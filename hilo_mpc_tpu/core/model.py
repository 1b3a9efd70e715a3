"""Dynamic model: declaration, integration, simulation, linearization.

Batched replacement for the reference's ``Model`` (reference:
hilo_mpc/modules/dynamic_model/dynamic_model.py:49-4369). Instead of building CasADi
symbolic expressions and compiling them through C, a model's equations are pure JAX
functions ``f(x, z, u, p, t)``; ``setup`` composes them with a fixed-step integrator
(ERK/collocation/discrete, core/integrators.py) into one jitted step function, and
``simulate`` rolls it out with ``lax.scan`` (time) and ``vmap`` (batch) — the analogue of
the reference's ``Function.mapaccum`` path (dynamic_model.py:4198) without leaving the
device.
"""
from __future__ import annotations

import copy as _copy
import inspect
from typing import Callable, Dict, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .integrators import IntegratorSpec, make_step
from .series import TimeSeries
from .variables import VarSpec

Array = jnp.ndarray

_CANONICAL_ARGS = ("x", "z", "u", "p", "t")


def wrap_rhs(fn: Callable, what: str = "rhs") -> Callable:
    """Adapt a user function with any subset of (x, z, u, p, t) parameters (by name or
    positionally in canonical order) to the canonical signature f(x, z, u, p, t)."""
    try:
        sig = inspect.signature(fn)
        params = [p.name for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY)]
    except (TypeError, ValueError):
        params = list(_CANONICAL_ARGS)
    if all(p in _CANONICAL_ARGS for p in params):
        picks = params
    else:
        # unknown names: bind positionally in canonical order
        picks = list(_CANONICAL_ARGS[: len(params)])

    def canonical(x, z, u, p, t):
        env = {"x": x, "z": z, "u": u, "p": p, "t": t}
        out = fn(*[env[name] for name in picks])
        return jnp.atleast_1d(jnp.asarray(out))

    canonical.__name__ = f"canonical_{what}"
    return canonical


class Model:
    """Dynamic ODE/DAE/discrete model with measurements and quadratures."""

    def __init__(self, name: Optional[str] = None, discrete: bool = False,
                 solver: Optional[str] = None, time_unit: str = "h",
                 plot_backend: Optional[str] = None, dtype=jnp.float32):
        self.name = name or "model"
        self._discrete = bool(discrete)
        self._solver = solver
        self._time_unit = time_unit
        self._plot_backend = plot_backend
        self._dtype = dtype

        self._x = VarSpec()   # differential states
        self._z = VarSpec()   # algebraic states
        self._u = VarSpec()   # inputs
        self._p = VarSpec()   # parameters
        self._y = VarSpec()   # measurements
        self._q = VarSpec()   # quadrature states

        self._ode: Optional[Callable] = None
        self._alg: Optional[Callable] = None
        self._meas: Optional[Callable] = None
        self._quad: Optional[Callable] = None
        self._equations_src: Optional[str] = None

        # linear state-space matrices if declared that way
        self._ss: Dict[str, Optional[np.ndarray]] = {k: None for k in "ABCDM"}

        self._dt: Optional[float] = None
        self._int_spec: Optional[IntegratorSpec] = None
        self._step = None          # step(x, z, u, p, t, dt) -> (x+, z+, y+, q+)
        self._step_jit = None
        self._rollout_jit = None
        self._rollout_batched_jit = None
        self._setup_done = False

        self._x0: Optional[np.ndarray] = None
        self._z0: Optional[np.ndarray] = None
        self._p0: Optional[np.ndarray] = None
        self._time = 0.0
        self.solution: Optional[TimeSeries] = None

        # deferred-linearization bookkeeping (reference: linearize() then
        # set_equilibrium_point() on the linearized model)
        self._linearized_parent: Optional["Model"] = None
        self._needs_equilibrium = False
        self._equilibrium: Optional[dict] = None

    # -- dimensions ---------------------------------------------------------
    @property
    def n_x(self) -> int: return self._x.n
    @property
    def n_z(self) -> int: return self._z.n
    @property
    def n_u(self) -> int: return self._u.n
    @property
    def n_p(self) -> int: return self._p.n
    @property
    def n_q(self) -> int: return self._q.n

    @property
    def n_y(self) -> int:
        return self._y.n if self._y.n else self._x.n

    @property
    def dynamical_states(self): return list(self._x.names)
    @property
    def algebraic_states(self): return list(self._z.names)
    @property
    def inputs(self): return list(self._u.names)
    @property
    def parameters(self): return list(self._p.names)
    @property
    def measurements(self):
        return list(self._y.names) if self._y.n else list(self._x.names)

    @property
    def discrete(self) -> bool: return self._discrete
    @property
    def continuous(self) -> bool: return not self._discrete
    @property
    def dt(self) -> Optional[float]: return self._dt
    @property
    def time_unit(self) -> str: return self._time_unit
    @property
    def dtype(self): return self._dtype

    # -- declaration --------------------------------------------------------
    @staticmethod
    def _vector_decl(names, dim):
        """Normalize the reference's vector-declaration forms (reference:
        set_dynamical_states('x', 3) / (3, 'x') / 3 → names x_0..x_2;
        dynamic_model.py:793-807, naming via ca.SX.sym(name, n))."""
        if dim is None:
            return names
        if isinstance(names, str) and isinstance(dim, (int, np.integer)):
            name, n = names, int(dim)
        elif isinstance(dim, str) and isinstance(names, (int, np.integer)):
            name, n = dim, int(names)
        else:
            raise TypeError("vector declaration takes (name, dim) or (dim, name)")
        if n < 0:
            raise ValueError(f"vector dimension must be >= 0, got {n}")
        if n == 1:
            return [name]
        return [f"{name}_{i}" for i in range(n)]

    def set_dynamical_states(self, names, dim=None, **meta):
        self._x = VarSpec()
        self._x.add(self._vector_decl(names, dim), prefix="x")
        return self

    def set_algebraic_states(self, names, dim=None, **meta):
        self._z = VarSpec()
        self._z.add(self._vector_decl(names, dim), prefix="z")
        return self

    def set_inputs(self, names, dim=None, **meta):
        self._u = VarSpec()
        self._u.add(self._vector_decl(names, dim), prefix="u")
        return self

    def set_parameters(self, names, dim=None, **meta):
        self._p = VarSpec()
        self._p.add(self._vector_decl(names, dim), prefix="p")
        return self

    def set_measurements(self, names, dim=None, **meta):
        self._y = VarSpec()
        self._y.add(self._vector_decl(names, dim), prefix="y")
        return self

    def set_dynamical_equations(self, fn: Union[Callable, str, Sequence[str]]):
        if isinstance(fn, (str, list, tuple)):
            return self.set_equations(ode=fn)
        self._ode = wrap_rhs(fn, "ode")
        return self

    def set_algebraic_equations(self, fn: Callable):
        self._alg = wrap_rhs(fn, "alg")
        return self

    def set_measurement_equations(self, fn: Union[Callable, str, Sequence[str]]):
        if isinstance(fn, (str, list, tuple)):
            return self.set_equations(meas=fn)
        self._meas = wrap_rhs(fn, "meas")
        return self

    def set_quadrature_functions(self, fn: Callable):
        self._quad = wrap_rhs(fn, "quad")
        if self._q.n == 0:
            self._q.add(1, prefix="q")
        return self

    def set_equations(self, equations=None, ode=None, alg=None, meas=None, quad=None):
        """Set equations from callables, a dict of callables, or the equation-string DSL
        (reference DSL semantics: hilo_mpc/util/parsing.py:246)."""
        if isinstance(equations, dict):
            ode = equations.get("ode", ode)
            alg = equations.get("alg", alg)
            meas = equations.get("meas", meas)
            quad = equations.get("quad", quad)
            equations = None
        if equations is not None:
            if callable(equations):
                self._ode = wrap_rhs(equations, "ode")
                return self
            from ..utils.parsing import apply_parsed_equations
            if isinstance(equations, (list, tuple)):
                equations = "\n".join(equations)
            apply_parsed_equations(self, equations)
            self._equations_src = equations  # DSL text enables pickling
            return self
        if ode is not None:
            if isinstance(ode, (str, list, tuple)):
                from ..utils.parsing import apply_parsed_equations
                text = ode if isinstance(ode, str) else "\n".join(ode)
                apply_parsed_equations(self, text)
            else:
                self._ode = wrap_rhs(ode, "ode")
        if alg is not None:
            self._alg = wrap_rhs(alg, "alg")
        if meas is not None:
            if isinstance(meas, (str, list, tuple)):
                from ..utils.parsing import apply_parsed_equations
                text = meas if isinstance(meas, str) else "\n".join(meas)
                apply_parsed_equations(self, text)
            else:
                self._meas = wrap_rhs(meas, "meas")
        if quad is not None:
            self.set_quadrature_functions(quad)
        return self

    # -- linear state-space declaration --------------------------------------
    def set_state_space(self, A=None, B=None, C=None, D=None, M=None):
        """Declare a (possibly time-discrete) linear model x' = Ax + Bu, y = Cx + Du
        (reference: dynamic_model.py:371 _unpack_state_space)."""
        for key, val in zip("ABCDM", (A, B, C, D, M)):
            if val is not None:
                self._ss[key] = np.atleast_2d(np.asarray(val, dtype=float))
        A_ = self._ss["A"]
        # dimension validation at declaration time, like the reference's
        # _unpack_state_space (dynamic_model.py:371)
        if A_ is not None and A_.shape[0] != A_.shape[1]:
            raise ValueError(f"A must be square, got {A_.shape}")
        if A_ is not None and self._x.n == 0:
            self._x.add(A_.shape[0], prefix="x")
        B_ = self._ss["B"]
        if B_ is not None and A_ is not None and B_.shape[0] != A_.shape[0]:
            raise ValueError(f"B has {B_.shape[0]} rows for {A_.shape[0]} "
                             "states")
        if B_ is not None and self._u.n == 0:
            self._u.add(B_.shape[1], prefix="u")
        C_ = self._ss["C"]
        if C_ is not None and self._x.n and C_.shape[1] != self._x.n:
            raise ValueError(f"C has {C_.shape[1]} columns for {self._x.n} "
                             "states")
        if C_ is not None and self._y.n == 0:
            self._y.add(C_.shape[0], prefix="y")
        D_ = self._ss["D"]
        if D_ is not None and self._u.n and D_.shape[1] != self._u.n:
            raise ValueError(f"D has {D_.shape[1]} columns for {self._u.n} "
                             "inputs")
        if D_ is not None and C_ is not None and D_.shape[0] != C_.shape[0]:
            raise ValueError(f"D has {D_.shape[0]} rows for {C_.shape[0]} "
                             "measurements")
        if D_ is not None and self._y.n == 0:
            self._y.add(D_.shape[0], prefix="y")

        nx, nu, ny = self._x.n, self._u.n, self._y.n
        # snapshot at build time: every setter rebuilds these closures, so a
        # live read of self._ss would be equivalent — but a snapshot keeps the
        # closures content-stable, which lets them carry a content-provenance
        # marker for cross-instance solver-trace sharing (trace_signature)
        A_s, B_s, C_s, D_s = (None if m is None else m.copy()
                              for m in (A_, B_, C_, D_))

        def ode(x, z, u, p, t):
            out = jnp.zeros(nx, dtype=x.dtype)
            if A_s is not None:
                out = out + jnp.asarray(A_s, x.dtype) @ x
            if B_s is not None and nu:
                out = out + jnp.asarray(B_s, x.dtype) @ u
            return out

        def _mat_key(m):
            return None if m is None else (m.shape, m.tobytes())

        ode._hilo_dsl_src = ("ss_ode", _mat_key(A_s), _mat_key(B_s))
        self._ode = ode
        if C_s is not None or D_s is not None:
            def meas(x, z, u, p, t):
                out = jnp.zeros(ny, dtype=x.dtype)
                if C_s is not None:
                    out = out + jnp.asarray(C_s, x.dtype) @ x
                if D_s is not None and nu:
                    out = out + jnp.asarray(D_s, x.dtype) @ u
                return out
            meas._hilo_dsl_src = ("ss_meas", _mat_key(C_s), _mat_key(D_s))
            self._meas = meas
        return self

    @property
    def A(self):
        return None if self._ss["A"] is None else np.array(self._ss["A"])

    @A.setter
    def A(self, val):
        self.set_state_space(A=val)

    @property
    def B(self):
        return None if self._ss["B"] is None else np.array(self._ss["B"])

    @B.setter
    def B(self, val):
        self.set_state_space(B=val)

    @property
    def C(self):
        return None if self._ss["C"] is None else np.array(self._ss["C"])

    @C.setter
    def C(self, val):
        self.set_state_space(C=val)

    @property
    def D(self):
        return None if self._ss["D"] is None else np.array(self._ss["D"])

    @D.setter
    def D(self, val):
        self.set_state_space(D=val)

    # -- canonical function access ------------------------------------------
    def ode_fn(self) -> Callable:
        if self._ode is None:
            raise RuntimeError("no dynamical equations set")
        return self._ode

    def alg_fn(self) -> Optional[Callable]:
        return self._alg

    def meas_fn(self) -> Callable:
        """Measurement function; defaults to full state observation."""
        if self._meas is not None:
            return self._meas
        return lambda x, z, u, p, t: x

    def quad_fn(self) -> Optional[Callable]:
        return self._quad

    def trace_signature(self):
        """Hashable signature of everything that enters a solver trace.

        Two models with equal signatures produce behaviorally identical
        ode/alg/meas/quad closures, so controllers/estimators built on them
        can share one traced+compiled solver (the cross-instance trace
        registry in control/nmpc.py — reference semantics: HILO-MPC builds
        its CasADi solver once per problem, mpc.py:1778-1787; ours is once
        per *configuration*). DSL-built models hash by equation text +
        variable-name layout; callable-built models fall back to the id of
        the exact function objects (conservative: same objects share, fresh
        lambdas do not). Returns ``(sig, keep)`` where ``keep`` lists the
        objects whose ids appear in ``sig`` (the registry must hold them so
        ids cannot be recycled).
        """
        keep = []

        def fn_sig(fn):
            if fn is None:
                return None
            src = getattr(fn, "_hilo_dsl_src", None)
            if src is not None:
                return ("dsl", src)
            keep.append(fn)
            return ("id", id(fn))

        eq = ("fns", fn_sig(self._ode), fn_sig(self._alg),
              fn_sig(self._meas), fn_sig(self._quad))
        sig = (type(self).__name__, self.discrete, eq,
               tuple(self._x.names), tuple(self._z.names),
               tuple(self._u.names), tuple(self._p.names),
               tuple(self.measurements), self.n_q,
               None if self._z0 is None else tuple(np.asarray(self._z0)))
        return sig, keep

    # -- structural analysis --------------------------------------------------
    def _probe_args(self, seed: int = 0, spread: float = 0.37):
        rng = np.random.default_rng(seed)
        mk = lambda n: jnp.asarray(rng.normal(size=n) * spread + 0.21,
                                   dtype=jnp.float64
                                   if jax.config.jax_enable_x64 else jnp.float32)
        return mk(self.n_x), mk(self.n_z), mk(self.n_u), mk(max(self.n_p, 0)), 0.13

    @property
    def is_linear(self) -> bool:
        """Probabilistic affinity check in (x, u) (reference does symbolic detection,
        dynamic_model.py:214; random-probe superposition is the tracing analogue).
        Probe points are widely separated so curvature shows up well above the
        floating-point noise of a genuinely affine map."""
        if self._ode is None:
            return False
        if self._ss["A"] is not None:
            return True
        try:
            f64 = jax.config.jax_enable_x64
            tol = dict(rtol=1e-9, atol=1e-10) if f64 else dict(rtol=3e-5,
                                                               atol=1e-6)
            for seeds in ((1, 2), (5, 9)):
                x1, z, u1, p, t = self._probe_args(seeds[0], spread=1.9)
                x2, _, u2, _, _ = self._probe_args(seeds[1], spread=1.9)
                f = lambda x, u: self.ode_fn()(x, z, u, p, t)
                a = 0.731
                lhs = np.asarray(f(a * x1 + (1 - a) * x2,
                                   a * u1 + (1 - a) * u2), dtype=float)
                rhs = np.asarray(a * f(x1, u1) + (1 - a) * f(x2, u2),
                                 dtype=float)
                if not np.allclose(lhs, rhs, **tol):
                    return False
            return True
        except Exception:
            return False

    @property
    def is_time_variant(self) -> bool:
        if self._ode is None:
            return False
        try:
            x, z, u, p, _ = self._probe_args(3)
            f1 = self.ode_fn()(x, z, u, p, 0.17)
            f2 = self.ode_fn()(x, z, u, p, 2.93)
            return not bool(np.allclose(np.asarray(f1), np.asarray(f2), rtol=1e-6, atol=1e-8))
        except Exception:
            return False

    # -- setup ----------------------------------------------------------------
    def setup(self, dt: float = 1.0, integration_method: Optional[str] = None,
              degree: int = 3, scheme: str = "radau", substeps: int = 1,
              newton_iters: int = 8, options: Optional[dict] = None):
        """Compile the per-step transition function.

        ``integration_method``: one of the ERK names ('euler','rk4',...), 'collocation',
        'cvodes'/'idas' (mapped to Radau collocation), or 'discrete'.
        """
        if self._ode is None:
            raise RuntimeError(f"model {self.name!r}: no equations set before setup()")
        options = options or {}
        if integration_method is None:
            integration_method = "discrete" if self._discrete else (
                "collocation" if self.n_z else "rk4")
        if self._discrete:
            integration_method = "discrete"
        if self.n_z and integration_method not in ("collocation", "irk", "discrete",
                                                   "cvodes", "idas"):
            # explicit methods still work: algebraic states solved per stage by Newton
            pass
        self._int_spec = IntegratorSpec(
            method=integration_method, degree=degree, scheme=scheme,
            substeps=substeps, newton_iters=newton_iters)
        self._dt = float(dt)

        ode, alg = self._ode, self._alg
        quad = self._quad
        nq = self._q.n if quad is not None else 0
        if quad is not None and not self._discrete:
            # integrate quadratures as augmented states: d[q]/dt = integrand
            nx = self.n_x

            def ode_aug(xa, z, u, p, t):
                x = xa[:nx]
                dx = ode(x, z, u, p, t)
                dq = jnp.atleast_1d(quad(x, z, u, p, t)).astype(x.dtype)
                return jnp.concatenate([dx, dq])

            alg_aug = (lambda xa, z, u, p, t: alg(xa[:nx], z, u, p, t)) if alg else None
            core = make_step(ode_aug, alg_aug, self.n_x + nq, self.n_z, self._int_spec)

            def step(x, z, u, p, t, dt):
                xa = jnp.concatenate([x, jnp.zeros(nq, dtype=x.dtype)])
                xa_n, z_n = core(xa, z, u, p, t, dt)
                x_n, q_n = xa_n[:nx].astype(x.dtype), xa_n[nx:].astype(x.dtype)
                y_n = self.meas_fn()(x_n, z_n, u, p, t + dt)
                return x_n, z_n, jnp.atleast_1d(y_n).astype(x.dtype), q_n
        else:
            core = make_step(ode, alg, self.n_x, self.n_z, self._int_spec)

            def step(x, z, u, p, t, dt):
                x_n, z_n = core(x, z, u, p, t, dt)
                x_n = x_n.astype(x.dtype)
                y_n = self.meas_fn()(x_n, z_n, u, p, t + dt)
                q_n = (jnp.atleast_1d(quad(x_n, z_n, u, p, t + dt)).astype(x.dtype)
                       if (quad is not None and self._discrete) else
                       jnp.zeros(nq, dtype=x.dtype))
                return x_n, z_n, jnp.atleast_1d(y_n).astype(x.dtype), q_n

        self._step = step
        self._step_jit = jax.jit(step)
        self._rollout_jit = None
        self._rollout_batched_jit = None
        self.solution = TimeSeries(self._time_unit)
        self.solution.register("x", self._x.names)
        self.solution.register("z", self._z.names)
        self.solution.register("u", self._u.names)
        self.solution.register("y", self.measurements)
        self.solution.register("p", self._p.names)
        self._time = 0.0
        self._setup_done = True
        return self

    def is_setup(self) -> bool:
        return self._setup_done

    @property
    def step_fn(self) -> Callable:
        """step(x, z, u, p, t, dt) -> (x_next, z_next, y_next, q_next), jitted."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        return self._step_jit

    @property
    def step_fn_raw(self) -> Callable:
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        return self._step

    # -- initial conditions ---------------------------------------------------
    def set_initial_conditions(self, x0, z0=None):
        if (self.solution is not None and self.solution.n_samples > 1):
            # reference parity (dynamic_model.py:3385-3394): once simulated,
            # new initial conditions are NOT silently applied — simulate()
            # would keep continuing from the stored trajectory tail
            import warnings
            warnings.warn(
                "The model has already been simulated — call reset_solution() "
                "to record a new trajectory (no changes applied); for "
                "stateless one-off rollouts from arbitrary states use "
                "simulate(x0=..., ...) instead")
            return self
        self._x0 = np.atleast_1d(np.asarray(x0, dtype=float)).ravel()
        if self._x0.size != self.n_x:
            raise ValueError(f"x0 has {self._x0.size} entries, expected {self.n_x}")
        if z0 is not None:
            self._z0 = np.atleast_1d(np.asarray(z0, dtype=float)).ravel()
        if self.solution is not None and self.solution.n_samples == 1:
            self.solution.reset()   # re-setting before any simulate: overwrite
        if self.solution is not None and self.solution.n_samples == 0:
            z0v = self._z0 if self._z0 is not None else np.zeros(self.n_z)
            y0 = np.asarray(self.meas_fn()(
                jnp.asarray(self._x0, self._dtype), jnp.asarray(z0v, self._dtype),
                jnp.zeros(self.n_u, self._dtype),
                jnp.asarray(self._p0 if self._p0 is not None else np.zeros(self.n_p),
                            self._dtype), 0.0))
            self.solution.append(0.0, x=self._x0, z=z0v, y=y0)
        return self

    def set_initial_parameter_values(self, p):
        self._p0 = np.atleast_1d(np.asarray(p, dtype=float)).ravel()
        if self._p0.size != self.n_p:
            raise ValueError(f"p has {self._p0.size} entries, expected {self.n_p}")
        return self

    def reset_solution(self):
        if self.solution is not None:
            self.solution.reset()
        self._time = 0.0
        if self._x0 is not None:
            self.set_initial_conditions(self._x0, self._z0)
        return self

    # -- simulation -----------------------------------------------------------
    def _coerce_u(self, u, steps: int) -> np.ndarray:
        if u is None:
            return np.zeros((steps, self.n_u))
        u = np.asarray(u, dtype=float)
        if u.ndim == 0:
            u = u.reshape(1, 1)
        if u.ndim == 1:
            if u.size == self.n_u:
                u = np.tile(u.reshape(1, -1), (steps, 1))
            elif self.n_u == 1:
                u = u.reshape(-1, 1)
        if u.shape == (self.n_u, steps) and self.n_u != steps:
            u = u.T
        if u.shape == (1, self.n_u) and steps > 1:
            # a single input row is held over all steps (reference: repmat in
            # Model.simulate, dynamic_model.py:3942-3990)
            u = np.tile(u, (steps, 1))
        if u.shape != (steps, self.n_u):
            raise ValueError(f"u has shape {u.shape}, expected {(steps, self.n_u)}")
        return u

    def _coerce_u_batched(self, u, steps: int, batch: int):
        """Coerce u for a batched rollout. Returns ``(U, per_scenario)``.

        Per-scenario inputs (reference semantics: simulate honors the u it is
        given per call, dynamic_model.py:3942-3990) are accepted as
        ``(B, steps, n_u)``, or ``(B, n_u)`` held over all steps. A 2-D u that
        also parses as the shared ``(steps, n_u)`` layout keeps the shared
        interpretation for backward compatibility.
        """
        if u is None:
            return self._coerce_u(None, steps), False
        u_arr = np.asarray(u, dtype=float)
        if u_arr.ndim == 3:
            if u_arr.shape != (batch, steps, self.n_u):
                raise ValueError(
                    f"per-scenario u has shape {u_arr.shape}, expected "
                    f"{(batch, steps, self.n_u)}")
            return u_arr, True
        if u_arr.ndim == 2 and u_arr.shape == (batch, self.n_u):
            if u_arr.shape == (steps, self.n_u):
                # Ambiguous: (B, n_u) per-scenario held input vs (steps, n_u)
                # shared time-varying input when B == steps. Keep the shared
                # interpretation for backward compatibility, but say so.
                import warnings
                warnings.warn(
                    f"batched simulate: u of shape {u_arr.shape} is ambiguous "
                    f"(batch == steps == {batch}); interpreting as the shared "
                    f"time-varying (steps, n_u) layout. Pass the 3-D "
                    f"(B, steps, n_u) form for per-scenario inputs.",
                    stacklevel=3)
            else:
                return (np.broadcast_to(u_arr[:, None, :],
                                        (batch, steps, self.n_u)).copy(), True)
        return self._coerce_u(u_arr, steps), False

    def _coerce_p_batched(self, p, steps: int, batch: int):
        """Batched analogue of :meth:`_coerce_p`; see ``_coerce_u_batched``."""
        if p is None:
            return self._coerce_p(None, steps), False
        p_arr = np.asarray(p, dtype=float)
        if p_arr.ndim == 3:
            if p_arr.shape != (batch, steps, self.n_p):
                raise ValueError(
                    f"per-scenario p has shape {p_arr.shape}, expected "
                    f"{(batch, steps, self.n_p)}")
            return p_arr, True
        if p_arr.ndim == 2 and p_arr.shape == (batch, self.n_p):
            if p_arr.shape == (steps, self.n_p):
                import warnings
                warnings.warn(
                    f"batched simulate: p of shape {p_arr.shape} is ambiguous "
                    f"(batch == steps == {batch}); interpreting as the shared "
                    f"time-varying (steps, n_p) layout. Pass the 3-D "
                    f"(B, steps, n_p) form for per-scenario parameters.",
                    stacklevel=3)
            else:
                return (np.broadcast_to(p_arr[:, None, :],
                                        (batch, steps, self.n_p)).copy(), True)
        return self._coerce_p(p_arr, steps), False

    def _coerce_p(self, p, steps: int) -> np.ndarray:
        if p is None:
            if self._p0 is not None:
                p = self._p0
            elif self.n_p == 0:
                p = np.zeros(0)
            else:
                raise ValueError("model has parameters; pass p= or "
                                 "set_initial_parameter_values")
        p = np.asarray(p, dtype=float)
        if p.ndim <= 1:
            p = np.tile(np.atleast_1d(p).reshape(1, -1), (steps, 1))
        if p.shape == (self.n_p, steps) and self.n_p != steps:
            p = p.T
        if p.shape != (steps, self.n_p):
            raise ValueError(f"p has shape {p.shape}, expected {(steps, self.n_p)}")
        return p

    def rollout_fn(self) -> Callable:
        """Pure rollout: (x0, z0, U, P, t0) -> dict of stacked trajectories, where
        U: (steps, n_u), P: (steps, n_p). Scan over time; vmap-friendly."""
        step = self.step_fn_raw
        dt = self._dt

        def rollout(x0, z0, U, P, t0=0.0):
            def body(carry, inp):
                x, z, t = carry
                u, p = inp
                x_n, z_n, y_n, q_n = step(x, z, u, p, t, dt)
                return (x_n, z_n, t + dt), (x_n, z_n, y_n, q_n)

            (_, _, _), (X, Z, Y, Q) = jax.lax.scan(
                body, (x0, z0, jnp.asarray(t0, x0.dtype)), (U, P))
            return {"x": X, "z": Z, "y": Y, "q": Q}

        return rollout

    def simulate(self, x0=None, z0=None, u=None, p=None, steps: Optional[int] = None,
                 t0: Optional[float] = None, store: bool = True):
        """Simulate ``steps`` steps (default: as many as rows of u).

        Unbatched: appends to ``self.solution``. Batched (x0 with a leading batch dim):
        vmapped rollout, nothing stored, returns trajectory dict with leading batch axis.
        """
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if self._needs_equilibrium:
            raise RuntimeError(
                "Model is linearized, but no equilibrium point was set. Please "
                "set equilibrium point before simulating the model!")
        if steps is None:
            if u is not None:
                u_arr = np.asarray(u, dtype=float)
                if u_arr.ndim == 3:
                    steps = u_arr.shape[1]
                elif u_arr.ndim == 2:
                    steps = u_arr.shape[0] if u_arr.shape[1] == self.n_u else u_arr.shape[1]
                elif u_arr.ndim == 1 and self.n_u == 1:
                    steps = u_arr.size
                else:
                    steps = 1
            else:
                steps = 1

        batched = x0 is not None and np.asarray(x0).ndim > 1
        if x0 is None:
            if self.solution is not None and self.solution.n_samples:
                x0 = self.solution["x:f"]
            elif self._x0 is not None:
                x0 = self._x0
            else:
                raise ValueError("no x0 given and no stored initial conditions")
        x0 = np.asarray(x0, dtype=float)
        if z0 is None:
            z0 = (self.solution["z:f"] if (self.solution is not None and
                                           self.solution.n_samples and self.n_z)
                  else np.zeros(self.n_z))
            z0 = np.nan_to_num(np.asarray(z0, dtype=float))
            if batched:
                z0 = np.tile(z0, (x0.shape[0], 1))
        t_start = self._time if t0 is None else float(t0)

        dtype = self._dtype
        if batched:
            B = x0.shape[0]
            U, u_per = self._coerce_u_batched(u, steps, B)
            P, p_per = self._coerce_p_batched(p, steps, B)
            key = (u_per, p_per)
            if self._rollout_batched_jit is None:
                self._rollout_batched_jit = {}
            if key not in self._rollout_batched_jit:
                in_axes = (0, 0, 0 if u_per else None, 0 if p_per else None, None)
                self._rollout_batched_jit[key] = jax.jit(
                    jax.vmap(self.rollout_fn(), in_axes=in_axes))
            out = self._rollout_batched_jit[key](
                jnp.asarray(x0, dtype), jnp.asarray(z0, dtype),
                jnp.asarray(U, dtype), jnp.asarray(P, dtype), t_start)
            return {k: np.asarray(v) for k, v in out.items()}
        U = self._coerce_u(u, steps)
        P = self._coerce_p(p, steps)

        if self._rollout_jit is None:
            self._rollout_jit = jax.jit(self.rollout_fn())
        fn = self._rollout_jit
        out = fn(jnp.asarray(x0, dtype), jnp.asarray(np.atleast_1d(z0), dtype),
                 jnp.asarray(U, dtype), jnp.asarray(P, dtype), t_start)
        out = {k: np.asarray(v) for k, v in out.items()}
        if store and self.solution is not None:
            ts = t_start + self._dt * np.arange(1, steps + 1)
            self.solution.append(ts, x=out["x"].T, z=out["z"].T if self.n_z else None,
                                 u=U.T, y=out["y"].T,
                                 p=P.T if self.n_p else None)
            self._time = float(ts[-1])
        return out

    # -- linearization --------------------------------------------------------
    def linearize(self, x_eq=None, u_eq=None, z_eq=None, p=None, t: float = 0.0):
        """Jacobian linearization about an equilibrium (reference:
        dynamic_model.py:2488 — returns a linear model in Δ-coordinates).

        Like the reference, the equilibrium point may be deferred: calling
        ``linearize()`` with no point returns a linear model whose A/B/C/D are
        finalized by ``set_equilibrium_point(...)`` on the *linearized* model;
        ``simulate`` raises until then (reference: tests/test_linearization.py
        test_no_equilibrium_point_given)."""
        if self._linearized_parent is not None:
            print("Model is already linearized. Nothing to be done.")
            return self
        if self.is_linear:
            print("Model is already linear. Linearization is not necessary. "
                  "Nothing to be done.")
            return self
        deferred = x_eq is None and u_eq is None
        nx, nu, nz = self.n_x, self.n_u, self.n_z
        dt64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        x_eq = jnp.zeros(nx, dt64) if x_eq is None else jnp.asarray(x_eq, dt64)
        u_eq = jnp.zeros(nu, dt64) if u_eq is None else jnp.asarray(u_eq, dt64)
        z_eq = jnp.zeros(nz, dt64) if z_eq is None else jnp.asarray(z_eq, dt64)
        p_v = (jnp.asarray(self._p0, dt64) if (p is None and self._p0 is not None)
               else jnp.asarray(p if p is not None else np.zeros(self.n_p), dt64))
        f = self.ode_fn()
        h = self.meas_fn()
        A = np.asarray(jax.jacfwd(lambda x: f(x, z_eq, u_eq, p_v, t))(x_eq))
        B = np.asarray(jax.jacfwd(lambda u: f(x_eq, z_eq, u, p_v, t))(u_eq))
        C = np.asarray(jax.jacfwd(lambda x: h(x, z_eq, u_eq, p_v, t))(x_eq))
        D = np.asarray(jax.jacfwd(lambda u: h(x_eq, z_eq, u, p_v, t))(u_eq))
        lin = Model(name=f"{self.name}_linearized", discrete=self._discrete,
                    time_unit=self._time_unit, dtype=self._dtype)
        lin.set_dynamical_states([f"d{n}" for n in self._x.names])
        if nu:
            lin.set_inputs([f"d{n}" for n in self._u.names])
        lin.set_measurements([f"d{n}" for n in self.measurements])
        lin.set_state_space(A=A, B=B if nu else None, C=C, D=D if nu else None)
        lin._linearized_parent = self
        if deferred:
            lin._needs_equilibrium = True
        else:
            lin._equilibrium = {"x": np.asarray(x_eq), "u": np.asarray(u_eq),
                                "p": np.asarray(p_v)}
        return lin

    def set_equilibrium_point(self, x_eq, u_eq=None, p=None, tol: float = 1e-6):
        """Validate and store an equilibrium (reference: dynamic_model.py:4127-4140
        raises on non-equilibrium inputs). On a model produced by a deferred
        ``linearize()`` this finalizes the linearization: A/B/C/D are recomputed
        at the point from the parent's dynamics."""
        x_eq = np.asarray(x_eq, dtype=float).ravel()
        if x_eq.size != self.n_x:
            raise ValueError(f"x_eq has {x_eq.size} entries, expected {self.n_x}")
        u_eq = (np.zeros(self.n_u) if u_eq is None
                else np.asarray(u_eq, dtype=float).ravel())
        if u_eq.size != self.n_u:
            raise ValueError(f"u_eq has {u_eq.size} entries, expected {self.n_u}")
        parent = self._linearized_parent
        if parent is not None:
            # validate against the ORIGINAL nonlinear dynamics, then refresh
            # the Jacobians at the new point
            parent.set_equilibrium_point(x_eq, u_eq, p=p, tol=tol)
            fresh = parent.linearize(x_eq=x_eq, u_eq=u_eq, p=p)
            self._ss.update(fresh._ss)
            self.set_state_space()  # rebind the closures to the updated matrices
            self._equilibrium = dict(fresh._equilibrium)
            self._needs_equilibrium = False
            if self._setup_done:
                spec = self._int_spec
                self.setup(dt=self._dt, integration_method=spec.method,
                           degree=spec.degree, scheme=spec.scheme,
                           substeps=spec.substeps, newton_iters=spec.newton_iters)
            return self
        p_v = (self._p0 if (p is None and self._p0 is not None)
               else np.asarray(p if p is not None else np.zeros(self.n_p),
                               dtype=float))
        f = self.ode_fn()
        dt64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        res = np.asarray(f(jnp.asarray(x_eq, dt64), jnp.zeros(self.n_z, dt64),
                           jnp.asarray(u_eq, dt64), jnp.asarray(p_v, dt64), 0.0))
        if self._discrete:
            res = res - x_eq
        if np.max(np.abs(res)) > tol:
            raise ValueError(
                f"({x_eq}, {u_eq}) is not an equilibrium: residual {res} "
                f"(max |r| = {np.max(np.abs(res)):.3g} > tol {tol})")
        self._equilibrium = {"x": x_eq, "u": u_eq, "p": np.asarray(p_v)}
        return self

    def linearize_trajectory(self, X, U, p=None, t0: float = 0.0):
        """Time-varying linearization along a trajectory: returns (A_k, B_k) arrays
        of shape (T, nx, nx) / (T, nx, nu) (reference: trajectory linearization in
        dynamic_model.py:2488-2731)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        U = np.atleast_2d(np.asarray(U, dtype=float))
        T = min(X.shape[0], U.shape[0])
        p_v = (self._p0 if (p is None and self._p0 is not None)
               else np.asarray(p if p is not None else np.zeros(self.n_p),
                               dtype=float))
        dt64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        f = self.ode_fn()
        z0 = jnp.zeros(self.n_z, dt64)
        pj = jnp.asarray(p_v, dt64)
        dt = self._dt or 1.0

        def jac_at(x, u, t):
            A = jax.jacfwd(lambda xx: f(xx, z0, u, pj, t))(x)
            B = jax.jacfwd(lambda uu: f(x, z0, uu, pj, t))(u)
            return A, B

        ts = t0 + dt * jnp.arange(T)
        A, B = jax.vmap(jac_at)(jnp.asarray(X[:T], dt64), jnp.asarray(U[:T], dt64),
                                ts)
        return np.asarray(A), np.asarray(B)

    def jacobians(self, x, u, z=None, p=None, t: float = 0.0):
        """(A, B) continuous- or discrete-time Jacobians of the RHS at a point."""
        z = jnp.zeros(self.n_z, self._dtype) if z is None else jnp.asarray(z, self._dtype)
        p = (jnp.asarray(self._p0, self._dtype) if (p is None and self._p0 is not None)
             else jnp.asarray(p if p is not None else np.zeros(self.n_p), self._dtype))
        f = self.ode_fn()
        x = jnp.asarray(x, self._dtype)
        u = jnp.asarray(u, self._dtype)
        A = jax.jacfwd(lambda xx: f(xx, z, u, p, t))(x)
        B = jax.jacfwd(lambda uu: f(x, z, uu, p, t))(u)
        return A, B

    # -- discretization -------------------------------------------------------
    def discretize(self, method: str = "rk4", degree: int = 3, substeps: int = 1,
                   dt: Optional[float] = None):
        """Return a discrete-time model whose difference equation is one integrator step
        of this model (reference: dynamic_model.py:2113-2456)."""
        if self._discrete:
            raise RuntimeError("model is already discrete")
        spec = IntegratorSpec(method=method, degree=degree, substeps=substeps)
        core = make_step(self.ode_fn(), self._alg, self.n_x, self.n_z, spec)
        disc = self.copy(keep_solution=False)
        disc._discrete = True
        dt_fixed = dt

        nx = self.n_x

        def disc_map(x, z, u, p, t):
            h = dt_fixed if dt_fixed is not None else (disc._dt or 1.0)
            x_n, _ = core(x, z, u, p, t, h)
            return x_n

        disc._ode = disc_map
        disc._setup_done = False
        disc._step = disc._step_jit = None
        return disc

    # -- data generation ------------------------------------------------------
    def generate_data(self, kind: str = "random_uniform", steps: int = 100, **kwargs):
        from ..utils.data import DataGenerator
        gen = DataGenerator(self, steps=steps, **kwargs)
        getattr(gen, kind)(**{k: v for k, v in kwargs.items()
                              if k in ("lb", "ub", "mean", "std", "seed")})
        gen.run()
        return gen.data

    # -- composition with learned components ---------------------------------
    def __add__(self, other):
        from ..ml.hybrid import hybridize
        return hybridize(self, other)

    def substitute_from(self, learned):
        """Replace parameters named by the learned component's labels with its
        predictions (reference: dynamic_model.py:3040 substitute_from)."""
        from ..ml.hybrid import substitute_from as _sub
        _sub(self, learned)
        return self

    # -- misc -----------------------------------------------------------------
    def copy(self, name: Optional[str] = None, keep_solution: bool = False) -> "Model":
        new = _copy.copy(self)
        new.name = name or self.name
        new._x = self._x.copy(); new._z = self._z.copy(); new._u = self._u.copy()
        new._p = self._p.copy(); new._y = self._y.copy(); new._q = self._q.copy()
        new._ss = {k: (None if v is None else np.array(v)) for k, v in self._ss.items()}
        new.solution = (self.solution.copy() if (keep_solution and self.solution)
                        else None)
        if not keep_solution:
            new._setup_done = False
            new._step = new._step_jit = None
            new._rollout_jit = new._rollout_batched_jit = None
        return new

    def __getstate__(self):
        state = self.__dict__.copy()
        # compiled artifacts are rebuilt by setup() after unpickling
        state["_step"] = None
        state["_step_jit"] = None
        state["_rollout_jit"] = None
        state["_rollout_batched_jit"] = None
        state["_setup_done"] = False
        # the parent may hold unpicklable closures; a finalized linear model
        # no longer needs it (finalize deferred linearizations before pickling)
        state["_linearized_parent"] = None
        if state.get("_equations_src") is not None:
            # DSL models re-parse on load; closure-based equations must pickle
            # themselves (lambdas won't — mirror of the reference's __getstate__
            # contract, dynamic_model.py:139-158)
            for key in ("_ode", "_alg", "_meas", "_quad"):
                state[key] = None
        elif state.get("_ss", {}).get("A") is not None:
            # state-space models rebuild their closures from the matrices
            state["_ode"] = None
            state["_meas"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_linearized_parent", None)
        self.__dict__.setdefault("_needs_equilibrium", False)
        self.__dict__.setdefault("_equilibrium", None)
        if self._ode is None and self._ss.get("A") is not None:
            self.set_state_space()  # rebuild closures from the matrices
        if getattr(self, "_equations_src", None) is not None and self._ode is None:
            from ..utils.parsing import apply_parsed_equations
            x, z, u, p = (list(self._x.names), list(self._z.names),
                          list(self._u.names), list(self._p.names))
            apply_parsed_equations(self, self._equations_src)
            self._x.names, self._z.names = x, z
            self._u.names, self._p.names = u, p

    def __repr__(self):
        return (f"Model({self.name!r}, nx={self.n_x}, nz={self.n_z}, nu={self.n_u}, "
                f"np={self.n_p}, ny={self.n_y}, "
                f"{'discrete' if self._discrete else 'continuous'})")

    def __str__(self):
        """Human-readable summary table (reference prints PrettyTable summaries,
        mpc.py:107-199 and Model.__str__)."""
        rows = [("kind", "names")]
        for kind, names in [("states", self._x.names),
                            ("algebraic", self._z.names),
                            ("inputs", self._u.names),
                            ("parameters", self._p.names),
                            ("measurements", self.measurements)]:
            rows.append((kind, ", ".join(names) if names else "-"))
        w0 = max(len(r[0]) for r in rows)
        w1 = max(len(r[1]) for r in rows)
        sep = "+" + "-" * (w0 + 2) + "+" + "-" * (w1 + 2) + "+"
        lines = [f"Model {self.name!r} "
                 f"({'discrete' if self._discrete else 'continuous'}"
                 f"{', set up, dt=' + str(self._dt) if self._setup_done else ''})",
                 sep]
        for i, (a, b) in enumerate(rows):
            lines.append(f"| {a:<{w0}} | {b:<{w1}} |")
            if i == 0:
                lines.append(sep)
        lines.append(sep)
        return "\n".join(lines)

    def __iter__(self):
        yield from {"x": self._x.names, "z": self._z.names, "u": self._u.names,
                    "p": self._p.names, "y": self.measurements}.items()
