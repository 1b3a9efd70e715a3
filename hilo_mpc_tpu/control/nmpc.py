"""Nonlinear model predictive control (and open-loop OCP).

Batched rebuild of the reference's NMPC (reference: hilo_mpc/modules/controller/
mpc.py:42-1930): where the reference assembles a flat CasADi NLP (decision vector
v = [x_0..N, u_0..Nc, slacks], mpc.py:1440-1455) and hands it to IPOPT, this class keeps
the multiple-shooting structure stagewise and solves it with the batched Riccati
interior-point engine (ops/ip_solver.py). Feature parity targets: reference/trajectory
tracking, path following (theta-augmented), economic (generic) costs, Δu penalties and
bounds, control horizon < prediction horizon, soft/hard box and custom constraints,
time-varying parameters, warm starts, multi-start — plus a batched `optimize_batch` the
reference cannot express (thousands of scenarios per chip).

Control-horizon / Δu handling: instead of tying trailing controls in the NLP (reference
mpc.py:1627), the state is augmented with u_prev and controls become Δu, which keeps the
KKT system block-banded for the Riccati sweep; input bounds become state bounds on the
u_prev component (exact, stagewise).
"""
from __future__ import annotations

import time as _time
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.integrators import IntegratorSpec, make_step
from ..core.model import Model
from ..core.series import TimeSeries
from ..ops.ip_solver import (IPOptions, OCPBounds, OCPDims, OCPFunctions,
                             solve_ocp)
from .costs import GenericConstraint, GenericCost, QuadraticCost, make_constraint

_NLP_OPTION_KEYS = {
    "integration_method", "degree", "collocation_scheme", "substeps",
    "newton_iters", "max_iter", "tol", "mu_init", "warm_start", "print_level",
    "dt", "convexify", "n_linesearch", "early_exit", "u_pf_lb", "u_pf_ub",
    "ipopt_debugger", "parallel_riccati", "mehrotra", "riccati_unroll",
    "const_cost_hessian", "lin_storage_dtype",
    "mi_neighbors",
    "mi_max_enum",
    "initial_guess",
}

# Cross-instance trace registry: one traced+compiled solver per
# CONFIGURATION, not per instance — see utils/trace_cache.py for the design.
from ..utils.trace_cache import (arr_key as _arr_key, clear_trace_registry,
                                 registry_lookup, registry_store,
                                 trace_registry_stats)


class NMPC:
    """Nonlinear MPC over a Model."""

    _controller_type = "NMPC"

    def __init__(self, model: Model, id: Optional[str] = None,
                 name: Optional[str] = None):
        self._model = model.copy(keep_solution=False)
        self.name = name or f"nmpc_{self._model.name}"
        self.quad_stage_cost = QuadraticCost(self._model)
        self.quad_terminal_cost = QuadraticCost(self._model)
        self.stage_cost = GenericCost(self._model)
        self.terminal_cost = GenericCost(self._model)
        self._stage_constraints: List[GenericConstraint] = []
        self._terminal_constraints: List[GenericConstraint] = []

        self._horizon: Optional[int] = None
        self._control_horizon: Optional[int] = None
        nx, nu = self._model.n_x, self._model.n_u
        self._x_lb = np.full(nx, -np.inf); self._x_ub = np.full(nx, np.inf)
        self._u_lb = np.full(nu, -np.inf); self._u_ub = np.full(nu, np.inf)
        self._du_lb = np.full(nu, -np.inf); self._du_ub = np.full(nu, np.inf)
        self._x_soft = False
        self._soft_weight = 1e4
        self._x_scaling = np.ones(nx)
        self._u_scaling = np.ones(nu)
        self._x_guess: Optional[np.ndarray] = None
        self._u_guess = np.zeros(nu)
        self._tvp_names: List[str] = []
        self._tvp_values: Optional[np.ndarray] = None   # (T, n_tvp)
        self._p_defaults: Optional[np.ndarray] = None

        self._path_following = False
        self._path_u_bounds = (0.0, np.inf)
        self._path_speed = None
        self._min_time = None
        self._discrete_inputs: dict = {}   # input name -> levels array | None
        self._mi = None                    # resolved at setup()

        self._setup_done = False
        self._solver = None
        self._trace_entry = None   # cross-instance trace-registry entry
        self._opts: dict = {}
        self._time = 0.0
        self._step_count = 0
        self._u_old = np.zeros(nu)
        self._theta_path0 = 0.0
        self._warm = None          # previous (X, U) scaled solution for warm start
        self._rti = None           # prepared RTI data (rti_prepare/rti_feedback)
        self._rti_pending = None   # (xs0, U) applied by the last feedback phase
        self.rti_gn_iterations = None  # int k: prepare runs exactly k GN/IP
        #   iterations (classical single-iteration RTI at k=1) instead of a
        #   full solve; None = full-solve (advanced-step) prepare
        self._rti_gn_jit = None    # lazy: fixed-iteration prepare solver
        self._rti_batch = None     # prepared batched-RTI data
        self._rti_gain_batch_jit = None
        self._rti_gain_jit = None  # lazy: Riccati gain extraction at a solution
        self._dyn_step_jit = None  # lazy: one-step dynamics for x_pred refresh
        self.solution: Optional[TimeSeries] = None
        self.last_prediction = None
        self.stats: dict = {}

    # -- basic configuration -------------------------------------------------
    @property
    def horizon(self) -> Optional[int]:
        return self._horizon

    @horizon.setter
    def horizon(self, N: int):
        if int(N) < 1:
            raise ValueError("horizon must be >= 1")
        self._horizon = int(N)

    prediction_horizon = horizon

    @property
    def control_horizon(self) -> Optional[int]:
        return self._control_horizon if self._control_horizon else self._horizon

    @control_horizon.setter
    def control_horizon(self, Nc: int):
        if int(Nc) < 1:
            raise ValueError("control horizon must be >= 1")
        self._control_horizon = int(Nc)

    @property
    def n_x(self): return self._model.n_x
    @property
    def n_u(self): return self._model.n_u

    def set_box_constraints(self, x_lb=None, x_ub=None, u_lb=None, u_ub=None,
                            du_lb=None, du_ub=None, x_soft: bool = False,
                            soft_weight: float = 1e4):
        def setv(cur, val, n):
            if val is None:
                return cur
            return np.broadcast_to(np.asarray(val, dtype=float).ravel(), (n,)).copy()

        nx, nu = self._model.n_x, self._model.n_u
        self._x_lb = setv(self._x_lb, x_lb, nx)
        self._x_ub = setv(self._x_ub, x_ub, nx)
        self._u_lb = setv(self._u_lb, u_lb, nu)
        self._u_ub = setv(self._u_ub, u_ub, nu)
        self._du_lb = setv(self._du_lb, du_lb, nu)
        self._du_ub = setv(self._du_ub, du_ub, nu)
        self._x_soft = bool(x_soft)
        self._soft_weight = float(soft_weight)
        return self

    def set_discrete_inputs(self, inputs, levels=None):
        """Declare inputs that may only take values from a finite set (mixed-integer
        NMPC). The reference reserves solver plumbing for this ('bonmin' in
        optimizer.py:897, `_mixed_integer_flag` in mpc.py:56) but never activates it;
        here it is solved natively: relaxed interior-point solve, then a batch of
        rounding/neighborhood candidates with the discrete inputs pinned
        (lbu == ubu) evaluated in ONE vmapped solve, best feasible wins.

        :param inputs: input name(s) or index(es) into model.inputs
        :param levels: allowed values — one array applied to every declared input,
            or a list of arrays (one per input). ``None`` derives the integer
            lattice from the box bounds at setup() (requires finite u bounds).
        """
        if isinstance(inputs, (str, int)):
            inputs = [inputs]
        inputs = list(inputs)
        if levels is None:
            per_input = [None] * len(inputs)
        elif isinstance(levels, (list, tuple)) and len(levels) and \
                isinstance(levels[0], (list, tuple, np.ndarray)):
            if len(levels) != len(inputs):
                raise ValueError(f"{len(inputs)} inputs but {len(levels)} level sets")
            per_input = [np.asarray(lv, dtype=float).ravel() for lv in levels]
        else:
            per_input = [np.asarray(levels, dtype=float).ravel()] * len(inputs)
        names = self._model.inputs
        for inp, lv in zip(inputs, per_input):
            name = names[inp] if isinstance(inp, int) else inp
            if name not in names:
                raise ValueError(f"unknown input {name!r} (have {names})")
            if lv is not None and lv.size < 2:
                raise ValueError(f"input {name!r}: need >= 2 levels, got {lv}")
            self._discrete_inputs[name] = None if lv is None else np.unique(lv)
        return self

    def set_initial_guess(self, x_guess=None, u_guess=None):
        if x_guess is not None:
            self._x_guess = np.asarray(x_guess, dtype=float).ravel()
        if u_guess is not None:
            self._u_guess = np.broadcast_to(
                np.asarray(u_guess, dtype=float).ravel(), (self._model.n_u,)).copy()
        return self

    def set_scaling(self, x_scaling=None, u_scaling=None):
        if x_scaling is not None:
            self._x_scaling = np.broadcast_to(
                np.asarray(x_scaling, float).ravel(), (self._model.n_x,)).copy()
        if u_scaling is not None:
            self._u_scaling = np.broadcast_to(
                np.asarray(u_scaling, float).ravel(), (self._model.n_u,)).copy()
        return self

    def set_time_varying_parameters(self, names, values=None):
        if isinstance(names, str):
            names = [names]
        for nm in names:
            if nm not in self._model.parameters:
                raise ValueError(f"{nm!r} is not a model parameter")
        self._tvp_names = list(names)
        if values is not None:
            self.set_tvp_values(values)
        return self

    def set_tvp_values(self, values):
        """values: dict name -> (T,) array, or array (T, n_tvp)."""
        if isinstance(values, dict):
            cols = [np.asarray(values[nm], dtype=float).ravel()
                    for nm in self._tvp_names]
            T = max(c.size for c in cols)
            arr = np.stack([np.resize(c, T) for c in cols], axis=1)
        else:
            arr = np.atleast_2d(np.asarray(values, dtype=float))
            if arr.shape[1] != len(self._tvp_names):
                arr = arr.T
        self._tvp_values = arr
        return self

    def set_parameters(self, p):
        self._p_defaults = np.asarray(p, dtype=float).ravel()
        return self

    def add_stage_constraint(self, fn: Callable = None, lb=None, ub=None, n=None,
                             is_soft=False, weight=1e4, max_violation=None,
                             name="stage_constraint"):
        con = make_constraint(fn, lb=lb, ub=ub, n=n, is_soft=is_soft, weight=weight,
                              max_violation=max_violation, name=name,
                              probe_dims=(self._model.n_x, self._model.n_u,
                                          self._model.n_p))
        self._stage_constraints.append(con)
        return self

    def add_terminal_constraint(self, fn: Callable = None, lb=None, ub=None, n=None,
                                is_soft=False, weight=1e4, max_violation=None,
                                name="terminal_constraint"):
        con = make_constraint(fn, lb=lb, ub=ub, n=n, is_soft=is_soft, weight=weight,
                              max_violation=max_violation, name=name,
                              probe_dims=(self._model.n_x, 0, self._model.n_p))
        self._terminal_constraints.append(con)
        return self

    def create_path_variable(self, u_pf_lb: float = 0.0, u_pf_ub: float = np.inf,
                             speed_ref: Optional[float] = None,
                             speed_weight: float = 1.0):
        """Enable path-following mode: augments the OCP with a path parameter state
        theta and virtual path velocity input (reference: mpc.py:1025,1173-1204).
        ``speed_ref`` adds a (u_pf - speed_ref)^2 stage penalty rewarding progress
        along the path."""
        self._path_following = True
        self._path_u_bounds = (float(u_pf_lb), float(u_pf_ub))
        self._path_speed = (None if speed_ref is None
                            else (float(speed_ref), float(speed_weight)))
        return self

    def minimize_final_time(self, weight: float = 1.0, dt_min: float = 1e-3,
                            dt_max: Optional[float] = None):
        """Minimum-time mode: the step length becomes a decision variable
        (reference: minimize_final_time, mpc.py:859 — dt as decision + equality
        chain). Implemented stagewise: a constant state tau carries dt, a virtual
        control adjusts it at stage 0 only (bounds [0,0] elsewhere), and the
        objective gains weight * sum_k dt_k = weight * T."""
        self._min_time = {"weight": float(weight), "dt_min": float(dt_min),
                          "dt_max": (np.inf if dt_max is None else float(dt_max))}
        return self

    # -- setup ----------------------------------------------------------------
    def _trace_signature(self, spec, aug, path, mt, ip_opts, dims):
        """Exhaustive hashable key of everything baked into the solver traces
        (see _TRACE_REGISTRY). Returns (sig, keep) — sig is None when this
        configuration must not be shared (mixed-integer candidate jits bake
        instance bounds as constants)."""
        keep = []
        if self._mi is not None:
            return None, keep
        try:
            msig, mkeep = self._model.trace_signature()
        except Exception:
            return None, keep
        keep += mkeep

        def fid(obj):
            if obj is None:
                return None
            keep.append(obj)
            return ("id", id(obj))

        def term_sig(t):
            return (t.kind, tuple(int(i) for i in t.idx), _arr_key(t.W),
                    _arr_key(t.ref), bool(t.trajectory_tracking),
                    bool(t.path_following), fid(t.path_fn))

        def con_sig(c):
            return (fid(c.fn), int(c.n), _arr_key(c.lb), _arr_key(c.ub),
                    bool(c.is_soft), float(c.weight), float(c.linear_weight),
                    _arr_key(c.max_violation))

        import dataclasses as _dc
        x_soft = np.asarray(self._x_soft, dtype=bool)
        try:
            sig = (
                "nmpc", msig, int(dims.N), int(self.control_horizon),
                float(self._dt),
                (spec.method, spec.degree, spec.scheme, spec.substeps,
                 spec.newton_iters),
                bool(aug), bool(path), bool(mt),
                None if self._min_time is None else (
                    float(self._min_time["weight"]),
                    float(self._min_time["dt_min"]),
                    float(self._min_time["dt_max"])),
                None if self._path_speed is None
                else tuple(map(float, self._path_speed)),
                _arr_key(self._x_scaling), _arr_key(self._u_scaling),
                _arr_key(x_soft), float(self._soft_weight),
                ((_arr_key(self._x_lb), _arr_key(self._x_ub))
                 if x_soft.any() else None),
                tuple(term_sig(t) for t in self.quad_stage_cost.terms),
                tuple(term_sig(t) for t in self.quad_terminal_cost.terms),
                ("empty" if self.stage_cost.is_empty
                 else fid(self.stage_cost.cost)),
                ("empty" if self.terminal_cost.is_empty
                 else fid(self.terminal_cost.cost)),
                tuple(con_sig(c) for c in self._stage_constraints),
                tuple(con_sig(c) for c in self._terminal_constraints),
                tuple(_dc.astuple(ip_opts)),
                bool(jax.config.jax_enable_x64),
            )
            hash(sig)
        except Exception:
            return None, keep
        return sig, keep

    def _shared_jit(self, name, build):
        """Per-configuration lazy jit cache: same-config instances share the
        traced callable built for ``name`` (no registry entry -> private)."""
        ent = getattr(self, "_trace_entry", None)
        if ent is None:
            return build()
        if name not in ent["sites"]:
            ent["sites"][name] = build()
        return ent["sites"][name]

    def setup(self, options: Optional[dict] = None, solver_options: Optional[dict]
              = None, nlp_opts: Optional[dict] = None):
        options = dict(options or {})
        options.update(nlp_opts or {})
        unknown = set(options) - _NLP_OPTION_KEYS
        if unknown:
            raise ValueError(f"unknown options {sorted(unknown)}; "
                             f"valid: {sorted(_NLP_OPTION_KEYS)}")
        if self._horizon is None:
            raise ValueError("set nmpc.horizon before setup()")
        model = self._model
        nx, nu, n_p = model.n_x, model.n_u, model.n_p
        N = self._horizon
        Nc = self.control_horizon
        dt = options.get("dt", model.dt)
        if dt is None:
            raise ValueError("no sampling time: set model.setup(dt=...) or pass "
                             "options={'dt': ...}")
        self._dt = float(dt)
        self._opts = options

        has_du = (any(t.kind == "inputs_change" for t in
                      self.quad_stage_cost.terms + self.quad_terminal_cost.terms)
                  or np.any(np.isfinite(self._du_lb))
                  or np.any(np.isfinite(self._du_ub))
                  or Nc < N)
        self._augment_du = bool(has_du and nu > 0)
        if self._discrete_inputs and self._augment_du:
            raise ValueError(
                "discrete inputs are incompatible with the Δu formulation "
                "(Δu penalties/bounds or control_horizon < horizon): the solver's "
                "control variable would be the input increment, not the input")
        path = self._path_following or any(
            t.path_following for t in
            self.quad_stage_cost.terms + self.quad_terminal_cost.terms)
        self._path_following = path

        mt = self._min_time is not None
        nxs = nx + (nu if self._augment_du else 0) + (1 if path else 0) \
            + (1 if mt else 0)
        nus = nu + (1 if path else 0) + (1 if mt else 0)
        idx_upf = nu                      # virtual path-velocity control
        idx_vtau = nu + (1 if path else 0)  # virtual dt-adjust control
        idx_tau = nxs - 1                 # dt-carrying state (when mt)

        int_method = options.get("integration_method",
                                 "discrete" if model.discrete else "rk4")
        if int_method == "multiple_shooting":
            int_method = "rk4"
        spec = IntegratorSpec(
            method=int_method, degree=options.get("degree", 3),
            scheme=options.get("collocation_scheme", "radau"),
            substeps=options.get("substeps", 1),
            newton_iters=options.get("newton_iters", 8))
        core_step = make_step(model.ode_fn(), model.alg_fn(), nx, model.n_z, spec)
        z_guess_np = (model._z0 if model._z0 is not None else np.zeros(model.n_z))

        sx = self._x_scaling
        su = self._u_scaling

        # theta layout: [t, dt, p (n_p), stage_refs (n_ref_s), term_refs (n_ref_t)]
        stage_ref_terms = [t for t in self.quad_stage_cost.terms if t.runtime_ref]
        term_ref_terms = [t for t in self.quad_terminal_cost.terms if t.runtime_ref]
        n_ref_s = sum(t.n for t in stage_ref_terms)
        n_ref_t = sum(t.n for t in term_ref_terms)
        off_p = 2
        off_rs = off_p + n_p
        off_rt = off_rs + n_ref_s
        self._n_theta = off_rt + n_ref_t
        self._theta_offsets = (off_p, off_rs, off_rt)

        aug = self._augment_du
        meas_fn = model.meas_fn()

        def unpack(xs, us, theta):
            x = xs[:nx] * jnp.asarray(sx, xs.dtype)
            t = theta[0]
            if mt:
                h = xs[idx_tau] + us[idx_vtau]
            else:
                h = theta[1]
            p = theta[off_p:off_p + n_p]
            if aug:
                u_prev = xs[nx:nx + nu] * jnp.asarray(su, xs.dtype)
                du = us[:nu] * jnp.asarray(su, xs.dtype)
                u = u_prev + du
            else:
                du = jnp.zeros(nu, xs.dtype)
                u = us[:nu] * jnp.asarray(su, xs.dtype)
            th_path = xs[nx + (nu if aug else 0)] if path else jnp.zeros((), xs.dtype)
            return x, u, du, p, t, h, th_path

        def dyn(xs, us, theta):
            x, u, du, p, t, h, th_path = unpack(xs, us, theta)
            zg = jnp.asarray(z_guess_np, xs.dtype)
            x_next, _ = core_step(x, zg, u, p, t, h)
            parts = [x_next / jnp.asarray(sx, xs.dtype)]
            if aug:
                parts.append(u / jnp.asarray(su, xs.dtype))
            if path:
                parts.append((th_path + h * us[idx_upf])[None])
            if mt:
                parts.append(h[None])
            return jnp.concatenate(parts)

        def take_static(vec, idx):
            # static scalar indexing instead of a constant-index gather
            return jnp.stack([vec[int(i)] for i in np.asarray(idx)])

        def quad_terms_cost(terms, ref_offset, x, u, du, p, t, th_path, theta):
            cost = jnp.zeros((), x.dtype)
            off = ref_offset
            for term in terms:
                if term.kind == "states":
                    v = take_static(x, term.idx)
                elif term.kind == "inputs":
                    v = take_static(u, term.idx)
                elif term.kind == "inputs_change":
                    v = take_static(du, term.idx)
                elif term.kind == "measurements":
                    v = take_static(
                        jnp.atleast_1d(meas_fn(x, jnp.zeros(0, x.dtype), u, p, t)),
                        term.idx)
                else:
                    raise ValueError(term.kind)
                if term.path_following and term.path_fn is not None:
                    ref = jnp.atleast_1d(jnp.asarray(term.path_fn(th_path)))
                elif term.runtime_ref:
                    ref = theta[off:off + term.n]
                    off += term.n
                elif term.ref is not None:
                    ref = jnp.asarray(term.ref, x.dtype)
                else:
                    ref = jnp.zeros(term.n, x.dtype)
                e = v - ref
                # unrolled eᵀWe with scalar W entries: no matrix constant and no
                # dot_general in the trace — required by the whole-solve Pallas
                # kernel, and XLA folds it to the same fused multiply-adds
                Wnp = np.asarray(term.W, dtype=float)
                for i in range(term.n):
                    for j in range(term.n):
                        if Wnp[i, j] != 0.0:
                            cost = cost + float(Wnp[i, j]) * e[i] * e[j]
            return cost

        x_pen_ub = np.where(self._x_soft, self._x_ub, np.inf)
        x_pen_lb = np.where(self._x_soft, self._x_lb, -np.inf)
        soft_w = self._soft_weight
        soft_cons_s = [c for c in self._stage_constraints if c.is_soft]
        soft_cons_t = [c for c in self._terminal_constraints if c.is_soft]

        def soft_box_penalty(x):
            if not self._x_soft:
                return 0.0
            ub = jnp.asarray(np.where(np.isfinite(x_pen_ub), x_pen_ub, 1e20), x.dtype)
            lb = jnp.asarray(np.where(np.isfinite(x_pen_lb), x_pen_lb, -1e20), x.dtype)
            viol = jnp.maximum(x - ub, 0.0) + jnp.maximum(lb - x, 0.0)
            return soft_w * jnp.sum(viol ** 2)

        gen_stage = self.stage_cost
        gen_term = self.terminal_cost
        stage_terms = list(self.quad_stage_cost.terms)
        term_terms = list(self.quad_terminal_cost.terms)

        def stage_cost(xs, us, theta):
            x, u, du, p, t, h, th_path = unpack(xs, us, theta)
            c = quad_terms_cost(stage_terms, off_rs, x, u, du, p, t, th_path, theta)
            if not gen_stage.is_empty:
                c = c + gen_stage(x, u, p, t)
            c = c + soft_box_penalty(x)
            for con in soft_cons_s:
                c = c + con.penalty(con.fn(x, u, p, t))
            if path and self._path_speed is not None:
                v_ref, w_pf = self._path_speed
                c = c + w_pf * (us[idx_upf] - v_ref) ** 2
            # integrate stage cost over the sample interval like the reference's
            # quadrature-weighted collocation cost: multiply by dt for invariance
            c = c * h / self._dt
            if mt:
                c = c + self._min_time["weight"] * h
            return c

        def term_cost(xs, theta):
            x = xs[:nx] * jnp.asarray(sx, xs.dtype)
            p = theta[off_p:off_p + n_p]
            t = theta[0]
            th_path = xs[nx + (nu if aug else 0)] if path else jnp.zeros((), xs.dtype)
            u0 = jnp.zeros(nu, xs.dtype)
            c = quad_terms_cost(term_terms, off_rt, x, u0, jnp.zeros(nu, xs.dtype),
                                p, t, th_path, theta)
            if not gen_term.is_empty:
                c = c + gen_term(x, u0, p, t)
            c = c + soft_box_penalty(x)
            for con in soft_cons_t:
                c = c + con.penalty(con.fn(x, u0, p, t))
            return c

        # --- general inequality rows (static row selection; masks resolved here) ---
        hard_s = [(c,) + c.hard_rows() for c in self._stage_constraints]
        hard_t = [(c,) + c.hard_rows() for c in self._terminal_constraints]
        n_h = sum(int(ub_r.sum() + lb_r.sum()) for _, ub_r, lb_r, _, _ in hard_s)
        n_hN = sum(int(ub_r.sum() + lb_r.sum()) for _, ub_r, lb_r, _, _ in hard_t)

        def stage_ineq(xs, us, theta):
            x, u, du, p, t, h, th_path = unpack(xs, us, theta)
            rows = []
            for con, ub_r, lb_r, ub, lb in hard_s:
                g = con.fn(x, u, p, t)
                if ub_r.any():
                    rows.append(g[np.where(ub_r)[0]] - jnp.asarray(ub[ub_r], x.dtype))
                if lb_r.any():
                    rows.append(jnp.asarray(lb[lb_r], x.dtype) - g[np.where(lb_r)[0]])
            return jnp.concatenate(rows) if rows else jnp.zeros(0, xs.dtype)

        def term_ineq(xs, theta):
            x = xs[:nx] * jnp.asarray(sx, xs.dtype)
            p = theta[off_p:off_p + n_p]
            t = theta[0]
            u0 = jnp.zeros(nu, xs.dtype)
            rows = []
            for con, ub_r, lb_r, ub, lb in hard_t:
                g = con.fn(x, u0, p, t)
                if ub_r.any():
                    rows.append(g[np.where(ub_r)[0]] - jnp.asarray(ub[ub_r], x.dtype))
                if lb_r.any():
                    rows.append(jnp.asarray(lb[lb_r], x.dtype) - g[np.where(lb_r)[0]])
            return jnp.concatenate(rows) if rows else jnp.zeros(0, xs.dtype)

        # equality rows (lb == ub) go through the solver's augmented-Lagrangian path
        eq_s = [(c, c.equality_rows()) for c in self._stage_constraints
                if c.equality_rows().any()]
        eq_t = [(c, c.equality_rows()) for c in self._terminal_constraints
                if c.equality_rows().any()]
        n_e = sum(int(r.sum()) for _, r in eq_s)
        n_eN = sum(int(r.sum()) for _, r in eq_t)

        def stage_eq(xs, us, theta):
            x, u, du, p, t, h, th_path = unpack(xs, us, theta)
            rows = []
            for con, r in eq_s:
                g = con.fn(x, u, p, t)
                sel = np.where(r)[0]
                rows.append(g[sel] - jnp.asarray(con.ub[r], x.dtype))
            return jnp.concatenate(rows)

        def term_eq(xs, theta):
            x = xs[:nx] * jnp.asarray(sx, xs.dtype)
            p = theta[off_p:off_p + n_p]
            t = theta[0]
            u0 = jnp.zeros(nu, xs.dtype)
            rows = []
            for con, r in eq_t:
                g = con.fn(x, u0, p, t)
                sel = np.where(r)[0]
                rows.append(g[sel] - jnp.asarray(con.ub[r], x.dtype))
            return jnp.concatenate(rows)

        # the cost Hessian is point-independent iff every term is a true
        # quadratic in the decision variables: no generic costs, no soft
        # penalties (piecewise), no nonlinear measurement maps, no
        # path-parameterized references (nonlinear in theta_path), and no
        # minimum-time stage scaling (cost * dt_k is cubic)
        quad_cost_only = (
            gen_stage.is_empty and gen_term.is_empty
            and not np.asarray(self._x_soft, dtype=bool).any()
            and not soft_cons_s and not soft_cons_t and not mt
            and all(t.kind != "measurements" and not t.path_following
                    for t in stage_terms + term_terms))

        dims = OCPDims(nx=nxs, nu=nus, N=N, n_h=n_h, n_hN=n_hN,
                       n_e=n_e, n_eN=n_eN)
        funcs = OCPFunctions(
            dyn=dyn, stage_cost=stage_cost, term_cost=term_cost,
            stage_ineq=stage_ineq if n_h else None,
            term_ineq=term_ineq if n_hN else None,
            stage_eq=stage_eq if n_e else None,
            term_eq=term_eq if n_eN else None)

        # --- bounds in solver (scaled, augmented) coordinates ---
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self._solver_dtype = dtype
        x_lb_s = (x_pen_lb if self._x_soft else self._x_lb) / sx
        x_ub_s = (x_pen_ub if self._x_soft else self._x_ub) / sx
        if self._x_soft:
            x_lb_s = np.full(nx, -np.inf)
            x_ub_s = np.full(nx, np.inf)
        lbx = np.tile(np.concatenate([x_lb_s, ]), (N + 1, 1))
        ubx = np.tile(np.concatenate([x_ub_s, ]), (N + 1, 1))
        if aug:
            # u bounds as state bounds on the u_prev component (rows 1..N == u_0..N-1)
            u_lb_st = np.tile(self._u_lb / su, (N + 1, 1))
            u_ub_st = np.tile(self._u_ub / su, (N + 1, 1))
            u_lb_st[0] = -np.inf
            u_ub_st[0] = np.inf
            lbx = np.concatenate([lbx, u_lb_st], axis=1)
            ubx = np.concatenate([ubx, u_ub_st], axis=1)
        if path:
            lbx = np.concatenate([lbx, np.zeros((N + 1, 1))], axis=1)
            ubx = np.concatenate([ubx, np.full((N + 1, 1), np.inf)], axis=1)
        if mt:
            lbx = np.concatenate(
                [lbx, np.full((N + 1, 1), self._min_time["dt_min"])], axis=1)
            ubx = np.concatenate(
                [ubx, np.full((N + 1, 1), self._min_time["dt_max"])], axis=1)

        if aug:
            lbu = np.tile(self._du_lb / su, (N, 1))
            ubu = np.tile(self._du_ub / su, (N, 1))
            if Nc < N:
                lbu[Nc:] = 0.0
                ubu[Nc:] = 0.0
        else:
            lbu = np.tile(self._u_lb / su, (N, 1))
            ubu = np.tile(self._u_ub / su, (N, 1))
        if path:
            lbu = np.concatenate([lbu, np.full((N, 1), self._path_u_bounds[0])],
                                 axis=1)
            ubu = np.concatenate([ubu, np.full((N, 1), self._path_u_bounds[1])],
                                 axis=1)
        if mt:
            # dt adjusts only at stage 0; the tau state carries it down the horizon
            v_lb = np.zeros((N, 1))
            v_ub = np.zeros((N, 1))
            v_lb[0] = self._min_time["dt_min"] - self._dt
            v_ub[0] = self._min_time["dt_max"] - self._dt
            lbu = np.concatenate([lbu, v_lb], axis=1)
            ubu = np.concatenate([ubu, v_ub], axis=1)

        self._mi = None
        if self._discrete_inputs:
            mi_dims, mi_levels = [], []
            for name, lv in self._discrete_inputs.items():
                d = model.inputs.index(name)
                if lv is None:
                    lo, hi = self._u_lb[d], self._u_ub[d]
                    if not (np.isfinite(lo) and np.isfinite(hi)):
                        raise ValueError(
                            f"discrete input {name!r}: no levels given and box "
                            f"bounds are not finite — cannot derive the lattice")
                    lv = np.arange(np.ceil(lo), np.floor(hi) + 1.0)
                else:
                    lv = lv[(lv >= self._u_lb[d]) & (lv <= self._u_ub[d])]
                if lv.size < 2:
                    raise ValueError(f"discrete input {name!r}: fewer than 2 "
                                     f"levels remain within the box bounds")
                mi_dims.append(d)
                mi_levels.append(lv / su[d])       # solver works in scaled units
                # relaxed problem spans exactly the level range
                lbu[:, d] = lv.min() / su[d]
                ubu[:, d] = lv.max() / su[d]
            self._mi = {"dims": mi_dims, "levels": mi_levels,
                        "neighbors": int(options.get("mi_neighbors", 12)),
                        "cand_enum": None}
            # exact mode: if the full assignment lattice is small enough, solve
            # every candidate (the count is static, so the batch compiles once)
            max_enum = int(options.get("mi_max_enum", 512))
            log_count = N * float(sum(np.log(lv.size) for lv in self._mi["levels"]))
            if max_enum > 0 and log_count <= np.log(max_enum) + 1e-9:
                import itertools as _it
                entry_levels = [self._mi["levels"][j]
                                for _k in range(N) for j in range(len(mi_dims))]
                cand = np.array(list(_it.product(*entry_levels)), dtype=float)
                self._mi["cand_enum"] = cand.reshape(-1, N, len(mi_dims))

        self._bounds = OCPBounds(
            lbx=jnp.asarray(lbx, dtype), ubx=jnp.asarray(ubx, dtype),
            lbu=jnp.asarray(lbu, dtype), ubu=jnp.asarray(ubu, dtype))
        self._dims = dims
        self._funcs = funcs
        ip_opts = IPOptions(
            max_iter=options.get("max_iter", 40),
            # 1e-6 KKT is routinely unreachable in f32 — follow the dtype
            tol=options.get("tol",
                            1e-6 if dtype == jnp.float64 else 1e-4),
            mu_init=options.get("mu_init", 1e-1),
            convexify=options.get("convexify", True),
            n_linesearch=options.get("n_linesearch", 10),
            early_exit=options.get("early_exit", True),
            record_iterates=options.get("ipopt_debugger", False),
            # opt-in: log-depth pays only where the batch leaves the device
            # idle (few scenarios, long horizons); its extra flops lose at
            # large batch
            parallel_riccati=options.get("parallel_riccati", False),
            # ~30% fewer IP iterations at identical solutions (ignored by the
            # solver when equality constraints are present)
            mehrotra=options.get("mehrotra", True),
            # unrolling the Riccati scans lets XLA fuse across stages — the
            # sweeps dominate iteration time at small nx/nu (tools/profile_ip.py)
            riccati_unroll=options.get("riccati_unroll", 1),
            const_cost_hessian=options.get("const_cost_hessian",
                                           quad_cost_only),
            lin_storage_dtype=options.get("lin_storage_dtype", None),
        )
        self._ip_opts = ip_opts
        self._warm_start = options.get("warm_start", True)
        # cold-start trajectory guess: a zero/held-input ROLLOUT is a good
        # multiple-shooting guess for stable plants but catastrophic for
        # open-loop-unstable ones (a cartpole "falls" along the rollout and
        # every cold solve becomes swing-up from a hanging trajectory —
        # measured 21% convergence at 80 iters vs 100% at ~4 from a
        # constant-x0 guess). "auto" (default) evaluates the NLP cost of
        # both guesses per scenario and keeps the rollout unless it is
        # decisively worse; "rollout"/"constant" force one
        guess_mode = options.get("initial_guess", "auto")
        if guess_mode not in ("auto", "rollout", "constant"):
            raise ValueError(
                f"initial_guess must be 'auto', 'rollout' or 'constant', "
                f"got {guess_mode!r}")
        self._guess_mode = guess_mode

        self._solve_batch_jit = None
        self._guess_cost_jit = None
        # lazy per-instance jits capture funcs/dims at creation — reset on
        # (re-)setup so they rebuild against the current configuration
        self._rti_gn_jit = None
        self._rti_gain_jit = None
        self._rti_gain_batch_jit = None
        self._dyn_step_jit = None
        self._rti = None
        self._rti_batch = None
        sig, _keep = self._trace_signature(spec, aug, path, mt, ip_opts, dims)
        ent = registry_lookup(sig)
        if ent is not None:
            # this configuration was already traced once in this process:
            # adopt the canonical funcs/dims/options OBJECTS so every jit
            # cache keyed on their identity — the base solver here and the
            # RTI/batch sites below — hits instead of retracing
            funcs, dims, ip_opts = ent["funcs"], ent["dims"], ent["ip_opts"]
            self._funcs, self._dims, self._ip_opts = funcs, dims, ip_opts
            self._solve_jit = ent["solve_cold"]
            self._solve_warm_jit = ent["solve_warm"]
            self._rollout_guess_jit = ent["rollout"]
            self._rollout_guess_batch_jit = ent["rollout_batch"]
            self._trace_entry = ent
            self.solution = TimeSeries(model.time_unit)
            self.solution.register("x", model.dynamical_states)
            self.solution.register("u", model.inputs)
            self.solution.register("stats", ["iterations", "kkt_error",
                                             "extime_ms", "converged"])
            self._setup_done = True
            self._time = 0.0
            self._step_count = 0
            self._warm = None
            return self

        # ONE jitted solver shared by cold- and warm-start paths: the warm
        # variant differs only in the initial barrier, which is passed as a
        # RUNTIME scalar (mu0) — one trace, one compiled executable per
        # configuration instead of two (halves per-config trace/compile cost
        # in tests and on remote-compile backends).
        _base_solve = jax.jit(partial(
            solve_ocp, funcs, dims, options=ip_opts, fix_x0=True))
        # warm-started solves (closed loop) start from a near-optimal point: a
        # small initial barrier skips the early centering iterations
        # (mu never increases in the monotone scheme, so don't start too low)
        # 1e-3 saves one IP iteration over 1e-2 at full convergence, incl.
        # online setpoint changes (ref_sc tests)
        _mu_cold = float(ip_opts.mu_init)
        _mu_warm = min(float(ip_opts.mu_init), 1e-3)

        def _solve_cold(b, th, x0s, Xi, Ui):
            return _base_solve(b, th, x0s, Xi, Ui, mu0=_mu_cold)

        def _solve_warm(b, th, x0s, Xi, Ui):
            return _base_solve(b, th, x0s, Xi, Ui, mu0=_mu_warm)

        self._solve_jit = _solve_cold
        self._solve_warm_jit = _solve_warm

        # jitted cold-start rollout (a Python-loop rollout would dispatch N eager
        # ops per scenario — ruinous on remote-compile backends)
        def _rollout_guess(xs0, theta_arr, U_arr):
            def body(xk, inp):
                uk, thk = inp
                xn = dyn(xk, uk, thk)
                return xn, xn

            _, X_tail = jax.lax.scan(body, xs0, (U_arr, theta_arr[:-1]))
            return jnp.concatenate([xs0[None], X_tail], axis=0)

        self._rollout_guess_jit = jax.jit(_rollout_guess)
        self._rollout_guess_batch_jit = jax.jit(jax.vmap(
            _rollout_guess, in_axes=(0, None, None)))

        if sig is not None:
            self._trace_entry = registry_store(sig, {
                "funcs": funcs, "dims": dims, "ip_opts": ip_opts,
                "solve_cold": _solve_cold, "solve_warm": _solve_warm,
                "rollout": self._rollout_guess_jit,
                "rollout_batch": self._rollout_guess_batch_jit,
                "keep": _keep})
        else:
            self._trace_entry = None

        if self._mi is not None:
            # candidate solves: same scenario, different pinned u-bounds per
            # candidate — all bound handling in the solver is traced jnp, so C
            # candidates share ONE compilation and run as a single batched solve
            import dataclasses as _dcm
            mi_opts = _dcm.replace(ip_opts, mu_init=min(ip_opts.mu_init, 1e-2),
                                   record_iterates=False)
            base_bounds = self._bounds

            def _solve_candidate(lbu_c, ubu_c, theta_a, xs0_a, X0, U0):
                b = OCPBounds(lbx=base_bounds.lbx, ubx=base_bounds.ubx,
                              lbu=lbu_c, ubu=ubu_c)
                return solve_ocp(funcs, dims, b, theta_a, xs0_a, X0, U0,
                                 options=mi_opts, fix_x0=True)

            self._solve_mi_jit = jax.jit(jax.vmap(
                _solve_candidate, in_axes=(0, 0, None, None, 0, 0)))
            self._rollout_guess_umany_jit = jax.jit(jax.vmap(
                _rollout_guess, in_axes=(None, None, 0)))

        self.solution = TimeSeries(model.time_unit)
        self.solution.register("x", model.dynamical_states)
        self.solution.register("u", model.inputs)
        # structured per-step solver metrics (SURVEY §5: solve time, KKT residual,
        # iterations as arrays — the reference stores extime/niterations when
        # stats=True, mpc.py:815-835)
        self.solution.register("stats", ["iterations", "kkt_error", "extime_ms",
                                         "converged"])
        self._setup_done = True
        self._time = 0.0
        self._step_count = 0
        self._warm = None
        return self

    def is_setup(self) -> bool:
        return self._setup_done

    # -- theta assembly --------------------------------------------------------
    def _assemble_p_rows(self, cp, tvp, N, step0):
        n_p = self._model.n_p
        p_rows = np.zeros((N + 1, n_p))
        base = np.zeros(n_p)
        if self._p_defaults is not None:
            base[:] = self._p_defaults
        if cp is not None:
            cp = np.asarray(cp, dtype=float).ravel()
            const_idx = [i for i, nm in enumerate(self._model.parameters)
                         if nm not in self._tvp_names]
            if cp.size == n_p:
                base[:] = cp
            elif cp.size == len(const_idx):
                base[const_idx] = cp
            else:
                raise ValueError(f"cp has {cp.size} entries")
        p_rows[:] = base
        if self._tvp_names:
            vals = tvp
            if vals is None:
                if self._tvp_values is None:
                    raise ValueError("time-varying parameters declared but no values")
                T = self._tvp_values.shape[0]
                rows = (step0 + np.arange(N + 1)) % T
                vals = self._tvp_values[rows]
            else:
                vals = np.atleast_2d(np.asarray(vals, dtype=float))
                if vals.shape[0] == 1:
                    vals = np.tile(vals, (N + 1, 1))
                elif vals.shape[0] < N + 1:
                    vals = np.vstack([vals, np.tile(vals[-1], (N + 1 - vals.shape[0],
                                                               1))])
            tvp_idx = [self._model.parameters.index(nm) for nm in self._tvp_names]
            p_rows[:, tvp_idx] = vals[:N + 1]
        return p_rows

    def _ref_dict_column(self, name, value, N, step0, what):
        """One reference column for a named variable from a ref_sc/ref_tc dict
        entry: a scalar holds the setpoint over the horizon; a sequence longer
        than 1 is a time series indexed by the closed-loop step count
        (reference: _parse_trajectory_values, mpc.py:366-473)."""
        v = np.asarray(value, dtype=float).ravel()
        if v.size == 1:
            return np.full(N + 1, float(v[0]))
        if step0 + N + 1 > v.size:
            raise ValueError(
                f"time-varying reference for '{name}' ({what}) has {v.size} "
                f"points but step {step0} needs {step0 + N + 1} "
                f"(horizon {N}); supply more data points")
        return v[step0:step0 + N + 1]

    def _assemble_refs(self, terms, ref_arg, N, step0, terminal=False,
                       ref_dict=None):
        what = "ref_tc" if terminal else "ref_sc"
        if ref_dict is not None:
            known = {n for term in terms if term.runtime_ref for n in term.names}
            unknown = set(ref_dict) - known
            if unknown:
                raise ValueError(
                    f"unknown variable(s) {sorted(unknown)} in {what}: no "
                    f"trajectory-tracking cost term references them "
                    f"(tracked: {sorted(known)})")
        cols = []
        col0 = 0  # running offset into a plain-array ref_arg
        for term in terms:
            if not term.runtime_ref:
                continue
            if ref_dict is not None and any(n in ref_dict for n in term.names):
                block = np.zeros((N + 1, term.n))
                for j, n in enumerate(term.names):
                    if n in ref_dict:
                        block[:, j] = self._ref_dict_column(
                            n, ref_dict[n], N, step0, what)
                    elif term.ref is not None and term.ref.ndim == 1:
                        block[:, j] = term.ref[j]
                cols.append(block)
            elif term.ref is not None and term.ref.ndim == 2:
                T = term.ref.shape[0]
                rows = np.minimum(step0 + np.arange(N + 1), T - 1)
                cols.append(term.ref[rows])
            elif ref_arg is not None:
                r = np.asarray(ref_arg, dtype=float)
                if r.ndim == 1:
                    r = np.tile(r[None, :], (N + 1, 1))
                cols.append(r[:, col0:col0 + term.n])
            elif term.ref is not None:
                cols.append(np.tile(term.ref[None, :], (N + 1, 1)))
            elif term.trajectory_tracking:
                raise ValueError(
                    f"variable(s) {term.names} follow a runtime reference but "
                    f"none was supplied — pass {what}={{name: value}} (or "
                    f"ref=array) to optimize()/run() "
                    f"(reference: mpc.py:418-425)")
            else:
                cols.append(np.zeros((N + 1, term.n)))
            col0 += term.n
        if cols:
            return np.concatenate(cols, axis=1)
        return np.zeros((N + 1, 0))

    def _assemble_theta(self, cp, tvp, ref, N=None, ref_sc=None, ref_tc=None):
        N = N or self._horizon
        step0 = self._step_count
        t_col = self._time + self._dt * np.arange(N + 1)
        dt_col = np.full(N + 1, self._dt)
        p_rows = self._assemble_p_rows(cp, tvp, N, step0)
        refs_s = self._assemble_refs(
            [t for t in self.quad_stage_cost.terms if t.runtime_ref], ref, N,
            step0, ref_dict=ref_sc)
        refs_t = self._assemble_refs(
            [t for t in self.quad_terminal_cost.terms if t.runtime_ref], ref, N,
            step0, terminal=True, ref_dict=ref_tc)
        theta = np.concatenate(
            [t_col[:, None], dt_col[:, None], p_rows, refs_s, refs_t], axis=1)
        return theta

    # -- initial guesses -------------------------------------------------------
    def _solver_x0(self, x0):
        parts = [np.asarray(x0, dtype=float).ravel() / self._x_scaling]
        if self._augment_du:
            parts.append(self._u_old / self._u_scaling)
        if self._path_following:
            parts.append(np.array([self._theta_path0]))
        if self._min_time is not None:
            parts.append(np.array([self._dt]))
        return np.concatenate(parts)

    def _get_guess_cost_jit(self):
        """Vmapped NLP objective along a guess trajectory — drives the
        'auto' cold-start guess selection; shared across same-config
        instances via the trace registry."""
        if getattr(self, "_guess_cost_jit", None) is None:
            funcs = self._funcs

            def traj_cost(X, U, theta):
                c = jnp.sum(jax.vmap(funcs.stage_cost)(X[:-1], U, theta[:-1]))
                return c + funcs.term_cost(X[-1], theta[-1])

            def build():
                return jax.jit(jax.vmap(traj_cost, in_axes=(0, 0, 0)))

            ent = getattr(self, "_trace_entry", None)
            if ent is None:
                self._guess_cost_jit = build()
            else:
                if "guess_cost" not in ent["sites"]:
                    ent["sites"]["guess_cost"] = build()
                self._guess_cost_jit = ent["sites"]["guess_cost"]
        return self._guess_cost_jit

    def _select_cold_guess(self, X_roll_B, xs0_B, U_B, theta_B):
        """Per-scenario cold-start guess (batched shapes): the rollout
        unless 'auto' finds it decisively costlier than the constant-x0
        guess (factor 2 — an unstable plant's fallen rollout is orders of
        magnitude over, a stable plant's rollout never is) or nonfinite."""
        if self._guess_mode == "rollout":
            return X_roll_B
        N = self._dims.N
        Xc_B = np.tile(xs0_B[:, None, :], (1, N + 1, 1))
        if self._guess_mode == "constant":
            return Xc_B
        dtype = self._solver_dtype
        fn = self._get_guess_cost_jit()
        theta_j = jnp.asarray(theta_B, dtype)
        u_j = jnp.asarray(U_B, dtype)
        c_roll = np.asarray(fn(jnp.asarray(X_roll_B, dtype), u_j, theta_j))
        c_const = np.asarray(fn(jnp.asarray(Xc_B, dtype), u_j, theta_j))
        use_const = ~np.isfinite(c_roll) | (c_roll > 2.0 * c_const + 1e-9)
        return np.where(use_const[:, None, None], Xc_B, X_roll_B)

    def _initial_trajectory(self, xs0, theta):
        nxs, nus, N = self._dims.nx, self._dims.nu, self._dims.N
        if self._warm is not None and self._warm_start:
            X_prev, U_prev = self._warm
            X = np.vstack([xs0[None, :], X_prev[2:], X_prev[-1:]])
            U = np.vstack([U_prev[1:], U_prev[-1:]])
            return X, U
        # cold start: hold u_guess, roll the dynamics out
        if self._augment_du:
            U = np.zeros((N, nus))
        else:
            U = np.tile(np.concatenate(
                [self._u_guess / self._u_scaling,
                 np.zeros(1 if self._path_following else 0)]), (N, 1))
        if self._x_guess is not None:
            Xg = np.tile(self._solver_x0(self._x_guess)[None, :], (N + 1, 1))
            Xg[0] = xs0
            return Xg, U
        dtype = self._solver_dtype
        X = np.asarray(self._rollout_guess_jit(
            jnp.asarray(xs0, dtype), jnp.asarray(theta, dtype),
            jnp.asarray(U, dtype)))
        X = np.nan_to_num(X, nan=0.0, posinf=1e3, neginf=-1e3)
        X = self._select_cold_guess(X[None], xs0[None], U[None],
                                    theta[None])[0]
        return X, U

    # -- mixed-integer refinement ---------------------------------------------
    def _mi_candidates(self, U_rel: np.ndarray) -> np.ndarray:
        """Rounding candidates for the discrete inputs from a relaxed solution.

        Returns (C, N, n_d) candidate level assignments. Exact mode (small
        lattice, see mi_max_enum): every assignment. Heuristic mode: nearest
        rounding, floor-/ceil-biased roundings, the top-K most fractional entries
        flipped to their second-nearest level one at a time and in pairs, and all
        K flipped together. C is fixed (duplicates repeat the nearest rounding)
        so the batched candidate solve compiles once.
        """
        mi = self._mi
        if mi["cand_enum"] is not None:
            return mi["cand_enum"]
        N = self._dims.N
        n_d = len(mi["dims"])
        near = np.zeros((N, n_d))
        second = np.zeros((N, n_d))
        floor_c = np.zeros((N, n_d))
        ceil_c = np.zeros((N, n_d))
        frac = np.zeros((N, n_d))
        for j, (d, lv) in enumerate(zip(mi["dims"], mi["levels"])):
            u = np.asarray(U_rel[:, d], dtype=float)
            dist = np.abs(u[:, None] - lv[None, :])          # (N, L)
            order = np.argsort(dist, axis=1)
            rows = np.arange(N)
            near[:, j] = lv[order[:, 0]]
            second[:, j] = lv[order[:, 1]]
            # fractionality: how close the relaxed value sits to the midpoint
            # between its two nearest levels (1 = exactly between, 0 = on-level)
            frac[:, j] = dist[rows, order[:, 0]] / np.maximum(
                dist[rows, order[:, 1]], 1e-12)
            below = u[:, None] >= lv[None, :] - 1e-12
            floor_c[:, j] = np.where(below.any(axis=1),
                                     lv[np.maximum(below.sum(axis=1) - 1, 0)],
                                     lv[0])
            above = u[:, None] <= lv[None, :] + 1e-12
            ceil_c[:, j] = np.where(above.any(axis=1),
                                    lv[np.minimum(lv.size - above.sum(axis=1),
                                                  lv.size - 1)],
                                    lv[-1])
        K_cfg = mi["neighbors"]
        K = min(K_cfg, N * n_d)
        cands = [near, floor_c, ceil_c]
        flat = frac.ravel()
        top = np.argsort(-flat)[:K]
        all_flipped = near.copy()
        for idx in top:
            k, j = np.unravel_index(idx, (N, n_d))
            flip = near.copy()
            flip[k, j] = second[k, j]
            cands.append(flip)
            all_flipped[k, j] = second[k, j]
        # pairwise flips of the most fractional entries cover Hamming-distance-2
        # optima that single flips miss
        import itertools as _it
        P = min(K_cfg, 8)
        for ia, ib in _it.combinations(top[:min(K, 8)], 2):
            ka, ja = np.unravel_index(ia, (N, n_d))
            kb, jb = np.unravel_index(ib, (N, n_d))
            flip = near.copy()
            flip[ka, ja] = second[ka, ja]
            flip[kb, jb] = second[kb, jb]
            cands.append(flip)
        cands.append(all_flipped)
        C_total = 4 + K_cfg + P * (P - 1) // 2
        while len(cands) < C_total:    # keep C static across steps
            cands.append(near)
        return np.stack(cands[:C_total], axis=0)

    def _mi_refine(self, theta, xs0, U_rel, dtype):
        """Pin each rounding candidate (lbu == ubu on the discrete dims) and solve
        the whole candidate batch in one vmapped interior-point call; return the
        best converged candidate's solution."""
        mi = self._mi
        cand = self._mi_candidates(np.asarray(U_rel))        # (C, N, n_d)
        C = cand.shape[0]
        lbu = np.broadcast_to(np.asarray(self._bounds.lbu), (C,) +
                              self._bounds.lbu.shape).copy()
        ubu = np.broadcast_to(np.asarray(self._bounds.ubu), (C,) +
                              self._bounds.ubu.shape).copy()
        U_c = np.broadcast_to(np.asarray(U_rel), (C,) + U_rel.shape).copy()
        for j, d in enumerate(mi["dims"]):
            lbu[:, :, d] = cand[:, :, j]
            ubu[:, :, d] = cand[:, :, j]
            U_c[:, :, d] = cand[:, :, j]
        X_c = self._rollout_guess_umany_jit(
            jnp.asarray(xs0, dtype), jnp.asarray(theta, dtype),
            jnp.asarray(U_c, dtype))
        X_c = jnp.nan_to_num(X_c, nan=0.0, posinf=1e3, neginf=-1e3)
        sols = self._solve_mi_jit(
            jnp.asarray(lbu, dtype), jnp.asarray(ubu, dtype),
            jnp.asarray(theta, dtype), jnp.asarray(xs0, dtype),
            X_c, jnp.asarray(U_c, dtype))
        conv = np.asarray(sols.converged)
        obj = np.asarray(sols.objective, dtype=float)
        if conv.any():
            masked = np.where(conv, obj, np.inf)
            i = int(np.argmin(masked))
        else:
            i = int(np.argmin(np.asarray(sols.kkt_error)))
        sol = jax.tree_util.tree_map(lambda a: a[i], sols)
        X = np.array(sol.X)
        U = np.array(sol.U)
        for j, d in enumerate(mi["dims"]):
            U[:, d] = cand[i, :, j]    # snap: pin is a stiff quadratic, not exact
        info = {"mi_candidates": C, "mi_feasible": int(conv.sum()),
                "mi_pick": i}
        return sol, X, U, info

    # -- solve -----------------------------------------------------------------
    def optimize(self, x0, cp=None, tvp=None, ref=None, runs: int = 1,
                 seed: int = 0, ref_sc=None, ref_tc=None):
        """One MPC step: solve the horizon problem from measured state x0 and return
        the first control move (reference: mpc.py:744-857). ref_sc / ref_tc map
        variable names to stage/terminal reference values (scalar setpoint or a
        time series) for trajectory-tracking cost terms, like the reference's
        optimize kwargs (mpc.py:366-473)."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        for nm, d in (("ref_sc", ref_sc), ("ref_tc", ref_tc)):
            if d is not None and not isinstance(d, dict):
                raise TypeError(f"{nm} must be a dict mapping variable names to "
                                f"reference values, got {type(d).__name__}")
        t_wall = _time.perf_counter()
        x0 = np.asarray(x0, dtype=float).ravel()
        if x0.size != self._model.n_x:
            raise ValueError(f"x0 has {x0.size} entries, expected {self._model.n_x} "
                             f"({self._model.dynamical_states})")
        theta = self._assemble_theta(cp, tvp, ref, ref_sc=ref_sc, ref_tc=ref_tc)
        xs0 = self._solver_x0(x0)
        X_init, U_init = self._initial_trajectory(xs0, theta)
        dtype = self._solver_dtype
        solver = (self._solve_warm_jit
                  if (self._warm is not None and self._warm_start)
                  else self._solve_jit)
        sol = solver(
            self._bounds,
            jnp.asarray(theta, dtype), jnp.asarray(xs0, dtype),
            jnp.asarray(X_init, dtype), jnp.asarray(U_init, dtype))
        if self._ip_opts.record_iterates:
            sol, history = sol
            self.iteration_history = {k: np.asarray(v) for k, v in history.items()}
        X = np.asarray(sol.X)
        U = np.asarray(sol.U)

        if runs > 1:
            # multi-start: perturbed initial guesses, keep the best converged
            # objective (reference: runs kwarg, mpc.py:727-741) — run them all;
            # a "converged" first solve may sit on a stationary hump of a
            # nonconvex cost
            rng = np.random.default_rng(seed)
            best_obj = float(sol.objective) if bool(sol.converged) else np.inf
            for _ in range(runs - 1):
                U_r = U_init + 0.5 * rng.standard_normal(U_init.shape)
                sol_r = self._solve_jit(
                    self._bounds, jnp.asarray(theta, dtype), jnp.asarray(xs0, dtype),
                    jnp.asarray(X_init, dtype), jnp.asarray(U_r, dtype))
                if bool(sol_r.converged) and float(sol_r.objective) < best_obj:
                    sol, best_obj = sol_r, float(sol_r.objective)
                    X, U = np.asarray(sol.X), np.asarray(sol.U)

        mi_info = {}
        if self._mi is not None:
            relaxed_obj = float(sol.objective)
            sol, X, U, mi_info = self._mi_refine(theta, xs0, U, dtype)
            # integrality gap: discrete-feasible objective vs relaxed lower bound
            mi_info["mi_gap"] = float(sol.objective) - relaxed_obj

        nx, nu = self._model.n_x, self._model.n_u
        if self._augment_du:
            u0 = (X[1, nx:nx + nu]) * self._u_scaling
        else:
            u0 = U[0, :nu] * self._u_scaling
        self._warm = (X, U)
        self._u_old = u0.copy()
        if self._path_following:
            idx_path = nx + (nu if self._augment_du else 0)
            self._theta_path0 = float(X[1, idx_path])
        if self._min_time is not None:
            self.optimal_dt = float(X[-1, -1])
            self.optimal_final_time = self.optimal_dt * self._horizon
        self.last_prediction = {
            "x": X[:, :nx] * self._x_scaling,
            "u": (X[1:, nx:nx + nu] * self._u_scaling if self._augment_du
                  else U[:, :nu] * self._u_scaling),
            "t": self._time + self._dt * np.arange(self._horizon + 1),
        }
        self._time += self._dt
        self._step_count += 1
        self.stats = {
            "iterations": int(sol.iterations),
            "kkt_error": float(sol.kkt_error),
            "objective": float(sol.objective),
            "converged": bool(sol.converged),
            "status": int(sol.status),
            "extime": _time.perf_counter() - t_wall,
            **mi_info,
        }
        if self.solution is not None:
            self.solution.append(
                self._time, x=x0, u=u0,
                stats=np.array([self.stats["iterations"],
                                self.stats["kkt_error"],
                                self.stats["extime"] * 1e3,
                                float(self.stats["converged"])]))
        return u0

    # -- real-time iteration (prepare / feedback split) ----------------------
    def _build_rti_gain(self):
        """Jitted first-stage Riccati feedback gain at a solved trajectory.

        Linearizes the dynamics and quadratizes the cost along (X, U), runs the
        backward Riccati sweep (ops/riccati.py) and returns K_0 — the
        Gauss-Newton approximation of ∂u0*/∂x0 (cost curvature only; the
        λᵀ∇²f Lagrangian term is omitted, standard for RTI schemes — validated
        against finite-difference NLP sensitivities in tests/test_rti.py). The
        feedback phase applies u_0 + K_0 δx0 (projected onto the input box),
        the tangential predictor of advanced-step / real-time-iteration NMPC.
        Beyond the reference: CasADi/IPOPT has no prepare/feedback split
        (reference solves the full NLP in the loop, mpc.py:1778-1787).
        """
        funcs, dims = self._funcs, self._dims
        from ..ops.riccati import backward_sweep

        def gain(X, U, theta):
            def lin(x, u, th):
                A = jax.jacobian(funcs.dyn, argnums=0)(x, u, th)
                B = jax.jacobian(funcs.dyn, argnums=1)(x, u, th)
                return A, B

            def quad(x, u, th):
                Q = jax.hessian(funcs.stage_cost, argnums=0)(x, u, th)
                R = jax.hessian(funcs.stage_cost, argnums=1)(x, u, th)
                S = jax.jacobian(jax.grad(funcs.stage_cost, argnums=1),
                                 argnums=0)(x, u, th)
                return Q, R, S

            A, B = jax.vmap(lin)(X[:-1], U, theta[:-1])
            Q, R, S = jax.vmap(quad)(X[:-1], U, theta[:-1])
            P_T = jax.hessian(lambda x: funcs.term_cost(x, theta[-1]))(X[-1])
            nxs, nus, N = dims.nx, dims.nu, dims.N
            zq = jnp.zeros((N, nxs), X.dtype)
            zr = jnp.zeros((N, nus), X.dtype)
            zc = jnp.zeros((N, nxs), X.dtype)
            K, *_ = backward_sweep(A, B, Q, S, R, zq, zr, zc, P_T,
                                   jnp.zeros(nxs, X.dtype), reg=1e-8)
            return K[0]

        return gain

    def _get_rti_gn_jit(self):
        """Fixed-iteration prepare solver for classical RTI: exactly
        ``rti_gn_iterations`` Gauss-Newton/barrier steps (each = one Riccati
        factor+solve), no convergence early-exit, warm barrier."""
        k = int(self.rti_gn_iterations)
        if self._rti_gn_jit is None or self._rti_gn_jit[0] != k:
            import dataclasses as _dc
            opts = _dc.replace(self._ip_opts, max_iter=k, early_exit=False,
                               mu_init=min(self._ip_opts.mu_init, 1e-3),
                               record_iterates=False)
            solver = partial(solve_ocp, self._funcs, self._dims,
                             options=opts, fix_x0=True)
            self._rti_gn_jit = (k, self._shared_jit(
                f"rti_gn:{k}",
                lambda: jax.jit(
                    lambda b, th, x0, Xi, Ui: solver(b, th, x0, Xi, Ui))))
        return self._rti_gn_jit[1]

    def rti_prepare(self, x_pred=None, cp=None, tvp=None, ref=None,
                    ref_sc=None, ref_tc=None):
        """Preparation phase of real-time-iteration NMPC: solve the horizon
        problem at the PREDICTED next state (before the measurement exists)
        and cache the first input plus the first-stage Riccati feedback gain.
        ``rti_feedback(x0)`` then returns the control for the measured state
        in microseconds — control latency is decoupled from solve latency.

        ``x_pred`` defaults to the one-step-ahead prediction of the previous
        step; the first call must pass it explicitly. The reference has no
        such split (every loop step pays a full IPOPT solve,
        mpc.py:1778-1787)."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if (self._path_following or self._min_time is not None
                or self._mi is not None):
            raise NotImplementedError(
                "RTI mode supports the standard and Δu-augmented NMPC "
                "formulations (no path following, minimum time or discrete "
                "inputs)")
        t0 = _time.perf_counter()
        nx = self._model.n_x
        if x_pred is None:
            pend = self._rti_pending
            if pend is not None:
                # propagate the measured state under the applied move — the
                # device call the feedback phase deliberately skips so its
                # latency stays in numpy territory
                if self._dyn_step_jit is None:
                    self._dyn_step_jit = self._shared_jit(
                        "dyn_step", lambda: jax.jit(self._funcs.dyn))
                dtype_ = self._solver_dtype
                xs_pred = np.asarray(self._dyn_step_jit(
                    jnp.asarray(pend["xs0"], dtype_),
                    jnp.asarray(pend["U"][0], dtype_),
                    jnp.asarray(pend["theta"][0], dtype_)))
                x_pred = xs_pred[:nx] * self._x_scaling
            elif self.last_prediction is not None:
                x_pred = self.last_prediction["x"][1]
            else:
                raise RuntimeError(
                    "no prediction available yet — pass x_pred= on the first "
                    "rti_prepare() call (e.g. the current measured state)")
        x_pred = np.asarray(x_pred, dtype=float).ravel()
        if x_pred.size != self._model.n_x:
            raise ValueError(f"x_pred has {x_pred.size} entries, expected "
                             f"{self._model.n_x}")
        self._rti_pending = None
        theta = self._assemble_theta(cp, tvp, ref, ref_sc=ref_sc,
                                     ref_tc=ref_tc)
        xs_pred = self._solver_x0(x_pred)
        X_init, U_init = self._initial_trajectory(xs_pred, theta)
        dtype = self._solver_dtype
        if self.rti_gn_iterations:
            # classical RTI: exactly k Gauss-Newton/barrier iterations from the
            # shifted previous trajectory (k=1 = one Riccati solve per prepare)
            solver = self._get_rti_gn_jit()
        else:
            solver = (self._solve_warm_jit
                      if (self._warm is not None and self._warm_start)
                      else self._solve_jit)
        sol = solver(self._bounds, jnp.asarray(theta, dtype),
                     jnp.asarray(xs_pred, dtype), jnp.asarray(X_init, dtype),
                     jnp.asarray(U_init, dtype))
        if self._ip_opts.record_iterates and not self.rti_gn_iterations:
            sol, history = sol
            self.iteration_history = {k: np.asarray(v)
                                      for k, v in history.items()}
        X, U = np.asarray(sol.X), np.asarray(sol.U)
        if self._rti_gain_jit is None:
            self._rti_gain_jit = self._shared_jit(
                "rti_gain", lambda: jax.jit(self._build_rti_gain()))
        K0 = np.asarray(self._rti_gain_jit(sol.X, sol.U,
                                           jnp.asarray(theta, dtype)))
        self._warm = (X, U)
        nu = self._model.n_u
        # Timestamp convention: rti_feedback advances self._time BEFORE the
        # next prepare, so self._time is already the sampling instant of
        # x_pred both on the pending-propagation path and on the first
        # explicit-x_pred call — the horizon base is self._time in either case.
        self.last_prediction = {
            "x": X[:, :nx] * self._x_scaling,
            "u": (X[1:, nx:nx + nu] * self._u_scaling if self._augment_du
                  else U[:, :nu] * self._u_scaling),
            "t": self._time + self._dt * np.arange(self._horizon + 1),
        }
        self._rti = {
            "xs_pred": xs_pred, "theta": theta, "X": X, "U": U, "K0": K0,
            "stats": {"iterations": int(sol.iterations),
                      "kkt_error": float(sol.kkt_error),
                      "objective": float(sol.objective),
                      "converged": bool(sol.converged),
                      "status": int(sol.status),
                      "mode": ("rti-gn" if self.rti_gn_iterations else "rti"),
                      "t_prepare": _time.perf_counter() - t0},
        }
        return self._rti["stats"]

    def rti_feedback(self, x0):
        """Feedback phase: instant control for the measured state.

        Applies the projected tangential predictor
        ``u_0 = clip(u_0* + K_0 (x0 − x_pred))`` using the gain cached by
        ``rti_prepare`` — a few numpy flops, NO device call (the prediction
        refresh is deferred to the next ``rti_prepare``), so the latency is
        microseconds even on remote-dispatch backends. Updates the solution
        series like ``optimize``."""
        if self._rti is None:
            raise RuntimeError("call rti_prepare() first")
        t0 = _time.perf_counter()
        x0 = np.asarray(x0, dtype=float).ravel()
        if x0.size != self._model.n_x:
            raise ValueError(f"x0 has {x0.size} entries, expected "
                             f"{self._model.n_x}")
        d = self._rti
        xs0 = self._solver_x0(x0)
        U = d["U"].copy()
        U[0] = U[0] + d["K0"] @ (xs0 - d["xs_pred"])
        lbu = np.asarray(self._bounds.lbu)[0]
        ubu = np.asarray(self._bounds.ubu)[0]
        U[0] = np.clip(U[0], lbu, ubu)
        nx, nu = self._model.n_x, self._model.n_u
        if self._augment_du:
            # solver controls are Δu; reconstruct u = u_prev + Δu, clip to the
            # u bounds (kept as state bounds on the augmented rows), and fold
            # any clipping back into Δu so the pending propagation is exact
            u_s = xs0[nx:nx + nu] + U[0, :nu]
            u_s = np.clip(u_s, np.asarray(self._bounds.lbx)[1, nx:nx + nu],
                          np.asarray(self._bounds.ubx)[1, nx:nx + nu])
            U[0, :nu] = u_s - xs0[nx:nx + nu]
            u0 = u_s * self._u_scaling
        else:
            u0 = U[0, :nu] * self._u_scaling
        self._u_old = u0.copy()
        # NO device call here: the feedback phase is pure numpy (a matvec, a
        # clip) so its latency is microseconds even on remote backends; the
        # prediction refresh from (xs0, u0) happens in the NEXT rti_prepare
        self._rti_pending = {"xs0": xs0, "U": U, "theta": d["theta"]}
        self._time += self._dt
        self._step_count += 1
        self.stats = {**d["stats"], "phase": "rti",
                      "t_feedback": _time.perf_counter() - t0,
                      "extime": d["stats"]["t_prepare"]}
        if self.solution is not None:
            self.solution.append(
                self._time, x=x0, u=u0,
                stats=np.array([self.stats["iterations"],
                                self.stats["kkt_error"],
                                self.stats["t_feedback"] * 1e3,
                                float(self.stats["converged"])]))
        self._rti = None
        return u0

    def print_stats(self):
        """Per-step solver statistics summary (p50/p99 solve time, iterations,
        convergence rate) over the recorded closed-loop run."""
        st = self.solution.get("stats") if self.solution is not None else None
        if st is None or st.shape[1] == 0:
            print("no recorded solves")
            return
        it, kkt, ms, conv = st
        print(f"solves: {it.size} | converged {100 * np.nanmean(conv):.1f}% | "
              f"iterations p50={np.nanmedian(it):.0f} max={np.nanmax(it):.0f} | "
              f"solve time p50={np.nanpercentile(ms, 50):.1f} ms "
              f"p99={np.nanpercentile(ms, 99):.1f} ms | "
              f"kkt p50={np.nanmedian(kkt):.2e}")

    def __str__(self):
        feats = []
        if self._setup_done:
            feats.append(f"N={self._horizon}")
            if self.control_horizon != self._horizon:
                feats.append(f"Nc={self.control_horizon}")
            feats.append(f"dt={self._dt}")
            if self._augment_du:
                feats.append("du-augmented")
            if self._path_following:
                feats.append("path-following")
            if self._min_time is not None:
                feats.append("min-time")
            if self._dims.n_e or self._dims.n_eN:
                feats.append(f"equalities={self._dims.n_e + self._dims.n_eN}")
            if self._dims.n_h or self._dims.n_hN:
                feats.append(f"custom-ineqs={self._dims.n_h + self._dims.n_hN}")
        state = ", ".join(feats) if feats else "not set up"
        lines = [f"{self._controller_type} {self.name!r} on model "
                 f"{self._model.name!r} ({state})"]
        if self.stats:
            lines.append(
                f"  last solve: {'converged' if self.stats.get('converged') else 'NOT converged'}"
                f" in {self.stats.get('iterations')} iterations, "
                f"kkt={self.stats.get('kkt_error'):.2e}, "
                f"{self.stats.get('extime', 0) * 1e3:.1f} ms")
        return "\n".join(lines)

    def return_prediction(self):
        return self.last_prediction

    def plot_prediction(self, save_plot=False, plot_dir=None,
                        name_file="mpc_prediction.png", show_plot=False,
                        extras=None, extras_names=None, title=None):
        """Plot the MPC's predicted state/input trajectories from the last
        solve (reference: plot_prediction, mpc.py:868-1024 — bokeh there;
        matplotlib here, same extras-overlay contract: ``extras`` maps
        state/input names to arrays plotted over the prediction)."""
        if self.last_prediction is None:
            raise RuntimeError("call optimize() before plot_prediction()")
        from ..utils.plotting import get_plot_backend
        if get_plot_backend() == "bokeh":
            from ..utils.plotting_bokeh import plot_prediction_bokeh
            import os
            save_as = (os.path.join(plot_dir or "",
                                    str(name_file).replace(".png", ".html"))
                       if save_plot else None)
            return plot_prediction_bokeh(
                self.last_prediction, self._model.dynamical_states,
                self._model.inputs, extras=extras,
                extras_names=extras_names, save_as=save_as, title=title,
                time_unit=self._model.time_unit)
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        pred = self.last_prediction
        x_names = list(self._model.dynamical_states)
        u_names = list(self._model.inputs)
        t = np.asarray(pred["t"])
        n_panels = len(x_names) + len(u_names)
        fig, axes = plt.subplots(n_panels, 1, figsize=(8, 2.2 * n_panels),
                                 sharex=True, squeeze=False)
        axes = axes.ravel()
        extras = extras or {}
        extras_names = list(extras_names or [])
        # tolerate a short extras_names list: fall back to the extras key
        keys = list(extras)
        extras_names += keys[len(extras_names):]

        def _extra_label(nm):
            return extras_names[keys.index(nm)]
        for i, nm in enumerate(x_names):
            axes[i].plot(t, np.asarray(pred["x"])[:, i], "-o", ms=3,
                         label="prediction")
            if nm in extras:
                e = np.asarray(extras[nm]).ravel()
                axes[i].plot(t[:e.size], e, "--",
                             label=_extra_label(nm))
            axes[i].set_ylabel(nm)
            axes[i].legend(loc="best", fontsize=8)
        for j, nm in enumerate(u_names):
            ax = axes[len(x_names) + j]
            u = np.asarray(pred["u"])[:, j]
            ax.step(t[:u.size], u, where="post", label="prediction")
            if nm in extras:
                e = np.asarray(extras[nm]).ravel()
                ax.step(t[:e.size], e, "--", where="post",
                        label=_extra_label(nm))
            ax.set_ylabel(nm)
            ax.legend(loc="best", fontsize=8)
        axes[-1].set_xlabel(f"time [{self._model.time_unit}]")
        if title:
            fig.suptitle(title)
        fig.tight_layout()
        if save_plot:
            import os
            path = (os.path.join(plot_dir, name_file) if plot_dir
                    else name_file)
            fig.savefig(path, dpi=120)
        if show_plot:  # pragma: no cover - interactive
            plt.show()
        return fig

    def plot_iterations(self, save_as=None, show=False):
        """Visualize the recorded IP iterate history (reference: plot_iterations,
        optimizer.py:1562 + IpoptDebugger). Requires
        setup(options={'ipopt_debugger': True})."""
        hist = getattr(self, "iteration_history", None)
        if hist is None:
            raise RuntimeError("enable options={'ipopt_debugger': True} and call "
                               "optimize() first")
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        n = int(hist["n"])
        fig, axes = plt.subplots(3, 1, figsize=(8, 9))
        its = np.arange(n)
        axes[0].semilogy(its, np.maximum(hist["kkt"][:n], 1e-16), "-o", ms=3)
        axes[0].set_ylabel("KKT error")
        axes[1].semilogy(its, np.maximum(hist["mu"][:n], 1e-16), "-o", ms=3)
        axes[1].set_ylabel("barrier mu")
        nu = self._model.n_u
        for it in range(0, n, max(1, n // 8)):
            axes[2].plot(hist["U"][it, :, :nu].ravel(), alpha=0.4)
        axes[2].plot(hist["U"][max(n - 1, 0), :, :nu].ravel(), "k", lw=2,
                     label="final")
        axes[2].set_ylabel("u trajectory per iterate")
        axes[2].legend()
        for ax in axes:
            ax.grid(alpha=0.3)
        fig.tight_layout()
        if save_as:
            fig.savefig(save_as, dpi=120)
        if show:
            plt.show()
        return fig

    # -- batched solve (fleet path) -------------------------------------------
    def solve_batch_fn(self, warm: bool = False):
        """Return a jitted function (theta_B, xs0_B, X_init_B, U_init_B) -> OCPSolution
        batched over scenarios — the fleet path (BASELINE.json configs[0]).

        warm=True uses the warm-start barrier schedule (smaller mu_init): pass
        it when the initial trajectories come from a previous solution (the
        closed-loop regime) — one fewer IP iteration at the same accuracy.
        """
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        opts = self._ip_opts
        # warm vs cold differ only in the initial barrier — passed as a
        # runtime scalar below so both variants share one executable
        mu_val = (min(float(opts.mu_init), 1e-3) if warm
                  else float(opts.mu_init))
        bounds = self._bounds

        funcs, dims = self._funcs, self._dims

        # bounds and mu0 are runtime args (not closure constants), so one
        # traced executable serves every same-config instance and both the
        # warm and cold barrier schedules (_shared_jit / _TRACE_REGISTRY)
        def _build():
            def solve_many(b, theta_B, xs0_B, X_B, U_B, mu0):
                return jax.vmap(lambda th, x0s, Xi, Ui: solve_ocp(
                    funcs, dims, b, th, x0s, Xi, Ui, options=opts,
                    fix_x0=True, mu0=mu0))(theta_B, xs0_B, X_B, U_B)
            return jax.jit(solve_many)

        jfn = self._shared_jit("solve_batch", _build)
        return lambda th, x0s, Xi, Ui: jfn(bounds, th, x0s, Xi, Ui, mu_val)

    def prepare_batch(self, x0_batch, cp=None, tvp=None, ref=None,
                      u_prev=None):
        """Vectorized solver inputs for B scenarios:
        (theta_B, xs0_B, X_init_B, U_init_B), cold-started via one jitted rollout.

        ``u_prev`` (B, n_u): per-scenario previous inputs for the Δu-augmented
        formulation (each scenario's u_prev rides in its augmented solver
        state); defaults to this controller's scalar ``_u_old`` for every
        scenario."""
        x0_batch = np.atleast_2d(np.asarray(x0_batch, dtype=float))
        B = x0_batch.shape[0]
        theta = self._assemble_theta(cp, tvp, ref)
        dtype = self._solver_dtype
        N, nus = self._dims.N, self._dims.nu
        if u_prev is not None and not self._augment_du:
            raise ValueError("u_prev is only meaningful for the Δu-augmented "
                             "formulation (Δu costs/bounds or Nc < N)")
        xs0 = np.asarray([self._solver_x0(x0_batch[i]) for i in range(B)])
        if u_prev is not None:
            u_prev = np.atleast_2d(np.asarray(u_prev, dtype=float))
            nx, nu = self._model.n_x, self._model.n_u
            if u_prev.shape != (B, nu):
                raise ValueError(f"u_prev has shape {u_prev.shape}, expected "
                                 f"{(B, nu)}")
            xs0[:, nx:nx + nu] = u_prev / self._u_scaling
        if self._augment_du:
            U = np.zeros((N, nus))
        else:
            U = np.tile(np.concatenate(
                [self._u_guess / self._u_scaling,
                 np.zeros(1 if self._path_following else 0)]), (N, 1))
        X_B = np.asarray(self._rollout_guess_batch_jit(
            jnp.asarray(xs0, dtype), jnp.asarray(theta, dtype),
            jnp.asarray(U, dtype)))
        X_B = np.nan_to_num(X_B, nan=0.0, posinf=1e3, neginf=-1e3)
        U_B = np.tile(U[None], (B, 1, 1))
        theta_B = np.tile(theta[None], (B, 1, 1))
        X_B = self._select_cold_guess(X_B, xs0, U_B, theta_B)
        return (jnp.asarray(theta_B, dtype), jnp.asarray(xs0, dtype),
                jnp.asarray(X_B, dtype), jnp.asarray(U_B, dtype))

    def rti_prepare_batch(self, x_pred_batch, cp=None, tvp=None, ref=None,
                          warm: bool = False, u_prev=None):
        """Batched RTI preparation: solve B horizon problems at the predicted
        states AND extract every first-stage Riccati gain, all in one device
        dispatch. ``rti_feedback_batch(x0_batch)`` then answers B measured
        states with a single numpy einsum — the scenario-fleet analogue of
        ``rti_prepare``/``rti_feedback``.

        ``warm=True`` (fleet closed-loop regime) shift-initializes every
        scenario from the previous batch solution and uses the warm-start
        barrier schedule — same semantics as the scalar warm path.

        Δu-augmented formulations are supported: each scenario's previous
        input rides in its augmented solver state. ``u_prev`` (B, n_u)
        overrides it explicitly; by default the fleet's applied inputs are
        carried step-to-step by ``rti_feedback_batch`` (zeros before the
        first feedback, like the scalar path's ``_u_old``)."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if (self._path_following
                or self._min_time is not None or self._mi is not None):
            raise NotImplementedError(
                "batched RTI supports the standard and Δu-augmented NMPC "
                "formulations (no path following, minimum time or discrete "
                "inputs)")
        if self._solve_batch_jit is None:
            self._solve_batch_jit = self.solve_batch_fn()
        if getattr(self, "_rti_gain_batch_jit", None) is None:
            self._rti_gain_batch_jit = self._shared_jit(
                "rti_gain_batch",
                lambda: jax.jit(jax.vmap(self._build_rti_gain())))
        if self._augment_du and u_prev is None:
            u_old = getattr(self, "_rti_batch_u_old", None)
            B = np.atleast_2d(np.asarray(x_pred_batch)).shape[0]
            if u_old is not None and u_old.shape[0] == B:
                u_prev = u_old
            else:
                u_prev = np.zeros((B, self._model.n_u))
        args = self.prepare_batch(x_pred_batch, cp, tvp, ref, u_prev=u_prev)
        prev = getattr(self, "_rti_batch_warm", None)
        use_warm = (warm and prev is not None
                    and prev[0].shape == args[2].shape)
        if use_warm:
            X_prev, U_prev = prev
            # shift-initialization per scenario (cf. _initial_trajectory)
            xs0 = np.asarray(args[1])
            X_w = np.concatenate(
                [xs0[:, None], X_prev[:, 2:], X_prev[:, -1:]], axis=1)
            U_w = np.concatenate([U_prev[:, 1:], U_prev[:, -1:]], axis=1)
            dtype = self._solver_dtype
            args = (args[0], args[1], jnp.asarray(X_w, dtype),
                    jnp.asarray(U_w, dtype))
            if getattr(self, "_solve_batch_warm_jit", None) is None:
                self._solve_batch_warm_jit = self.solve_batch_fn(warm=True)
            sol = self._solve_batch_warm_jit(*args)
        else:
            sol = self._solve_batch_jit(*args)
        K0_B = np.asarray(self._rti_gain_batch_jit(sol.X, sol.U, args[0]))
        xs_pred_B = np.asarray(args[1])
        self._rti_batch_warm = (np.asarray(sol.X), np.asarray(sol.U))
        self._rti_batch = {
            "xs_pred": xs_pred_B, "U": np.asarray(sol.U), "K0": K0_B,
            "converged": np.asarray(sol.converged),
        }
        return self._rti_batch

    def rti_feedback_batch(self, x0_batch):
        """Batched feedback phase: (B, n_u) first moves for B measured states
        from the gains cached by ``rti_prepare_batch`` — one einsum + clip,
        no device call."""
        if getattr(self, "_rti_batch", None) is None:
            raise RuntimeError("call rti_prepare_batch() first")
        d = self._rti_batch
        x0_batch = np.atleast_2d(np.asarray(x0_batch, dtype=float))
        B = x0_batch.shape[0]
        if B != d["xs_pred"].shape[0]:
            raise ValueError(f"x0_batch has {B} scenarios, prepared "
                             f"{d['xs_pred'].shape[0]}")
        lbu = np.asarray(self._bounds.lbu)[0]
        ubu = np.asarray(self._bounds.ubu)[0]
        nx, nu = self._model.n_x, self._model.n_u
        if self._augment_du:
            # mirror the scalar Δu feedback: the solver's controls are Δu and
            # each scenario's u_prev rides in the augmented state. δxs uses
            # the same per-scenario u_prev the prepare solved with (zero
            # deviation on the augmented rows), Δu is clipped to its own
            # bounds, then u = u_prev + Δu is clipped to the input box (kept
            # as state bounds on the augmented rows).
            u_old_s = d["xs_pred"][:, nx:nx + nu]
            xs0 = np.concatenate([x0_batch / self._x_scaling, u_old_s],
                                 axis=1)
            dU0 = d["U"][:, 0, :] + np.einsum("bij,bj->bi", d["K0"],
                                              xs0 - d["xs_pred"])
            dU0 = np.clip(dU0, lbu, ubu)
            u_s = u_old_s + dU0[:, :nu]
            u_s = np.clip(u_s, np.asarray(self._bounds.lbx)[1, nx:nx + nu],
                          np.asarray(self._bounds.ubx)[1, nx:nx + nu])
            u0 = u_s * self._u_scaling
            # carried to the next rti_prepare_batch as the fleet's u_prev
            self._rti_batch_u_old = u0.copy()
            self._rti_batch = None
            return u0
        xs0 = x0_batch / self._x_scaling
        U0 = d["U"][:, 0, :] + np.einsum("bij,bj->bi", d["K0"],
                                         xs0 - d["xs_pred"])
        U0 = np.clip(U0, lbu, ubu)
        self._rti_batch = None
        return U0[:, :nu] * self._u_scaling

    def optimize_batch(self, x0_batch, cp=None, tvp=None, ref=None,
                       u_prev=None):
        """Solve B independent MPC problems at once; returns (B, n_u) first
        moves. ``u_prev`` (B, n_u): per-scenario previous inputs for the
        Δu-augmented formulation."""
        if self._solve_batch_jit is None:
            self._solve_batch_jit = self.solve_batch_fn()
        args = self.prepare_batch(x0_batch, cp, tvp, ref, u_prev=u_prev)
        sol = self._solve_batch_jit(*args)
        nx, nu = self._model.n_x, self._model.n_u
        X = np.asarray(sol.X)
        if self._augment_du:
            u0 = X[:, 1, nx:nx + nu] * self._u_scaling
        else:
            u0 = np.asarray(sol.U)[:, 0, :nu] * self._u_scaling
        return u0, sol


class OptimalControlProblem(NMPC):
    """Open-loop optimal control: solve once, apply the control sequence step by step
    (reference: hilo_mpc/modules/controller/ocp.py:27-37)."""

    _controller_type = "OCP"

    def __init__(self, model, **kwargs):
        super().__init__(model, **kwargs)
        self._u_sequence = None
        self._seq_pos = 0

    def optimize(self, x0, **kwargs):
        if self._u_sequence is None:
            super().optimize(x0, **kwargs)
            self._u_sequence = np.asarray(self.last_prediction["u"])
            self._seq_pos = 0
        u = self._u_sequence[min(self._seq_pos, len(self._u_sequence) - 1)]
        self._seq_pos += 1
        return u

    def reset(self):
        self._u_sequence = None
        self._seq_pos = 0
