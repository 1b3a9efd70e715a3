"""Moving-horizon estimation.

Batched rebuild of the reference's MovingHorizonEstimator (reference: hilo_mpc/
modules/estimator/mhe.py:38-1251). The window NLP — decision vars x_0..N, process noise
w_0..N-1, optionally estimated parameters; arrival + measurement + state-noise costs —
maps onto the same stagewise interior-point engine as NMPC (ops/ip_solver.py) with
``fix_x0=False`` (the Riccati sweep picks the optimal free initial state, replacing the
reference's flat-NLP decision vector, mhe.py:418-791). Estimated parameters ride as
constant-dynamics state augmentations. Measurement buffering mirrors the reference's
ring buffers (mhe.py:311-416). Beyond the reference: NaN entries in a measurement mark
missing values — a per-channel validity mask rides in theta and zeroes their error
terms, so irregular/dropped samples are handled without resizing the window NLP.
"""
from __future__ import annotations

from collections import deque
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.integrators import IntegratorSpec, make_step
from ..ops.ip_solver import (IPOptions, OCPBounds, OCPDims, OCPFunctions,
                             solve_ocp)
from ..ops.riccati import sweep_unroll
from ..utils.trace_cache import arr_key, registry_lookup, registry_store
from .base import Estimator, _as_cov


class MHEQuadraticCost:
    """Accumulates MHE cost terms (reference: MHEQuadraticCost,
    util/modeling.py:533-818)."""

    def __init__(self, model):
        self._model = model
        self.W_meas: Optional[np.ndarray] = None       # measurement weight (R^-1-ish)
        self.W_noise: Optional[np.ndarray] = None      # state-noise weight (Q^-1-ish)
        self.W_arrival_x: Optional[np.ndarray] = None  # arrival state weight
        self.W_arrival_p: Optional[np.ndarray] = None  # arrival parameter weight

    def add_measurements(self, weights=None, names=None):
        n = self._model.n_y
        self.W_meas = _as_cov(weights if weights is not None else 1.0, n, "W_meas")
        return self

    def add_state_noise(self, weights=None, names=None):
        n = self._model.n_x
        self.W_noise = _as_cov(weights if weights is not None else 1.0, n, "W_noise")
        return self


class MovingHorizonEstimator(Estimator):
    """Moving-horizon estimator: window NLP with free arrival state, arrival
    cost updates, optional parameter estimation, and batched windows."""

    _estimator_type = "MHE"

    def __init__(self, model, **kwargs):
        super().__init__(model, **kwargs)
        self._horizon: Optional[int] = None
        self.quad_stage_cost = MHEQuadraticCost(self._model)
        self.quad_arrival_cost = MHEQuadraticCost(self._model)
        self._est_params: List[str] = []
        self._p_guess: Optional[np.ndarray] = None
        self._x_lb = np.full(self._model.n_x, -np.inf)
        self._x_ub = np.full(self._model.n_x, np.inf)
        self._p_lb = None
        self._p_ub = None
        self._w_bound = np.inf
        self._y_history: deque = deque()
        self._u_history: deque = deque()
        self._setup_done = False

    @property
    def horizon(self):
        return self._horizon

    @horizon.setter
    def horizon(self, N):
        if int(N) < 1:
            raise ValueError("horizon must be >= 1")
        self._horizon = int(N)

    def set_box_constraints(self, x_lb=None, x_ub=None, p_lb=None, p_ub=None,
                            w_bound=None):
        nx = self._model.n_x
        if x_lb is not None:
            self._x_lb = np.broadcast_to(np.asarray(x_lb, float).ravel(), (nx,)).copy()
        if x_ub is not None:
            self._x_ub = np.broadcast_to(np.asarray(x_ub, float).ravel(), (nx,)).copy()
        if p_lb is not None:
            self._p_lb = np.asarray(p_lb, dtype=float).ravel()
        if p_ub is not None:
            self._p_ub = np.asarray(p_ub, dtype=float).ravel()
        if w_bound is not None:
            self._w_bound = float(w_bound)
        return self

    def set_estimated_parameters(self, names, guess=None, arrival_weight=None):
        """Declare model parameters to be estimated alongside the states."""
        if isinstance(names, str):
            names = [names]
        for nm in names:
            if nm not in self._model.parameters:
                raise ValueError(f"{nm!r} is not a model parameter")
        self._est_params = list(names)
        if guess is not None:
            self._p_guess = np.asarray(guess, dtype=float).ravel()
        if arrival_weight is not None:
            self.quad_arrival_cost.W_arrival_p = _as_cov(
                arrival_weight, len(names), "arrival_p")
        return self

    def _detect_affine_measurement(self, meas, nz, nx, n_pe, pe_idx, n_p, nu):
        """True iff the measurement map is affine in [x; p_est].

        An affine map has an identically-zero Hessian, so probing it at a
        few random points is exact (no false negatives); any nonlinearity,
        NaN, or numerical doubt returns False, which only keeps the
        conservative solver defaults (no false-positive risk beyond
        measure-zero coincidences at the probe points)."""
        p_base = (np.asarray(self._p_values, float).ravel()
                  if self._p_values is not None and len(self._p_values) == n_p
                  else np.ones(n_p))
        nxs = nx + n_pe
        pe = jnp.asarray(pe_idx) if n_pe else None

        def g(xs, u, t):
            p = jnp.asarray(p_base, xs.dtype)
            if n_pe:
                p = p.at[pe].set(xs[nx:])
            return jnp.atleast_1d(
                meas(xs[:nx], jnp.zeros(nz, xs.dtype), u, p, t)).ravel()

        jac = jax.jacrev(g, argnums=0)
        hess = jax.jacfwd(jac, argnums=0)
        rng = np.random.default_rng(0)
        try:
            for scale in (0.7, 1.9):
                xs = jnp.asarray(scale * rng.standard_normal(nxs))
                u = jnp.asarray(rng.standard_normal(nu))
                t = float(rng.random())
                H = np.asarray(hess(xs, u, t))
                J = np.asarray(jac(xs, u, t))
                if not (np.all(np.isfinite(H)) and np.all(np.isfinite(J))):
                    return False
                if np.max(np.abs(H), initial=0.0) > \
                        1e-6 * (1.0 + np.max(np.abs(J), initial=0.0)):
                    return False
        except Exception:
            return False
        return True

    # -- setup ----------------------------------------------------------------
    def setup(self, dt: Optional[float] = None, options: Optional[dict] = None):
        options = dict(options or {})
        if self._horizon is None:
            raise ValueError("set mhe.horizon before setup()")
        m = self._model
        N = self._horizon
        self._dt = float(dt if dt is not None else
                         options.get("dt", m.dt or 1.0))
        nx, nu, ny, n_p = m.n_x, m.n_u, m.n_y, m.n_p
        n_pe = len(self._est_params)
        pe_idx = [m.parameters.index(nm) for nm in self._est_params]

        method = options.get("integration_method",
                             "discrete" if m.discrete else "rk4")
        spec = IntegratorSpec(method=method, degree=options.get("degree", 3),
                              substeps=options.get("substeps", 1))
        core = make_step(m.ode_fn(), m.alg_fn(), nx, m.n_z, spec)
        meas = m.meas_fn()
        nz = m.n_z
        h = self._dt

        # default weights from covariances if not set explicitly
        W_meas = (self.quad_stage_cost.W_meas if self.quad_stage_cost.W_meas
                  is not None else np.linalg.inv(self._R))
        W_noise = (self.quad_stage_cost.W_noise if self.quad_stage_cost.W_noise
                   is not None else np.linalg.inv(self._Q))
        W_arr_x = (self.quad_arrival_cost.W_arrival_x
                   if self.quad_arrival_cost.W_arrival_x is not None
                   else np.linalg.inv(self._P0))
        W_arr_p = (self.quad_arrival_cost.W_arrival_p
                   if self.quad_arrival_cost.W_arrival_p is not None
                   else np.eye(n_pe))

        # theta layout per node k: [t, u_k (nu), y_k (ny), p_full (n_p),
        #                           arrival_x_bar (nx), arrival_p_bar (n_pe),
        #                           y_mask (ny)]
        # y_mask: per-channel measurement validity (NaN in a supplied y marks a
        # missing value — the mask zeroes its error term; the reference has no
        # missing-data support, mhe.py:311-416 assumes a full window)
        off_u = 1
        off_y = off_u + nu
        off_p = off_y + ny
        off_ax = off_p + n_p
        off_ap = off_ax + nx
        off_m = off_ap + n_pe
        self._n_theta = off_m + ny
        self._offsets = (off_u, off_y, off_p, off_ax, off_ap)
        self._off_mask = off_m

        nxs = nx + n_pe
        arrival_scale = 1.0

        def full_p(xs, theta):
            p = theta[off_p:off_p + n_p]
            if n_pe:
                p = p.at[jnp.asarray(pe_idx)].set(xs[nx:])
            return p

        def dyn(xs, w, theta):
            x = xs[:nx]
            u = theta[off_u:off_u + nu]
            p = full_p(xs, theta)
            t = theta[0]
            x_next, _ = core(x, jnp.zeros(nz, x.dtype), u, p, t, h)
            return jnp.concatenate([x_next + w, xs[nx:]])

        def stage_cost(xs, w, theta):
            x = xs[:nx]
            u = theta[off_u:off_u + nu]
            y = theta[off_y:off_y + ny]
            p = full_p(xs, theta)
            t = theta[0]
            y_pred = jnp.atleast_1d(meas(x, jnp.zeros(nz, x.dtype), u, p, t))
            e = (y - y_pred) * theta[off_m:off_m + ny]
            c = e @ jnp.asarray(W_meas, x.dtype) @ e
            c = c + w @ jnp.asarray(W_noise, x.dtype) @ w
            return c

        # arrival handled via an indicator: append flag column
        self._n_theta += 1
        flag_col = self._n_theta - 1

        def stage_cost_full(xs, w, theta):
            c = stage_cost(xs, w, theta)
            x = xs[:nx]
            flag = theta[flag_col]
            xbar = theta[off_ax:off_ax + nx]
            dx = x - xbar
            c = c + flag * (dx @ jnp.asarray(W_arr_x, x.dtype) @ dx)
            if n_pe:
                pbar = theta[off_ap:off_ap + n_pe]
                dp = xs[nx:] - pbar
                c = c + flag * (dp @ jnp.asarray(W_arr_p, x.dtype) @ dp)
            return c

        def term_cost(xs, theta):
            x = xs[:nx]
            u = theta[off_u:off_u + nu]
            y = theta[off_y:off_y + ny]
            p = full_p(xs, theta)
            t = theta[0]
            y_pred = jnp.atleast_1d(meas(x, jnp.zeros(nz, x.dtype), u, p, t))
            e = (y - y_pred) * theta[off_m:off_m + ny]
            return e @ jnp.asarray(W_meas, x.dtype) @ e

        dims = OCPDims(nx=nxs, nu=nx, N=N)
        funcs = OCPFunctions(dyn=dyn, stage_cost=stage_cost_full,
                             term_cost=term_cost)

        # -- fast-path auto-detection -------------------------------------
        # The window cost is a sum of fixed quadratic forms in the residuals
        # (MHEQuadraticCost admits nothing else), so the cost Hessian is
        # point-independent — and the whole window problem is safely convex —
        # exactly when the measurement map is affine in the decision states
        # (incl. estimated parameters). In that case the conservative solver
        # guards (per-iteration eigh convexification, 10-candidate merit
        # line search) only cost time and create straggler lanes that drive
        # the vmapped while-loop to max_iter; the single-Newton-step playbook
        # (docs/PERFORMANCE.md) is exact. Mirrors NMPC's quad_cost_only
        # auto-detection (control/nmpc.py). Override with
        # options={'fast_path': True/False}.
        fast = options.get("fast_path", "auto")
        if isinstance(fast, str):
            fast = self._detect_affine_measurement(
                meas, nz, nx, n_pe, pe_idx, m.n_p, nu)
        self.fast_path = bool(fast)
        if self.fast_path:
            _d = dict(n_linesearch=1, convexify=False, max_iter=25,
                      riccati_unroll=sweep_unroll(jax.default_backend(), N),
                      const_cost_hessian=True)
        else:
            _d = dict(n_linesearch=10, convexify=True, max_iter=40,
                      riccati_unroll=1, const_cost_hessian=False)

        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        lbx = np.tile(self._x_lb, (N + 1, 1))
        ubx = np.tile(self._x_ub, (N + 1, 1))
        if n_pe:
            p_lb = (self._p_lb if self._p_lb is not None
                    else np.full(n_pe, -np.inf))
            p_ub = (self._p_ub if self._p_ub is not None
                    else np.full(n_pe, np.inf))
            lbx = np.concatenate([lbx, np.tile(p_lb, (N + 1, 1))], axis=1)
            ubx = np.concatenate([ubx, np.tile(p_ub, (N + 1, 1))], axis=1)
        bounds = OCPBounds(
            lbx=jnp.asarray(lbx, dtype), ubx=jnp.asarray(ubx, dtype),
            lbu=jnp.full((N, nx), -self._w_bound, dtype),
            ubu=jnp.full((N, nx), self._w_bound, dtype))
        self._bounds = bounds
        self._dims = dims
        self._funcs = funcs
        # 1e-7 KKT is unreachable in f32; pick the default by solver dtype
        default_tol = 1e-7 if dtype == jnp.float64 else 1e-4
        # the NMPC throughput playbook applies unchanged to the window solve
        # (same stagewise IP engine): fewer line-search candidates, unrolled
        # Riccati sweeps, Mehrotra — see docs/PERFORMANCE.md
        ip_opts = IPOptions(
            max_iter=options.get("max_iter", _d["max_iter"]),
            tol=options.get("tol", default_tol),
            mu_init=options.get("mu_init", 1e-2),
            n_linesearch=options.get("n_linesearch", _d["n_linesearch"]),
            mehrotra=options.get("mehrotra", False),
            convexify=options.get("convexify", _d["convexify"]),
            early_exit=options.get("early_exit", True),
            riccati_unroll=options.get("riccati_unroll", _d["riccati_unroll"]),
            parallel_riccati=options.get("parallel_riccati", False),
            const_cost_hessian=options.get("const_cost_hessian",
                                           _d["const_cost_hessian"]))
        self._ip_opts = ip_opts
        # cross-instance trace sharing (utils/trace_cache.py): same-config MHE
        # instances adopt the canonical funcs/dims/jits instead of retracing.
        # Everything baked into the closures above is in the key; bounds are
        # runtime args everywhere (the batch jit takes them as an argument).
        import dataclasses as _dc
        try:
            msig, _keep = m.trace_signature()
            sig = ("mhe", msig, N, float(self._dt),
                   (spec.method, spec.degree, spec.scheme, spec.substeps,
                    spec.newton_iters),
                   tuple(pe_idx), arr_key(W_meas), arr_key(W_noise),
                   arr_key(W_arr_x), arr_key(W_arr_p),
                   tuple(_dc.astuple(ip_opts)),
                   bool(jax.config.jax_enable_x64))
            hash(sig)
        except Exception:
            sig, _keep = None, []
        ent = registry_lookup(sig)
        if ent is not None:
            funcs, dims, ip_opts = ent["funcs"], ent["dims"], ent["ip_opts"]
            self._funcs, self._dims, self._ip_opts = funcs, dims, ip_opts
            self._solve_jit = ent["solve"]
            self._trace_entry = ent
        else:
            self._solve_jit = jax.jit(partial(
                solve_ocp, funcs, dims, options=ip_opts, fix_x0=False))
            if sig is not None:
                self._trace_entry = registry_store(sig, {
                    "funcs": funcs, "dims": dims, "ip_opts": ip_opts,
                    "solve": self._solve_jit, "keep": _keep})
            else:
                self._trace_entry = None
        self._solve_batch_jit = None
        self._solver_dtype = dtype
        self._register_solution()
        self.solution.register("w", [f"w_{n}" for n in m.dynamical_states])
        if n_pe:
            self.solution.register("p_est", self._est_params)
        self._x_arrival: Optional[np.ndarray] = None
        self._p_arrival = (self._p_guess if self._p_guess is not None
                           else np.zeros(n_pe))
        self._warm = None
        self._time = 0.0
        self._setup_done = True
        return self

    def _get_solve_batch_jit(self):
        """Vmapped window solver with bounds as a runtime argument — shared
        across same-config instances via the trace registry."""
        if getattr(self, "_solve_batch_jit", None) is None:
            funcs, dims, opts = self._funcs, self._dims, self._ip_opts

            def build():
                solver = partial(solve_ocp, funcs, dims, options=opts,
                                 fix_x0=False)
                return jax.jit(jax.vmap(
                    lambda b, th, x0s, Xi, Ui: solver(b, th, x0s, Xi, Ui),
                    in_axes=(None, 0, 0, 0, 0)))

            ent = getattr(self, "_trace_entry", None)
            if ent is None:
                self._solve_batch_jit = build()
            else:
                if "solve_batch" not in ent["sites"]:
                    ent["sites"]["solve_batch"] = build()
                self._solve_batch_jit = ent["sites"]["solve_batch"]
        return self._solve_batch_jit

    # -- measurement buffering -------------------------------------------------
    def add_measurements(self, y, u=None):
        y = np.asarray(y, dtype=float).ravel()
        if y.size != self.n_y:
            raise ValueError(f"y has {y.size} entries, expected {self.n_y}")
        self._y_history.append(y)
        self._u_history.append(
            np.zeros(self.n_u) if u is None
            else np.asarray(u, dtype=float).ravel())
        max_len = (self._horizon or 0) + 1
        while len(self._y_history) > max_len:
            self._y_history.popleft()
            self._u_history.popleft()
        return self

    @property
    def window_full(self) -> bool:
        return len(self._y_history) >= (self._horizon or 0) + 1

    # -- batched windows (addition over the reference) -------------------------
    def _theta_batch(self, Ys, Us, x_arrivals, p_vec):
        m = self._model
        B, N = Ys.shape[0], self._horizon
        nx, n_pe = m.n_x, len(self._est_params)
        off_u, off_y, off_p, off_ax, off_ap = self._offsets
        theta = np.zeros((B, N + 1, self._n_theta))
        theta[:, :, 0] = self._dt * np.arange(N + 1)[None, :]
        # interval inputs lead by one within the window (see estimate())
        us_int = np.concatenate([Us[:, 1:], Us[:, -1:]], axis=1)
        theta[:, :, off_u:off_u + m.n_u] = us_int
        theta[:, :, off_y:off_y + m.n_y] = np.nan_to_num(Ys, nan=0.0)
        theta[:, :, off_p:off_p + m.n_p] = p_vec[None, None, :]
        theta[:, :, off_ax:off_ax + nx] = x_arrivals[:, None, :]
        if n_pe:
            theta[:, :, off_ap:off_ap + n_pe] = self._p_arrival[None, None, :]
        theta[:, :, self._off_mask:self._off_mask + m.n_y] = \
            np.isfinite(Ys).astype(float)
        theta[:, 0, -1] = 1.0
        return theta

    def estimate_batch(self, Ys, Us=None, x_arrivals=None, p=None, mesh=None):
        """Solve B independent MHE windows at once.

        Ys: (B, N+1, n_y) measurement windows; Us: (B, N+1, n_u) inputs, paired
        like estimate(): row k's input is the one whose application produced row
        k's measurement. x_arrivals: (B, nx) arrival means.
        With ``mesh`` (a jax.sharding.Mesh with a leading 'dp' axis) the window
        batch is sharded across devices and the vmapped solve partitions over
        the mesh — the MHE analogue of parallel/sharding.sharded_solve_fn.
        Returns (x_est (B, nx), OCPSolution).
        """
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        m = self._model
        N = self._horizon
        nx, n_pe = m.n_x, len(self._est_params)
        Ys = np.asarray(Ys, dtype=float)
        B = Ys.shape[0]
        if Ys.shape[1:] != (N + 1, m.n_y):
            raise ValueError(f"Ys shape {Ys.shape}, expected "
                             f"(B, {N + 1}, {m.n_y})")
        Us = (np.zeros((B, N + 1, m.n_u)) if Us is None
              else np.asarray(Us, dtype=float))
        if x_arrivals is None:
            x_arrivals = np.tile(
                (self._x0 if self._x0 is not None else np.zeros(nx)), (B, 1))
        x_arrivals = np.asarray(x_arrivals, dtype=float)
        if (p is None and self._p_values is None
                and len(self._est_params) == m.n_p):
            p_vec = np.zeros(m.n_p)
        else:
            p_vec = self._p_or_default(p)
        theta = self._theta_batch(Ys, Us, x_arrivals, p_vec)
        dtype = self._solver_dtype
        xs0 = np.concatenate(
            [x_arrivals, np.tile(self._p_arrival[:n_pe], (B, 1))], axis=1)
        X_init = np.tile(xs0[:, None, :], (1, N + 1, 1))
        U_init = np.zeros((B, N, nx))
        solve_batch = self._get_solve_batch_jit()
        args = (jnp.asarray(theta, dtype), jnp.asarray(xs0, dtype),
                jnp.asarray(X_init, dtype), jnp.asarray(U_init, dtype))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            sh = NamedSharding(mesh, P(mesh.axis_names[0]))
            args = tuple(jax.device_put(a, sh) for a in args)
        sol = solve_batch(self._bounds, *args)
        x_est = np.asarray(sol.X)[:, -1, :nx]
        return x_est, sol

    # -- solve -----------------------------------------------------------------
    def estimate(self, y=None, u=None, p=None, runs: int = 1,
                 pert_factor: float = 0.1, seed: int = 0):
        """Add an optional new measurement, then solve the window problem.
        Returns the current state estimate (and parameter estimates if any), or
        None while the window is still filling.

        ``runs > 1`` enables multi-start (reference: the ``runs`` kwarg with
        multiplicatively perturbed initial guesses, mhe.py:386-399): instead of
        the reference's sequential re-solve loop, all perturbed window guesses
        are solved in ONE vmapped jit and the best converged objective wins —
        the batched form of restart-based robustification. ``pert_factor``
        scales the relative perturbation like the reference's kwarg."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if y is not None:
            self.add_measurements(y, u)
        if not self.window_full:
            return None
        m = self._model
        N = self._horizon
        nx, n_pe = m.n_x, len(self._est_params)
        if (p is None and self._p_values is None
                and len(self._est_params) == m.n_p):
            # every parameter is estimated: the theta placeholder values are
            # overwritten by the augmented states anyway
            p_vec = np.zeros(m.n_p)
        else:
            p_vec = self._p_or_default(p)
        if self._x_arrival is None:
            self._x_arrival = (self._x0 if self._x0 is not None
                               else np.zeros(nx))

        ys = np.stack(list(self._y_history))      # (N+1, ny): y_k at node k
        y_mask = np.isfinite(ys).astype(float)    # NaN = missing measurement
        ys = np.nan_to_num(ys, nan=0.0)
        us = np.stack(list(self._u_history))      # (N+1, nu): u applied after y_k
        # interval input for node k -> k+1 is the u applied AFTER y_k was measured,
        # i.e. us[k+1] (estimate(y, u) receives (y_{j+1}, u_j) pairs like the
        # filters, so us leads by one within the window)
        us_interval = np.vstack([us[1:], us[-1:]])
        t_col = self._time + self._dt * np.arange(N + 1)
        theta = np.zeros((N + 1, self._n_theta))
        off_u, off_y, off_p, off_ax, off_ap = self._offsets
        theta[:, 0] = t_col
        theta[:, off_u:off_u + m.n_u] = us_interval
        theta[:, off_y:off_y + m.n_y] = ys
        theta[:, off_p:off_p + m.n_p] = p_vec[None, :]
        theta[:, off_ax:off_ax + nx] = self._x_arrival[None, :]
        if n_pe:
            theta[:, off_ap:off_ap + n_pe] = self._p_arrival[None, :]
        theta[:, self._off_mask:self._off_mask + m.n_y] = y_mask
        theta[0, -1] = 1.0   # arrival-cost indicator

        dtype = self._solver_dtype
        xs0 = np.concatenate([self._x_arrival,
                              self._p_arrival[:n_pe]])
        if self._warm is not None:
            X_init, U_init = self._warm
            X_init = np.vstack([X_init[1:], X_init[-1:]])
            U_init = np.vstack([U_init[1:], U_init[-1:]])
        else:
            X_init = np.tile(xs0[None, :], (N + 1, 1))
            U_init = np.zeros((N, nx))
        if runs > 1:
            # multi-start: perturb the state-trajectory guess multiplicatively
            # (plus an absolute floor so zero guesses still move) and the noise
            # guess additively; solve all runs in one vmapped jit
            rng = np.random.default_rng(seed)
            scale = np.abs(X_init) + 1.0
            X_pert = np.tile(X_init[None], (runs, 1, 1))
            U_pert = np.tile(U_init[None], (runs, 1, 1))
            X_pert[1:] += (pert_factor * scale[None]
                           * (1.0 - 2.0 * rng.random((runs - 1,) + X_init.shape)))
            U_pert[1:] += (pert_factor
                           * (1.0 - 2.0 * rng.random((runs - 1,) + U_init.shape)))
            sols = self._get_solve_batch_jit()(
                self._bounds,
                jnp.tile(jnp.asarray(theta, dtype)[None], (runs, 1, 1)),
                jnp.tile(jnp.asarray(xs0, dtype)[None], (runs, 1)),
                jnp.asarray(X_pert, dtype), jnp.asarray(U_pert, dtype))
            # best converged objective; unconverged runs are penalized, run 0
            # (the unperturbed warm guess) wins ties
            score = np.where(np.asarray(sols.converged),
                             np.asarray(sols.objective), np.inf)
            best = int(np.argmin(score)) if np.isfinite(score).any() else 0
            sol = jax.tree_util.tree_map(lambda a: a[best], sols)
        else:
            sol = self._solve_jit(self._bounds, jnp.asarray(theta, dtype),
                                  jnp.asarray(xs0, dtype),
                                  jnp.asarray(X_init, dtype),
                                  jnp.asarray(U_init, dtype))
        X = np.asarray(sol.X)
        W = np.asarray(sol.U)
        self._warm = (X, U_init if not np.all(np.isfinite(W)) else W)
        # arrival update: next window starts one step later
        self._x_arrival = X[1, :nx]
        if n_pe:
            self._p_arrival = X[-1, nx:]
        x_est = X[-1, :nx]
        self._time += self._dt
        self.stats = {
            "iterations": int(sol.iterations),
            "kkt_error": float(sol.kkt_error),
            "objective": float(sol.objective),
            "converged": bool(sol.converged),
            "fast_path": self.fast_path,
        }
        y_pred = np.asarray(jnp.atleast_1d(m.meas_fn()(
            jnp.asarray(x_est), jnp.zeros(m.n_z), jnp.asarray(us[-1]),
            jnp.asarray(p_vec), 0.0)))
        kwargs = dict(x=x_est, y=y_pred, w=W[-1])
        if n_pe:
            kwargs["p_est"] = self._p_arrival
        self.solution.append(self._time, **kwargs)
        if n_pe:
            return x_est, np.array(self._p_arrival)
        return x_est
