"""Sampling-importance-resampling particle filter.

Batched rebuild of the reference's ParticleFilter (reference: hilo_mpc/modules/
estimator/pf.py:36-452): particles propagate through the model integrator with process
noise via one `vmap` (the reference loops in Python over np arrays), Gaussian likelihood
weights, systematic resampling (cumsum + searchsorted — branchless, unlike
`np.random.choice` multinomial), optional roughening, Latin-hypercube initial sampling
(reference: lhsnorm, pf.py:425).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.smallalg import chol_small, solve_small

from ..core.integrators import IntegratorSpec, make_step
from .base import Estimator


def lhsnorm(mean, cov, n: int, seed: int = 0) -> np.ndarray:
    """Latin-hypercube sampling from N(mean, cov) (reference: pf.py:425)."""
    from scipy.stats import norm

    rng = np.random.default_rng(seed)
    mean = np.atleast_1d(np.asarray(mean, dtype=float))
    d = mean.size
    u = (rng.permuted(np.tile(np.arange(n), (d, 1)), axis=1).T
         + rng.uniform(size=(n, d))) / n
    z = norm.ppf(np.clip(u, 1e-12, 1 - 1e-12))
    L = np.linalg.cholesky(np.atleast_2d(np.asarray(cov, dtype=float))
                           + 1e-12 * np.eye(d))
    return mean[None, :] + z @ L.T


class ParticleFilter(Estimator):
    """SIR particle filter: vmapped particle propagation, Gaussian likelihoods,
    systematic resampling, optional roughening, LHS initial sampling."""

    _estimator_type = "PF"

    def __init__(self, model, n_particles: int = 100, roughening: bool = False,
                 roughening_tuning: float = 0.2, seed: int = 0, **kwargs):
        super().__init__(model, **kwargs)
        if n_particles < 1:
            raise ValueError("n_particles must be >= 1")
        if model.is_linear:
            import warnings
            # reference parity: a PF on a linear model works but a Kalman
            # filter is exact and cheaper (reference: pf.py linear warning)
            warnings.warn("The supplied model is linear. For better "
                          "performance use the Kalman filter.")
        self.n_particles = int(n_particles)
        self.roughening = bool(roughening)
        self.roughening_tuning = float(roughening_tuning)
        self._seed = seed
        self._particles: Optional[np.ndarray] = None
        self._pdf = lhsnorm
        self._transpose_pdf: Optional[bool] = None

    def setup(self, dt: Optional[float] = None, integration_method: str = "rk4",
              **options):
        # remembered so sample_size changes can rebuild the jitted step (its
        # closure bakes in the particle count)
        self._setup_args = (dt, integration_method, dict(options))
        m = self._model
        self._dt = float(dt if dt is not None else (m.dt or 1.0))
        method = "discrete" if m.discrete else integration_method
        spec = IntegratorSpec(method=method, degree=options.get("degree", 3),
                              substeps=options.get("substeps", 1))
        core = make_step(m.ode_fn(), m.alg_fn(), m.n_x, m.n_z, spec)
        meas = m.meas_fn()
        nz, nx, ny = m.n_z, m.n_x, m.n_y
        h = self._dt
        n_part = self.n_particles
        rough = self.roughening
        tune = self.roughening_tuning

        def step(key, parts, u, p, y, t):
            """(key, particles (M, nx), u, p, y, t) -> (key, particles+, x_est, y_est)"""
            Q = jnp.asarray(self._Q, parts.dtype)
            R = jnp.asarray(self._R, parts.dtype)
            k1, k2, k3 = jax.random.split(key, 3)
            # propagate + additive process noise
            prop = jax.vmap(lambda s: core(s, jnp.zeros(nz, s.dtype), u, p, t, h)[0])
            parts_pr = prop(parts)
            # sample w ~ N(0, Q) via the unrolled Cholesky — the stock
            # multivariate_normal decomposes Q with an SVD on every call,
            # which would dominate the whole filter step
            Lq = chol_small(Q + 1e-12 * jnp.eye(nx, dtype=parts.dtype))
            noise = jax.random.normal(k1, (n_part, nx), parts.dtype) @ Lq.T
            parts_pr = parts_pr + noise
            # likelihood weights
            ysig = jax.vmap(lambda s: jnp.atleast_1d(
                meas(s, jnp.zeros(nz, s.dtype), u, p, t + h)))(parts_pr)
            innov = y[None, :] - ysig
            logw = -0.5 * jnp.sum(innov.T * solve_small(R, innov.T), axis=0)
            logw = logw - jnp.max(logw)
            w = jnp.exp(logw)
            w = w / jnp.sum(w)
            x_est = jnp.einsum("m,mn->n", w, parts_pr)
            y_est = jnp.einsum("m,mn->n", w, ysig)
            # systematic resampling
            edges = jnp.cumsum(w)
            offset = jax.random.uniform(k2, (), parts.dtype) / n_part
            pts = offset + jnp.arange(n_part, dtype=parts.dtype) / n_part
            idx = jnp.searchsorted(edges, pts)
            idx = jnp.clip(idx, 0, n_part - 1)
            parts_new = parts_pr[idx]
            if rough:
                spread = (jnp.max(parts_new, axis=0) - jnp.min(parts_new, axis=0))
                sig = tune * spread * n_part ** (-1.0 / nx)
                parts_new = parts_new + sig[None, :] * jax.random.normal(
                    k3, (n_part, nx), parts.dtype)
            return k3, parts_new, x_est, y_est

        self._step = step
        self._step_jit = jax.jit(step)
        self._key = jax.random.PRNGKey(self._seed)
        self._register_solution()
        self._time = 0.0
        self._setup_done = True
        return self

    def step_fn(self):
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        return self._step

    def set_initial_guess(self, x0, P0=None):
        super().set_initial_guess(x0, P0)
        if self._setup_done:
            self._init_particles()
        return self

    # -- initial sampling distribution (reference: pf.py:195-224) -----------------
    @property
    def probability_density_function(self):
        """Sampler drawing the initial particle cloud: pdf(mu, sigma, n) ->
        (n, nx) array. Defaults to Latin-hypercube normal sampling."""
        return self._pdf

    @probability_density_function.setter
    def probability_density_function(self, pdf):
        import inspect
        import typing

        if not callable(pdf):
            raise TypeError("probability density function (pdf) must be "
                            "callable")
        # resolve annotations (handles PEP 563 string annotations); when they
        # cannot be resolved, accept the callable unvalidated
        try:
            hints = typing.get_type_hints(pdf)
        except Exception:
            hints = {}
        if hints:
            try:
                params = list(inspect.signature(pdf).parameters)
            except (TypeError, ValueError):
                params = []
            expected = (np.ndarray, np.ndarray, int)
            # check by PARAMETER POSITION, only where an annotation exists
            for i, arg in enumerate(params[:3]):
                if arg in hints and hints[arg] is not expected[i]:
                    no = ("first", "second", "third")[i]
                    raise TypeError(
                        f"The {no} argument to the probability density "
                        f"function (pdf) needs to be {expected[i].__name__}")
            ret = hints.get("return")
            if ret is not None and ret is not np.ndarray:
                raise TypeError("The return value of the probability density "
                                "function (pdf) needs to be numpy.ndarray")
        self._pdf = pdf
        self._transpose_pdf = None  # re-detect output orientation

    # reference alias for the particle count used by the initial sampling
    @property
    def sample_size(self):
        return self.n_particles

    @sample_size.setter
    def sample_size(self, n):
        n = int(n)
        if n < 1:
            raise ValueError("sample_size must be >= 1")
        self.n_particles = n
        self._particles = None
        # the jitted step closes over the particle count — rebuild it,
        # preserving the recorded solution and filter time
        if self._setup_done:
            dt, method, options = self._setup_args
            sol, time = self.solution, self._time
            self.setup(dt=dt, integration_method=method, **options)
            self.solution, self._time = sol, time

    def _init_particles(self):
        if self._pdf is lhsnorm:
            X = lhsnorm(self._x0, self._P0, self.n_particles, seed=self._seed)
        else:
            X = np.asarray(self._pdf(np.asarray(self._x0), np.asarray(self._P0),
                                     self.n_particles), dtype=float)
            # accept (n, nx) or the reference's (nx, n) column layout
            if self._transpose_pdf is None:
                self._transpose_pdf = X.shape != (self.n_particles, self.n_x)
            if self._transpose_pdf:
                X = X.T
            if X.shape != (self.n_particles, self.n_x):
                raise ValueError(
                    f"Dimension mismatch. Expected dimension "
                    f"{self.n_particles}x{self.n_x}, got {X.shape}")
        self._particles = X

    def estimate(self, y, u=None, p=None):
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if self._x0 is None:
            raise ValueError("call set_initial_guess(x0) first")
        if self._particles is None:
            self._init_particles()
        y = np.atleast_2d(np.asarray(y, dtype=float))
        if y.shape[1] != self.n_y:
            y = y.T
        steps = y.shape[0]
        if u is None:
            u = np.zeros((steps, self.n_u))
        else:
            u = np.atleast_2d(np.asarray(u, dtype=float))
            if u.shape[0] == 1:
                u = np.tile(u, (steps, 1))
            if u.shape[1] != self.n_u and u.shape[0] == self.n_u:
                u = u.T
        p_vec = self._p_or_default(p)
        parts = jnp.asarray(self._particles)
        x_est = None
        for k in range(steps):
            self._key, parts, x_est, y_est = self._step_jit(
                self._key, parts, jnp.asarray(u[k]), jnp.asarray(p_vec),
                jnp.asarray(y[k]), self._time)
            self._time += self._dt
            P = np.cov(np.asarray(parts).T).reshape(self.n_x, self.n_x)
            self.solution.append(self._time, x=np.asarray(x_est),
                                 y=np.asarray(y_est), P=P.ravel())
        self._particles = np.asarray(parts)
        return np.asarray(x_est)

    @property
    def particles(self):
        return None if self._particles is None else np.array(self._particles)
