"""Kalman filters: linear KF, extended KF, unscented KF.

Batched rebuild of the reference's filters (reference: hilo_mpc/modules/estimator/
kf.py:35-646). The reference propagates covariance by appending vec(P) as extra model
states with Pdot = FP + PFᵀ + Q and calling the CasADi integrator; here the predict step
is the model's discrete step function and P propagates with the *exact discrete-time*
Jacobian A = ∂F/∂x (forward-mode AD through the integrator), update uses the Joseph form.
One filter step is a pure function (`step_fn`) — multi-step estimation is `lax.scan`
(the reference's mapaccum, kf.py:301) and scenario batching is `vmap`.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.integrators import IntegratorSpec, make_step
from ..ops.smallalg import chol_small, solve_psd_small
from .base import Estimator


class _KalmanFilterBase(Estimator):
    def __init__(self, model, **kwargs):
        super().__init__(model, **kwargs)
        self._P: Optional[np.ndarray] = None

    def setup(self, dt: Optional[float] = None, integration_method: str = "rk4",
              **options):
        m = self._model
        self._dt = float(dt if dt is not None else (m.dt or 1.0))
        method = "discrete" if m.discrete else integration_method
        spec = IntegratorSpec(method=method,
                              degree=options.get("degree", 3),
                              substeps=options.get("substeps", 1))
        core = make_step(m.ode_fn(), m.alg_fn(), m.n_x, m.n_z, spec)
        meas = m.meas_fn()
        nz = m.n_z
        h = self._dt

        def F(x, u, p, t):
            zg = jnp.zeros(nz, x.dtype)
            x_next, _ = core(x, zg, u, p, t, h)
            return x_next

        def H(x, u, p, t):
            return jnp.atleast_1d(meas(x, jnp.zeros(nz, x.dtype), u, p, t))

        self._F, self._H = F, H
        self._build_step()
        self._step_jit = jax.jit(self._step)
        self._register_solution()
        self._P = np.array(self._P0)
        self._time = 0.0
        self._setup_done = True
        return self

    def step_fn(self):
        """Pure filter step: (x, P, u, p, y, t) -> (x+, P+, y_pred)."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        return self._step

    def predict(self, x=None, P=None, u=None, p=None, t: Optional[float] = None):
        """Prediction step only: (x, P) -> (x_pred, P_pred). Pure — does not
        advance the filter state (reference exposes predict/update separately,
        tests/test_KFs.py:488-522)."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        x = jnp.asarray(self._x_current() if x is None else x, dtype=float)
        P = jnp.asarray(self._P if P is None else P, dtype=float)
        u = jnp.asarray(np.zeros(self.n_u) if u is None else u, dtype=float)
        p_vec = jnp.asarray(self._p_or_default(p), dtype=float)
        t = self._time if t is None else float(t)
        x_pr, P_pr = self._predict_impl(x, P, u, p_vec, t)
        return np.asarray(x_pr), np.asarray(P_pr)

    def update(self, x_pred, P_pred, y, u=None, p=None,
               t: Optional[float] = None):
        """Measurement update only: (x_pred, P_pred, y) ->
        (x_new, P_new, y_pred). Pure — does not advance the filter state."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        x_pr = jnp.asarray(x_pred, dtype=float)
        P_pr = jnp.asarray(P_pred, dtype=float)
        y = jnp.asarray(np.atleast_1d(y), dtype=float)
        u = jnp.asarray(np.zeros(self.n_u) if u is None else u, dtype=float)
        p_vec = jnp.asarray(self._p_or_default(p), dtype=float)
        t = self._time if t is None else float(t)
        x_new, P_new, y_pr = self._update_impl(x_pr, P_pr, y, u, p_vec, t)
        return np.asarray(x_new), np.asarray(P_new), np.asarray(y_pr)

    def estimate(self, y, u=None, p=None):
        """One (or several) filter updates from measurement(s) y."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if self._x0 is None:
            raise ValueError("call set_initial_guess(x0) first")
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

        x = jnp.asarray(self._x_current())
        for k in range(steps):
            x, P, y_pred = self._step_jit(
                x, jnp.asarray(self._P), jnp.asarray(u[k]), jnp.asarray(p_vec),
                jnp.asarray(y[k]), self._time)
            self._P = np.asarray(P)
            self._time += self._dt
            self.solution.append(self._time, x=np.asarray(x), y=np.asarray(y_pred),
                                 P=self._P.ravel())
        return np.asarray(x)

    def _x_current(self):
        if self.solution is not None and self.solution.n_samples:
            return self.solution["x:f"]
        return self._x0


class KalmanFilter(_KalmanFilterBase):
    """Linear / extended Kalman filter (reference: kf.py:328,370 — the EKF there
    linearizes the model symbolically first; AD makes the two classes identical here,
    KalmanFilter simply asserts linearity)."""

    _estimator_type = "KF"

    def __init__(self, model, **kwargs):
        if type(self) is KalmanFilter and not model.is_linear:
            raise ValueError("KalmanFilter requires a linear model; use "
                             "ExtendedKalmanFilter for nonlinear models")
        super().__init__(model, **kwargs)

    def _build_step(self):
        F, H = self._F, self._H
        nx = self.n_x

        def predict(x, P, u, p, t):
            Q = jnp.asarray(self._Q, x.dtype)
            A = jax.jacfwd(F, argnums=0)(x, u, p, t)
            x_pr = F(x, u, p, t)
            P_pr = A @ P @ A.T + Q
            return x_pr, P_pr

        def update(x_pr, P_pr, y, u, p, t):
            R = jnp.asarray(self._R, x_pr.dtype)
            C = jax.jacfwd(H, argnums=0)(x_pr, u, p, t)
            y_pr = H(x_pr, u, p, t)
            S = C @ P_pr @ C.T + R
            K = solve_psd_small(S, (P_pr @ C.T).T).T
            x_new = x_pr + K @ (y - y_pr)
            I_KC = jnp.eye(nx, dtype=x_pr.dtype) - K @ C
            P_new = I_KC @ P_pr @ I_KC.T + K @ R @ K.T   # Joseph form
            return x_new, 0.5 * (P_new + P_new.T), y_pr

        def step(x, P, u, p, y, t):
            x_pr, P_pr = predict(x, P, u, p, t)
            return update(x_pr, P_pr, y, u, p, t + self._dt)

        self._predict_impl, self._update_impl, self._step = predict, update, step


class ExtendedKalmanFilter(KalmanFilter):
    """EKF — same AD-linearized step, nonlinear models allowed (reference: kf.py:370)."""

    _estimator_type = "EKF"

    def __init__(self, model, **kwargs):
        _KalmanFilterBase.__init__(self, model, **kwargs)


class UnscentedKalmanFilter(_KalmanFilterBase):
    """Sigma-point filter with alpha/beta/kappa scaling (reference: kf.py:413-646)."""

    _estimator_type = "UKF"

    def __init__(self, model, alpha: float = 1e-3, beta: float = 2.0,
                 kappa: float = 0.0, **kwargs):
        super().__init__(model, **kwargs)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.kappa = float(kappa)

    @property
    def alpha(self):
        return self._alpha

    @alpha.setter
    def alpha(self, v):
        if not 0 < v <= 1:
            raise ValueError("alpha must be in (0, 1]")
        self._alpha = float(v)

    @property
    def beta(self):
        return self._beta

    @beta.setter
    def beta(self, v):
        self._beta = float(v)

    @property
    def kappa(self):
        return self._kappa

    @kappa.setter
    def kappa(self, v):
        if v < 0:
            raise ValueError("kappa must be >= 0")
        self._kappa = float(v)

    def _weights(self, n, dtype):
        lam = self._alpha ** 2 * (n + self._kappa) - n
        wm = jnp.full(2 * n + 1, 1.0 / (2 * (n + lam)), dtype)
        wm = wm.at[0].set(lam / (n + lam))
        wc = wm.at[0].add(1 - self._alpha ** 2 + self._beta)
        return lam, wm, wc

    def _build_step(self):
        F, H = self._F, self._H
        nx = self.n_x

        def predict(x, P, u, p, t):
            Q = jnp.asarray(self._Q, x.dtype)
            lam, wm, wc = self._weights(nx, x.dtype)
            L = chol_small((nx + lam) * (P + 1e-12 * jnp.eye(nx, dtype=x.dtype)))
            sig = jnp.concatenate(
                [x[None, :], x[None, :] + L.T, x[None, :] - L.T], axis=0)
            sig_pr = jax.vmap(lambda s: F(s, u, p, t))(sig)
            x_pr = jnp.einsum("i,in->n", wm, sig_pr)
            dX = sig_pr - x_pr
            P_pr = jnp.einsum("i,in,im->nm", wc, dX, dX) + Q
            return x_pr, P_pr

        def update(x_pr, P_pr, y, u, p, t):
            R = jnp.asarray(self._R, x_pr.dtype)
            lam, wm, wc = self._weights(nx, x_pr.dtype)
            # re-draw sigma points about the predicted mean for the update
            L2 = chol_small(
                (nx + lam) * (P_pr + 1e-12 * jnp.eye(nx, dtype=x_pr.dtype)))
            sig2 = jnp.concatenate(
                [x_pr[None, :], x_pr[None, :] + L2.T, x_pr[None, :] - L2.T],
                axis=0)
            ysig = jax.vmap(lambda s: H(s, u, p, t))(sig2)
            y_pr = jnp.einsum("i,in->n", wm, ysig)
            dY = ysig - y_pr
            dX2 = sig2 - x_pr
            P_yy = jnp.einsum("i,in,im->nm", wc, dY, dY) + R
            P_xy = jnp.einsum("i,in,im->nm", wc, dX2, dY)
            K = solve_psd_small(P_yy, P_xy.T).T
            x_new = x_pr + K @ (y - y_pr)
            P_new = P_pr - K @ P_yy @ K.T
            return x_new, 0.5 * (P_new + P_new.T), y_pr

        def step(x, P, u, p, y, t):
            x_pr, P_pr = predict(x, P, u, p, t)
            return update(x_pr, P_pr, y, u, p, t + self._dt)

        self._predict_impl, self._update_impl, self._step = predict, update, step
