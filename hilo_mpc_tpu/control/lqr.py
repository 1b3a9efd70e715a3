"""Finite/infinite-horizon discrete-time LQR.

Batched rebuild of the reference's LinearQuadraticRegulator (reference:
hilo_mpc/modules/controller/lqr.py:34-307): the reference unrolls the Riccati iteration
symbolically into one CasADi Function; here the backward recursion is a `lax.scan`
(ops/riccati.py) and the control law u = -K x is a jitted closure. Bonus over the
reference: the infinite-horizon gain (DARE fixed point) is implemented instead of
raising NotImplementedError (lqr.py:236-244).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.model import Model
from ..ops.smallalg import solve_psd_small
from ..ops.riccati import dare_solve, lqr_backward


def _check_psd(M, name):
    M = np.asarray(M)
    if np.iscomplexobj(M):
        raise ValueError(f"{name} must be real-valued")
    M = np.asarray(M, dtype=float)
    if M.ndim <= 1:
        # vectors set the diagonal, like the reference's Q/R setters
        M = np.diag(np.atleast_1d(M))
    if not np.allclose(M, M.T, atol=1e-10):
        raise ValueError(f"{name} must be symmetric")
    eigs = np.linalg.eigvalsh(M)
    if np.any(eigs < -1e-10):
        raise ValueError(f"{name} must be positive semi-definite")
    return M


class LinearQuadraticRegulator:
    """u = -K x for a discrete-time linear model."""

    _controller_type = "LQR"

    def __init__(self, model: Model, id: Optional[str] = None,
                 name: Optional[str] = None, plot_backend=None):
        if not model.is_linear:
            raise ValueError("LQR requires a linear model")
        self._model = model.copy(keep_solution=False)
        self.name = name or f"lqr_{self._model.name}"
        self._horizon: Optional[int] = None
        self._Q: Optional[np.ndarray] = None
        self._R: Optional[np.ndarray] = None
        self._K: Optional[np.ndarray] = None
        self._setup_done = False
        self._dt = model.dt or 1.0

    @property
    def horizon(self):
        return self._horizon

    @horizon.setter
    def horizon(self, N):
        if N is not None and int(N) < 1:
            raise ValueError("horizon must be >= 1 (or None for infinite horizon)")
        self._horizon = None if N is None else int(N)

    @property
    def Q(self):
        return self._Q

    @Q.setter
    def Q(self, val):
        Q = _check_psd(val, "Q")
        if Q.shape != (self._model.n_x, self._model.n_x):
            raise ValueError(f"Q shape {Q.shape}, expected "
                             f"{(self._model.n_x, self._model.n_x)}")
        self._Q = Q
        if self._setup_done and self._R is not None:
            self._compute_gain()

    @property
    def R(self):
        return self._R

    @R.setter
    def R(self, val):
        R = _check_psd(val, "R")
        if np.any(np.linalg.eigvalsh(R) <= 0):
            raise ValueError("R must be positive definite")
        if R.shape != (self._model.n_u, self._model.n_u):
            raise ValueError(f"R shape {R.shape}, expected "
                             f"{(self._model.n_u, self._model.n_u)}")
        self._R = R
        if self._setup_done and self._Q is not None:
            self._compute_gain()

    @property
    def K(self):
        """Feedback gain (after setup)."""
        return None if self._K is None else np.array(self._K)

    feedback_gain = K

    def _discrete_AB(self, p=None):
        m = self._model
        if p is not None:
            p = np.broadcast_to(np.atleast_1d(np.asarray(p, dtype=float)),
                                (m.n_p,))
        if m.discrete:
            if m.A is not None and p is None:
                return m.A, m.B
            # linear but declared via equations (possibly parameter-dependent):
            # extract via jacobians at the supplied parameter values
            A, B = m.jacobians(np.zeros(m.n_x), np.zeros(m.n_u), p=p)
            return np.asarray(A), np.asarray(B)
        # continuous linear model: zero-order-hold discretization via matrix exp
        # (the reference instead requires a discrete model, lqr.py; ZOH is a
        # strict superset of that behavior)
        A, B = m.jacobians(np.zeros(m.n_x), np.zeros(m.n_u), p=p)
        import scipy.linalg

        nx, nu = m.n_x, m.n_u
        M = np.zeros((nx + nu, nx + nu))
        M[:nx, :nx] = np.asarray(A)
        M[:nx, nx:] = np.asarray(B)
        E = scipy.linalg.expm(M * self._dt)
        return E[:nx, :nx], E[:nx, nx:]

    def _compute_gain(self, p=None):
        A, B = self._discrete_AB(p=p)
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        A_ = jnp.asarray(A, dtype)
        B_ = jnp.asarray(B, dtype)
        Q_ = jnp.asarray(self._Q, dtype)
        R_ = jnp.asarray(self._R, dtype)
        if self._horizon is None:
            K, P = dare_solve(A_, B_, Q_, R_)
            self._K = np.asarray(K)
        else:
            _, P0 = lqr_backward(A_, B_, Q_, R_, horizon=self._horizon)
            # gain from the fully-iterated Riccati matrix P_N, exactly like the
            # reference (lqr.py:204-260 unrolls N updates then solves for K)
            K = solve_psd_small(R_ + B_.T @ P0 @ B_, B_.T @ P0 @ A_)
            self._K = np.asarray(K)
        self._P = np.asarray(P0 if self._horizon is not None else P)

    def setup(self, dt: Optional[float] = None, **kwargs):
        if dt is not None:
            self._dt = float(dt)
        if self._Q is not None and self._R is not None:
            self._compute_gain()
        self._setup_done = True
        return self

    def is_setup(self):
        return self._setup_done

    def call(self, x=None, p=None, **kwargs):
        if not self._setup_done:
            raise RuntimeError(
                "LQR is not set up. Run LQR.setup(...) before calling the LQR.")
        if self._Q is None:
            raise RuntimeError(
                "Matrix Q is not set properly. To ensure that a unique solution "
                "exists, the matrix Q needs to be symmetric, real-valued and "
                "positive semidefinite.")
        if self._R is None:
            raise RuntimeError(
                "Matrix R is not set properly. To ensure that a unique solution "
                "exists, the matrix R needs to be symmetric, real-valued and "
                "positive definite.")
        if x is None:
            raise ValueError("No state information was supplied to the LQR!")
        if p is not None or self._K is None:
            # parameter-dependent dynamics: the gain is recomputed at the
            # supplied parameter values (reference: tests/test_LQR.py:330)
            self._compute_gain(p=p)
        x = np.asarray(x, dtype=float).ravel()
        return -(self._K @ x)

    optimize = call
    __call__ = call
