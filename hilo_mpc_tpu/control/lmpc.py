"""Linear MPC.

Rebuild of the reference's LMPC (reference: hilo_mpc/modules/controller/mpc.py:
1934-2460). The reference condenses the problem into one sparse QP via Kronecker
products (H = blkdiag(kron(I,Q), P, kron(I,R)), mpc.py:2143-2306) and calls qpoases;
here the linear-quadratic structure stays stagewise and the same Riccati interior-point
engine solves it — for a linear model the dynamics Jacobians are constant, so each IP
iteration is exact and convergence takes a handful of iterations. Q/R/P are set as
matrices (reference's property API) instead of via cost-term accumulation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.model import Model
from .nmpc import NMPC


def _check_weight(val, n, name, psd_ok=True):
    M = np.asarray(val, dtype=float)
    if M.ndim == 0:
        M = np.eye(n) * float(M)
    elif M.ndim == 1:
        M = np.diag(M)
    if M.shape != (n, n):
        raise ValueError(f"{name} shape {M.shape}, expected {(n, n)}")
    if not np.allclose(M, M.T, atol=1e-10):
        raise ValueError(f"{name} must be symmetric")
    eigs = np.linalg.eigvalsh(M)
    if np.any(eigs < -1e-10):
        raise ValueError(f"{name} must be positive semi-definite")
    return M


class LMPC(NMPC):
    """Discrete-time linear MPC with matrix-weight API."""

    _controller_type = "LMPC"

    def __init__(self, model: Model, **kwargs):
        if not model.is_linear:
            raise ValueError("LMPC requires a linear model; use NMPC instead")
        super().__init__(model, **kwargs)
        nx, nu = model.n_x, model.n_u
        self._Q_mat = np.eye(nx)
        self._R_mat = np.eye(nu)
        self._P_mat: Optional[np.ndarray] = None
        self._x_ref: Optional[np.ndarray] = None
        self._u_ref: Optional[np.ndarray] = None

    @property
    def Q(self):
        return np.array(self._Q_mat)

    @Q.setter
    def Q(self, val):
        self._Q_mat = _check_weight(val, self._model.n_x, "Q")

    @property
    def R(self):
        return np.array(self._R_mat)

    @R.setter
    def R(self, val):
        R = _check_weight(val, self._model.n_u, "R")
        if np.any(np.linalg.eigvalsh(R) <= 0):
            raise ValueError("R must be positive definite")
        self._R_mat = R

    @property
    def P(self):
        return None if self._P_mat is None else np.array(self._P_mat)

    @P.setter
    def P(self, val):
        self._P_mat = _check_weight(val, self._model.n_x, "P")

    def set_reference(self, x_ref=None, u_ref=None):
        if x_ref is not None:
            self._x_ref = np.asarray(x_ref, dtype=float).ravel()
        if u_ref is not None:
            self._u_ref = np.asarray(u_ref, dtype=float).ravel()
        return self

    def setup(self, options: Optional[dict] = None, **kwargs):
        # install the matrix weights as cost terms, then defer to the OCP engine
        self.quad_stage_cost.terms = [
            t for t in self.quad_stage_cost.terms
            if t.kind not in ("states", "inputs")]
        self.quad_stage_cost.add_states(weights=self._Q_mat, ref=self._x_ref)
        if self._model.n_u:
            self.quad_stage_cost.add_inputs(weights=self._R_mat, ref=self._u_ref)
        self.quad_terminal_cost.terms = []
        if self._P_mat is not None:
            self.quad_terminal_cost.add_states(weights=self._P_mat,
                                               ref=self._x_ref)
        options = dict(options or {})
        if self._model.discrete:
            options.setdefault("integration_method", "discrete")
        return super().setup(options=options, **kwargs)

    # -- condensed-QP fast path (Pallas) --------------------------------------
    def condensed_qp(self):
        """(H, G, lb, ub) of the condensed input-sequence QP (factor 2: our cost
        convention is xᵀQx, the QP's is ½uᵀHu)."""
        from ..embedded.codegen import condense_lmpc

        model = self._model
        A, B = model.A, model.B
        if A is None:
            A, B = (np.asarray(j) for j in model.jacobians(
                np.zeros(model.n_x), np.zeros(model.n_u)))
        if not model.discrete:
            raise ValueError("condensed fast path requires a discrete-time model")
        N = self.horizon
        H, G = condense_lmpc(A, B, 2 * self.Q, 2 * self.R,
                             2 * self.P if self.P is not None else None, N)
        lb = np.tile(self._u_lb, N)
        ub = np.tile(self._u_ub, N)
        return H, G, lb, ub

    def optimize_batch_fgm(self, x0_batch, iters: int = 100):
        """Batched condensed-QP solve by the projected fast gradient method
        (ops/fgm.py). Returns the first control moves (B, n_u)."""
        from ..ops.fgm import fgm_boxqp_batch

        if self._x_ref is not None or self._u_ref is not None:
            raise NotImplementedError("fgm fast path currently solves the "
                                      "regulation problem (no references)")
        H, G, lb, ub = self.condensed_qp()
        x0_batch = np.atleast_2d(np.asarray(x0_batch, dtype=float))
        U = fgm_boxqp_batch(H, G, x0_batch, lb, ub, iters=iters)
        nu = self._model.n_u
        return np.asarray(U)[:, :nu]
