"""Riccati block elimination for stagewise (block-banded) KKT systems.

This is the factorization core of the NMPC/MHE engine — the batched replacement for
the sparse KKT factorizations IPOPT/qpoases perform inside the reference's solver calls
(reference: hilo_mpc/modules/controller/mpc.py:1780, mpc.py:2276). The horizon recursion
runs as a `lax.scan`; every per-stage operation is dense small-matrix algebra that, once
`vmap`-ed over thousands of scenarios, becomes elementwise work across the batch.
Infinite-horizon/LQR gains reuse the same sweep.

Equality-constrained LQ problem solved here:

    min  Σ_{k=0}^{N-1} [ ½ dxᵀQ_k dx + dxᵀS_kᵀdu... ] + ½ dx_Nᵀ P_term dx_N + ...
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,   dx_0 given.

Stage blocks: Q (N,nx,nx), R (N,nu,nu), S (N,nu,nx), q (N,nx), r (N,nu),
A (N,nx,nx), B (N,nx,nu), c (N,nx), terminal P_term (nx,nx), p_term (nx,).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .smallalg import (mm_small as _mm, mv_small as _mv, solve_psd_small,
                       tmm_small as _tmm, tmv_small as _tmv)


class LQSolution(NamedTuple):
    dX: jnp.ndarray      # (N+1, nx)
    dU: jnp.ndarray      # (N, nu)
    lam: jnp.ndarray     # (N, nx) multipliers of the dynamics rows (for x_1..x_N)
    K: jnp.ndarray       # (N, nu, nx) feedback gains
    kff: jnp.ndarray     # (N, nu) feedforward
    cost_red: jnp.ndarray  # predicted objective reduction (scalar, >= 0 at descent)


def backward_sweep(A, B, Q, S, R, q, r, c, P_term, p_term, reg: float = 1e-9,
                   unroll: int = 1):
    """Backward Riccati recursion. Returns (K, kff, P_0, p_0, Ps, ps).

    Regularization `reg` is added to the control-space Schur complement G to guarantee
    factorizability; with PSD stage blocks (Gauss-Newton + barrier terms) G is PD and
    reg only guards roundoff.
    """

    def step(carry, blocks):
        P_next, p_next = carry
        A_k, B_k, Q_k, S_k, R_k, q_k, r_k, c_k = blocks
        Pc_p = _mv(P_next, c_k) + p_next                   # (nx,)
        PA = _mm(P_next, A_k)                              # (nx, nx)
        PB = _mm(P_next, B_k)                              # (nx, nu)
        G = R_k + _tmm(B_k, PB)                            # (nu, nu)
        G = 0.5 * (G + G.T) + reg * jnp.eye(G.shape[0], dtype=G.dtype)
        H_ux = S_k + _tmm(B_k, PA)                         # (nu, nx)
        g_u = r_k + _tmv(B_k, Pc_p)                        # (nu,)
        sol = -solve_psd_small(G, jnp.concatenate([H_ux, g_u[:, None]], axis=1))
        K_k, kff_k = sol[:, :-1], sol[:, -1]
        P_k = Q_k + _tmm(A_k, PA) + _tmm(H_ux, K_k)
        P_k = 0.5 * (P_k + P_k.T)
        p_k = q_k + _tmv(A_k, Pc_p) + _tmv(H_ux, kff_k)
        # predicted decrease contribution: -½ kffᵀ G kff - kffᵀ g_u = ½ kffᵀ G kff
        dec = -0.5 * jnp.dot(kff_k, g_u)
        return (P_k, p_k), (K_k, kff_k, P_next, p_next, dec)

    (P0, p0), (K, kff, Ps_next, ps_next, dec) = lax.scan(
        step, (P_term, p_term), (A, B, Q, S, R, q, r, c), reverse=True,
        unroll=unroll)
    return K, kff, P0, p0, Ps_next, ps_next, jnp.sum(dec)


def forward_sweep(A, B, c, K, kff, dx0, Ps_next, ps_next, unroll: int = 1):
    """Forward rollout of the affine policy; also recovers dynamics multipliers."""

    def step(dx, blocks):
        A_k, B_k, c_k, K_k, kff_k, P_n, p_n = blocks
        du = _mv(K_k, dx) + kff_k
        dx_next = _mv(A_k, dx) + _mv(B_k, du) + c_k
        lam_next = _mv(P_n, dx_next) + p_n
        return dx_next, (dx_next, du, lam_next)

    _, (dX_tail, dU, lam) = lax.scan(
        step, dx0, (A, B, c, K, kff, Ps_next, ps_next), unroll=unroll)
    dX = jnp.concatenate([dx0[None, :], dX_tail], axis=0)
    return dX, dU, lam


def solve_lq(A, B, Q, S, R, q, r, c, P_term, p_term, dx0, reg: float = 1e-9,
             unroll: int = 1) -> LQSolution:
    """Solve the stagewise equality-constrained LQ problem by Riccati elimination."""
    K, kff, P0, p0, Ps_next, ps_next, dec = backward_sweep(
        A, B, Q, S, R, q, r, c, P_term, p_term, reg, unroll=unroll)
    dX, dU, lam = forward_sweep(A, B, c, K, kff, dx0, Ps_next, ps_next,
                                unroll=unroll)
    return LQSolution(dX=dX, dU=dU, lam=lam, K=K, kff=kff, cost_red=dec)


def solve_lq_parallel(A, B, Q, S, R, q, r, c, P_term, p_term, dx0,
                      reg: float = 1e-9) -> LQSolution:
    """Temporal-parallel LQ solve: O(log N) depth via `lax.associative_scan`.

    Same problem and interface as `solve_lq`, but both the value-function
    (backward) and trajectory (forward) recursions run as associative scans —
    the parallelization of the Riccati recursion (PAPERS.md: Särkkä &
    García-Fernández temporal parallelization; dual-regularized Riccati IP).
    On an accelerator this turns the horizon from a serial chain into a
    log-depth tree of batched small-matrix composes.

    When to use: only for FEW scenarios with LONG horizons — i.e. when the
    device is otherwise idle along the batch dimension. At large batch the
    sequential sweep already fills the device and this variant's ~3x flops
    make it slower. It is therefore opt-in (IPOptions.parallel_riccati).

    Precision: under the solver's `default_matmul_precision("highest")` this
    scan is as accurate as the sequential sweep on random stagewise LQ
    problems (f32 against f64 truth); a square-root/QR-composed variant gave
    no improvement and NaNs first on extreme κ~1e9 problems, so it was
    dropped. The precision hazard is a reduced-precision default matmul
    (TF32 on the GPU), which degrades ALL variants equally — never run the
    KKT path at default matmul precision (see solve_ocp).

    Method: per-stage cross/linear control terms are eliminated by completing the
    square (u = ũ - R⁻¹(S dx + r)), stages become conditional-value-function
    elements e_k = (A, b, C, η, J) with the standard composition rule; the reverse
    associative scan yields (P_k, p_k) = (J_k, -η_k) for every k at once; gains and
    the forward affine rollout follow as one vmap + one more associative scan over
    affine-map composition.
    """
    N, nx = A.shape[0], A.shape[1]
    nu = B.shape[2]
    dtype = A.dtype
    I_nu = jnp.eye(nu, dtype=dtype)
    I_nx = jnp.eye(nx, dtype=dtype)

    # --- eliminate control cross/linear terms per stage (vmapped) ---
    R_reg = R + reg * I_nu
    Rinv = jnp.linalg.inv(0.5 * (R_reg + jnp.swapaxes(R_reg, 1, 2)))
    RiS = jnp.einsum("kij,kjn->kin", Rinv, S)          # R⁻¹S
    Rir = jnp.einsum("kij,kj->ki", Rinv, r)            # R⁻¹r
    A_t = A - jnp.einsum("kij,kjn->kin", B, RiS)       # A - B R⁻¹ S
    c_t = c - jnp.einsum("kij,kj->ki", B, Rir)         # c - B R⁻¹ r
    Q_t = Q - jnp.einsum("kni,kij->knj", jnp.swapaxes(S, 1, 2), RiS)
    q_t = q - jnp.einsum("kni,ki->kn", jnp.swapaxes(S, 1, 2), Rir)
    C_t = jnp.einsum("kij,kjl,knl->kin", B, Rinv, B)   # B R⁻¹ Bᵀ

    # --- elements: stages 0..N-1 then the terminal boundary element ---
    Ae = jnp.concatenate([A_t, jnp.zeros((1, nx, nx), dtype)], axis=0)
    be = jnp.concatenate([c_t, jnp.zeros((1, nx), dtype)], axis=0)
    Ce = jnp.concatenate([C_t, jnp.zeros((1, nx, nx), dtype)], axis=0)
    etae = jnp.concatenate([-q_t, -p_term[None]], axis=0)
    Je = jnp.concatenate([Q_t, P_term[None]], axis=0)

    def combine(ei, ej):
        # ei spans [k, m], ej spans [m, l] — note associative_scan(reverse=True)
        # calls combine(earlier, later) elementwise on reversed order; arguments
        # here are (later-in-scan, earlier-in-scan) => map (i=left/earlier in time,
        # j=right/later in time) accordingly below.
        Ai, bi, Ci, etai, Ji = ei
        Aj, bj, Cj, etaj, Jj = ej
        M = jnp.linalg.inv(jnp.eye(nx, dtype=dtype) + jnp.einsum(
            "...ij,...jn->...in", Ci, Jj))
        AjM = jnp.einsum("...ij,...jn->...in", Aj, M)
        A_new = jnp.einsum("...ij,...jn->...in", AjM, Ai)
        b_new = jnp.einsum("...ij,...j->...i", AjM,
                           bi + jnp.einsum("...ij,...j->...i", Ci, etaj)) + bj
        C_new = jnp.einsum("...ij,...jn,...mn->...im", AjM, Ci, Aj) + Cj
        Mt = jnp.linalg.inv(jnp.eye(nx, dtype=dtype) + jnp.einsum(
            "...ij,...jn->...in", Jj, Ci))
        AiT_Mt = jnp.einsum("...ji,...jn->...in", Ai, Mt)
        eta_new = jnp.einsum("...ij,...j->...i", AiT_Mt,
                             etaj - jnp.einsum("...ij,...j->...i", Jj, bi)) + etai
        J_new = jnp.einsum("...ij,...jn,...nm->...im", AiT_Mt, Jj, Ai) + Ji
        return (A_new, b_new, C_new, eta_new, J_new)

    def combine_rev(a, b):
        # reverse scan feeds (later, earlier); re-order to (earlier, later)
        return combine(b, a)

    elems = (Ae, be, Ce, etae, Je)
    _, _, _, eta_all, J_all = lax.associative_scan(combine_rev, elems,
                                                   reverse=True)
    Ps = J_all                      # (N+1, nx, nx): P_k for all k
    ps = -eta_all                   # (N+1, nx)

    # --- gains from (P_{k+1}, p_{k+1}) for all stages at once ---
    P_next = Ps[1:]
    p_next = ps[1:]
    PB = jnp.einsum("kij,kjn->kin", P_next, B)
    G = R + jnp.einsum("kji,kjn->kin", B, PB)       # R + BᵀP'B
    G = 0.5 * (G + jnp.swapaxes(G, 1, 2)) + reg * I_nu
    H_ux = S + jnp.einsum("kji,kjl,kln->kin", B, P_next, A)
    Pc_p = jnp.einsum("kij,kj->ki", P_next, c) + p_next
    g_u = r + jnp.einsum("kji,kj->ki", B, Pc_p)
    Ginv = jnp.linalg.inv(G)
    K = -jnp.einsum("kij,kjn->kin", Ginv, H_ux)
    kff = -jnp.einsum("kij,kj->ki", Ginv, g_u)

    # --- forward affine rollout as an associative scan over (M, v) composition ---
    Mcl = A + jnp.einsum("kij,kjn->kin", B, K)
    vcl = jnp.einsum("kij,kj->ki", B, kff) + c

    def affine_compose(f, g):
        # f then g: x -> Mg (Mf x + vf) + vg
        Mf, vf = f
        Mg, vg = g
        return (jnp.einsum("...ij,...jn->...in", Mg, Mf),
                jnp.einsum("...ij,...j->...i", Mg, vf) + vg)

    Mscan, vscan = lax.associative_scan(affine_compose, (Mcl, vcl))
    dX_tail = jnp.einsum("kij,j->ki", Mscan, dx0) + vscan
    dX = jnp.concatenate([dx0[None], dX_tail], axis=0)
    dU = jnp.einsum("kij,kj->ki", K, dX[:-1]) + kff
    lam = jnp.einsum("kij,kj->ki", P_next, dX[1:]) + p_next
    dec = -0.5 * jnp.einsum("ki,ki->", kff, g_u)
    return LQSolution(dX=dX, dU=dU, lam=lam, K=K, kff=kff, cost_red=dec)


def lqr_backward(A, B, Q, R, S=None, P_term=None, horizon: int = None):
    """Finite-horizon time-invariant LQR gains K_0..K_{N-1} (and P_0).

    Replaces the reference's unrolled symbolic Riccati iteration (reference:
    hilo_mpc/modules/controller/lqr.py:204-260).
    """
    nx = A.shape[0]
    nu = B.shape[1]
    dtype = A.dtype
    if S is None:
        S = jnp.zeros((nu, nx), dtype)
    if P_term is None:
        P_term = Q
    N = horizon

    def rep(M):
        return jnp.broadcast_to(M, (N,) + M.shape)

    K, kff, P0, p0, _, _, _ = backward_sweep(
        rep(A), rep(B), rep(Q), rep(S), rep(R),
        jnp.zeros((N, nx), dtype), jnp.zeros((N, nu), dtype),
        jnp.zeros((N, nx), dtype), P_term, jnp.zeros(nx, dtype))
    return K, P0


def dare_solve(A, B, Q, R, iters: int = 200):
    """Infinite-horizon discrete algebraic Riccati equation by fixed-point iteration."""
    dtype = A.dtype
    nu = B.shape[1]

    def body(_, P):
        PB = P @ B
        G = R + B.T @ PB
        K = solve_psd_small(G, (B.T @ P @ A))
        P_new = Q + A.T @ P @ (A - B @ K)
        return 0.5 * (P_new + P_new.T)

    P = lax.fori_loop(0, iters, body, Q)
    K = solve_psd_small(R + B.T @ P @ B, B.T @ P @ A)
    return K, P


def sweep_unroll(platform: str, N: int) -> int:
    """`lax.scan` unroll factor of the XLA Riccati sweeps for a platform.

    On the GPU the fully unrolled sweeps (N) let XLA fuse across stages; on
    the CPU unrolling only costs compile time, so the scan stays rolled (1).
    """
    return N if platform == "gpu" else 1
