"""Fusable small-matrix linear algebra for accelerator hot loops.

XLA lowers `jnp.linalg.cholesky/solve` to blocked while-loop routines or
library calls whose per-call latency dwarfs the actual FLOPs for the
nx/nu/ny-sized blocks that dominate control and estimation sweeps. These helpers unroll the index
arithmetic into plain elementwise expressions that XLA fuses into the
surrounding kernel — exact (no iteration), batched over leading dims, and
`vmap`/`grad`-compatible.

Used by the Riccati sweeps (ops/riccati.py), KF/EKF/UKF scan steps
(estimation/kf.py), and the implicit-integrator Newton solves
(core/integrators.py). Dimensions above the unroll limits fall back to the
stock XLA routines, which amortize fine at larger block sizes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# adjugate-based solves stay well-conditioned (and cheaper than Cholesky) only
# for tiny n; Cholesky unrolls stay fusable a bit further
_SOLVE_UNROLL = 3
_CHOL_UNROLL = 6


def solve_small(G, rhs):
    """Solve G @ X = rhs for general invertible G, fusable for n <= 3.

    The n=2/3 paths are cofactor (adjugate) solves made scale-invariant by
    normalizing G to unit max-entry first — otherwise det overflows f32 at
    ||G|| ~ 1e13, which the barrier-condensed Schur complements can reach near
    active constraints (z/s is clipped only at 1e10*mu/s).

    Shapes: G (..., n, n), rhs (..., n) or (..., n, k).
    """
    n = G.shape[-1]
    vec = rhs.ndim == G.ndim - 1
    if vec:
        rhs = rhs[..., None]
    if 2 <= n <= 3:
        scale = jnp.maximum(
            jnp.max(jnp.abs(G), axis=(-2, -1), keepdims=True), 1e-30)
        G = G / scale
    if n == 1:
        out = rhs / G[..., :1, :]
    elif n == 2:
        a, b = G[..., 0, 0], G[..., 0, 1]
        c, d = G[..., 1, 0], G[..., 1, 1]
        det = a * d - b * c
        x0 = (d[..., None] * rhs[..., 0, :] - b[..., None] * rhs[..., 1, :])
        x1 = (-c[..., None] * rhs[..., 0, :] + a[..., None] * rhs[..., 1, :])
        out = jnp.stack([x0, x1], axis=-2) / (det[..., None, None] * scale)
    elif n == 3:
        a, b, c = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
        d, e, f = G[..., 1, 0], G[..., 1, 1], G[..., 1, 2]
        g, h, i = G[..., 2, 0], G[..., 2, 1], G[..., 2, 2]
        A00 = e * i - f * h
        A01 = c * h - b * i
        A02 = b * f - c * e
        A10 = f * g - d * i
        A11 = a * i - c * g
        A12 = c * d - a * f
        A20 = d * h - e * g
        A21 = b * g - a * h
        A22 = a * e - b * d
        det = a * A00 + b * A10 + c * A20
        adj = jnp.stack([
            jnp.stack([A00, A01, A02], axis=-1),
            jnp.stack([A10, A11, A12], axis=-1),
            jnp.stack([A20, A21, A22], axis=-1)], axis=-2)
        out = (jnp.einsum("...ij,...jk->...ik", adj, rhs)
               / (det[..., None, None] * scale))
    else:
        out = jnp.linalg.solve(G, rhs)
    return out[..., 0] if vec else out


def chol_small(G):
    """Lower-Cholesky factor, unrolled (fusable) for n <= 6.

    G must be symmetric PD. Shapes: (..., n, n) -> (..., n, n).
    """
    n = G.shape[-1]
    if n > _CHOL_UNROLL:
        return jnp.linalg.cholesky(G)
    L = [[None] * n for _ in range(n)]
    zero = jnp.zeros_like(G[..., 0, 0])
    for i in range(n):
        for j in range(i + 1):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    rows = [jnp.stack([L[i][j] if j <= i else zero for j in range(n)], axis=-1)
            for i in range(n)]
    return jnp.stack(rows, axis=-2)


def solve_psd_small(G, rhs):
    """Solve G @ X = rhs for symmetric PD G.

    Scaled adjugate for n <= 3; unrolled Cholesky + unrolled substitution for
    n <= 6 (still one fused elementwise chain); stock XLA Cholesky above.
    Shapes: G (..., n, n), rhs (..., n) or (..., n, k).
    """
    n = G.shape[-1]
    if n <= _SOLVE_UNROLL:
        return solve_small(G, rhs)
    vec = rhs.ndim == G.ndim - 1
    if vec:
        rhs = rhs[..., None]
    if n <= _CHOL_UNROLL:
        L = chol_small(G)
        ncol = rhs.shape[-1]
        Lv = [[L[..., i, j] for j in range(n)] for i in range(n)]
        # forward substitution L Y = rhs, then back substitution L^T X = Y
        Y = [[None] * ncol for _ in range(n)]
        for i in range(n):
            for m in range(ncol):
                acc = rhs[..., i, m]
                for l in range(i):
                    acc = acc - Lv[i][l] * Y[l][m]
                Y[i][m] = acc / Lv[i][i]
        X = [[None] * ncol for _ in range(n)]
        for i in range(n - 1, -1, -1):
            for m in range(ncol):
                acc = Y[i][m]
                for l in range(i + 1, n):
                    acc = acc - Lv[l][i] * X[l][m]
                X[i][m] = acc / Lv[i][i]
        out = jnp.stack([jnp.stack([X[i][m] for m in range(ncol)], axis=-1)
                         for i in range(n)], axis=-2)
    else:
        L = jnp.linalg.cholesky(G)
        out = jax.scipy.linalg.cho_solve((L, True), rhs)
    return out[..., 0] if vec else out


_MM_UNROLL = 8


def mm_small(X, Y):
    """X @ Y lowered to fusable elementwise ops for tiny trailing dims.

    XLA fuses elementwise+reduce chains into single kernels but never fuses
    `dot_general`s with each other; inside latency-bound sequential sweeps the
    broadcast-multiply-sum form avoids one kernel launch per product at
    control-problem block sizes (tools/profile_ip.py). Falls back to `@`
    above n=8.
    """
    if X.shape[-1] <= _MM_UNROLL and X.shape[-2] <= _MM_UNROLL \
            and Y.shape[-1] <= _MM_UNROLL:
        return (X[..., :, :, None] * Y[..., None, :, :]).sum(axis=-2)
    return X @ Y


def mv_small(X, y):
    if X.shape[-1] <= _MM_UNROLL and X.shape[-2] <= _MM_UNROLL:
        return (X * y[..., None, :]).sum(axis=-1)
    return X @ y


def tmm_small(X, Y):
    """X.T @ Y (transpose on the two trailing dims), fusable for tiny blocks."""
    if X.shape[-1] <= _MM_UNROLL and X.shape[-2] <= _MM_UNROLL \
            and Y.shape[-1] <= _MM_UNROLL:
        return (X[..., :, :, None] * Y[..., :, None, :]).sum(axis=-3)
    return jnp.swapaxes(X, -1, -2) @ Y


def tmv_small(X, y):
    if X.shape[-1] <= _MM_UNROLL and X.shape[-2] <= _MM_UNROLL:
        return (X * y[..., :, None]).sum(axis=-2)
    return jnp.swapaxes(X, -1, -2) @ y
