"""Batched box-constrained QP by the projected fast gradient method (FGM).

Condensed linear MPC with shared data: for every scenario b,

    min_u 1/2 uᵀHu + (G x0_b)ᵀu   s.t.  lb <= u <= ub,

solved by u+ = clip(y - (1/L)(H y + g)), y+ = u+ + beta (u+ - u) — the batched
analogue of the reference's qpoases/muAO-MPC condensed-QP path (reference:
hilo_mpc/modules/controller/mpc.py:2143-2306, modules/embedded/muaompc.py).
Each iteration is one (B, n) x (n, n) product plus a clip, which XLA hands to
the GPU's matrix library directly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def fgm_boxqp_batch(H, G, x0_batch, lb, ub, iters: int = 60, u0_batch=None):
    """Solve B box-QPs min 1/2 uᵀHu + (G x0)ᵀu with shared H, G.

    H: (n, n), G: (n, nx), x0_batch: (B, nx), lb/ub: (n,) (±inf allowed).
    Returns (B, n). The products run at "highest" precision: the default f32
    dot on the GPU may use TF32 (about three decimal digits), which stalls the
    iteration well above the 1e-5 agreement the solution needs.
    """
    # spectrum on host first (H must be a concrete array, not a tracer)
    eigs = np.linalg.eigvalsh(0.5 * (np.asarray(H) + np.asarray(H).T))
    H = jnp.asarray(H, jnp.float32)
    G = jnp.asarray(G, jnp.float32)
    lb = jnp.asarray(np.where(np.isfinite(lb), lb, -1e30), jnp.float32)
    ub = jnp.asarray(np.where(np.isfinite(ub), ub, 1e30), jnp.float32)
    x0_batch = jnp.asarray(x0_batch, jnp.float32)
    L = float(eigs[-1])
    mu = float(max(eigs[0], 1e-9))
    kappa = np.sqrt(L / mu)
    beta = float((kappa - 1.0) / (kappa + 1.0))
    inv_L = float(1.0 / L)
    hi = lax.Precision.HIGHEST
    g = jnp.matmul(x0_batch, G.T, precision=hi)
    u0 = (jnp.zeros_like(g) if u0_batch is None
          else jnp.asarray(u0_batch, jnp.float32))

    def body(_, carry):
        u, y = carry
        grad = jnp.matmul(y, H.T, precision=hi) + g
        u_new = jnp.clip(y - inv_L * grad, lb, ub)
        y_new = u_new + beta * (u_new - u)
        return (u_new, y_new)

    u, _ = jax.lax.fori_loop(0, iters, body, (u0, u0))
    return u
