"""Fixed-step ODE/DAE integrators for accelerators.

Batched replacement for the reference's CVODES/IDAS adaptive integrators and its
RK/collocation transcription (reference: hilo_mpc/modules/base.py:1713,
hilo_mpc/util/modeling.py:1088-1314): adaptive stepping is compiler-hostile, so accuracy is
bought with collocation degree / RK order / substeps, all with static shapes. Implicit
stages (DAE algebraic variables, collocation equations) are solved by a fixed-iteration
Newton wrapped in ``lax.custom_root`` so sensitivities use the implicit function theorem
instead of differentiating through the iterations.

Conventions:
  - ``ode(x, z, u, p, t) -> dx``         shape (nx,)
  - ``alg(x, z, u, p, t) -> residual``   shape (nz,), semi-explicit DAE 0 = g(...)
  - all arrays are 1-D per instance; batching is done by ``vmap`` outside.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.smallalg import solve_small

# ---------------------------------------------------------------------------
# Explicit Runge-Kutta Butcher tableaus (same method menu as the reference's
# EXPLICIT_METHODS registry, hilo_mpc/util/modeling.py:1008 — tableaus are textbook).
# ---------------------------------------------------------------------------

_ERK_TABLEAUS = {
    # name: (A, b, c)
    "euler": ([[0.0]], [1.0], [0.0]),
    "rk1": ([[0.0]], [1.0], [0.0]),
    "midpoint": ([[0.0, 0.0], [0.5, 0.0]], [0.0, 1.0], [0.0, 0.5]),
    "heun": ([[0.0, 0.0], [1.0, 0.0]], [0.5, 0.5], [0.0, 1.0]),
    "rk2": ([[0.0, 0.0], [0.5, 0.0]], [0.0, 1.0], [0.0, 0.5]),
    "ralston": ([[0.0, 0.0], [2 / 3, 0.0]], [0.25, 0.75], [0.0, 2 / 3]),
    "heun3": (
        [[0.0, 0.0, 0.0], [1 / 3, 0.0, 0.0], [0.0, 2 / 3, 0.0]],
        [0.25, 0.0, 0.75],
        [0.0, 1 / 3, 2 / 3],
    ),
    "rk3": (
        [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [-1.0, 2.0, 0.0]],
        [1 / 6, 2 / 3, 1 / 6],
        [0.0, 0.5, 1.0],
    ),
    "ssprk3": (
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.25, 0.25, 0.0]],
        [1 / 6, 1 / 6, 2 / 3],
        [0.0, 1.0, 0.5],
    ),
    "rk4": (
        [
            [0.0, 0.0, 0.0, 0.0],
            [0.5, 0.0, 0.0, 0.0],
            [0.0, 0.5, 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
        ],
        [1 / 6, 1 / 3, 1 / 3, 1 / 6],
        [0.0, 0.5, 0.5, 1.0],
    ),
    "rk38": (
        [
            [0.0, 0.0, 0.0, 0.0],
            [1 / 3, 0.0, 0.0, 0.0],
            [-1 / 3, 1.0, 0.0, 0.0],
            [1.0, -1.0, 1.0, 0.0],
        ],
        [1 / 8, 3 / 8, 3 / 8, 1 / 8],
        [0.0, 1 / 3, 2 / 3, 1.0],
    ),
}

ERK_METHODS = tuple(sorted(_ERK_TABLEAUS))


def erk_tableau(method: str):
    try:
        A, b, c = _ERK_TABLEAUS[method]
    except KeyError:
        raise ValueError(
            f"unknown explicit RK method {method!r}; available: {ERK_METHODS}"
        ) from None
    return np.asarray(A), np.asarray(b), np.asarray(c)


# ---------------------------------------------------------------------------
# Newton with implicit differentiation
# ---------------------------------------------------------------------------


def newton_solve(res_fn: Callable, w0: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Solve res_fn(w) = 0 by a fixed number of damped-free Newton steps.

    Differentiation goes through ``lax.custom_root`` → implicit function theorem, so
    gradients cost one extra linear solve, not ``iters`` unrolled solves.
    """

    def solve(f, w):
        jac = jax.jacfwd(f)

        def body(_, w):
            r = f(w)
            J = jac(w)
            return w - solve_small(J, r)

        return lax.fori_loop(0, iters, body, w)

    def tangent_solve(g, y):
        # g is linear; its (constant) Jacobian evaluated anywhere.
        J = jax.jacfwd(g)(jnp.zeros_like(y))
        return solve_small(J, y)

    return lax.custom_root(res_fn, w0, solve, tangent_solve)


# ---------------------------------------------------------------------------
# Collocation basis (Radau IIA / Gauss-Legendre, arbitrary degree)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def collocation_points(degree: int, scheme: str = "radau") -> Tuple[float, ...]:
    """Collocation nodes on (0, 1], excluding the left endpoint 0."""
    if degree < 1:
        raise ValueError("collocation degree must be >= 1")
    if scheme == "legendre":
        pts = np.polynomial.legendre.leggauss(degree)[0]  # on (-1, 1)
        pts = 0.5 * (pts + 1.0)
    elif scheme == "radau":
        # Radau IIA nodes: roots of P_d(2t-1) - P_{d-1}(2t-1) on (0, 1]; includes t=1.
        Pd = np.polynomial.legendre.Legendre.basis(degree)
        Pdm1 = np.polynomial.legendre.Legendre.basis(degree - 1)
        poly = Pd - Pdm1
        roots = poly.roots()
        pts = np.sort(np.real(0.5 * (roots + 1.0)))
    else:
        raise ValueError(f"unknown collocation scheme {scheme!r} (radau|legendre)")
    return tuple(float(t) for t in pts)


@functools.lru_cache(maxsize=None)
def collocation_coefficients(degree: int, scheme: str = "radau"):
    """Lagrange-basis collocation matrices over nodes tau_0=0 < tau_1 < ... < tau_d.

    Returns (C, D, B, taus):
      C[j, r] = dL_r/dtau (tau_j)  for j=1..d       (d, d+1) derivative matrix
      D[r]    = L_r(1)                              (d+1,)   continuity weights
      B[r]    = ∫_0^1 L_r dtau                      (d+1,)   quadrature weights
    """
    taus = (0.0,) + collocation_points(degree, scheme)
    n = degree + 1
    C = np.zeros((degree, n))
    D = np.zeros(n)
    B = np.zeros(n)
    for r in range(n):
        # Lagrange polynomial L_r through the nodes
        poly = np.poly1d([1.0])
        for s in range(n):
            if s != r:
                poly *= np.poly1d([1.0, -taus[s]]) / (taus[r] - taus[s])
        D[r] = poly(1.0)
        dpoly = np.polyder(poly)
        for j in range(1, n):
            C[j - 1, r] = dpoly(taus[j])
        ipoly = np.polyint(poly)
        B[r] = ipoly(1.0)
    return C, D, B, np.asarray(taus)


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------


def make_erk_step(
    ode: Callable,
    alg: Optional[Callable] = None,
    nz: int = 0,
    method: str = "rk4",
    newton_iters: int = 8,
) -> Callable:
    """Build ``step(x, z, u, p, t, dt) -> (x_next, z_next)`` for an explicit RK method.

    For semi-explicit DAEs the algebraic variables are solved at every stage by Newton
    (index-1 assumption), mirroring the reference's rootfinder-embedded discretization
    (reference: hilo_mpc/modules/dynamic_model/dynamic_model.py:2223-2312) but with fixed
    iteration counts.
    """
    A, b, c = erk_tableau(method)
    # plain python floats are weak-typed in JAX: they never promote f32 states to f64
    A = [[float(v) for v in row] for row in A]
    b = [float(v) for v in b]
    c = [float(v) for v in c]
    s = len(b)

    def stage_z(x_stage, z_guess, u, p, t_stage):
        if alg is None or nz == 0:
            return z_guess
        res = lambda z: alg(x_stage, z, u, p, t_stage)
        return newton_solve(res, z_guess, iters=newton_iters)

    def step(x, z, u, p, t, dt):
        ks = []
        z_cur = z
        for i in range(s):
            xi = x
            for j in range(i):
                if A[i][j] != 0.0:
                    xi = xi + dt * A[i][j] * ks[j]
            ti = t + c[i] * dt
            z_cur = stage_z(xi, z_cur, u, p, ti)
            ks.append(ode(xi, z_cur, u, p, ti))
        x_next = x
        for i in range(s):
            if b[i] != 0.0:
                x_next = x_next + dt * b[i] * ks[i]
        z_next = stage_z(x_next, z_cur, u, p, t + dt)
        return x_next, z_next

    return step


def make_collocation_step(
    ode: Callable,
    alg: Optional[Callable] = None,
    nx: int = 0,
    nz: int = 0,
    degree: int = 3,
    scheme: str = "radau",
    newton_iters: int = 8,
) -> Callable:
    """Build an implicit collocation step (Radau IIA by default — stiffly accurate,
    the workhorse replacing IDAS for DAEs and stiff ODEs)."""
    C, D, B, taus = collocation_coefficients(degree, scheme)
    taus = [float(v) for v in taus]  # weak-typed: no f32 -> f64 promotion
    d = degree

    def step(x, z, u, p, t, dt):
        dtype = x.dtype
        Cj = jnp.asarray(C, dtype)
        Dj = jnp.asarray(D, dtype)

        def unpack(w):
            X = w[: d * nx].reshape(d, nx)
            Z = w[d * nx :].reshape(d, nz) if nz else jnp.zeros((d, 0), dtype)
            return X, Z

        def residual(w):
            X, Z = unpack(w)
            Xall = jnp.concatenate([x[None, :], X], axis=0)  # (d+1, nx)
            res_x = []
            res_z = []
            for j in range(1, d + 1):
                tj = t + taus[j] * dt
                zj = Z[j - 1] if nz else z
                fj = ode(X[j - 1], zj, u, p, tj)
                # sum_r C[j-1, r] * X_r = dt * f(X_j)
                xdot_poly = jnp.einsum("r,rn->n", Cj[j - 1], Xall)
                res_x.append(xdot_poly - dt * fj)
                if nz:
                    res_z.append(alg(X[j - 1], zj, u, p, tj))
            out = jnp.concatenate([r.ravel() for r in res_x])
            if nz:
                out = jnp.concatenate([out, jnp.concatenate([r.ravel() for r in res_z])])
            return out

        w0 = jnp.concatenate(
            [jnp.tile(x, d)] + ([jnp.tile(z, d)] if nz else [])
        )
        w = newton_solve(residual, w0, iters=newton_iters)
        X, Z = unpack(w)
        Xall = jnp.concatenate([x[None, :], X], axis=0)
        x_next = jnp.einsum("r,rn->n", Dj, Xall)
        z_next = Z[-1] if nz else z
        return x_next, z_next

    return step


def make_discrete_step(f: Callable, alg: Optional[Callable] = None, nz: int = 0,
                       newton_iters: int = 8) -> Callable:
    """Wrap an already-discrete map x+ = f(x, z, u, p, t) as a step function."""

    def step(x, z, u, p, t, dt):
        x_next = f(x, z, u, p, t)
        if alg is not None and nz:
            res = lambda zz: alg(x_next, zz, u, p, t + dt)
            z_next = newton_solve(res, z, iters=newton_iters)
        else:
            z_next = z
        return x_next, z_next

    return step


def with_substeps(step: Callable, substeps: int) -> Callable:
    """Divide each dt into ``substeps`` equal integrator steps via lax.scan."""
    if substeps <= 1:
        return step

    def stepped(x, z, u, p, t, dt):
        h = dt / substeps

        def body(carry, i):
            xc, zc = carry
            xn, zn = step(xc, zc, u, p, t + i * h, h)
            return (xn, zn), None

        (x_next, z_next), _ = lax.scan(
            body, (x, z), jnp.arange(substeps, dtype=x.dtype)
        )
        return x_next, z_next

    return stepped


class IntegratorSpec(NamedTuple):
    """Static description of an integrator configuration."""

    method: str = "rk4"  # erk name | 'collocation' | 'discrete'
    degree: int = 3
    scheme: str = "radau"  # collocation family
    substeps: int = 1
    newton_iters: int = 8


def make_step(
    ode: Callable,
    alg: Optional[Callable],
    nx: int,
    nz: int,
    spec: IntegratorSpec,
) -> Callable:
    """Dispatch to the right step factory. Returns step(x, z, u, p, t, dt)."""
    m = spec.method.lower()
    if m in ("collocation", "irk"):
        base = make_collocation_step(
            ode, alg, nx=nx, nz=nz, degree=spec.degree, scheme=spec.scheme,
            newton_iters=spec.newton_iters,
        )
    elif m == "discrete":
        base = make_discrete_step(ode, alg, nz=nz, newton_iters=spec.newton_iters)
    elif m in ("cvodes", "idas"):
        # Adaptive SUNDIALS integrators have no fixed-cost analogue; map to high-order
        # implicit collocation which covers the same stiff/DAE ground at fixed cost.
        base = make_collocation_step(
            ode, alg, nx=nx, nz=nz, degree=max(spec.degree, 3), scheme="radau",
            newton_iters=spec.newton_iters,
        )
    else:
        base = make_erk_step(ode, alg, nz=nz, method=m, newton_iters=spec.newton_iters)
    return with_substeps(base, spec.substeps)
