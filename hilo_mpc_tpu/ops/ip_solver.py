"""Stagewise nonlinear primal-dual interior-point solver for optimal control.

Batched replacement for IPOPT as used by the reference's NMPC/MHE/OCP solves
(reference: hilo_mpc/modules/controller/mpc.py:1778-1787, modules/estimator/mhe.py). The
NLP never materializes as a flat sparse matrix: the multiple-shooting structure is kept
stagewise, each IP iteration linearizes dynamics/costs/constraints per stage (vmapped over
the horizon), condenses the barrier terms into the stage Hessians, and factorizes the
block-banded KKT system with a Riccati sweep (ops/riccati.py). Iteration counts are fixed
with per-scenario convergence masks, so the whole solve jits and `vmap`s over thousands of
scenarios — the batched analogue of the reference's one-problem-at-a-time IPOPT calls.

Algorithmic skeleton (monotone Fiacco-McCormick barrier updates, fraction-to-boundary
rule, slack reset, l1-merit backtracking) follows the standard interior-point literature
that IPOPT implements, so converged solutions match the reference's to solver tolerance.

Problem form (single scenario; batch via vmap):

    min   Σ_{k=0}^{N-1} l(x_k, u_k, θ_k)  +  lN(x_N, θ_N)
    s.t.  x_{k+1} = F(x_k, u_k, θ_k)                    k = 0..N-1
          lbu ≤ u_k ≤ ubu,  lbx ≤ x_k ≤ ubx             (±inf allowed)
          h(x_k, u_k, θ_k) ≤ 0,   hN(x_N, θ_N) ≤ 0
          x_0 = x̂  (fix_x0=True)  or  x_0 free (MHE arrival)
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .riccati import backward_sweep, solve_lq, solve_lq_parallel


class OCPFunctions(NamedTuple):
    dyn: Callable                    # F(x, u, theta) -> (nx,)
    stage_cost: Callable             # l(x, u, theta) -> scalar
    term_cost: Callable              # lN(x, thetaN) -> scalar
    stage_ineq: Optional[Callable] = None   # h(x, u, theta) -> (n_h,)
    term_ineq: Optional[Callable] = None    # hN(x, thetaN) -> (n_hN,)
    stage_eq: Optional[Callable] = None     # e(x, u, theta) -> (n_e,), e == 0
    term_eq: Optional[Callable] = None      # eN(x, thetaN) -> (n_eN,), eN == 0


@dataclasses.dataclass(frozen=True)
class OCPDims:
    nx: int
    nu: int
    N: int
    n_h: int = 0
    n_hN: int = 0
    n_e: int = 0
    n_eN: int = 0


class OCPBounds(NamedTuple):
    """±inf-padded box bounds. Shapes: lbx/ubx (N+1, nx), lbu/ubu (N, nu)."""
    lbx: jnp.ndarray
    ubx: jnp.ndarray
    lbu: jnp.ndarray
    ubu: jnp.ndarray


def default_bounds(dims: OCPDims, dtype=jnp.float32) -> OCPBounds:
    inf = jnp.asarray(jnp.inf, dtype)
    return OCPBounds(
        lbx=-inf * jnp.ones((dims.N + 1, dims.nx), dtype),
        ubx=inf * jnp.ones((dims.N + 1, dims.nx), dtype),
        lbu=-inf * jnp.ones((dims.N, dims.nu), dtype),
        ubu=inf * jnp.ones((dims.N, dims.nu), dtype),
    )


@dataclasses.dataclass(frozen=True)
class IPOptions:
    max_iter: int = 40
    tol: float = 1e-6
    mu_init: float = 1e-1
    mu_min: float = 1e-9
    kappa_mu: float = 0.2        # linear mu reduction factor
    theta_mu: float = 1.5        # superlinear mu reduction exponent
    kappa_eps: float = 10.0      # barrier-subproblem tolerance = kappa_eps * mu
    tau_min: float = 0.99        # fraction-to-boundary
    # each candidate re-evaluates the horizon rollout, so fewer is cheaper;
    # 6 keeps convergence on every stress case (incl. min-time bang-bang)
    n_linesearch: int = 6        # backtracking candidates (halvings)
    reg: float = 1e-8            # Riccati control-Schur regularization
    convexify: bool = True       # eigenvalue-clip indefinite cost Hessians
    min_eig: float = 1e-6
    # slack floor at init — the IP analogue of IPOPT's bound_push (kappa_1 =
    # 1e-2): an initial point sitting ON a bound (e.g. u_guess = 0 with
    # u_lb = 0, the bioreactor feed case) would get s ~ 0, dual z = mu/s and
    # barrier curvature z/s that walls the iterate in; measured on the
    # Lee-Ramirez fed-batch NMPC, s_min=1e-6 crawls (0% convergence at 80
    # iters, u creeping 1e-3/iter) while 1e-2 converges normally. Points
    # genuinely in the interior (|c0| > s_min) are untouched.
    s_min: float = 1e-2
    early_exit: bool = True      # while_loop with convergence predicate
    # equality constraints are handled by an augmented-Lagrangian term
    # (tight two-sided bounds would choke the fraction-to-boundary rule)
    rho_eq: float = 1e2          # initial AL penalty
    rho_eq_max: float = 1e7
    record_iterates: bool = False  # keep per-iteration (X, U, kkt, mu, obj) history
    parallel_riccati: bool = False  # O(log N)-depth associative-scan KKT solve
    mehrotra: bool = False       # predictor-corrector with adaptive centering
    # lax.scan unroll factor for the Riccati sweeps: unrolling lets XLA fuse
    # across stages and trims per-step loop overhead, at the price of compile
    # time (riccati.sweep_unroll is the platform rule MHE applies)
    riccati_unroll: int = 1
    # treat the cost Hessian blocks as constant (exact for quadratic costs):
    # they are evaluated once at the initial point instead of every iteration,
    # removing the per-iteration jax.hessian (and eigh when convexify is on).
    # Ignored when equality constraints are present (the AL terms change the
    # Hessian with rho). NMPC auto-enables this for pure quadratic costs.
    const_cost_hessian: bool = False
    # store the per-stage linearization tensors (A, B, Hessian blocks,
    # constraint jacobians) in bfloat16 between production and consumption:
    # these tensors dominate the per-iteration device-memory bytes.
    # Gradients, values and the Newton algebra stay f32 (bf16 tensors promote
    # at use). KKT stationarity is then only trustworthy to ~1e-3 relative,
    # so use with tol >= 1e-3 and verify convergence on your problem.
    # None = off (default); "bfloat16" = on.
    lin_storage_dtype: Optional[str] = None


class OCPSolution(NamedTuple):
    X: jnp.ndarray          # (N+1, nx)
    U: jnp.ndarray          # (N, nu)
    lam: jnp.ndarray        # (N, nx)
    s: jnp.ndarray          # (N, m)
    z: jnp.ndarray          # (N, m)
    sN: jnp.ndarray         # (mN,)
    zN: jnp.ndarray         # (mN,)
    mu: jnp.ndarray         # scalar
    kkt_error: jnp.ndarray  # scalar
    objective: jnp.ndarray  # scalar
    iterations: jnp.ndarray  # scalar int
    converged: jnp.ndarray  # scalar bool
    status: jnp.ndarray     # 0 ok, 1 max_iter, 2 diverged/NaN


# ---------------------------------------------------------------------------
# Stage constraint assembly: rows = [u-ubu; lbu-u; x-ubx; lbx-x; h(x,u,θ)]
# ---------------------------------------------------------------------------


def _stage_ineq_fn(funcs: OCPFunctions, dims: OCPDims):
    def c_fn(x, u, theta, lbx, ubx, lbu, ubu, mask):
        rows = [u - ubu, lbu - u, x - ubx, lbx - x]
        if funcs.stage_ineq is not None and dims.n_h:
            rows.append(funcs.stage_ineq(x, u, theta))
        c = jnp.concatenate(rows)
        return jnp.where(mask, c, -1.0)
    return c_fn


def _term_ineq_fn(funcs: OCPFunctions, dims: OCPDims):
    def cN_fn(x, thetaN, lbx, ubx, mask):
        rows = [x - ubx, lbx - x]
        if funcs.term_ineq is not None and dims.n_hN:
            rows.append(funcs.term_ineq(x, thetaN))
        c = jnp.concatenate(rows)
        return jnp.where(mask, c, -1.0)
    return cN_fn


def _pinned_controls(bounds: OCPBounds):
    """Controls with lbu == ubu are fixed values, not barrier rows (a tight
    two-sided bound would choke the fraction-to-boundary rule globally)."""
    return (jnp.isfinite(bounds.ubu) & jnp.isfinite(bounds.lbu)
            & (bounds.ubu - bounds.lbu < 1e-9))


def _constraint_masks(bounds: OCPBounds, dims: OCPDims, fix_x0: bool):
    """Static validity masks for the padded inequality rows."""
    pinned = _pinned_controls(bounds)
    m_u = jnp.isfinite(bounds.ubu) & ~pinned
    m_lu = jnp.isfinite(bounds.lbu) & ~pinned
    m_x = jnp.isfinite(bounds.ubx[:-1])
    m_lx = jnp.isfinite(bounds.lbx[:-1])
    if fix_x0:
        # x_0 is not a decision variable: its bound rows are meaningless
        m_x = m_x.at[0].set(False)
        m_lx = m_lx.at[0].set(False)
    h_mask = jnp.ones((dims.N, dims.n_h), bool)
    mask = jnp.concatenate([m_u, m_lu, m_x, m_lx, h_mask], axis=1)
    mN = jnp.concatenate([
        jnp.isfinite(bounds.ubx[-1]), jnp.isfinite(bounds.lbx[-1]),
        jnp.ones((dims.n_hN,), bool)])
    return mask, mN


def _convexify(M, min_eig):
    """Eigenvalue-clip a symmetric matrix to be positive definite."""
    M = 0.5 * (M + M.T)
    w, V = jnp.linalg.eigh(M)
    w = jnp.maximum(w, min_eig)
    return (V * w) @ V.T


# ---------------------------------------------------------------------------
# Main solver
# ---------------------------------------------------------------------------


def solve_ocp(
    funcs: OCPFunctions,
    dims: OCPDims,
    bounds: OCPBounds,
    theta: jnp.ndarray,            # (N+1, n_theta); row N feeds terminal functions
    x0: jnp.ndarray,               # (nx,) initial state (or arrival guess if free)
    X_init: jnp.ndarray,           # (N+1, nx)
    U_init: jnp.ndarray,           # (N, nu)
    options: IPOptions = IPOptions(),
    fix_x0: bool = True,
    mu0: Optional[jnp.ndarray] = None,
) -> OCPSolution:
    """Solve one OCP instance. jit/vmap-compatible; all control flow is lax.

    ``mu0`` optionally overrides ``options.mu_init`` as a RUNTIME value (a
    traced scalar): cold- and warm-start solvers differ only in the initial
    barrier, so passing it dynamically lets both share ONE trace and ONE
    compiled executable instead of two per configuration."""
    # f32 matmuls at default precision may run in TF32 on the GPU (about three
    # decimal digits); the Riccati/Newton arithmetic needs full f32 to reach
    # 1e-4 KKT tolerances
    with jax.default_matmul_precision("highest"):
        return _solve_ocp_impl(funcs, dims, bounds, theta, x0, X_init, U_init,
                               options, fix_x0, mu0)


def _solve_ocp_impl(funcs, dims, bounds, theta, x0, X_init, U_init, options,
                    fix_x0, mu0_dyn=None) -> OCPSolution:
    nx, nu, N = dims.nx, dims.nu, dims.N
    m = 2 * nu + 2 * nx + dims.n_h
    mN = 2 * nx + dims.n_hN
    dtype = X_init.dtype
    opt = options

    c_fn = _stage_ineq_fn(funcs, dims)
    cN_fn = _term_ineq_fn(funcs, dims)
    mask, maskN = _constraint_masks(bounds, dims, fix_x0)
    mask_f = mask.astype(dtype)
    maskN_f = maskN.astype(dtype)
    lbx_s, ubx_s = bounds.lbx[:-1], bounds.ubx[:-1]

    big = jnp.asarray(1e20, dtype)

    def safe_b(b):
        return jnp.clip(jnp.nan_to_num(b, posinf=1e20, neginf=-1e20), -big, big)

    lbx_c, ubx_c = safe_b(lbx_s), safe_b(ubx_s)
    lbu_c, ubu_c = safe_b(bounds.lbu), safe_b(bounds.ubu)
    lbxN_c, ubxN_c = safe_b(bounds.lbx[-1]), safe_b(bounds.ubx[-1])

    # pinned (equality-bounded) controls: removed from the barrier, held by a
    # stiff quadratic in the Riccati blocks and excluded from the stationarity test
    pin = _pinned_controls(bounds)
    pin_f = pin.astype(dtype)
    free_u_f = 1.0 - pin_f
    pin_val = 0.5 * (lbu_c + ubu_c) * pin_f
    w_pin = jnp.asarray(1e7 if dtype == jnp.float64 else 1e5, dtype)

    def stage_c(X, U):
        return jax.vmap(c_fn)(X[:-1], U, theta[:-1], lbx_c, ubx_c, lbu_c, ubu_c, mask)

    def term_c(X):
        return cN_fn(X[-1], theta[-1], lbxN_c, ubxN_c, maskN)

    # fused value+jacobian w.r.t. (x, u): jax.linearize evaluates the primal
    # ONCE and pushes the nx+nu basis tangents through the stored linear trace —
    # vs. three primal traversals (value + two jacfwd calls) of the integrator
    def _value_and_jacobians(f, x, u):
        val, jvp = jax.linearize(f, x, u)
        dt_ = x.dtype
        dX = jnp.concatenate([jnp.eye(nx, dtype=dt_),
                              jnp.zeros((nu, nx), dt_)], axis=0)
        dU = jnp.concatenate([jnp.zeros((nx, nu), dt_),
                              jnp.eye(nu, dtype=dt_)], axis=0)
        J = jax.vmap(jvp)(dX, dU)          # (nx+nu, n_out)
        return val, J[:nx].T, J[nx:].T     # val, d/dx, d/du

    # Jacobians of the stage inequality rows w.r.t. (x, u). The box rows
    # [u-ubu; lbu-u; x-ubx; lbx-x] have constant ±selector jacobians — only the
    # custom h rows need AD; masked-out rows have zero jacobian (c is pinned).
    Jx_box = jnp.concatenate([jnp.zeros((2 * nu, nx), dtype),
                              jnp.eye(nx, dtype=dtype),
                              -jnp.eye(nx, dtype=dtype)], axis=0)
    Ju_box = jnp.concatenate([jnp.eye(nu, dtype=dtype),
                              -jnp.eye(nu, dtype=dtype),
                              jnp.zeros((2 * nx, nu), dtype)], axis=0)
    JxN_box = jnp.concatenate([jnp.eye(nx, dtype=dtype),
                               -jnp.eye(nx, dtype=dtype)], axis=0)

    def stage_c_jac(x, u, th, msk):
        if funcs.stage_ineq is not None and dims.n_h:
            _, Hx, Hu = _value_and_jacobians(
                lambda xx, uu: funcs.stage_ineq(xx, uu, th), x, u)
            Cx = jnp.concatenate([Jx_box, Hx], axis=0)
            Cu = jnp.concatenate([Ju_box, Hu], axis=0)
        else:
            Cx, Cu = Jx_box, Ju_box
        mf = msk.astype(x.dtype)[:, None]
        return Cx * mf, Cu * mf

    def term_c_jac(x):
        if funcs.term_ineq is not None and dims.n_hN:
            Hx = jax.jacfwd(lambda xx: funcs.term_ineq(xx, theta[-1]))(x)
            CxN = jnp.concatenate([JxN_box, Hx], axis=0)
        else:
            CxN = JxN_box
        return CxN * maskN_f[:, None]

    # dynamics linearization (value + both jacobians from one primal pass)
    def dyn_lin(x, u, th):
        return _value_and_jacobians(
            lambda xx, uu: funcs.dyn(xx, uu, th), x, u)

    # equality constraints enter through augmented-Lagrangian terms on the costs
    n_e, n_eN = dims.n_e, dims.n_eN
    has_eq = funcs.stage_eq is not None and n_e > 0
    has_eqN = funcs.term_eq is not None and n_eN > 0

    def stage_cost_aug(x, u, th, y, rho):
        c = funcs.stage_cost(x, u, th)
        if has_eq:
            h = funcs.stage_eq(x, u, th)
            c = c + jnp.dot(y, h) + 0.5 * rho * jnp.dot(h, h)
        return c

    def term_cost_aug(x, yN, rho):
        c = funcs.term_cost(x, theta[-1])
        if has_eqN:
            h = funcs.term_eq(x, theta[-1])
            c = c + jnp.dot(yN, h) + 0.5 * rho * jnp.dot(h, h)
        return c

    def stage_eq_all(X, U):
        if not has_eq:
            return jnp.zeros((N, 0), dtype)
        return jax.vmap(funcs.stage_eq)(X[:-1], U, theta[:-1])

    def term_eq_val(X):
        if not has_eqN:
            return jnp.zeros(0, dtype)
        return funcs.term_eq(X[-1], theta[-1])

    def cost_grads(x, u, th, y, rho):
        return jax.grad(stage_cost_aug, argnums=(0, 1))(x, u, th, y, rho)

    def cost_terms(x, u, th, y, rho):
        gx, gu = cost_grads(x, u, th, y, rho)
        H = jax.hessian(stage_cost_aug, argnums=(0, 1))(x, u, th, y, rho)
        Hxx, Hxu = H[0]
        Hux, Huu = H[1]
        if opt.convexify:
            M = jnp.block([[Hxx, Hxu], [Hux, Huu]])
            M = _convexify(M, opt.min_eig)
            Hxx, Hxu = M[:nx, :nx], M[:nx, nx:]
            Hux, Huu = M[nx:, :nx], M[nx:, nx:]
        return gx, gu, Hxx, Hux, Huu

    def term_terms(x, yN, rho):
        g = jax.grad(term_cost_aug, argnums=0)(x, yN, rho)
        H = jax.hessian(term_cost_aug, argnums=0)(x, yN, rho)
        if opt.convexify:
            H = _convexify(H, opt.min_eig)
        return g, H

    def objective(X, U):
        stage = jax.vmap(funcs.stage_cost)(X[:-1], U, theta[:-1])
        return jnp.sum(stage) + funcs.term_cost(X[-1], theta[-1])

    def dyn_defect(X, U):
        F = jax.vmap(funcs.dyn)(X[:-1], U, theta[:-1])
        return F - X[1:]

    # -- init ---------------------------------------------------------------
    X = X_init
    if fix_x0:
        X = X.at[0].set(x0)
    U = jnp.where(pin, pin_val, U_init)
    c0 = stage_c(X, U)
    cN0 = term_c(X)
    mu0 = jnp.asarray(opt.mu_init if mu0_dyn is None else mu0_dyn, dtype)
    # |c| (not -c): a constraint VIOLATED at the initial point must still get a
    # slack at its own scale — s ~ s_min would give barrier curvature mu/s^2 that
    # pins the iterate at the infeasible point forever
    s = jnp.maximum(jnp.abs(c0), opt.s_min)
    sN = jnp.maximum(jnp.abs(cN0), opt.s_min)
    z = mu0 / s * mask_f + (1.0 - mask_f)
    zN = mu0 / sN * maskN_f + (1.0 - maskN_f)
    lam = jnp.zeros((N, nx), dtype)
    nu_pen = jnp.asarray(10.0, dtype)
    Y0 = jnp.zeros((N, n_e), dtype)
    yN0 = jnp.zeros(n_eN, dtype)
    rho0 = jnp.asarray(opt.rho_eq, dtype)

    class Carry(NamedTuple):
        X: jnp.ndarray
        U: jnp.ndarray
        lam: jnp.ndarray
        s: jnp.ndarray
        z: jnp.ndarray
        sN: jnp.ndarray
        zN: jnp.ndarray
        mu: jnp.ndarray
        nu_pen: jnp.ndarray
        kkt: jnp.ndarray
        it: jnp.ndarray
        converged: jnp.ndarray
        diverged: jnp.ndarray
        Y: jnp.ndarray       # (N, n_e) AL multipliers, stage equalities
        yN: jnp.ndarray      # (n_eN,) AL multipliers, terminal equalities
        rho: jnp.ndarray     # AL penalty
        eqv: jnp.ndarray     # previous max equality violation
        hist_X: jnp.ndarray  # (max_iter, N+1, nx) when recording, else (0,)
        hist_U: jnp.ndarray
        hist_s: jnp.ndarray  # (max_iter, 3): [kkt, mu, objective]

    const_H = opt.const_cost_hessian and not (has_eq or has_eqN)
    if const_H:
        # quadratic costs: Hessian blocks are point-independent — evaluate once
        # (incl. the convexify eigh when enabled) instead of every iteration
        _, _, Hxx_c, Hux_c, Huu_c = jax.vmap(
            cost_terms, in_axes=(0, 0, 0, 0, None))(
                X_init[:-1], U_init, theta[:-1], Y0, rho0)
        _, HN_c = term_terms(X_init[-1], yN0, rho0)

    def linearize(X, U, Y, yN, rho):
        """One full linearization of dynamics/costs/constraints along the horizon —
        shared by the convergence test and the Newton step (the expensive part)."""
        F, A, B = jax.vmap(dyn_lin)(X[:-1], U, theta[:-1])
        if const_H:
            gx, gu = jax.vmap(
                cost_grads, in_axes=(0, 0, 0, 0, None))(X[:-1], U, theta[:-1],
                                                        Y, rho)
            Hxx, Hux, Huu = Hxx_c, Hux_c, Huu_c
            gN = jax.grad(term_cost_aug, argnums=0)(X[-1], yN, rho)
            HN = HN_c
        else:
            gx, gu, Hxx, Hux, Huu = jax.vmap(
                cost_terms, in_axes=(0, 0, 0, 0, None))(X[:-1], U, theta[:-1],
                                                        Y, rho)
            gN, HN = term_terms(X[-1], yN, rho)
        c = stage_c(X, U)
        cN = term_c(X)
        Cx, Cu = jax.vmap(stage_c_jac)(X[:-1], U, theta[:-1], mask)
        CxN = term_c_jac(X[-1])
        if opt.lin_storage_dtype is not None and dtype == jnp.float32:
            # bandwidth lever: the jacobian/hessian blocks are the bulk of
            # the per-iteration HBM traffic; store them in bf16 and let the
            # consumers promote back to f32 (values/gradients stay f32 so
            # feasibility and the step direction RHS keep full precision)
            sd = jnp.dtype(opt.lin_storage_dtype)
            A, B = A.astype(sd), B.astype(sd)
            Hxx, Hux, Huu = (Hxx.astype(sd), Hux.astype(sd), Huu.astype(sd))
            HN = HN.astype(sd)
            Cx, Cu, CxN = Cx.astype(sd), Cu.astype(sd), CxN.astype(sd)
        return (F, A, B, gx, gu, Hxx, Hux, Huu, gN, HN, c, cN, Cx, Cu, CxN)

    def kkt_errors(lin, X, lam, s, z, sN, zN, mu):
        """(err at mu=0, err at current mu) from an existing linearization."""
        F, A, B, gx, gu, _, _, _, gN, _, c, cN, Cx, Cu, CxN = lin
        zm = z * mask_f
        zNm = zN * maskN_f
        # stationarity w.r.t. x_k (k=1..N-1): gx_k + A_kᵀlam_k - lam_{k-1} + Cxᵀz
        r_x = (gx + jnp.einsum("kij,ki->kj", A, lam)
               + jnp.einsum("kij,ki->kj", Cx, zm))
        r_x = r_x.at[1:].add(-lam[:-1])
        r_xN = gN - lam[-1] + CxN.T @ zNm
        r_u = (gu + jnp.einsum("kij,ki->kj", B, lam)
               + jnp.einsum("kij,ki->kj", Cu, zm)) * free_u_f
        r_dyn = F - X[1:]
        r_ineq = (c + s) * mask_f
        r_ineqN = (cN + sN) * maskN_f
        sz = s * z * mask_f
        szN = sN * zN * maskN_f
        stat_terms = [jnp.max(jnp.abs(r_u)), jnp.max(jnp.abs(r_xN))]
        if not fix_x0:
            stat_terms.append(jnp.max(jnp.abs(r_x[0])))
        if N > 1:
            stat_terms.append(jnp.max(jnp.abs(r_x[1:])))
        # scale stationarity like IPOPT's s_d to tolerate large multipliers
        s_d = jnp.maximum(1.0, (jnp.sum(jnp.abs(lam)) + jnp.sum(jnp.abs(zm))
                                + jnp.sum(jnp.abs(zNm)))
                          / (N * nx + N * m + mN))
        e_stat = jnp.max(jnp.stack(stat_terms)) / s_d
        e_feas = jnp.maximum(jnp.max(jnp.abs(r_dyn)),
                             jnp.maximum(jnp.max(jnp.abs(r_ineq), initial=0.0),
                                         jnp.max(jnp.abs(r_ineqN), initial=0.0)))

        def comp_err(mu_val):
            return jnp.maximum(
                jnp.max(jnp.abs(sz - mu_val * mask_f), initial=0.0),
                jnp.max(jnp.abs(szN - mu_val * maskN_f), initial=0.0)) / s_d

        base = jnp.maximum(e_stat, e_feas)
        return (jnp.maximum(base, comp_err(0.0)),
                jnp.maximum(base, comp_err(mu)))

    def eq_violation(X, U):
        h = stage_eq_all(X, U)
        hN = term_eq_val(X)
        return jnp.maximum(jnp.max(jnp.abs(h), initial=0.0),
                           jnp.max(jnp.abs(hN), initial=0.0))

    def merit(X, U, s, sN, mu, nu_p, Y, yN, rho):
        f = objective(X, U)
        if has_eq or has_eqN:
            h = stage_eq_all(X, U)
            hN = term_eq_val(X)
            f = (f + jnp.sum(Y * h) + 0.5 * rho * jnp.sum(h * h)
                 + jnp.dot(yN, hN) + 0.5 * rho * jnp.dot(hN, hN))
        bar = -mu * (jnp.sum(jnp.log(jnp.maximum(s, 1e-30)) * mask_f)
                     + jnp.sum(jnp.log(jnp.maximum(sN, 1e-30)) * maskN_f))
        viol = (jnp.sum(jnp.abs(dyn_defect(X, U)))
                + jnp.sum(jnp.abs((stage_c(X, U) + s) * mask_f))
                + jnp.sum(jnp.abs((term_c(X) + sN) * maskN_f)))
        return f + bar + nu_p * viol

    def iteration(carry: Carry) -> Carry:
        X, U, lam, s, z, sN, zN, mu, nu_p = (
            carry.X, carry.U, carry.lam, carry.s, carry.z, carry.sN, carry.zN,
            carry.mu, carry.nu_pen)

        Y, yN, rho = carry.Y, carry.yN, carry.rho
        lin = linearize(X, U, Y, yN, rho)
        (F, A, B, gx, gu, Hxx, Hux, Huu, gN, HN, c, cN, Cx, Cu, CxN) = lin

        # convergence / barrier bookkeeping on the CURRENT iterate, reusing this
        # iteration's linearization (no extra jacobian passes)
        err0, err_mu = kkt_errors(lin, X, lam, s, z, sN, zN, mu)
        eq_v = eq_violation(X, U)
        if opt.record_iterates:
            # per-iteration history ring (reference: IpoptDebugger callback,
            # util/optimizer.py:37-144)
            hist_X = carry.hist_X.at[carry.it].set(X)
            hist_U = carry.hist_U.at[carry.it].set(U)
            hist_s = carry.hist_s.at[carry.it].set(
                jnp.stack([err0, mu, objective(X, U)]))
        else:
            hist_X, hist_U, hist_s = carry.hist_X, carry.hist_U, carry.hist_s
        converged = (err0 <= opt.tol) & (eq_v <= opt.tol)
        subproblem_done = err_mu <= opt.kappa_eps * mu
        mu = jnp.where(
            subproblem_done,
            jnp.maximum(opt.tol / 10.0,
                        jnp.minimum(opt.kappa_mu * mu, mu ** opt.theta_mu)),
            mu)
        # augmented-Lagrangian outer update at barrier-subproblem solves.
        # LANCELOT rule: a first-order multiplier step ONLY when the violation
        # dropped enough (else dual ascent diverges — y must track true duals);
        # otherwise escalate rho. Multipliers are kept bounded as a safeguard.
        if has_eq or has_eqN:
            good = subproblem_done & (eq_v <= 0.25 * carry.eqv)
            bad_up = subproblem_done & ~good & (eq_v > opt.tol)
            h_cur = stage_eq_all(X, U)
            hN_cur = term_eq_val(X)
            y_max = 1e5
            Y = jnp.where(good, jnp.clip(Y + rho * h_cur, -y_max, y_max), Y)
            yN = jnp.where(good, jnp.clip(yN + rho * hN_cur, -y_max, y_max), yN)
            rho = jnp.where(bad_up, jnp.minimum(rho * 10.0, opt.rho_eq_max), rho)
            eqv_new = jnp.where(good, eq_v, carry.eqv)
        else:
            eqv_new = carry.eqv

        sigma = jnp.where(mask, z / s, 0.0)
        sigmaN = jnp.where(maskN, zN / sN, 0.0)
        r_ineq = (c + s) * mask_f
        r_ineqN = (cN + sN) * maskN_f

        # barrier-condensed Hessian blocks (shared by predictor and corrector)
        Qb = Hxx + jnp.einsum("kmi,km,kmj->kij", Cx, sigma, Cx)
        Rb = (Huu + jnp.einsum("kmi,km,kmj->kij", Cu, sigma, Cu)
              + jnp.einsum("km,mn->kmn", w_pin * pin_f,
                           jnp.eye(nu, dtype=dtype)))
        Sb = Hux + jnp.einsum("kmi,km,kmj->kij", Cu, sigma, Cx)
        P_term = HN + jnp.einsum("mi,m,mj->ij", CxN, sigmaN, CxN)
        # promote (possibly bf16-stored) dynamics jacobians back to the solve
        # dtype for the Riccati algebra — identity when lin_storage is off
        A = A.astype(dtype)
        B = B.astype(dtype)
        Qb = Qb.astype(dtype)
        Rb = Rb.astype(dtype)
        Sb = Sb.astype(dtype)
        P_term = P_term.astype(dtype)
        r_dyn = F - X[1:]
        if opt.parallel_riccati:
            lq_solver = solve_lq_parallel
        else:
            lq_solver = partial(solve_lq, unroll=opt.riccati_unroll)

        def newton_step(mu_t, corr, corrN):
            """One barrier-Newton solve targeting complementarity mu_t with an
            optional second-order correction term (Mehrotra)."""
            zh = jnp.where(mask, (mu_t + z * r_ineq - corr) / s, 0.0)
            zhN = jnp.where(maskN, (mu_t + zN * r_ineqN - corrN) / sN, 0.0)
            qb = gx + jnp.einsum("kmi,km->ki", Cx, zh)
            rb = (gu + jnp.einsum("kmi,km->ki", Cu, zh)
                  + w_pin * pin_f * (U - pin_val))
            p_term = gN + CxN.T @ zhN
            if fix_x0:
                dx0 = jnp.zeros(nx, dtype)
            else:
                # free initial state: dx0 minimizes the stage-0 value function
                _, _, P0, p0, _, _, _ = backward_sweep(
                    A, B, Qb, Sb, Rb, qb, rb, r_dyn, P_term, p_term, opt.reg,
                    unroll=opt.riccati_unroll)
                dx0 = -jnp.linalg.solve(
                    P0 + opt.reg * jnp.eye(nx, dtype=dtype), p0)
            sol = lq_solver(A, B, Qb, Sb, Rb, qb, rb, r_dyn, P_term, p_term,
                            dx0, reg=opt.reg)
            dC = (jnp.einsum("kmi,ki->km", Cx, sol.dX[:-1])
                  + jnp.einsum("kmi,ki->km", Cu, sol.dU))
            dCN = CxN @ sol.dX[-1]
            ds_ = jnp.where(mask, -r_ineq - dC, 0.0)
            dsN_ = jnp.where(maskN, -r_ineqN - dCN, 0.0)
            dz_ = jnp.where(mask, (mu_t - s * z - z * ds_ - corr) / s, 0.0)
            dzN_ = jnp.where(maskN, (mu_t - sN * zN - zN * dsN_ - corrN) / sN,
                             0.0)
            return sol, ds_, dz_, dsN_, dzN_

        zero = jnp.zeros((), dtype)
        # Mehrotra's fast gap collapse fights the augmented-Lagrangian outer loop
        # (multiplier updates key off the monotone barrier schedule) — use the
        # predictor-corrector only for inequality-constrained problems
        if opt.mehrotra and not (has_eq or has_eqN):
            # affine predictor (target 0 complementarity)
            _, ds_a, dz_a, dsN_a, dzN_a = newton_step(zero, zero, zero)

            def ftb(v, dv, msk):
                ratio = jnp.where((dv < 0) & msk,
                                  -v / jnp.minimum(dv, -1e-30), 1.0)
                return jnp.minimum(1.0, jnp.min(ratio, initial=1.0))

            a_p = jnp.minimum(ftb(s, ds_a, mask), ftb(sN, dsN_a, maskN))
            a_d = jnp.minimum(ftb(z, dz_a, mask), ftb(zN, dzN_a, maskN))
            m_tot = jnp.maximum(jnp.sum(mask_f) + jnp.sum(maskN_f), 1.0)
            gap = (jnp.sum(s * z * mask_f) + jnp.sum(sN * zN * maskN_f)) / m_tot
            gap_aff = (jnp.sum((s + a_p * ds_a) * (z + a_d * dz_a) * mask_f)
                       + jnp.sum((sN + a_p * dsN_a) * (zN + a_d * dzN_a)
                                 * maskN_f)) / m_tot
            sig_m = jnp.clip((gap_aff / jnp.maximum(gap, 1e-30)) ** 3, 0.0, 1.0)
            mu = jnp.maximum(sig_m * gap, opt.tol / 10.0)
            corr = ds_a * dz_a * mask_f
            corrN = dsN_a * dzN_a * maskN_f
            sol, ds, dz, dsN, dzN = newton_step(mu, corr, corrN)
        else:
            sol, ds, dz, dsN, dzN = newton_step(mu, zero, zero)
        dX, dU, lam_new = sol.dX, sol.dU, sol.lam

        # fraction-to-boundary
        tau = jnp.maximum(opt.tau_min, 1.0 - mu)

        def max_step(v, dv, msk):
            ratio = jnp.where((dv < 0) & msk, -tau * v / jnp.minimum(dv, -1e-30), 1.0)
            return jnp.minimum(1.0, jnp.min(ratio, initial=1.0))

        a_s = jnp.minimum(max_step(s, ds, mask), max_step(sN, dsN, maskN))
        a_z = jnp.minimum(max_step(z, dz, mask), max_step(zN, dzN, maskN))

        # penalty update from new multipliers
        lam_inf = jnp.max(jnp.abs(lam_new))
        z_inf = jnp.maximum(jnp.max(jnp.abs(z + dz), initial=0.0),
                            jnp.max(jnp.abs(zN + dzN), initial=0.0))
        nu_new = jnp.maximum(nu_p, 1.5 * jnp.maximum(lam_inf, z_inf) + 1.0)

        # backtracking line search on the l1 barrier merit (candidates evaluated
        # in parallel — a vmapped "batch over alphas" instead of a data-dependent loop)
        if opt.n_linesearch <= 1:
            # single candidate: both acceptance branches select it, so the merit
            # rollouts are dead code — skip them explicitly (a merit rollout is
            # a full horizon re-evaluation; NaN steps are still caught by the
            # finiteness guard below)
            alpha = a_s
        else:
            alphas = a_s * (0.5 ** jnp.arange(opt.n_linesearch, dtype=dtype))

            def merit_at(a):
                return merit(X + a * dX, U + a * dU, s + a * ds, sN + a * dsN,
                             mu, nu_new, Y, yN, rho)

            phis = jax.vmap(merit_at)(alphas)
            phi0 = merit(X, U, s, sN, mu, nu_new, Y, yN, rho)
            # accept the largest step that does not increase the merit (up to
            # roundoff — near the solution Newton steps change the merit by ~eps,
            # and demanding a strict decrease would stall the iteration);
            # otherwise take the best trial
            ok = (phis <= phi0 + 1e-12 * (1.0 + jnp.abs(phi0))) & jnp.isfinite(phis)
            any_ok = jnp.any(ok)
            first_ok = jnp.argmax(ok)  # first True (largest alpha)
            best = jnp.argmin(jnp.where(jnp.isfinite(phis), phis, jnp.inf))
            alpha = jnp.where(any_ok, alphas[first_ok], alphas[best])

        X_new = X + alpha * dX
        U_new = U + alpha * dU
        s_new = jnp.maximum(jnp.where(mask, s + alpha * ds, 1.0), 1e-30)
        sN_new = jnp.maximum(jnp.where(maskN, sN + alpha * dsN, 1.0), 1e-30)
        z_new = jnp.maximum(jnp.where(mask, z + a_z * dz, 1.0), 1e-30)
        zN_new = jnp.maximum(jnp.where(maskN, zN + a_z * dzN, 1.0), 1e-30)

        # IPOPT-style dual safeguard: keep z within kappa_Sigma of mu/s
        kap = 1e10
        z_new = jnp.clip(z_new, mu / (kap * s_new), kap * mu / s_new)
        zN_new = jnp.clip(zN_new, mu / (kap * sN_new), kap * mu / sN_new)

        bad = ~(jnp.all(jnp.isfinite(X_new)) & jnp.all(jnp.isfinite(U_new))
                & jnp.all(jnp.isfinite(z_new)))
        # no update when the current iterate already satisfies the KKT conditions
        # (or the step produced NaNs)
        keep = converged | bad

        def sel(a, b):
            return jnp.where(keep, a, b)

        return Carry(X=sel(X, X_new), U=sel(U, U_new), lam=sel(lam, lam_new),
                     s=sel(s, s_new), z=sel(z, z_new), sN=sel(sN, sN_new),
                     zN=sel(zN, zN_new), mu=mu, nu_pen=nu_new, kkt=err0,
                     it=carry.it + 1, converged=converged,
                     diverged=carry.diverged | bad,
                     Y=Y, yN=yN, rho=rho, eqv=eqv_new,
                     hist_X=hist_X, hist_U=hist_U, hist_s=hist_s)

    init_carry = Carry(X=X, U=U, lam=lam, s=s, z=z, sN=sN, zN=zN, mu=mu0,
                       nu_pen=nu_pen, kkt=jnp.asarray(jnp.inf, dtype),
                       it=jnp.zeros((), jnp.int32),
                       converged=jnp.zeros((), bool), diverged=jnp.zeros((), bool),
                       Y=Y0, yN=yN0, rho=rho0,
                       eqv=jnp.asarray(jnp.inf, dtype),
                       hist_X=(jnp.zeros((opt.max_iter, N + 1, nx), dtype)
                               if opt.record_iterates else jnp.zeros(0, dtype)),
                       hist_U=(jnp.zeros((opt.max_iter, N, nu), dtype)
                               if opt.record_iterates else jnp.zeros(0, dtype)),
                       hist_s=(jnp.zeros((opt.max_iter, 3), dtype)
                               if opt.record_iterates else jnp.zeros(0, dtype)))

    def masked_iteration(cr: Carry) -> Carry:
        # under vmap, while_loop applies the body to every lane while ANY lane is
        # active — finished lanes must freeze themselves
        new = iteration(cr)
        keep = cr.converged | cr.diverged
        return jax.tree.map(lambda a, b: jnp.where(keep, a, b), cr, new)

    if opt.early_exit:
        def cond(cr):
            return (cr.it < opt.max_iter) & ~cr.converged & ~cr.diverged

        final = lax.while_loop(cond, masked_iteration, init_carry)
    else:
        final = lax.fori_loop(0, opt.max_iter,
                              lambda _, cr: masked_iteration(cr), init_carry)

    obj = objective(final.X, final.U)
    status = jnp.where(final.converged, 0, jnp.where(final.diverged, 2, 1))
    if opt.record_iterates:
        history = {"X": final.hist_X, "U": final.hist_U,
                   "kkt": final.hist_s[:, 0], "mu": final.hist_s[:, 1],
                   "objective": final.hist_s[:, 2], "n": final.it}
        return OCPSolution(
            X=final.X, U=final.U, lam=final.lam, s=final.s, z=final.z,
            sN=final.sN, zN=final.zN, mu=final.mu, kkt_error=final.kkt,
            objective=obj, iterations=final.it, converged=final.converged,
            status=status.astype(jnp.int32)), history
    return OCPSolution(
        X=final.X, U=final.U, lam=final.lam, s=final.s, z=final.z, sN=final.sN,
        zN=final.zN, mu=final.mu, kkt_error=final.kkt, objective=obj,
        iterations=final.it, converged=final.converged,
        status=status.astype(jnp.int32))


def solve_ocp_batched(funcs: OCPFunctions, dims: OCPDims, bounds: OCPBounds,
                      theta, x0, X_init, U_init,
                      options: IPOptions = IPOptions(), fix_x0: bool = True,
                      bound_axes=None) -> OCPSolution:
    """vmap `solve_ocp` over a leading batch axis of (theta, x0, X_init, U_init).

    `bound_axes`: optional OCPBounds of in_axes (0 or None per field) when bounds vary
    per scenario.
    """
    if bound_axes is None:
        b_ax = None
    else:
        b_ax = bound_axes
    solver = partial(solve_ocp, funcs, dims, options=options, fix_x0=fix_x0)
    return jax.vmap(lambda b, th, x, Xi, Ui: solver(b, th, x, Xi, Ui),
                    in_axes=(b_ax, 0, 0, 0, 0))(bounds, theta, x0, X_init, U_init)
