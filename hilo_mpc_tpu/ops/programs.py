"""Standalone LP/QP/NLP optimization programs.

Rebuild of the reference's user-facing Optimizer/LinearProgram/QuadraticProgram/
NonlinearProgram wrappers (reference: hilo_mpc/modules/optimizer.py:47-772), which
delegate to ca.nlpsol/qpsol (IPOPT/qpoases). Here a dense primal-dual interior-point
solver — the unstructured sibling of the stagewise OCP engine (ops/ip_solver.py) —
handles min f(x) s.t. lbx<=x<=ubx, lbg<=g(x)<=ubg with exact JAX Hessians; jittable and
vmappable, so parameter sweeps of small programs run as one batch.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax



@dataclasses.dataclass(frozen=True)
class DenseIPOptions:
    max_iter: int = 60
    tol: float = 1e-8
    mu_init: float = 1e-1
    n_linesearch: int = 12
    reg: float = 1e-9


class DenseSolution(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    kkt_error: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray


def solve_dense_nlp(f: Callable, g: Optional[Callable], n: int, m: int,
                    x0, p, lbx, ubx, lbg, ubg,
                    options: DenseIPOptions = DenseIPOptions()) -> DenseSolution:
    """Dense slack-based interior point. f(x, p) scalar; g(x, p) -> (m,)."""
    opt = options
    dtype = jnp.result_type(x0)
    big = 1e20

    lbx = jnp.clip(jnp.nan_to_num(lbx, neginf=-big, posinf=big), -big, big)
    ubx = jnp.clip(jnp.nan_to_num(ubx, neginf=-big, posinf=big), -big, big)
    lbg_ = jnp.clip(jnp.nan_to_num(lbg, neginf=-big, posinf=big), -big, big)
    ubg_ = jnp.clip(jnp.nan_to_num(ubg, neginf=-big, posinf=big), -big, big)

    def cons(x):
        rows = [x - ubx, lbx - x]
        if g is not None and m:
            gv = g(x, p)
            rows += [gv - ubg_, lbg_ - gv]
        return jnp.concatenate(rows)

    n_c = 2 * n + 2 * m
    mask = jnp.concatenate([
        jnp.abs(ubx) < big, jnp.abs(lbx) < big,
        (jnp.abs(ubg_) < big) if m else jnp.zeros(0, bool),
        (jnp.abs(lbg_) < big) if m else jnp.zeros(0, bool)])
    mask_f = mask.astype(dtype)

    def cons_m(x):
        return jnp.where(mask, cons(x), -1.0)

    obj = lambda x: f(x, p)

    class Carry(NamedTuple):
        x: jnp.ndarray
        s: jnp.ndarray
        z: jnp.ndarray
        mu: jnp.ndarray
        nu: jnp.ndarray
        kkt: jnp.ndarray
        it: jnp.ndarray
        converged: jnp.ndarray

    c0 = cons_m(x0)
    s0 = jnp.maximum(jnp.abs(c0), 1e-4)  # violated rows get scale-sized slacks
    mu0 = jnp.asarray(opt.mu_init, dtype)
    z0 = mu0 / s0 * mask_f + (1 - mask_f)

    def merit(x, s, mu, nu):
        bar = -mu * jnp.sum(jnp.log(jnp.maximum(s, 1e-30)) * mask_f)
        viol = jnp.sum(jnp.abs((cons_m(x) + s) * mask_f))
        return obj(x) + bar + nu * viol

    def body(cr: Carry) -> Carry:
        x, s, z, mu, nu_p = cr.x, cr.s, cr.z, cr.mu, cr.nu
        gx = jax.grad(obj)(x)
        H = jax.hessian(obj)(x)
        C = jax.jacfwd(cons_m)(x)
        c = cons_m(x)
        zm = z * mask_f
        # general-constraint curvature enters through the multipliers
        if g is not None and m:
            def lag_c(xx):
                return jnp.dot(cons_m(xx), zm)

            H = H + jax.hessian(lag_c)(x)
        # convergence on current iterate
        r_stat = gx + C.T @ zm
        r_ineq = (c + s) * mask_f
        sz = s * z * mask_f
        s_d = jnp.maximum(1.0, jnp.sum(jnp.abs(zm)) / max(n_c, 1))
        err0 = jnp.maximum(jnp.max(jnp.abs(r_stat)) / s_d,
                           jnp.maximum(jnp.max(jnp.abs(r_ineq), initial=0.0),
                                       jnp.max(jnp.abs(sz), initial=0.0) / s_d))
        err_mu = jnp.maximum(jnp.max(jnp.abs(r_stat)) / s_d,
                             jnp.maximum(jnp.max(jnp.abs(r_ineq), initial=0.0),
                                         jnp.max(jnp.abs(sz - mu * mask_f),
                                                 initial=0.0) / s_d))
        converged = err0 <= opt.tol
        mu = jnp.where(err_mu <= 10.0 * mu,
                       jnp.maximum(opt.tol / 10, jnp.minimum(0.2 * mu, mu ** 1.5)),
                       mu)

        sigma = jnp.where(mask, z / s, 0.0)
        zhat = jnp.where(mask, (mu + z * r_ineq) / s, 0.0)
        Hbar = H + (C.T * sigma) @ C
        # symmetrize + regularize; eigenvalue clip for nonconvex objectives
        Hbar = 0.5 * (Hbar + Hbar.T)
        w, V = jnp.linalg.eigh(Hbar)
        w = jnp.maximum(w, opt.reg + 1e-8)
        gbar = gx + C.T @ zhat
        dx = -(V * (1.0 / w)) @ (V.T @ gbar)
        dc = C @ dx
        ds = jnp.where(mask, -r_ineq - dc, 0.0)
        dz = jnp.where(mask, (mu - s * z - z * ds) / s, 0.0)

        tau = jnp.maximum(0.99, 1.0 - mu)

        def max_step(v, dv):
            ratio = jnp.where((dv < 0) & mask, -tau * v / jnp.minimum(dv, -1e-30),
                              1.0)
            return jnp.minimum(1.0, jnp.min(ratio, initial=1.0))

        a_s = max_step(s, ds)
        a_z = max_step(z, dz)
        z_new_inf = jnp.max(jnp.abs(z + dz), initial=0.0)
        nu_new = jnp.maximum(nu_p, 1.5 * z_new_inf + 1.0)

        alphas = a_s * (0.5 ** jnp.arange(opt.n_linesearch, dtype=dtype))
        phis = jax.vmap(lambda a: merit(x + a * dx, s + a * ds, mu, nu_new))(alphas)
        phi0 = merit(x, s, mu, nu_new)
        ok = (phis <= phi0 + 1e-12 * (1 + jnp.abs(phi0))) & jnp.isfinite(phis)
        alpha = jnp.where(jnp.any(ok), alphas[jnp.argmax(ok)],
                          alphas[jnp.argmin(jnp.where(jnp.isfinite(phis), phis,
                                                      jnp.inf))])

        x_n = x + alpha * dx
        s_n = jnp.maximum(jnp.where(mask, s + alpha * ds, 1.0), 1e-30)
        z_n = jnp.maximum(jnp.where(mask, z + a_z * dz, 1.0), 1e-30)
        bad = ~jnp.all(jnp.isfinite(x_n))
        keep = converged | bad

        def sel(a, b):
            return jnp.where(keep, a, b)

        return Carry(x=sel(x, x_n), s=sel(s, s_n), z=sel(z, z_n), mu=mu,
                     nu=nu_new, kkt=err0, it=cr.it + 1, converged=converged)

    init = Carry(x=jnp.asarray(x0, dtype), s=s0, z=z0, mu=mu0,
                 nu=jnp.asarray(10.0, dtype), kkt=jnp.asarray(jnp.inf, dtype),
                 it=jnp.zeros((), jnp.int32), converged=jnp.zeros((), bool))
    final = lax.while_loop(
        lambda cr: (cr.it < opt.max_iter) & ~cr.converged,
        lambda cr: jax.tree.map(lambda a, b: jnp.where(cr.converged, a, b), cr,
                                body(cr)),
        init)
    gv = (g(final.x, p) if (g is not None and m) else jnp.zeros(0, dtype))
    return DenseSolution(x=final.x, f=obj(final.x), g=gv, kkt_error=final.kkt,
                         iterations=final.it, converged=final.converged)


class NonlinearProgram:
    """User-facing NLP (reference: Optimizer/NonlinearProgram, optimizer.py:47-772)."""

    _program_type = "NLP"

    def __init__(self, name: Optional[str] = None, solver: Optional[str] = None):
        self.name = name or self._program_type.lower()
        self._n = 0
        self._n_p = 0
        self._m = 0
        self._f: Optional[Callable] = None
        self._g: Optional[Callable] = None
        self._lbg = None
        self._ubg = None
        self._setup_done = False
        self._opts = DenseIPOptions()
        self.stats: dict = {}

    def set_decision_variables(self, n_or_names):
        if isinstance(n_or_names, (int, np.integer)):
            self._n = int(n_or_names)
            self._var_names = [f"x_{i}" for i in range(self._n)]
        else:
            names = ([n_or_names] if isinstance(n_or_names, str)
                     else list(n_or_names))
            self._var_names = names
            self._n = len(names)
        return self

    def set_parameters(self, n_or_names):
        if isinstance(n_or_names, (int, np.integer)):
            self._n_p = int(n_or_names)
        else:
            names = ([n_or_names] if isinstance(n_or_names, str)
                     else list(n_or_names))
            self._n_p = len(names)
        return self

    def set_objective(self, fn: Callable):
        """fn(x) or fn(x, p) -> scalar."""
        import inspect

        try:
            n_args = len(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            n_args = 2
        if n_args == 1:
            self._f = lambda x, p: jnp.squeeze(jnp.asarray(fn(x)))
        else:
            self._f = lambda x, p: jnp.squeeze(jnp.asarray(fn(x, p)))
        return self

    def set_constraints(self, fn: Callable, lb=None, ub=None, n: Optional[int]
                        = None):
        """fn(x) or fn(x, p) -> (m,), with lbg <= fn <= ubg."""
        import inspect

        try:
            n_args = len(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            n_args = 2
        if n_args == 1:
            gfn = lambda x, p: jnp.atleast_1d(jnp.asarray(fn(x)))
        else:
            gfn = lambda x, p: jnp.atleast_1d(jnp.asarray(fn(x, p)))
        if n is None:
            out = gfn(jnp.zeros(self._n), jnp.zeros(self._n_p))
            n = out.shape[0]
        self._g = gfn
        self._m = int(n)
        self._lbg = (np.full(n, -np.inf) if lb is None
                     else np.broadcast_to(np.asarray(lb, float).ravel(), (n,)))
        self._ubg = (np.full(n, np.inf) if ub is None
                     else np.broadcast_to(np.asarray(ub, float).ravel(), (n,)))
        return self

    def setup(self, options: Optional[dict] = None, solver: Optional[str] = None,
              **kwargs):
        if self._f is None:
            raise RuntimeError("set_objective first")
        if self._n == 0:
            raise RuntimeError("set_decision_variables first")
        options = options or {}
        self._opts = DenseIPOptions(
            max_iter=options.get("max_iter", 60),
            tol=options.get("tol", 1e-8),
        )
        self._solve_jit = jax.jit(partial(
            solve_dense_nlp, self._f, self._g, self._n, self._m,
            options=self._opts))
        self._setup_done = True
        return self

    def is_setup(self):
        return self._setup_done

    def solve(self, x0=None, p=None, lbx=None, ubx=None, lbg=None, ubg=None):
        if not self._setup_done:
            self.setup()
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        n = self._n
        x0 = jnp.asarray(np.zeros(n) if x0 is None
                         else np.asarray(x0, float).ravel(), dtype)
        p = jnp.asarray(np.zeros(self._n_p) if p is None
                        else np.asarray(p, float).ravel(), dtype)
        to = lambda v, d: jnp.asarray(
            np.broadcast_to(np.asarray(d if v is None else v, float).ravel(),
                            (n,)).copy() if np.ndim(d if v is None else v) <= 1
            else v, dtype)
        lbx = to(lbx, -np.inf)
        ubx = to(ubx, np.inf)
        m = self._m
        lbg = jnp.asarray(self._lbg if (lbg is None and self._lbg is not None)
                          else np.broadcast_to(
                              np.asarray(-np.inf if lbg is None else lbg,
                                         float).ravel(), (m,)), dtype) \
            if m else jnp.zeros(0, dtype)
        ubg = jnp.asarray(self._ubg if (ubg is None and self._ubg is not None)
                          else np.broadcast_to(
                              np.asarray(np.inf if ubg is None else ubg,
                                         float).ravel(), (m,)), dtype) \
            if m else jnp.zeros(0, dtype)
        sol = self._solve_jit(x0, p, lbx, ubx, lbg, ubg)
        self.stats = {
            "iterations": int(sol.iterations),
            "kkt_error": float(sol.kkt_error),
            "converged": bool(sol.converged),
        }
        return {"x": np.asarray(sol.x), "f": float(sol.f),
                "g": np.asarray(sol.g), "success": bool(sol.converged)}


class QuadraticProgram(NonlinearProgram):
    """min 1/2 xᵀHx + cᵀx s.t. bounds + linear constraints
    (reference: optimizer.py:768)."""

    _program_type = "QP"

    def set_quadratic_objective(self, H, c=None):
        H = np.atleast_2d(np.asarray(H, dtype=float))
        if self._n == 0:
            self.set_decision_variables(H.shape[0])
        c = np.zeros(H.shape[0]) if c is None else np.asarray(c, float).ravel()
        self.set_objective(lambda x: 0.5 * x @ jnp.asarray(H, x.dtype) @ x
                           + jnp.asarray(c, x.dtype) @ x)
        return self

    def set_linear_constraints(self, A, lb=None, ub=None):
        A = np.atleast_2d(np.asarray(A, dtype=float))
        self.set_constraints(lambda x: jnp.asarray(A, x.dtype) @ x, lb=lb, ub=ub,
                             n=A.shape[0])
        return self


class LinearProgram(QuadraticProgram):
    """min cᵀx s.t. bounds + linear constraints (reference: optimizer.py:697)."""

    _program_type = "LP"

    def set_linear_objective(self, c):
        c = np.asarray(c, dtype=float).ravel()
        if self._n == 0:
            self.set_decision_variables(c.size)
        self.set_objective(lambda x: jnp.asarray(c, x.dtype) @ x)
        return self
