"""Fused on-device closed loop: controller solve + plant step inside one lax.scan.

SURVEY.md §3.3's accelerator mapping of the reference's SimpleControlLoop: "this whole loop is
the rollout; batched over scenarios it becomes one lax.scan whose body fuses
controller-solve + plant-step". Thousands of closed-loop simulations (e.g. controller
tuning sweeps, scenario studies, Monte-Carlo verification of chance constraints) run
without the device ever syncing with the host; warm starts thread through the scan
carry exactly as they do step-to-step in deployment.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


def _scenario_keys(key, B, has_noise: bool):
    """Per-scenario PRNG keys. Refuses noise-without-key: with key=None every
    scenario would share one identical stream, silently defeating Monte-Carlo
    fleet studies (advisor round-3 finding)."""
    if key is not None:
        return jax.random.split(key, B)
    if has_noise:
        raise ValueError(
            "a noise std was supplied but key=None: all scenarios would "
            "receive the identical noise realization. Pass "
            "key=jax.random.PRNGKey(seed) to the run function.")
    return jnp.zeros((B, 2), jnp.uint32)


class ClosedLoopResult(NamedTuple):
    X: jnp.ndarray           # (B, steps+1, nx) plant states
    U: jnp.ndarray           # (B, steps, nu) applied inputs
    converged: jnp.ndarray   # (B, steps) per-step solver convergence
    iterations: jnp.ndarray  # (B, steps)


def fused_closed_loop_fn(nmpc, plant_model, steps: int,
                         plant_p: Optional[np.ndarray] = None,
                         process_noise_std: Optional[np.ndarray] = None):
    """Build a jitted fn(x0_batch[, key]) -> ClosedLoopResult.

    The controller's OCP is re-solved every step (warm-started from the previous
    shifted solution); the plant is stepped with the first control move. Assumes
    time-invariant references/tvp over the run (theta row 0 reused each step).
    """
    from ..ops.ip_solver import solve_ocp

    if not nmpc.is_setup():
        raise RuntimeError("nmpc must be set up")
    if not plant_model.is_setup():
        raise RuntimeError("plant model must be set up (plant.setup(dt=...))")
    if plant_model.n_p and plant_p is None:
        raise ValueError("plant model has parameters; pass plant_p=")
    dtype = nmpc._solver_dtype
    theta = jnp.asarray(nmpc._assemble_theta(None, None, None), dtype)
    solver = partial(solve_ocp, nmpc._funcs, nmpc._dims,
                     options=nmpc._ip_opts, fix_x0=True)
    bounds = nmpc._bounds
    plant_step = plant_model.step_fn_raw
    p_plant = jnp.asarray(plant_p if plant_p is not None
                          else np.zeros(plant_model.n_p), dtype)
    dt = plant_model.dt
    nx, nu = plant_model.n_x, plant_model.n_u
    nz = plant_model.n_z
    sx = jnp.asarray(nmpc._x_scaling, dtype)
    su = jnp.asarray(nmpc._u_scaling, dtype)
    aug = nmpc._augment_du
    noise = (None if process_noise_std is None
             else jnp.asarray(process_noise_std, dtype))

    def solver_x0(x_plant, u_old):
        parts = [x_plant / sx]
        if aug:
            parts.append(u_old / su)
        if nmpc._path_following:
            parts.append(jnp.zeros(1, dtype))
        if nmpc._min_time is not None:
            parts.append(jnp.full((1,), nmpc._dt, dtype))
        return jnp.concatenate(parts)

    def one_scenario(x0, key):
        xs0 = solver_x0(x0, jnp.zeros(nu, dtype))
        X_init = nmpc._rollout_guess_jit(
            xs0, theta, jnp.zeros((nmpc._dims.N, nmpc._dims.nu), dtype))
        U_init = jnp.zeros((nmpc._dims.N, nmpc._dims.nu), dtype)

        def body(carry, k):
            x, u_old, Xw, Uw, key = carry
            xs0 = solver_x0(x, u_old)
            Xw = Xw.at[0].set(xs0)
            sol = solver(bounds, theta, xs0, Xw, Uw)
            if aug:
                u0 = sol.X[1, nx:nx + nu] * su
            else:
                u0 = sol.U[0, :nu] * su
            x_next, _, _, _ = plant_step(x, jnp.zeros(nz, dtype), u0, p_plant,
                                         k * dt, dt)
            if noise is not None:
                key, sub = jax.random.split(key)
                x_next = x_next + noise * jax.random.normal(sub, (nx,), dtype)
            # shift warm start
            Xw_next = jnp.concatenate([sol.X[1:], sol.X[-1:]], axis=0)
            Uw_next = jnp.concatenate([sol.U[1:], sol.U[-1:]], axis=0)
            out = (x_next, u0, sol.converged, sol.iterations)
            return (x_next, u0, Xw_next, Uw_next, key), out

        (_, _, _, _, _), (X_traj, U_traj, conv, iters) = jax.lax.scan(
            body, (x0, jnp.zeros(nu, dtype), X_init, U_init, key),
            jnp.arange(steps, dtype=dtype))
        X_full = jnp.concatenate([x0[None], X_traj], axis=0)
        return ClosedLoopResult(X=X_full, U=U_traj, converged=conv,
                                iterations=iters)

    @jax.jit
    def run(x0_batch, key=None):
        x0_batch = jnp.asarray(x0_batch, dtype)
        B = x0_batch.shape[0]
        keys = _scenario_keys(key, B, noise is not None)
        return jax.vmap(one_scenario)(x0_batch, keys)

    return run


class ClosedLoopMHEResult(NamedTuple):
    X: jnp.ndarray           # (B, steps+1, nx) TRUE plant states
    X_est: jnp.ndarray       # (B, steps, nx) MHE estimates fed back
    U: jnp.ndarray           # (B, steps, nu) applied inputs
    converged: jnp.ndarray   # (B, steps) controller solves
    mhe_converged: jnp.ndarray  # (B, steps) window solves


def fused_closed_loop_mhe_fn(nmpc, plant_model, mhe, steps: int,
                             plant_p: Optional[np.ndarray] = None,
                             process_noise_std: Optional[np.ndarray] = None,
                             meas_noise_std: Optional[np.ndarray] = None):
    """Fused loop with a MOVING-HORIZON estimator in the feedback path: every
    scan step runs the controller solve at the MHE estimate, steps the plant,
    measures, shifts the measurement window and solves the window NLP —
    two interior-point solves per step, all on-device (SURVEY §3.3 with the
    reference's MHE observer, control_loop.py + estimator/mhe.py).

    ``mhe`` must be a set-up MovingHorizonEstimator on the controller's model
    WITHOUT estimated parameters (the fused variant keeps the window state
    minimal). The window must be pre-filled by the caller: pass
    ``y_window0 (B, N_w+1, ny)``, ``u_window0 (B, N_w+1, nu)`` and the
    arrival state batch — e.g. from a short recorded startup.

    Returns fn(x0_true, y_window0, u_window0, x_arrival0[, key]) ->
    ClosedLoopMHEResult.
    """
    from ..ops.ip_solver import solve_ocp

    if not nmpc.is_setup():
        raise RuntimeError("nmpc must be set up")
    if not plant_model.is_setup():
        raise RuntimeError("plant model must be set up (plant.setup(dt=...))")
    if not mhe._setup_done:
        raise RuntimeError("mhe must be set up")
    if mhe._est_params:
        raise NotImplementedError(
            "fused MHE loop supports state estimation only (no estimated "
            "parameters); use the host-driven loop for joint estimation")
    if plant_model.n_p and plant_p is None:
        raise ValueError("plant model has parameters; pass plant_p=")
    dtype = nmpc._solver_dtype
    theta_c = jnp.asarray(nmpc._assemble_theta(None, None, None), dtype)
    c_solver = partial(solve_ocp, nmpc._funcs, nmpc._dims,
                       options=nmpc._ip_opts, fix_x0=True)
    c_bounds = nmpc._bounds
    m_solver = partial(solve_ocp, mhe._funcs, mhe._dims,
                       options=mhe._ip_opts, fix_x0=False)
    m_bounds = mhe._bounds
    plant_step = plant_model.step_fn_raw
    meas_fn = plant_model.meas_fn()
    p_plant = jnp.asarray(plant_p if plant_p is not None
                          else np.zeros(plant_model.n_p), dtype)
    p_mhe = jnp.asarray(mhe._p_or_default(None), dtype)
    dt = plant_model.dt
    nx, nu, nz = plant_model.n_x, plant_model.n_u, plant_model.n_z
    ny = len(plant_model.measurements)
    Nw = mhe._horizon
    nxs_m, nw_m = mhe._dims.nx, mhe._dims.nu
    off_u, off_y, off_p, off_ax, _ = mhe._offsets
    off_mask = mhe._off_mask
    n_theta_m = mhe._n_theta
    sx = jnp.asarray(nmpc._x_scaling, dtype)
    su = jnp.asarray(nmpc._u_scaling, dtype)
    aug = nmpc._augment_du
    w_std = (None if process_noise_std is None
             else jnp.asarray(process_noise_std, dtype))
    v_std = (None if meas_noise_std is None
             else jnp.asarray(meas_noise_std, dtype))

    def solver_x0(x_est, u_old):
        parts = [x_est / sx]
        if aug:
            parts.append(u_old / su)
        if nmpc._path_following:
            parts.append(jnp.zeros(1, dtype))
        if nmpc._min_time is not None:
            parts.append(jnp.full((1,), nmpc._dt, dtype))
        return jnp.concatenate(parts)

    arange_w = jnp.arange(Nw + 1, dtype=dtype)

    def mhe_theta(Ys, Us, x_arr, t0):
        # mirrors MovingHorizonEstimator.estimate's window assembly
        # (estimation/mhe.py:398-409) with all measurements present
        us_interval = jnp.concatenate([Us[1:], Us[-1:]], axis=0)
        th = jnp.zeros((Nw + 1, n_theta_m), dtype)
        th = th.at[:, 0].set(t0 + dt * arange_w)
        th = th.at[:, off_u:off_u + nu].set(us_interval)
        th = th.at[:, off_y:off_y + ny].set(Ys)
        th = th.at[:, off_p:off_p + p_mhe.size].set(p_mhe[None, :])
        th = th.at[:, off_ax:off_ax + nx].set(x_arr[None, :])
        th = th.at[:, off_mask:off_mask + ny].set(1.0)
        th = th.at[0, -1].set(1.0)
        return th

    def one_scenario(x0_true, Ys0, Us0, x_arr0, key):
        x_est0 = x_arr0
        xs0 = solver_x0(x_est0, jnp.zeros(nu, dtype))
        Xc0 = nmpc._rollout_guess_jit(
            xs0, theta_c, jnp.zeros((nmpc._dims.N, nmpc._dims.nu), dtype))
        Uc0 = jnp.zeros((nmpc._dims.N, nmpc._dims.nu), dtype)
        Xm0 = jnp.tile(jnp.concatenate([x_arr0])[None, :], (Nw + 1, 1))
        Wm0 = jnp.zeros((Nw, nw_m), dtype)

        def body(carry, k):
            (x_true, x_est, Ys, Us, x_arr, t_m, u_old, Xc, Uc, Xm, Wm,
             key) = carry
            # -- controller solve at the estimate
            xs0 = solver_x0(x_est, u_old)
            Xc = Xc.at[0].set(xs0)
            sol = c_solver(c_bounds, theta_c, xs0, Xc, Uc)
            if aug:
                u0 = sol.X[1, nx:nx + nu] * su
            else:
                u0 = sol.U[0, :nu] * su
            # -- plant + measurement
            x_next, _, _, _ = plant_step(x_true, jnp.zeros(nz, dtype), u0,
                                         p_plant, k * dt, dt)
            if w_std is not None:
                key, sub = jax.random.split(key)
                x_next = x_next + w_std * jax.random.normal(sub, (nx,), dtype)
            y = jnp.atleast_1d(meas_fn(x_next, jnp.zeros(nz, dtype), u0,
                                       p_plant, (k + 1) * dt))
            if v_std is not None:
                key, sub = jax.random.split(key)
                y = y + v_std * jax.random.normal(sub, y.shape, dtype)
            # -- shift the window, solve the MHE NLP
            Ys_n = jnp.concatenate([Ys[1:], y[None, :]], axis=0)
            Us_n = jnp.concatenate([Us[1:], u0[None, :]], axis=0)
            th_m = mhe_theta(Ys_n, Us_n, x_arr, t_m)
            Xm_s = jnp.concatenate([Xm[1:], Xm[-1:]], axis=0)
            Wm_s = jnp.concatenate([Wm[1:], Wm[-1:]], axis=0)
            sol_m = m_solver(m_bounds, th_m, x_arr, Xm_s, Wm_s)
            x_est_n = sol_m.X[-1, :nx]
            x_arr_n = sol_m.X[1, :nx]
            out = (x_next, x_est_n, u0, sol.converged, sol_m.converged)
            return ((x_next, x_est_n, Ys_n, Us_n, x_arr_n, t_m + dt, u0,
                     jnp.concatenate([sol.X[1:], sol.X[-1:]], axis=0),
                     jnp.concatenate([sol.U[1:], sol.U[-1:]], axis=0),
                     sol_m.X, sol_m.U, key), out)

        carry0 = (x0_true, x_est0, Ys0, Us0, x_arr0, jnp.asarray(0.0, dtype),
                  jnp.zeros(nu, dtype), Xc0, Uc0, Xm0, Wm0, key)
        _, (X_traj, Xe_traj, U_traj, conv, conv_m) = jax.lax.scan(
            body, carry0, jnp.arange(steps, dtype=dtype))
        X_full = jnp.concatenate([x0_true[None], X_traj], axis=0)
        return ClosedLoopMHEResult(X=X_full, X_est=Xe_traj, U=U_traj,
                                   converged=conv, mhe_converged=conv_m)

    @jax.jit
    def run(x0_true_batch, y_window0, u_window0, x_arrival0, key=None):
        x0_true_batch = jnp.asarray(x0_true_batch, dtype)
        B = x0_true_batch.shape[0]
        keys = _scenario_keys(key, B,
                              w_std is not None or v_std is not None)
        return jax.vmap(one_scenario)(
            x0_true_batch, jnp.asarray(y_window0, dtype),
            jnp.asarray(u_window0, dtype), jnp.asarray(x_arrival0, dtype),
            keys)

    return run


class ClosedLoopEKFResult(NamedTuple):
    X: jnp.ndarray           # (B, steps+1, nx) TRUE plant states
    X_est: jnp.ndarray       # (B, steps, nx) EKF estimates fed back
    U: jnp.ndarray           # (B, steps, nu) applied inputs
    converged: jnp.ndarray   # (B, steps)
    iterations: jnp.ndarray  # (B, steps)


def fused_closed_loop_ekf_fn(nmpc, plant_model, ekf, steps: int,
                             plant_p: Optional[np.ndarray] = None,
                             process_noise_std: Optional[np.ndarray] = None,
                             meas_noise_std: Optional[np.ndarray] = None):
    """Fused loop with an EKF observer in the feedback path: controller solve
    + plant step + measurement + EKF predict/update, all inside one lax.scan
    body (SURVEY §3.3's accelerator mapping of SimpleControlLoop WITH an observer —
    reference: control_loop.py observers, modules/estimator KF path). The
    controller only ever sees the estimate; the true state is returned for
    estimation-error studies.

    ``ekf`` must be a set-up KalmanFilter/ExtendedKalmanFilter on the
    controller's model. Returns fn(x0_batch, x_est0, P0[, key]) ->
    ClosedLoopEKFResult; x0_batch is the TRUE initial state batch.
    """
    from ..ops.ip_solver import solve_ocp

    if not nmpc.is_setup():
        raise RuntimeError("nmpc must be set up")
    if not plant_model.is_setup():
        raise RuntimeError("plant model must be set up (plant.setup(dt=...))")
    if plant_model.n_p and plant_p is None:
        raise ValueError("plant model has parameters; pass plant_p=")
    dtype = nmpc._solver_dtype
    theta = jnp.asarray(nmpc._assemble_theta(None, None, None), dtype)
    solver = partial(solve_ocp, nmpc._funcs, nmpc._dims,
                     options=nmpc._ip_opts, fix_x0=True)
    bounds = nmpc._bounds
    plant_step = plant_model.step_fn_raw
    meas_fn = plant_model.meas_fn()
    p_plant = jnp.asarray(plant_p if plant_p is not None
                          else np.zeros(plant_model.n_p), dtype)
    ekf_step = ekf.step_fn()
    p_ekf = jnp.asarray(ekf._p_or_default(None), dtype)
    dt = plant_model.dt
    nx, nu, nz = plant_model.n_x, plant_model.n_u, plant_model.n_z
    sx = jnp.asarray(nmpc._x_scaling, dtype)
    su = jnp.asarray(nmpc._u_scaling, dtype)
    aug = nmpc._augment_du
    w_std = (None if process_noise_std is None
             else jnp.asarray(process_noise_std, dtype))
    v_std = (None if meas_noise_std is None
             else jnp.asarray(meas_noise_std, dtype))

    def solver_x0(x_est, u_old):
        parts = [x_est / sx]
        if aug:
            parts.append(u_old / su)
        if nmpc._path_following:
            parts.append(jnp.zeros(1, dtype))
        if nmpc._min_time is not None:
            parts.append(jnp.full((1,), nmpc._dt, dtype))
        return jnp.concatenate(parts)

    def one_scenario(x0_true, x_est0, P0, key):
        xs0 = solver_x0(x_est0, jnp.zeros(nu, dtype))
        X_init = nmpc._rollout_guess_jit(
            xs0, theta, jnp.zeros((nmpc._dims.N, nmpc._dims.nu), dtype))
        U_init = jnp.zeros((nmpc._dims.N, nmpc._dims.nu), dtype)

        def body(carry, k):
            x_true, x_est, P, u_old, Xw, Uw, key = carry
            xs0 = solver_x0(x_est, u_old)
            Xw = Xw.at[0].set(xs0)
            sol = solver(bounds, theta, xs0, Xw, Uw)
            if aug:
                u0 = sol.X[1, nx:nx + nu] * su
            else:
                u0 = sol.U[0, :nu] * su
            x_next, _, _, _ = plant_step(x_true, jnp.zeros(nz, dtype), u0,
                                         p_plant, k * dt, dt)
            if w_std is not None:
                key, sub = jax.random.split(key)
                x_next = x_next + w_std * jax.random.normal(sub, (nx,), dtype)
            y = jnp.atleast_1d(meas_fn(x_next, jnp.zeros(nz, dtype), u0,
                                       p_plant, (k + 1) * dt))
            if v_std is not None:
                key, sub = jax.random.split(key)
                y = y + v_std * jax.random.normal(sub, y.shape, dtype)
            x_est_next, P_next, _ = ekf_step(x_est, P, u0, p_ekf, y, k * dt)
            Xw_next = jnp.concatenate([sol.X[1:], sol.X[-1:]], axis=0)
            Uw_next = jnp.concatenate([sol.U[1:], sol.U[-1:]], axis=0)
            out = (x_next, x_est_next, u0, sol.converged, sol.iterations)
            return ((x_next, x_est_next, P_next, u0, Xw_next, Uw_next, key),
                    out)

        _, (X_traj, Xe_traj, U_traj, conv, iters) = jax.lax.scan(
            body, (x0_true, x_est0, P0, jnp.zeros(nu, dtype), X_init, U_init,
                   key),
            jnp.arange(steps, dtype=dtype))
        X_full = jnp.concatenate([x0_true[None], X_traj], axis=0)
        return ClosedLoopEKFResult(X=X_full, X_est=Xe_traj, U=U_traj,
                                   converged=conv, iterations=iters)

    @jax.jit
    def run(x0_batch, x_est0_batch, P0, key=None):
        x0_batch = jnp.asarray(x0_batch, dtype)
        x_est0_batch = jnp.asarray(x_est0_batch, dtype)
        B = x0_batch.shape[0]
        P0 = jnp.asarray(P0, dtype)
        P0_b = (jnp.broadcast_to(P0, (B, nx, nx)) if P0.ndim == 2 else P0)
        keys = _scenario_keys(key, B,
                              w_std is not None or v_std is not None)
        return jax.vmap(one_scenario)(x0_batch, x_est0_batch, P0_b, keys)

    return run
