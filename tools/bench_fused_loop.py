"""GPU benchmark: the fused on-device closed loop (SURVEY §3.3).

Measures closed-loop steps/s (one step = one warm-started NMPC solve + one
plant RK4 step, fused inside a lax.scan body) at production batch, and the
EKF-in-the-feedback-path variant (solve + plant step + noisy measurement +
EKF predict/update per step).

Usage: python tools/bench_fused_loop.py [B] [steps] [reps]
Prints one JSON line per variant.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build(N=20):
    import __graft_entry__ as ge

    return ge._build_nmpc(N=N, tol=1e-4, max_iter=25)


def main():
    import jax

    from hilo_mpc_tpu.utils.compile_cache import use_compile_cache
    use_compile_cache()

    from hilo_mpc_tpu.estimation import ExtendedKalmanFilter
    from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz
    from hilo_mpc_tpu.parallel import (fused_closed_loop_ekf_fn,
                                       fused_closed_loop_fn)

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    P = np.ones(6)
    dev = jax.devices()[0]
    print(f"# device={dev.platform}:{getattr(dev, 'device_kind', '?')} "
          f"B={B} steps={steps}", file=sys.stderr)

    plant = cstr_schaffner_and_zeitz()
    plant.setup(dt=0.1, integration_method="rk4")
    nmpc = _build()
    rng = np.random.default_rng(0)
    x0s = np.array([0.2, 0.1]) + 0.04 * rng.standard_normal((B, 2))

    # -- plain fused loop --------------------------------------------------
    run = fused_closed_loop_fn(nmpc, plant, steps=steps, plant_p=P)
    t0 = time.time()
    res = run(x0s)
    jax.block_until_ready(res.X)
    compile_s = time.time() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run(x0s)
        jax.block_until_ready(res.X)
        times.append(time.perf_counter() - t0)
    t = min(times)
    conv = float(np.asarray(res.converged).mean())
    err = float(np.linalg.norm(
        np.asarray(res.X)[:, -1, :] - [0.3, 0.18055], axis=1).max())
    print(json.dumps({
        "metric": "fused closed-loop steps/s (CSTR N=20, warm-started)",
        "B": B, "steps": steps, "value": round(B * steps / t, 1),
        "unit": "loop-steps/s", "t_s": t, "compile_s": round(compile_s, 1),
        "converged": conv, "final_err_max": err}))

    # -- EKF-in-loop variant ----------------------------------------------
    ekf = ExtendedKalmanFilter(cstr_schaffner_and_zeitz())
    ekf.Q = 1e-4 * np.eye(2)
    ekf.R = np.array([[1e-4]])
    ekf.set_initial_parameter_values(P)
    ekf.setup(dt=0.1)
    run_e = fused_closed_loop_ekf_fn(nmpc, plant, ekf, steps=steps,
                                     plant_p=P,
                                     meas_noise_std=np.array([0.002]))
    x_est0 = x0s + 0.02 * rng.standard_normal((B, 2))
    key = jax.random.PRNGKey(0)
    t0 = time.time()
    res_e = run_e(x0s, x_est0, 0.05 * np.eye(2), key=key)
    jax.block_until_ready(res_e.X)
    compile_e = time.time() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res_e = run_e(x0s, x_est0, 0.05 * np.eye(2), key=key)
        jax.block_until_ready(res_e.X)
        times.append(time.perf_counter() - t0)
    t_e = min(times)
    conv_e = float(np.asarray(res_e.converged).mean())
    err_e = float(np.linalg.norm(
        np.asarray(res_e.X)[:, -1, :] - [0.3, 0.18055], axis=1).max())
    est_err = float(np.abs(np.asarray(res_e.X_est)[:, -1, :]
                           - np.asarray(res_e.X)[:, -1, :]).max())
    print(json.dumps({
        "metric": "fused closed-loop steps/s with EKF feedback",
        "B": B, "steps": steps, "value": round(B * steps / t_e, 1),
        "unit": "loop-steps/s", "t_s": t_e, "compile_s": round(compile_e, 1),
        "converged": conv_e, "final_err_max": err_e,
        "est_err_max": est_err}))


if __name__ == "__main__":
    main()
