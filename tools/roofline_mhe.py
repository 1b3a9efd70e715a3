"""Roofline for the batched MHE window solve on the GPU.

Measures the production-regime batched MHE path — B independent N-window
estimation NLPs solved by the same stagewise IP engine as NMPC
(fix_x0=False: the Riccati sweep picks the free arrival state) — cold and
warm-started, with XLA cost analysis to name the binding resource.

Usage: python tools/roofline_mhe.py [B] [--json out.json]
Writes/updates the "mhe" section of results/ROOFLINE.json (or --json).
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_mhe(N=10, tol=1e-4, **extra):
    from hilo_mpc_tpu import MHE
    from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz

    # the production operating point (covariance-derived weights,
    # bench_secondary.py)
    mhe = MHE(cstr_schaffner_and_zeitz(), plot_backend=None)
    mhe.horizon = N
    mhe.Q = 1e-4
    mhe.R = 1e-3
    mhe.P0 = np.eye(2) * 0.1
    mhe.set_initial_parameter_values([1.0] * 6)
    mhe.setup(dt=0.1, options={"integration_method": "rk4", "tol": tol,
                               **extra})
    mhe.set_initial_guess([0.25, 0.15])
    return mhe


# The NMPC throughput playbook (single fraction-to-boundary Newton step,
# the platform's sweep, no per-stage eigh) IS the default for auto-detected
# convex windows (affine measurement map — estimation/mhe.py fast_path);
# "conservative" forces the guarded configuration for the A/B
CONSERVATIVE = dict(fast_path=False)


def batch_windows(mhe, B, seed=0):
    """Simulated measurement windows for B scenarios (same plant as the
    golden MHE config, per-scenario initial states + noise)."""
    rng = np.random.default_rng(seed)
    N = mhe._horizon
    p = [1.0] * 6

    def ode(x, u):
        # vectorized over the batch: x (B, 2), u (B, 1)
        a1, b1, a2, b2, g, E = p
        r = (1.0 - x[:, 0]) * np.exp(-E / (1.0 + x[:, 1]))
        return np.stack([-a1 * x[:, 0] + b1 * r,
                         -a2 * x[:, 1] + b2 * r + g * u[:, 0]], axis=1)

    def rk4(x, u, dt=0.1):
        k1 = ode(x, u)
        k2 = ode(x + 0.5 * dt * k1, u)
        k3 = ode(x + 0.5 * dt * k2, u)
        k4 = ode(x + dt * k3, u)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    T = N + 2  # one extra sample so the warm solve sees a genuinely new window
    X0 = np.array([0.2, 0.1]) + 0.03 * rng.standard_normal((B, 2))
    Us = 0.3 * np.sin(np.linspace(0, 3, T))[None, :, None] \
        + 0.05 * rng.standard_normal((B, T, 1))
    Ys = np.zeros((B, T, 1))
    x = X0.copy()
    for k in range(T):
        Ys[:, k, 0] = x[:, 1] + 0.003 * rng.standard_normal(B)
        x = rk4(x, Us[:, k])
    return X0, Ys, Us


def main():
    from hilo_mpc_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax
    import jax.numpy as jnp

    from tools.roofline import _peaks_for

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    dev = jax.devices()[0]
    peaks = _peaks_for(dev)
    print(f"# device={dev.platform}:{peaks['device_kind']} B={B}",
          file=sys.stderr)

    def run_config(mhe):
        X0, Ys, Us = batch_windows(mhe, B)
        N = mhe._horizon
        p_vec = np.ones(6)
        theta = mhe._theta_batch(Ys[:, :N + 1], Us[:, :N + 1], X0, p_vec)
        dtype = mhe._solver_dtype
        xs0 = X0
        X_init = np.tile(xs0[:, None, :], (1, N + 1, 1))
        U_init = np.zeros((B, N, 2))
        solve = mhe._get_solve_batch_jit()
        args = (jnp.asarray(theta, dtype), jnp.asarray(xs0, dtype),
                jnp.asarray(X_init, dtype), jnp.asarray(U_init, dtype))

        t0 = time.time()
        sol = solve(mhe._bounds, *args)
        jax.block_until_ready(sol.X)
        compile_s = time.time() - t0

        def timeit(a):
            ts = []
            for _ in range(4):
                t0 = time.perf_counter()
                s = solve(mhe._bounds, *a)
                jax.block_until_ready(s.X)
                ts.append(time.perf_counter() - t0)
            return min(ts), s

        t_cold, sol = timeit(args)
        # warm regime (deployment ring buffer): the NEXT window — one new
        # measurement appended, arrival advanced to the previous node-1
        # estimate, initial trajectory = shifted previous solution
        X_sol = np.asarray(sol.X)
        arr_w = X_sol[:, 1, :2]
        theta_w = mhe._theta_batch(Ys[:, 1:N + 2], Us[:, 1:N + 2], arr_w,
                                   p_vec)
        X_w = np.concatenate([X_sol[:, 1:], X_sol[:, -1:]], axis=1)
        U_w = np.concatenate([np.asarray(sol.U)[:, 1:],
                              np.asarray(sol.U)[:, -1:]], axis=1)
        args_w = (jnp.asarray(theta_w, dtype), jnp.asarray(arr_w, dtype),
                  jnp.asarray(X_w, dtype), jnp.asarray(U_w, dtype))
        t_warm, sol_w = timeit(args_w)

        try:
            comp = solve.lower(mhe._bounds, *args).compile()
            ca = comp.cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            fl1 = float(ca.get("flops", 0)) / B
            by1 = float(ca.get("bytes accessed", 0)) / B
        except Exception as e:
            fl1 = by1 = float("nan")
            print(f"# cost analysis failed: {e}", file=sys.stderr)

        trips = float(np.asarray(sol_w.iterations).max())
        res = {
            "B": B, "N": N, "compile_s": compile_s,
            "cold": {"t_s": t_cold, "windows_per_s": B / t_cold,
                     "iters_p50": float(np.median(
                         np.asarray(sol.iterations))),
                     "converged": float(np.asarray(sol.converged).mean())},
            "warm": {"t_s": t_warm, "windows_per_s": B / t_warm,
                     "iters_p50": float(np.median(
                         np.asarray(sol_w.iterations))),
                     "iters_max": trips,
                     "converged": float(np.asarray(sol_w.converged).mean())},
            "flops_per_window_one_trip": fl1,
            "bytes_per_window_one_trip": by1,
        }
        if np.isfinite(by1):
            bytes_w = by1 * trips            # XLA estimate: UPPER bound
            bw = bytes_w * res["warm"]["windows_per_s"]
            # physically-movable bytes in the measured time at peak BW
            bytes_cap = peaks["hbm_Bps"] * t_warm / B
            res["roofline"] = {
                "bytes_per_window_xla_upper_bound": bytes_w,
                "bytes_per_window_at_peak_bw": bytes_cap,
                "xla_overcount_factor": bytes_w / max(bytes_cap, 1e-30),
                "hbm_util_vs_xla_est": bw / peaks["hbm_Bps"],
                "binding_resource": (
                    "HBM bandwidth (XLA bytes estimate >= the physical "
                    "ceiling for the measured time, i.e. the solve runs "
                    "within its estimate's bytes-limited floor)"
                    if bw >= 0.6 * peaks["hbm_Bps"]
                    else "f32 issue rate / op serialization"),
            }
        return res, np.asarray(sol_w.X)[:, -1, :2]

    out = {}
    x_ref = None
    for name, mhe in (("default", build_mhe()),
                      ("conservative", build_mhe(**CONSERVATIVE))):
        res, x_est = run_config(mhe)
        res["fast_path"] = bool(mhe.fast_path)
        out[name] = res
        if x_ref is None:
            x_ref = x_est
        else:
            out[name]["max_est_dev_vs_default"] = float(
                np.max(np.abs(x_est - x_ref)))
        print(f"# {name}: warm {res['warm']['windows_per_s']:,.0f} "
              f"windows/s (cold {res['cold']['windows_per_s']:,.0f}), "
              f"conv {res['warm']['converged']:.3f}", file=sys.stderr)

    target = os.path.join(ROOT, "results", "ROOFLINE.json")
    for i, a in enumerate(sys.argv):
        if a == "--json" and i + 1 < len(sys.argv):
            target = sys.argv[i + 1]
    from tools.roofline import merge_report

    os.makedirs(os.path.dirname(os.path.abspath(target)), exist_ok=True)
    merge_report({"mhe": out}, target)
    print(json.dumps({"mhe": out}))


if __name__ == "__main__":
    main()
