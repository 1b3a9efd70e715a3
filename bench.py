"""Benchmark: batched CSTR NMPC solves/s on one GPU.

Metric matches BASELINE.json: "NMPC solves/s/chip (CSTR, N=20 horizon)". The
run fails when JAX finds no GPU, and fails rather than retrying at a smaller
batch when the solve does.

Usage: python bench.py [B] [reps]
Prints the card's name and power limit, then ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "device": ...}.
"""
import json
import subprocess
import sys
import time

import numpy as np


def main():
    from hilo_mpc_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax

    import __graft_entry__ as ge

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found platform {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"# card: {card}", file=sys.stderr)
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 262144
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    _run(ge, jax, dev, card, B, reps)


def _run(ge, jax, dev, card, B, reps):
    import jax.numpy as jnp

    nmpc = ge._build_nmpc(N=20, tol=1e-4, max_iter=25)
    args = ge._batch_inputs(nmpc, B)
    fn = nmpc.solve_batch_fn()

    # warm-up / compile
    t0 = time.time()
    sol = fn(*args)
    jax.block_until_ready(sol.U)
    compile_s = time.time() - t0
    conv = float(np.asarray(sol.converged).mean())
    iters = float(np.median(np.asarray(sol.iterations)))

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sol = fn(*args)
        jax.block_until_ready(sol.U)
        times.append(time.perf_counter() - t0)
    t_best = min(times)
    solves_per_s = B / t_best

    # warm-start measurement: re-solve from the previous solution shifted by one
    # stage (the real closed-loop MPC regime)
    theta_B, xs0_B, _, _ = args
    X_warm = jnp.concatenate([sol.X[:, 1:], sol.X[:, -1:]], axis=1)
    X_warm = X_warm.at[:, 0, :].set(xs0_B)
    U_warm = jnp.concatenate([sol.U[:, 1:], sol.U[:, -1:]], axis=1)
    fn = nmpc.solve_batch_fn(warm=True)
    sol_w = fn(theta_B, xs0_B, X_warm, U_warm)
    jax.block_until_ready(sol_w.U)
    t0 = time.perf_counter()
    sol_w = fn(theta_B, xs0_B, X_warm, U_warm)
    jax.block_until_ready(sol_w.U)
    t_warm = time.perf_counter() - t0
    warm_iters = float(np.median(np.asarray(sol_w.iterations)))

    result = {
        "metric": "NMPC solves/s/chip (CSTR, N=20, multiple shooting)",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "card": card},
    }
    print(json.dumps(result))
    print(f"# device={dev.platform} B={B} t_best={t_best*1e3:.1f}ms "
          f"compile={compile_s:.1f}s converged={conv:.3f} iters_p50={iters} "
          f"per-solve={t_best/B*1e6:.3f}us | warm-start: {B/t_warm:.0f} solves/s "
          f"({t_warm/B*1e6:.3f}us, iters_p50={warm_iters})", file=sys.stderr)


if __name__ == "__main__":
    main()
