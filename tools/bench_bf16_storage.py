"""Same-day A/B of bf16 linearization storage (IPOptions.lin_storage_dtype).

The flagship solve moves its per-stage linearization tensors through device
memory every IP iteration; storing the A/B/Hessian/constraint-jacobian
blocks in bf16 between production and consumption can halve those bytes IF
the converts land on XLA fusion boundaries. This tool measures, same card +
same process:

  * solves/s at batch B for f32 vs bf16 storage (interleaved reps),
  * convergence rate and median iterations,
  * max |U - U_f32ref| vs a tol=1e-7 f32 reference solve,
  * XLA-estimated HBM bytes per solve for both executables.

Usage: python tools/bench_bf16_storage.py [B] [reps]
"""
import sys
import time

import numpy as np


def measure(fn, args, reps):
    import jax

    sol = fn(*args)
    jax.block_until_ready(sol.U)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sol = fn(*args)
        jax.block_until_ready(sol.U)
        times.append(time.perf_counter() - t0)
    return min(times), sol


def cost_bytes(nmpc, args):
    """XLA cost-analysis HBM bytes of the batched solve executable."""
    import jax

    fn_jit = nmpc._trace_entry["sites"].get("solve_batch") if \
        nmpc._trace_entry else None
    if fn_jit is None:
        return float("nan")
    mu = float(nmpc._ip_opts.mu_init)
    lowered = fn_jit.lower(nmpc._bounds, *args, mu)
    ca = lowered.compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca.get("bytes accessed", float("nan")))


def main():
    import os

    import jax

    from hilo_mpc_tpu.utils.compile_cache import use_compile_cache
    use_compile_cache()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    n32 = ge._build_nmpc()
    nbf = ge._build_nmpc(lin_storage_dtype="bfloat16")
    args = ge._batch_inputs(n32, B)

    f32 = n32.solve_batch_fn()
    bf16 = nbf.solve_batch_fn()

    t32, s32 = measure(f32, args, reps)
    tbf, sbf = measure(bf16, args, reps)
    # interleave once more to control for drift
    t32b, _ = measure(f32, args, reps)
    tbfb, _ = measure(bf16, args, reps)
    t32, tbf = min(t32, t32b), min(tbf, tbfb)

    # accuracy vs a tight f32 reference on a small slice
    nref = ge._build_nmpc(tol=1e-7, max_iter=60)
    Bs = min(B, 4096)
    args_s = tuple(a[:Bs] for a in args)
    ref = nref.solve_batch_fn()(*args_s)
    dev32 = float(np.max(np.abs(np.asarray(s32.U[:Bs]) - np.asarray(ref.U))))
    devbf = float(np.max(np.abs(np.asarray(sbf.U[:Bs]) - np.asarray(ref.U))))

    by32 = cost_bytes(n32, args)
    bybf = cost_bytes(nbf, args)

    rows = [
        ("f32 storage", B / t32, float(np.mean(np.asarray(s32.converged))),
         float(np.median(np.asarray(s32.iterations))), dev32, by32 / B),
        ("bf16 storage", B / tbf, float(np.mean(np.asarray(sbf.converged))),
         float(np.median(np.asarray(sbf.iterations))), devbf, bybf / B),
    ]
    print(f"# B={B} reps={reps} device={jax.devices()[0].platform}")
    print("| config | solves/s | convergence | iters p50 | max|U-U*| "
          "| XLA bytes/solve |")
    print("|---|---|---|---|---|---|")
    for name, sps, conv, it, dev, bps in rows:
        print(f"| {name} | {sps:,.0f} | {conv:.4f} | {it:.0f} | {dev:.2e} "
              f"| {bps:,.0f} |")
    print(f"# speedup bf16/f32: {t32 / tbf:.3f}x")


if __name__ == "__main__":
    main()
