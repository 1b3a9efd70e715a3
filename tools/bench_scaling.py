"""Scaling-efficiency harness: batched NMPC solves/s at 1, 2, 4, ... devices.

BASELINE.json demands solves/s measured at 1 chip / 1 host / >=2 hosts with
>=80% efficiency at 2 hosts. This harness produces the {n_devices -> solves/s,
efficiency} table on whatever mesh is available:
  - a GPU host: run as-is (JAX sees all local cards)
  - CPU fake mesh: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python tools/bench_scaling.py
  - multi-host: launch one copy per host after hilo_mpc_tpu.parallel.\
        distributed.initialize() (devices() is then the global list)

Per-device batch is held constant (weak scaling — the production regime: more
hosts = more scenarios), so efficiency = solves/s(n) / (n * solves/s(1)).

Usage: python tools/bench_scaling.py [B_per_device] [reps]
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from hilo_mpc_tpu.utils.compile_cache import use_compile_cache
    use_compile_cache()

    import __graft_entry__ as ge
    from hilo_mpc_tpu.parallel import (batch_stats, make_mesh, shard_batch,
                                       sharded_solve_fn)

    B_per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    platform = jax.devices()[0].platform
    n_avail = len(jax.devices())
    if platform == "cpu" and B_per_dev > 256:
        B_per_dev = 64          # CPU fake mesh: keep the sweep fast
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]

    nmpc = ge._build_nmpc(N=20, tol=1e-4, max_iter=25) if platform != "cpu" \
        else ge._build_nmpc(N=8, tol=1e-4, max_iter=12)

    rows = []
    for n in counts:
        B = B_per_dev * n
        mesh = make_mesh(n)
        args = shard_batch(ge._batch_inputs(nmpc, B), mesh)
        fn = sharded_solve_fn(nmpc, mesh, with_stats=True)
        t0 = time.time()
        sol, stats = fn(*args)
        jax.block_until_ready(stats["rate"])
        compile_s = time.time() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sol, stats = fn(*args)
            jax.block_until_ready(stats["rate"])
            times.append(time.perf_counter() - t0)
        t = min(times)
        rows.append({"n_devices": n, "B": B, "t_ms": t * 1e3,
                     "solves_per_s": B / t,
                     "rate": float(stats["rate"]),
                     "compile_s": compile_s})
        print(f"# n={n} B={B} t={t*1e3:.2f}ms {B/t:,.0f} solves/s "
              f"conv={float(stats['rate']):.3f}", file=sys.stderr)

    base = rows[0]["solves_per_s"]
    for r in rows:
        r["efficiency"] = r["solves_per_s"] / (r["n_devices"] * base)
    out = {"platform": platform, "B_per_device": B_per_dev,
           "weak_scaling": rows,
           "efficiency_at_max": rows[-1]["efficiency"]}
    if platform == "cpu":
        out["note"] = ("virtual CPU mesh: all 'devices' share the same "
                       "physical cores, so weak-scaling efficiency is NOT "
                       "meaningful here — this run validates the harness; "
                       "efficiency numbers require real chips")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
