"""Scenario-sharded NMPC across a device mesh.

On real hardware, run as-is (uses every visible chip). Without a pod slice, run with
a virtual CPU mesh to exercise the identical sharding path:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/06_multichip_scaling.py --cpu

The solves are embarrassingly parallel across the batch axis; jit partitions the vmap
over the mesh so each chip computes its shard (scaling-book recipe: pick a mesh,
annotate shardings, let XLA place the compute).
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from hilo_mpc_tpu import NMPC
    from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz
    from hilo_mpc_tpu.parallel import (convergence_stats, make_mesh, shard_batch,
                                       sharded_solve_fn)

    n_dev = len(jax.devices())
    P = [1.0] * 6
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = 12
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_parameters(P)
    nmpc.setup(options={"dt": 0.1, "tol": 1e-4, "max_iter": 20,
                        "convexify": False})

    B = 128 * n_dev
    rng = np.random.default_rng(0)
    x0s = np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B, 2))
    args = nmpc.prepare_batch(x0s)

    results = {}
    rates = {}
    for nd in sorted({1, n_dev}):
        mesh = make_mesh(nd)
        fn = sharded_solve_fn(nmpc, mesh)
        sargs = shard_batch(args, mesh)
        sol = fn(*sargs)
        jax.block_until_ready(sol.U)
        t0 = time.perf_counter()
        sol = fn(*sargs)
        jax.block_until_ready(sol.U)
        t = time.perf_counter() - t0
        results[nd] = t
        rates[nd] = B / t
        stats = convergence_stats(sol)
        print(f"{nd} device(s): {B} solves in {t * 1e3:.1f} ms "
              f"({B / t:.0f} solves/s), convergence {stats['rate']:.3f}")
    if len(results) == 2:
        eff = results[1] / (results[n_dev] * n_dev)
        print(f"scaling efficiency at {n_dev} devices: {eff * 100:.0f}%")
        if jax.default_backend() == "cpu":
            print("NOTE: virtual CPU devices share the same physical cores (XLA "
                  "already multithreads the 1-device case), so efficiency here "
                  "only validates the sharding mechanics — real devices each "
                  "run their own shard of this embarrassingly parallel batch "
                  "axis.")

    if os.environ.get("HILO_EXAMPLES_OUT"):     # gallery figure
        import _gallery as _g

        fig, axes = _g.new_fig(1, 1, width=5.2)
        ax = axes[0][0]
        nds = sorted(rates)
        xs = np.arange(len(nds))
        ax.bar(xs, [rates[nd] for nd in nds], width=0.55,
               color=[_g.SERIES[0], _g.SERIES[2]][:len(nds)])
        for i, nd in enumerate(nds):
            ax.text(i, rates[nd], f"{rates[nd]:,.0f}/s", ha="center",
                    va="bottom", fontsize=8, color=_g.TEXT)
        ax.set_xticks(xs)
        ax.set_xticklabels([f"{nd} device{'s' if nd > 1 else ''}"
                            for nd in nds], color=_g.MUTED, fontsize=8)
        backend = "virtual CPU mesh" if jax.default_backend() == "cpu" \
            else f"{jax.default_backend().upper()} mesh"
        _g.style(ax, title=f"Scenario-sharded NMPC throughput ({backend}, "
                           f"B={128 * n_dev})",
                 ylabel="solves/s")
        _g.save(fig, "06_multichip_scaling.png")


if __name__ == "__main__":
    main()
