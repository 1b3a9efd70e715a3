"""One process of a CPU fake cluster (SURVEY.md §4(e): the reference has no
distributed tests; we simulate a 2-host pod with 2 local processes x 4 virtual
CPU devices each).

Usage: python tools/fake_cluster_worker.py <coordinator_port> <process_id> <num_processes>

Each worker initializes jax.distributed against the shared coordinator, builds
the GLOBAL "dp" mesh (8 devices across both processes), contributes its local
half of a B=16 batched CSTR NMPC solve via
jax.make_array_from_process_local_data, and reads back in-jit psum/max
convergence stats (identical replicated scalars on every host). Exit code 0 +
the OK line = the multi-host path compiles, executes, and converges.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from hilo_mpc_tpu.utils.compile_cache import use_compile_cache  # noqa: E402
use_compile_cache()

import numpy as np  # noqa: E402


def main():
    port, pid, nprocs = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    from hilo_mpc_tpu.parallel import distributed as dist

    multi = dist.initialize(coordinator_address=f"localhost:{port}",
                            num_processes=nprocs, process_id=pid)
    assert multi, "expected a multi-process runtime"
    assert jax.process_count() == nprocs, jax.process_count()
    n_local = jax.local_device_count()
    n_global = jax.device_count()
    assert n_global == nprocs * n_local, (n_global, n_local)

    import __graft_entry__ as ge
    from hilo_mpc_tpu.parallel import sharded_solve_fn

    nmpc = ge._build_nmpc(N=4, tol=1e-6, max_iter=12)
    B_global = 16
    full = ge._batch_inputs(nmpc, B_global)           # same seed on every host
    sl = dist.local_slice(B_global)
    local = jax.tree.map(lambda a: np.asarray(a)[sl], full)

    mesh = dist.global_mesh()
    args = dist.global_batch(local, mesh)
    assert args[0].shape[0] == B_global               # global logical shape
    fn = sharded_solve_fn(nmpc, mesh, with_stats=True)
    sol, stats = fn(*args)
    jax.block_until_ready(stats["rate"])
    rate = float(stats["rate"])
    kkt_max = float(stats["kkt_max"])
    assert rate == 1.0, f"convergence rate {rate}"
    print(f"worker {pid}/{nprocs}: OK — global_devices={n_global} "
          f"local={n_local} rate={rate} kkt_max={kkt_max:.2e}", flush=True)


if __name__ == "__main__":
    main()
