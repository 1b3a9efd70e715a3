"""Multi-host runtime: `jax.distributed` initialization + global-batch helpers.

The reference is single-process CPU (SURVEY.md §2.9) — this is the DCN story it
never had. One JAX process runs per host; `initialize()` wires them into one
global runtime (coordinator handshake), after which `jax.devices()` is the
GLOBAL device list, a `Mesh` built over it spans hosts, and `jit` inserts the
cross-host collectives (convergence reductions ride NVLink within a host and the
network across hosts — scaling-book recipe). Scenario batches are assembled per host
with `global_batch` (`jax.make_array_from_process_local_data`), so no host ever
materializes the full batch.

Typical multi-host launch (same program on every host):

    from hilo_mpc_tpu.parallel import distributed as dist
    dist.initialize()                       # env-driven (SLURM, JAX_* vars)
    mesh = dist.global_mesh()
    theta_g = dist.global_batch(theta_local, mesh)
    ...

A CPU fake cluster for tests uses explicit coordinator/process arguments
(tests/test_distributed.py spawns 2 local processes x 4 virtual devices).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> bool:
    """Initialize `jax.distributed` (idempotent).

    With no arguments, defers to JAX's automatic cluster detection (GKE,
    SLURM) or the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID environment variables. Returns True when a multi-process
    runtime is active after the call, False for the single-process fallback.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # single-process (or an auto-detected cluster): let JAX decide;
        # initialize() without a coordinator is only valid where JAX can
        # detect the cluster itself
        try:
            jax.distributed.initialize()
            _initialized = True
        except (ValueError, RuntimeError):
            return False
        return jax.process_count() > 1
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    _initialized = True
    return jax.process_count() > 1


def is_multi_process() -> bool:
    return jax.process_count() > 1


def global_mesh(axis_names: Sequence[str] = ("dp",),
                shape: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh over ALL global devices (spans hosts when distributed)."""
    devs = np.asarray(jax.devices())
    if shape is None:
        shape = (devs.size,)
    return Mesh(devs.reshape(tuple(shape)), tuple(axis_names))


def global_batch(local_tree, mesh: Mesh, axis: str = "dp"):
    """Assemble a globally-sharded batch from per-process local arrays.

    Each process contributes its local shard (leading dim = B_global /
    process_count); the returned jax.Arrays have global shape and leading-axis
    sharding over `axis`, without any host gathering the full batch.
    """
    def put(x):
        x = np.asarray(x)
        spec = P(axis, *([None] * (x.ndim - 1)))
        if jax.process_count() == 1:
            return jax.device_put(x, NamedSharding(mesh, spec))
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), x)

    return jax.tree.map(put, local_tree)


def local_slice(B_global: int) -> slice:
    """This process's slice of a globally-batched scenario set."""
    n = jax.process_count()
    if B_global % n:
        raise ValueError(f"global batch {B_global} not divisible by "
                         f"{n} processes")
    per = B_global // n
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)
