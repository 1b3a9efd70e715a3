"""Tracing/profiling helpers (SURVEY.md §5: reference has only wall-clock `extime`
stats, mpc.py:815-835; this build adds JAX profiler traces + per-solve stats)."""
from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/hilo_trace"):
    """Capture an xprof/TensorBoard-viewable device trace of the enclosed block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class SolveTimer:
    """Accumulates per-solve wall times; exposes the reference's stats surface
    (p50/p99, count) plus device sync for honest timing."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, result=None):
        import jax

        t0 = time.perf_counter()
        yield
        if result is not None:
            jax.block_until_ready(result)
        self.times.append(time.perf_counter() - t0)

    def stats(self) -> dict:
        import numpy as np

        if not self.times:
            return {"n": 0}
        t = np.asarray(self.times)
        return {
            "n": int(t.size),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
            "mean_ms": float(t.mean() * 1e3),
            "total_s": float(t.sum()),
        }
