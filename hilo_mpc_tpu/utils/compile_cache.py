"""Placement of JAX's persistent compilation cache for this repository's
scripts, benchmarks and tests.

The cache key includes the cache path, so the path must stay fixed from run to
run: where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here; otherwise the cache goes to ``.jax_cache`` at the root of
the checkout (listed in ``.gitignore``).
"""
from __future__ import annotations

import os
from pathlib import Path

#: the in-checkout cache directory used when the environment names none
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def use_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Enable the persistent compilation cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set this changes no setting. Otherwise
    it points the cache at `CHECKOUT_CACHE_DIR` and caches every program that
    took at least ``min_compile_secs`` to compile.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return str(CHECKOUT_CACHE_DIR)
