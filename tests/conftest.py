"""Test configuration: run all tests on a virtual 8-device CPU mesh with x64 enabled.

Multi-chip sharding paths are validated on `--xla_force_host_platform_device_count=8`
(SURVEY.md §4(e): the reference has no distributed tests; a virtual CPU mesh is our fake
cluster). x64 gives solver parity tests IPOPT-grade arithmetic; library code remains
dtype-agnostic and runs f32 on the GPU.

The platform follows JAX_PLATFORMS and defaults to the CPU. Tests that need the
card carry the `gpu` marker and skip through the `gpu_device` fixture where
JAX finds none; `chip_smoke.py` runs the same checks on the card.
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compile cache: repeated suite runs skip the (minutes of) XLA
# compiles; JAX_COMPILATION_CACHE_DIR places it, else <checkout>/.jax_cache
from hilo_mpc_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache(min_compile_secs=0.15)


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test where there is none (decided
    when the test runs, never at import or collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {dev.platform!r}")
    return dev

# library-level crash isolation for the root-caused XLA:CPU serialize abort
# (see the block comment below): cache writes run in a forked child, so an
# abort kills the child, not the worker. The pytest_handlecrashitem hook
# below stays as the backstop for any OTHER worker crash.
from hilo_mpc_tpu.utils.cache_guard import install_cache_crash_guard  # noqa: E402

install_cache_crash_guard()


# -- worker-crash rerun -------------------------------------------------------
# Root-caused environmental flake (this jax 0.9.0 + XLA:CPU image): writing a
# persistent-cache entry calls executable.serialize(), which internally AOT
# re-compiles the executable (that is where the `+prefer-no-scatter` target
# features in the cpu_aot_loader warnings come from); on COLD-cache full-suite
# runs this abort()s the process once in a while (observed 2 of 4 cold runs,
# faulthandler stack: compilation_cache.put_executable_and_time ->
# executable.serialize(), SIGABRT with no CHECK message; never reproducible
# standalone, never on warm caches — warm runs perform no cache writes). The
# crash takes the whole xdist worker down and its in-flight test would be
# reported as a spurious failure. Reschedule such tests (bounded) on the
# surviving workers instead: the recompile lands warm on retry, so the retry
# is deterministic.
_CRASH_RERUNS: dict = {}
_MAX_CRASH_RERUNS = 2


def pytest_handlecrashitem(crashitem, report, sched):
    n = _CRASH_RERUNS.get(crashitem, 0)
    if n < _MAX_CRASH_RERUNS:
        _CRASH_RERUNS[crashitem] = n + 1
        sched.mark_test_pending(crashitem)
        report.outcome = "rerun"


def pytest_report_teststatus(report, config):
    if report.outcome == "rerun":
        return "rerun", "R", ("RERUN", {"yellow": True})
