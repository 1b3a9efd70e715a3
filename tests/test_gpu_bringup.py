"""CPU checks of the GPU bring-up: chip_smoke.py's phases at tiny size through
its explicit CPU option, its refusal to run without a GPU, and the placement
of the persistent compilation cache."""
import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from hilo_mpc_tpu.utils import compile_cache  # noqa: E402


def test_chip_smoke_rehearsal_runs_every_phase(capsys):
    assert chip_smoke.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    for phase in ("sweep parity", "NMPC fleet", "MHE fast path",
                  "fused loop", "single solve"):
        assert f"== {phase}: ok" in out
    assert "card: " in out
    last = out.strip().splitlines()[-1]
    assert last.startswith('{"ok": true, "device": {"platform": "cpu"')


def test_chip_smoke_four_rehearsal_compares_with_one_device(capsys):
    # the suite's virtual 8-device CPU mesh stands in for the four cards
    assert chip_smoke.main(["--four", "--cpu"]) == 0
    out = capsys.readouterr().out
    for path in ("four NMPC", "four MHE", "four fused loop"):
        assert path in out and "weak-scaling efficiency" in out
    assert "== four: ok" in out
    assert "== NMPC fleet" not in out


def test_chip_smoke_refuses_to_run_without_a_gpu(capsys):
    assert chip_smoke.main([]) == 1
    captured = capsys.readouterr()
    assert "no GPU" in captured.err
    assert '"ok"' not in captured.out


@pytest.fixture
def restore_cache_config():
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", before[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", before[1])


def test_cache_dir_from_environment_sets_nothing(monkeypatch, tmp_path,
                                                 restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", "/sentinel")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/sentinel"


def test_cache_dir_defaults_to_the_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.use_compile_cache(min_compile_secs=0.25)
    assert got == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.25
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
