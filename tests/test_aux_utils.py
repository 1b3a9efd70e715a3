"""Auxiliary subsystems: AOT export/reload, SolveTimer stats, Session/TempDir
(SURVEY.md §5 — tracing/profiling, checkpoint/resume, session/tempdir)."""
import os

import numpy as np
import pytest

from hilo_mpc_tpu import Model
from hilo_mpc_tpu.utils.aot import export_function, export_model_step, load_function
from hilo_mpc_tpu.utils.profiling import SolveTimer
from hilo_mpc_tpu.utils.session import Session, TempDir


def pendulum():
    import jax.numpy as jnp

    m = Model(name="pend")
    m.set_dynamical_states(["th", "om"])
    m.set_inputs("tau")
    m.set_measurements(["y_th"])
    m.set_dynamical_equations(
        lambda x, u: jnp.array([x[1], -jnp.sin(x[0]) - 0.3 * x[1] + u[0]]))
    m.set_measurement_equations(lambda x: x[:1])
    return m


class TestAOT:
    def test_export_and_reload_function(self, tmp_path):
        import jax.numpy as jnp

        path = str(tmp_path / "fn.hlo")
        export_function(lambda a: 2.0 * a + 1.0, (jnp.zeros(3),), path)
        assert os.path.exists(path)
        fn = load_function(path)
        np.testing.assert_allclose(np.asarray(fn(jnp.array([1.0, 2.0, 3.0]))),
                                   [3.0, 5.0, 7.0], atol=1e-6)

    def test_export_model_step_roundtrip(self, tmp_path):
        m = pendulum()
        m.setup(dt=0.1, integration_method="rk4")
        m.set_initial_conditions([0.3, 0.0])
        path = export_model_step(m, str(tmp_path / "step.hlo"))
        fn = load_function(path)
        import jax.numpy as jnp

        dt = m.dtype  # exported artifact is specialized to the model dtype
        out = fn(jnp.array([0.3, 0.0], dt), jnp.zeros(0, dt),
                 jnp.array([0.1], dt), jnp.zeros(0, dt))
        ref = m.simulate(u=np.array([[0.1]]), steps=1)["x"][-1]
        x_next = np.asarray(out[0] if isinstance(out, (tuple, list)) else out)
        np.testing.assert_allclose(x_next.ravel()[:2], ref, atol=1e-6)


class TestSolveTimer:
    def test_percentiles(self):
        t = SolveTimer()
        for _ in range(20):
            with t.measure():
                sum(range(1000))
        s = t.stats()
        assert s["n"] == 20
        assert 0 <= s["p50_ms"] <= s["p99_ms"]

    def test_empty_timer_stats(self):
        s = SolveTimer().stats()
        assert s["n"] == 0


class TestSessionTempDir:
    def test_tempdir_context_cleans_up(self):
        with TempDir() as d:
            p = d if isinstance(d, str) else d.path
            assert os.path.isdir(p)
            with open(os.path.join(p, "x.txt"), "w") as f:
                f.write("hi")
        assert not os.path.exists(p)

    def test_session_context(self, tmp_path):
        with Session(compilation_cache=str(tmp_path / "cache")) as s:
            assert s is not None


class TestRooflineAccounting:
    """tools/roofline.py: the analytic FLOP/byte counters behind its roofline
    shares must stay consistent with the sweep's algebra."""

    def _tool(self):
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                        "tools"))
        import roofline
        return roofline

    def test_sweep_flops_scale_linearly_in_N(self):
        rl = self._tool()
        f1 = rl.lq_sweep_flops(1, 2, 1)
        f10 = rl.lq_sweep_flops(10, 2, 1)
        f20 = rl.lq_sweep_flops(20, 2, 1)
        # per-stage cost is N-independent: increments must match exactly
        assert f20 - f10 == 10 * (f10 - f1) / 9 * 1 or (f20 - f10) == (
            (f10 - f1) * 10 // 9)
        assert f20 > f10 > f1 > 0

    def test_sweep_flops_tiny_case_hand_count(self):
        rl = self._tool()
        # N=1, nx=1, nu=1 backward stage:
        #   Pc_p = P*c + p                      -> 2 flops (mul, add)
        #   PA = P*A                            -> 1
        #   PB = P*B                            -> 1
        #   G = R + B*PB; sym avg + reg         -> 2 + 3
        #   Hux = S + B*PA                      -> 2
        #   g_u = r + B*Pc_p                    -> 2
        #   chol: sqrt(G)                       -> 1
        #   fwd/back subst: 2 cols x 2 divs     -> 4 (incl. negate? negation
        #   of K,kff counts 2)
        # ... the exact total is what the counter says; assert the structural
        # identity instead: flops(N) = N*(stage+fwd) with no constant term
        # beyond the terminal handling
        f1, f2, f3 = (rl.lq_sweep_flops(n, 1, 1) for n in (1, 2, 3))
        assert f2 - f1 == f3 - f2          # exact linearity
        assert f1 == f2 - f1               # no constant offset

    def test_sweep_bytes_count(self):
        rl = self._tool()
        # N=20, nx=2, nu=1: inputs 20*(8+4+1+4+1)+4+4 floats, outputs
        # 21*2+20*(2+2+2)+1 floats, f32
        n_in = 20 * (2 * 4 + 2 * 2 + 1 + 2 * 2 + 1) + 4 + 4
        n_out = 21 * 2 + 20 * (2 * 1 + 2 + 1 * 2) + 1
        assert rl.lq_sweep_bytes(20, 2, 1) == 4 * (n_in + n_out)

    def test_peaks_lookup(self):
        rl = self._tool()

        class Dev:
            device_kind = "NVIDIA H100 80GB HBM3"

        p = rl._peaks_for(Dev())
        assert p["hbm_Bps"] == 3.35e12
        assert p["bf16_dense"] == 989e12
        assert p["device_kind"] == "NVIDIA H100 80GB HBM3"

    @pytest.mark.parametrize("kind", ["", "cpu", "NVIDIA A100-SXM4-80GB"])
    def test_unknown_device_raises(self, kind):
        rl = self._tool()

        class Dev:
            device_kind = kind

        with pytest.raises(ValueError, match="no published peaks"):
            rl._peaks_for(Dev())

    def test_counter_counts_each_op_once(self):
        rl = self._tool()
        rl._Ctr.ops = 0
        a, b = rl._Ctr(), rl._Ctr()
        _ = a + b
        _ = a * b
        _ = -a
        _ = a / b
        _ = a.sqrt()
        assert rl._Ctr.ops == 5
