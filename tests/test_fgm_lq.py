"""The batched box-QP fast gradient method against a plain numpy iteration and
the interior-point solution, and the Riccati LQ sweeps against a float64 dense
KKT solve."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hilo_mpc_tpu import LMPC, Model
from hilo_mpc_tpu.ops.fgm import fgm_boxqp_batch


def make_qp(n=6, nx=2, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    H = M @ M.T + np.eye(n)
    G = rng.normal(size=(n, nx))
    lb = -np.ones(n)
    ub = np.ones(n)
    return H, G, lb, ub


def fgm_numpy(H, G, x0, lb, ub, iters):
    """Plain f64 loop of the same projected fast-gradient iteration."""
    eigs = np.linalg.eigvalsh(0.5 * (H + H.T))
    L, mu = eigs[-1], max(eigs[0], 1e-9)
    beta = (np.sqrt(L / mu) - 1.0) / (np.sqrt(L / mu) + 1.0)
    out = []
    for x in x0:
        g = G @ x
        u = y = np.zeros(H.shape[0])
        for _ in range(iters):
            u_new = np.clip(y - (H @ y + g) / L, lb, ub)
            y = u_new + beta * (u_new - u)
            u = u_new
        out.append(u)
    return np.array(out)


class TestFGM:
    def test_matches_numpy_reference(self):
        H, G, lb, ub = make_qp()
        x0 = np.random.default_rng(1).normal(size=(17, 2))
        u = np.asarray(fgm_boxqp_batch(H, G, x0, lb, ub, iters=200))
        np.testing.assert_allclose(u, fgm_numpy(H, G, x0, lb, ub, 200),
                                   atol=1e-5)

    def test_matches_closed_form_unconstrained(self):
        H, G, _, _ = make_qp()
        lb = -1e3 * np.ones(6)
        ub = 1e3 * np.ones(6)
        x0 = np.random.default_rng(2).normal(size=(4, 2)) * 0.1
        u = np.asarray(fgm_boxqp_batch(H, G, x0, lb, ub, iters=400))
        u_exact = -(np.linalg.solve(H, G @ x0.T)).T
        np.testing.assert_allclose(u, u_exact, atol=1e-4)

    def test_active_bounds(self):
        H = np.eye(3)
        G = np.eye(3)[:, :2] * 10.0
        lb, ub = -0.5 * np.ones(3), 0.5 * np.ones(3)
        x0 = np.array([[1.0, 1.0]])
        u = np.asarray(fgm_boxqp_batch(H, G, x0, lb, ub, iters=100))
        # unconstrained optimum -G x0 = (-10, -10, 0) clips to bounds
        np.testing.assert_allclose(u[0], [-0.5, -0.5, 0.0], atol=1e-6)


class TestLMPCFastPath:
    def test_fgm_matches_interior_point(self):
        dt = 0.1
        m = Model(discrete=True)
        m.set_state_space(A=[[1.0, dt], [0.0, 1.0]], B=[[0.5 * dt ** 2], [dt]],
                          C=[[1.0, 0.0]])
        lmpc = LMPC(m)
        lmpc.horizon = 10
        lmpc.Q = np.diag([5.0, 1.0])
        lmpc.R = np.array([[0.5]])
        lmpc.set_box_constraints(u_lb=-1.0, u_ub=1.0)
        lmpc.setup(options={"dt": dt, "tol": 1e-10})
        x0s = np.array([[1.0, 0.0], [2.0, -1.0], [-1.5, 0.5], [0.3, 0.3]])
        u_fgm = lmpc.optimize_batch_fgm(x0s, iters=400)
        for i, x0 in enumerate(x0s):
            u_ip = lmpc.optimize(x0)
            lmpc._warm = None
            lmpc._u_old[:] = 0
            np.testing.assert_allclose(u_fgm[i], u_ip, atol=5e-4)


def _lq_problem(N, nx, nu, seed=0, Bt=None):
    rng = np.random.default_rng(seed)
    lead = () if Bt is None else (Bt,)
    A = np.eye(nx) + 0.05 * rng.standard_normal(lead + (N, nx, nx))
    B = 0.3 * rng.standard_normal(lead + (N, nx, nu))
    Q = np.broadcast_to(np.eye(nx), lead + (N, nx, nx))
    S = 0.1 * rng.standard_normal(lead + (N, nu, nx))
    R = np.broadcast_to(0.5 * np.eye(nu), lead + (N, nu, nu))
    q = rng.standard_normal(lead + (N, nx))
    r = rng.standard_normal(lead + (N, nu))
    c = 0.1 * rng.standard_normal(lead + (N, nx))
    Pt = np.broadcast_to(np.eye(nx), lead + (nx, nx))
    pt = rng.standard_normal(lead + (nx,))
    dx0 = rng.standard_normal(lead + (nx,))
    return (A, B, Q, S, R, q, r, c, Pt, pt, dx0)


class TestSolveLQDenseKKT:
    """`solve_lq` (scan, rolled and fully unrolled) and `solve_lq_parallel`
    against one dense float64 KKT solve per problem."""

    @pytest.mark.parametrize("N,nx,nu", [(5, 2, 1), (5, 3, 2), (5, 2, 3),
                                         (6, 4, 1), (3, 1, 1), (8, 7, 2)])
    def test_sweeps_match_dense_kkt(self, N, nx, nu):
        from lq_reference import dense_lq_solve

        from hilo_mpc_tpu.ops.riccati import solve_lq, solve_lq_parallel
        args = _lq_problem(N, nx, nu, seed=N * 10 + nx)
        dX, dU, lam = dense_lq_solve(*args)
        jargs = [jnp.asarray(a, jnp.float64) for a in args]
        for sol in (solve_lq(*jargs, reg=0.0), solve_lq(*jargs, reg=0.0,
                                                         unroll=N),
                    solve_lq_parallel(*jargs, reg=0.0)):
            np.testing.assert_allclose(np.asarray(sol.dX), dX, atol=1e-9)
            np.testing.assert_allclose(np.asarray(sol.dU), dU, atol=1e-9)
            np.testing.assert_allclose(np.asarray(sol.lam), lam, atol=1e-9)

    def test_f32_batched_sweep_within_parity_tolerance(self):
        # the f32 vmapped sweep at "highest" precision, the form chip_smoke's
        # sweep-parity phase checks on the card
        import chip_smoke
        res = chip_smoke.sweep_parity(32, 10, 2, 1, reps=1)
        for k in ("dX", "dU", "lam"):
            assert res[k][1] < chip_smoke.PARITY_RTOL, (k, res[k])


class TestSweepUnroll:
    @pytest.mark.parametrize("platform,N,want", [
        ("gpu", 20, 20), ("gpu", 10, 10), ("cpu", 20, 1), ("cpu", 1, 1)])
    def test_unroll_by_platform(self, platform, N, want):
        from hilo_mpc_tpu.ops.riccati import sweep_unroll
        assert sweep_unroll(platform, N) == want

    def test_mhe_fast_path_takes_the_platform_unroll(self):
        from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz
        from hilo_mpc_tpu.estimation.mhe import MovingHorizonEstimator
        mhe = MovingHorizonEstimator(cstr_schaffner_and_zeitz())
        mhe.horizon = 6
        mhe.set_initial_parameter_values([1.0] * 6)
        mhe.setup(dt=0.1, options={"integration_method": "rk4"})
        assert mhe.fast_path
        # this suite runs on the CPU: the scan stays rolled
        assert mhe._ip_opts.riccati_unroll == 1


@pytest.mark.gpu
def test_sweep_on_card_matches_dense_kkt(gpu_device):
    """The f32 sweep as compiled for the card, at a real width."""
    import chip_smoke

    res = chip_smoke.sweep_parity(131072, 20, 2, 1)
    for k in ("dX", "dU", "lam"):
        assert res[k][1] < chip_smoke.PARITY_RTOL, (k, res[k])
