"""Benchmark breadth: batched NMPC throughput on the GPU beyond the toy state
dimension, same methodology as bench.py:

  * cstr       — nx=2, nu=1, N=20 (the flagship)
  * cartpole   — nx=4, nu=1, N=30 (stabilization from perturbed states:
                 4x4 per-stage blocks)
  * bioreactor — nx=7, nu=2, N=20 (Lee-Ramirez fed-batch regulation)

Reports solves/s (cold + warm-shifted),
convergence, iters p50, XLA flops/bytes per solve and the binding resource;
writes the rows into results/ROOFLINE.json["dims"].

Usage: python tools/bench_dims.py [--quick]
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))


def build_cstr(N=20):
    import __graft_entry__ as ge

    return ge._build_nmpc(N=N, tol=1e-4, max_iter=25)


def build_cartpole(N=30):
    """Cart-pole stabilization NMPC (examples/07 dynamics), playbook options.

    Stabilization from perturbed near-upright states — the fleet-MPC regime
    (swing-up from hanging is a multi-start problem, examples/07, not a
    throughput benchmark)."""
    from hilo_mpc_tpu import NMPC

    from importlib import import_module

    cartpole = import_module("07_cartpole_swingup").cartpole
    nmpc = NMPC(cartpole())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[2.0, 10.0, 0.1, 0.1],
                                    ref=[0.0] * 4)
    nmpc.quad_stage_cost.add_inputs(weights=0.01)
    nmpc.quad_terminal_cost.add_states(weights=[10.0, 100.0, 1.0, 1.0],
                                       ref=[0.0] * 4)
    nmpc.set_box_constraints(u_lb=-15.0, u_ub=15.0,
                             x_lb=[-2.0, -np.inf, -np.inf, -np.inf],
                             x_ub=[2.0, np.inf, np.inf, np.inf])
    # the strongly nonlinear swing dynamics need a few merit-line-search
    # candidates (pure-Newton ls1 oscillates); the constant-x0 auto guess
    # (initial_guess='auto') is what makes the problem converge at all —
    # the zero-input rollout "falls" and turns every solve into swing-up
    nmpc.setup(options={"dt": 0.05, "integration_method": "rk4",
                        "tol": 1e-4, "max_iter": 40, "convexify": False,
                        "n_linesearch": 4, "mu_init": 1e-2,
                        "mehrotra": False, "riccati_unroll": N})
    return nmpc


def bioreactor_ref():
    """A reachable target state: the plant rolled out under constant feed."""
    from hilo_mpc_tpu.library import ecoli_D1210_fedbatch

    plant = ecoli_D1210_fedbatch()
    plant.setup(dt=0.5, integration_method="rk4")
    x0 = [0.1, 40.0, 0.0, 0.0, 1.0, 0.0, 1.0]
    plant.set_initial_conditions(x0)
    out = plant.simulate(u=np.tile([0.05, 0.02], (10, 1)), steps=10)
    return np.asarray(out["x"][-1]), np.array(x0)


def build_bioreactor(N=20):
    from hilo_mpc_tpu import NMPC
    from hilo_mpc_tpu.library import ecoli_D1210_fedbatch

    x_ref, _ = bioreactor_ref()
    nmpc = NMPC(ecoli_D1210_fedbatch())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(
        weights=[10.0, 0.1, 10.0, 1.0, 1.0, 1.0, 0.1], ref=x_ref)
    nmpc.quad_stage_cost.add_inputs(weights=[1.0, 1.0])
    nmpc.set_box_constraints(u_lb=[0.0, 0.0], u_ub=[0.5, 0.5],
                             x_lb=[0.0] * 7, x_ub=[np.inf] * 7)
    # pure-Newton (ls1): the l1 merit check rejects good steps here (21%
    # conv vs 100% without it); mehrotra's adaptive mu diverges on this
    # problem (mu -> 4e5 measured). Regulation regime: see batch_x0 —
    # tracking x_ref from FAR remains a GN-solver hard case
    nmpc.setup(options={"dt": 0.5, "integration_method": "rk4",
                        "tol": 1e-4, "max_iter": 40, "convexify": False,
                        "n_linesearch": 1, "mu_init": 1e-2,
                        "mehrotra": False, "riccati_unroll": N})
    return nmpc


def batch_x0(name, B, seed=0):
    rng = np.random.default_rng(seed)
    if name == "cstr":
        return np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B, 2))
    if name == "cartpole":
        lo = np.array([-0.5, -0.6, -0.5, -0.5])
        hi = -lo
        return lo + (hi - lo) * rng.random((B, 4))
    if name == "bioreactor":
        # fleet regulation at the operating point (±5%) — the production
        # regime; far-from-ref tracking is a documented GN hard case
        x_ref, _ = bioreactor_ref()
        pert = 1.0 + 0.05 * (2.0 * rng.random((B, 7)) - 1.0)
        return np.maximum(x_ref[None, :] * pert, 1e-3)
    raise ValueError(name)


def measure(nmpc, x0s, reps=3):
    import jax

    args = nmpc.prepare_batch(x0s)
    fn = nmpc.solve_batch_fn()
    B = x0s.shape[0]
    t0 = time.time()
    sol = fn(*args)
    jax.block_until_ready(sol.U)
    compile_s = time.time() - t0

    def timeit(f, a):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            s = f(*a)
            np.asarray(s.iterations[:16])
            jax.block_until_ready(s.U)
            ts.append(time.perf_counter() - t0)
        return min(ts), s

    t_cold, sol = timeit(fn, args)

    import jax.numpy as jnp

    theta_B, xs0_B = args[0], args[1]
    X_w = jnp.concatenate([sol.X[:, 1:], sol.X[:, -1:]], axis=1)
    X_w = X_w.at[:, 0, :].set(xs0_B)
    U_w = jnp.concatenate([sol.U[:, 1:], sol.U[:, -1:]], axis=1)
    fnw = nmpc.solve_batch_fn(warm=True)
    sw = fnw(theta_B, xs0_B, X_w, U_w)
    jax.block_until_ready(sw.U)
    t_warm, sol_w = timeit(fnw, (theta_B, xs0_B, X_w, U_w))

    return {
        "B": B, "compile_s": compile_s,
        "cold": {"t_s": t_cold, "solves_per_s": B / t_cold,
                 "iters_p50": float(np.median(np.asarray(sol.iterations))),
                 "iters_max": float(np.asarray(sol.iterations).max()),
                 "converged": float(np.asarray(sol.converged).mean())},
        "warm": {"t_s": t_warm, "solves_per_s": B / t_warm,
                 "iters_p50": float(np.median(np.asarray(sol_w.iterations))),
                 "converged": float(np.asarray(sol_w.converged).mean())},
    }


def cost_analysis(nmpc, x0s):
    """XLA flops/bytes per solve, ONE while-trip."""
    import jax

    args = nmpc.prepare_batch(x0s)
    fn = nmpc.solve_batch_fn()
    B = x0s.shape[0]
    try:
        comp = jax.jit(fn).lower(*args).compile()
        ca = comp.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return {"flops_per_solve_one_trip": float(ca.get("flops", 0)) / B,
                "bytes_per_solve_one_trip":
                    float(ca.get("bytes accessed", 0)) / B}
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def main():
    from hilo_mpc_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax

    from tools.roofline import _peaks_for

    quick = "--quick" in sys.argv
    dev = jax.devices()[0]
    peaks = _peaks_for(dev)
    print(f"# device={dev.platform}:{peaks['device_kind']}", file=sys.stderr)

    configs = [
        ("cstr", lambda: build_cstr(), 131072, {"nx": 2, "nu": 1, "N": 20}),
        ("cartpole", lambda: build_cartpole(), 65536,
         {"nx": 4, "nu": 1, "N": 30}),
        ("bioreactor", lambda: build_bioreactor(), 32768,
         {"nx": 7, "nu": 2, "N": 20}),
    ]
    out = {}
    for name, build, B, dims in configs:
        if quick:
            B = min(B, 4096)
        base = name.split("_")[0]
        print(f"# {name}: building ...", file=sys.stderr)
        try:
            nmpc = build()
            x0s = batch_x0(base, B)
            res = {**dims, **measure(nmpc, x0s)}
            ca = cost_analysis(nmpc, batch_x0(base, min(B, 4096), seed=1))
            res.update(ca)
            if "bytes_per_solve_one_trip" in ca:
                trips = res["warm"]["iters_p50"]
                bytes_est = ca["bytes_per_solve_one_trip"] * trips
                bw = bytes_est * res["warm"]["solves_per_s"]
                bytes_cap = peaks["hbm_Bps"] * res["warm"]["t_s"] / B
                res["roofline"] = {
                    "bytes_per_solve_xla_upper_bound": bytes_est,
                    "bytes_per_solve_at_peak_bw": bytes_cap,
                    "hbm_util_vs_xla_est": bw / peaks["hbm_Bps"],
                    "binding_resource": (
                        "HBM bandwidth" if bw >= 0.6 * peaks["hbm_Bps"]
                        else "f32 issue rate / op serialization"),
                }
        except Exception as e:
            res = {"error": f"{type(e).__name__}: {e}"}
            print(f"# {name} FAILED: {e}", file=sys.stderr)
        out[name] = res
        if "cold" in res:
            print(f"# {name}: cold {res['cold']['solves_per_s']:,.0f}/s "
                  f"warm {res['warm']['solves_per_s']:,.0f}/s "
                  f"conv {res['cold']['converged']:.3f} "
                  f"iters_p50 {res['cold']['iters_p50']}", file=sys.stderr)

    target = os.path.join(ROOT, "results", "ROOFLINE.json")
    os.makedirs(os.path.dirname(target), exist_ok=True)
    from tools.roofline import merge_report

    merge_report({"dims": out}, target)
    print(json.dumps({"dims": out}))


if __name__ == "__main__":
    main()
