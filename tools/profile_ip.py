"""Component-cost triangulation for the stagewise IP solver on real hardware.

Runs the flagship CSTR NMPC batch at fixed iteration counts (early_exit=False)
and differentiates timings across option toggles to attribute per-iteration
time to: linearization, newton_step (Riccati + condensation), merit rollouts.

Usage: python tools/profile_ip.py [B]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed_solve(nmpc_opts, B=4096, reps=3):
    import jax

    import __graft_entry__ as ge
    from hilo_mpc_tpu import NMPC
    from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz

    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = 20
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    base = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-4,
            "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
            "mehrotra": False, "early_exit": False, "max_iter": 8}
    base.update(nmpc_opts)
    nmpc.setup(options=base)
    args = ge._batch_inputs(nmpc, B)
    fn = nmpc.solve_batch_fn()
    sol = fn(*args)
    jax.block_until_ready(sol.U)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sol = fn(*args)
        jax.block_until_ready(sol.U)
        ts.append(time.perf_counter() - t0)
    return min(ts), float(np.asarray(sol.converged).mean())


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    rows = {}
    for name, opts in [
        ("it2", {"max_iter": 2}),
        ("it10", {"max_iter": 10}),
        ("it10_mehrotra", {"max_iter": 10, "mehrotra": True}),
        ("it10_ls6", {"max_iter": 10, "n_linesearch": 6}),
        ("it10_convexify", {"max_iter": 10, "convexify": True}),
    ]:
        t, conv = timed_solve(opts, B=B)
        rows[name] = t
        print(f"{name:18s} t={t*1e3:8.2f} ms  conv={conv:.3f}", flush=True)

    per_it = (rows["it10"] - rows["it2"]) / 8.0
    print(f"\nper-iteration time:            {per_it*1e3:7.3f} ms")
    d_meh = (rows["it10_mehrotra"] - rows["it10"]) / 10.0
    print(f"extra newton_step (mehrotra):  {d_meh*1e3:7.3f} ms/it "
          f"({d_meh/per_it*100:.0f}% of iter)")
    d_ls = (rows["it10_ls6"] - rows["it10"]) / 10.0 / 5.0
    print(f"one merit rollout:             {d_ls*1e3:7.3f} ms/it "
          f"({d_ls/per_it*100:.0f}% of iter)")
    d_cx = (rows["it10_convexify"] - rows["it10"]) / 10.0
    print(f"convexify (eigh):              {d_cx*1e3:7.3f} ms/it "
          f"({d_cx/per_it*100:.0f}% of iter)")
    # base config runs mehrotra=False and n_linesearch=1, so per_it already
    # contains ONE newton_step and NO merit rollouts; d_meh measures the cost
    # of one extra newton_step, d_ls of one extra rollout
    rest = per_it - d_meh
    print(f"remainder (linearize + misc):  {rest*1e3:7.3f} ms/it "
          f"({rest/per_it*100:.0f}% of iter; newton_step ~= the mehrotra "
          f"delta above)")


def extra():
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    for name, opts in [
        ("it2_u", {"max_iter": 2, "riccati_unroll": 21}),
        ("it10_u", {"max_iter": 10, "riccati_unroll": 21}),
    ]:
        t, conv = timed_solve(opts, B=B)
        print(f"{name:18s} t={t*1e3:8.2f} ms  conv={conv:.3f}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "extra":
        extra()
    else:
        main()
