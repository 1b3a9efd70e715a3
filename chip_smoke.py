"""Smoke run of the batched NMPC/MHE solve path on one NVIDIA GPU.

Drives the main path once, through the entry points a user calls, at fleet
size, in one process:

  1. environment: JAX version, devices, card name and power limit;
  2. sweep parity: the Riccati sweep as XLA compiles it for the card
     (`ops.riccati.solve_lq`, f32 at "highest" precision) at real widths,
     against a float64 dense KKT solve of the same problems;
  3. NMPC fleet solve: the CSTR N=20 flagship through `solve_batch_fn`, cold
     and warm-shifted, plus the x64 golden fixture of the same problem;
  4. MHE fast path: `estimate_batch` over simulated CSTR windows, plus the
     golden MHE fixture;
  5. fused closed loop: `fused_closed_loop_fn` for a few steps;
  6. single solve: `NMPC.optimize` as in the README quickstart.

Every phase checks its results and a failed check exits non-zero. The last
line of standard output is one JSON object naming the device.

Usage:
  python chip_smoke.py          # one GPU, full size
  python chip_smoke.py --four   # only the 4-GPU sharded path and its
                                # one-GPU comparison
  python chip_smoke.py --cpu    # rehearsal at tiny sizes on the CPU
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")

# (N, nx, nu) of the parity phase: the flagship CSTR, cart-pole-sized and
# Lee-Ramirez-sized stage blocks
PARITY_SHAPES = ((20, 2, 1), (30, 4, 1), (20, 7, 2))
FULL = dict(parity_B=131072, nmpc_B=262144, mhe_B=32768, mhe_N=10,
            loop_B=65536, loop_steps=5, shapes=PARITY_SHAPES)
TINY = dict(parity_B=64, nmpc_B=16, mhe_B=16, mhe_N=10, loop_B=8,
            loop_steps=2, shapes=((4, 2, 1), (3, 4, 1)))
MIN_CONVERGED = 0.99
# the f32 sweep against the float64 dense solve: f32 roundoff (6e-8) grown
# over 20-30 stages of the recursion reaches a few 1e-6 of the largest entry
# on these well-posed random problems — 1e-4 leaves room without hiding a
# wrong entry, and a TF32 product (about 1e-3) would fail it
PARITY_RTOL = 1e-4
# scenarios of each parity batch that are also solved by the dense reference
PARITY_CHECKED = 64
# the BASELINE acceptance budget (<1e-4 control deviation against the x64
# oracle at 1e-11), held by the f32 solve at KKT tol 1e-4; f32 on the CPU
# lands near 2e-6
GOLDEN_NMPC_ATOL = 1e-4
# MHE state estimates, same budget (states are O(0.1-1))
GOLDEN_MHE_ATOL = 1e-4


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(msg):
    print(msg, flush=True)


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


# -- 1. environment ----------------------------------------------------------

def phase_environment(cpu: bool, n_devices: int):
    import jax

    log(f"jax {jax.__version__}; devices {jax.devices()}")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not cpu:
        raise PhaseFailed(f"no GPU: JAX found platform {dev.platform!r} "
                          "(run with --cpu for the tiny-size rehearsal)")
    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, JAX found {len(jax.devices())}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        if not cpu:
            raise PhaseFailed(f"nvidia-smi failed: {e}") from e
        smi = "not available (CPU rehearsal)"
    log(f"card: {smi}")
    return dev


# -- 2. sweep parity ---------------------------------------------------------

def random_lq(B, N, nx, nu, seed=0):
    """A well-posed random stagewise LQ batch, generated on the device."""
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(jax.random.PRNGKey(seed), 8)
    f32 = jnp.float32
    nrm = lambda k, s: jax.random.normal(k, s, f32)
    A = jnp.eye(nx, dtype=f32) + 0.05 * nrm(ks[0], (B, N, nx, nx))
    Bm = 0.3 * nrm(ks[1], (B, N, nx, nu))
    Q = jnp.broadcast_to(jnp.eye(nx, dtype=f32), (B, N, nx, nx))
    S = 0.1 * nrm(ks[2], (B, N, nu, nx))
    R = jnp.broadcast_to(0.5 * jnp.eye(nu, dtype=f32), (B, N, nu, nu))
    q = nrm(ks[3], (B, N, nx))
    r = nrm(ks[4], (B, N, nu))
    c = 0.1 * nrm(ks[5], (B, N, nx))
    Pt = jnp.broadcast_to(jnp.eye(nx, dtype=f32), (B, nx, nx))
    pt = nrm(ks[6], (B, nx))
    dx0 = nrm(ks[7], (B, nx))
    return (A, Bm, Q, S, R, q, r, c, Pt, pt, dx0)


def sweep_parity(B, N, nx, nu, reps=3):
    """Compile the f32 Riccati sweep at (B, N, nx, nu), time it, and compare
    its first PARITY_CHECKED scenarios with the float64 dense KKT solve.
    Returns a dict of (max abs, max rel) errors, times and memory."""
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from lq_reference import dense_lq_solve

    from hilo_mpc_tpu.ops.riccati import solve_lq

    def sweep(*a):
        with jax.default_matmul_precision("highest"):
            return tuple(jax.vmap(lambda *s: solve_lq(*s, reg=0.0,
                                                      unroll=N))(*a))

    args = random_lq(B, N, nx, nu)
    t0 = time.perf_counter()
    compiled = jax.jit(sweep).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out, _ = timed(compiled, *args)
    res = {"compile_s": compile_s, "memory": compiled.memory_analysis(),
           "sweep_s": min(timed(compiled, *args)[1] for _ in range(reps))}
    n = min(B, PARITY_CHECKED)
    host = [np.asarray(a[:n], np.float64) for a in args]
    ref = [dense_lq_solve(*(a[i] for a in host)) for i in range(n)]
    for j, name in enumerate(("dX", "dU", "lam")):
        a = np.asarray(out[j][:n], np.float64)
        check(np.isfinite(np.asarray(out[j])).all(), f"sweep {name} not finite")
        b = np.stack([r[j] for r in ref])
        err = float(np.max(np.abs(a - b)))
        res[name] = (err, err / max(float(np.max(np.abs(b))), 1e-30))
    return res


def phase_sweep_parity(sz):
    B = sz["parity_B"]
    for N, nx, nu in sz["shapes"]:
        res = sweep_parity(B, N, nx, nu)
        errs = " ".join(f"{k} abs={res[k][0]:.2e} rel={res[k][1]:.2e}"
                        for k in ("dX", "dU", "lam"))
        log(f"sweep parity (B={B}, N={N}, nx={nx}, nu={nu}; "
            f"{PARITY_CHECKED} scenarios vs f64 dense KKT): {errs} "
            f"[tol rel {PARITY_RTOL:.0e}: f32 roundoff over {N} stages]")
        log(f"  compile {res['compile_s']:.2f} s, sweep "
            f"{res['sweep_s'] * 1e3:.3f} ms for {B} scenarios")
        log(f"  memory_analysis: {res['memory']}")
        for k in ("dX", "dU", "lam"):
            check(res[k][1] < PARITY_RTOL,
                  f"sweep {k} rel error {res[k][1]:.2e} >= {PARITY_RTOL}")


# -- 3. NMPC fleet solve -----------------------------------------------------

def _solve_stats(sol):
    conv = float(np.asarray(sol.converged).mean())
    iters = float(np.median(np.asarray(sol.iterations)))
    return conv, iters


def phase_nmpc(sz):
    import jax.numpy as jnp

    import __graft_entry__ as ge

    B = sz["nmpc_B"]
    nmpc = ge._build_nmpc(N=20, tol=1e-4, max_iter=25)
    args = ge._batch_inputs(nmpc, B)
    fn = nmpc.solve_batch_fn()
    sol, first_s = timed(fn, *args)
    _, run_s = timed(fn, *args)
    conv, iters = _solve_stats(sol)
    check(np.isfinite(np.asarray(sol.U)).all(), "NMPC controls not finite")
    log(f"NMPC cold: B={B} N=20 converged={conv:.4f} iters_p50={iters} "
        f"compile~{first_s - run_s:.1f} s run={run_s:.3f} s "
        f"({B / run_s:.0f} solves/s)")
    check(conv >= MIN_CONVERGED, f"NMPC cold convergence {conv} < 0.99")

    theta_B, xs0_B, _, _ = args
    X_w = jnp.concatenate([sol.X[:, 1:], sol.X[:, -1:]], axis=1)
    X_w = X_w.at[:, 0, :].set(xs0_B)
    U_w = jnp.concatenate([sol.U[:, 1:], sol.U[:, -1:]], axis=1)
    fw = nmpc.solve_batch_fn(warm=True)
    sol_w, first_w = timed(fw, theta_B, xs0_B, X_w, U_w)
    _, run_w = timed(fw, theta_B, xs0_B, X_w, U_w)
    conv_w, iters_w = _solve_stats(sol_w)
    log(f"NMPC warm-shifted: converged={conv_w:.4f} iters_p50={iters_w} "
        f"first={first_w:.2f} s run={run_w:.3f} s ({B / run_w:.0f} solves/s)")
    check(conv_w >= MIN_CONVERGED, f"NMPC warm convergence {conv_w} < 0.99")

    # golden: the x64 oracle's controls at its recorded closed-loop states,
    # solved here as one f32 batch through the same entry point
    gold = np.load(os.path.join(GOLDEN, "cstr_tracking.npz"))
    X_meas, U_gold = gold["X_meas"], gold["U_gold"]
    n = U_gold.shape[0]
    sol_g = fn(*nmpc.prepare_batch(X_meas[:n]))
    conv_g, _ = _solve_stats(sol_g)
    dev = float(np.max(np.abs(np.asarray(sol_g.U)[:, 0, :] - U_gold)))
    log(f"NMPC golden (cstr_tracking, {n} states): max|u - u_gold| = "
        f"{dev:.2e} [tol {GOLDEN_NMPC_ATOL:.0e}: f32 solve at KKT tol 1e-4 "
        f"vs x64 oracle], converged={conv_g:.2f}")
    check(dev < GOLDEN_NMPC_ATOL, f"NMPC golden deviation {dev:.2e}")


# -- 4. MHE fast path --------------------------------------------------------

def phase_mhe(sz):
    import __graft_entry__ as ge

    B, N = sz["mhe_B"], sz["mhe_N"]
    mhe = ge._build_mhe(N=N)
    Ys, Us, x_arr = ge._mhe_windows(B, N=N)
    (x_est, sol), first_s = timed(
        lambda: mhe.estimate_batch(Ys, Us, x_arrivals=x_arr))
    _, run_s = timed(lambda: mhe.estimate_batch(Ys, Us, x_arrivals=x_arr))
    conv, iters = _solve_stats(sol)
    check(mhe.fast_path, "MHE fast path not detected for the CSTR")
    check(np.isfinite(x_est).all(), "MHE estimates not finite")
    log(f"MHE fast path: B={B} N={N} converged={conv:.4f} iters_p50={iters} "
        f"compile~{first_s - run_s:.1f} s run={run_s:.3f} s "
        f"({B / run_s:.0f} windows/s, host window assembly included)")
    check(conv >= MIN_CONVERGED, f"MHE convergence {conv} < 0.99")
    mhe_golden()


def mhe_golden():
    """The golden MHE config (horizon 8, stiff weights), solved in the solve
    dtype: sequentially through estimate(), and the same windows at once
    through estimate_batch with the arrival means the sequence used."""
    from hilo_mpc_tpu.estimation.mhe import MovingHorizonEstimator
    from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz

    gold = np.load(os.path.join(GOLDEN, "mhe_cstr.npz"))
    Ys, Us = gold["Ys"], gold["Us"]
    Xg, steps = gold["Xest_gold"], [int(k) for k in gold["est_steps"]]
    N = 8
    mhe = MovingHorizonEstimator(cstr_schaffner_and_zeitz())
    mhe.horizon = N
    mhe.Q, mhe.R, mhe.P0 = 1e-3 * np.eye(2), np.array([[1e-4]]), 0.05 * np.eye(2)
    mhe.set_initial_parameter_values([1.0] * 6)
    mhe.setup(dt=0.1, options={"integration_method": "rk4"})
    mhe.set_initial_guess([0.25, 0.08])
    seq, arrivals = [], []
    for k in range(Ys.shape[0]):
        if k in steps:
            arrivals.append(np.array(mhe._x_arrival if mhe._x_arrival
                                     is not None else mhe._x0, float))
        est = mhe.estimate(y=Ys[k], u=Us[k])
        if est is not None:
            seq.append(np.asarray(est, float))
    seq = np.array(seq)
    check(seq.shape == Xg.shape, f"golden MHE produced {seq.shape} estimates")
    wins = np.array([k for k in steps])
    Yw = np.stack([Ys[k - N:k + 1] for k in wins])
    Uw = np.stack([Us[k - N:k + 1] for k in wins])
    xb, _ = mhe.estimate_batch(Yw, Uw, x_arrivals=np.array(arrivals))
    d_seq = float(np.max(np.abs(seq - Xg)))
    d_bat = float(np.max(np.abs(xb - Xg)))
    log(f"MHE golden (mhe_cstr, {len(wins)} windows): estimate() max dev "
        f"{d_seq:.2e}, estimate_batch max dev {d_bat:.2e} "
        f"[tol {GOLDEN_MHE_ATOL:.0e}: solve dtype vs x64 oracle]")
    check(d_seq < GOLDEN_MHE_ATOL, f"MHE golden deviation {d_seq:.2e}")
    check(d_bat < GOLDEN_MHE_ATOL, f"MHE golden batch deviation {d_bat:.2e}")


# -- 5. fused closed loop ----------------------------------------------------

def phase_loop(sz):
    import __graft_entry__ as ge
    from hilo_mpc_tpu.parallel import fused_closed_loop_fn

    B, steps = sz["loop_B"], sz["loop_steps"]
    ctrl = ge._build_nmpc(N=20, tol=1e-4, max_iter=25)
    plant = ge._loop_parts()[1]
    loop_fn = fused_closed_loop_fn(ctrl, plant, steps=steps,
                                   plant_p=np.ones(6))
    rng = np.random.default_rng(1)
    x0s = np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B, 2))
    res, first_s = timed(loop_fn, x0s)
    res, run_s = timed(loop_fn, x0s)
    conv = float(np.asarray(res.converged).mean())
    X = np.asarray(res.X)
    check(np.isfinite(X).all(), "closed-loop states not finite")
    check(X.shape == (B, steps + 1, 2), f"closed-loop shape {X.shape}")
    log(f"fused loop: B={B} steps={steps} N=20 converged={conv:.4f} "
        f"compile~{first_s - run_s:.1f} s run={run_s:.3f} s "
        f"({B * steps / run_s:.0f} MPC steps/s)")
    check(conv >= MIN_CONVERGED, f"closed-loop convergence {conv} < 0.99")


# -- 6. single solve ---------------------------------------------------------

def phase_single():
    from hilo_mpc_tpu import NMPC, Model

    plant = Model(name="CSTR")
    plant.set_equations("""
        dx_1/dt = -a_1*x_1(t) + b_1*r
        dx_2/dt = -a_2*x_2(t) + b_2*r + g*u(k)
        y(k) = x_2(t)
        r = (1 - x_1(t))*exp(-E/(1 + x_2(t)))
    """)
    plant.setup(dt=0.1, integration_method="rk4")
    plant.set_initial_conditions([0.2, 0.1])
    plant.set_initial_parameter_values([1.0] * 6)
    nmpc = NMPC(plant.copy())
    nmpc.horizon = 20
    nmpc.quad_stage_cost.add_states(weights=[10., 10.], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.], u_ub=[5.])
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={"dt": 0.1})
    x = np.array([0.2, 0.1])
    t0 = time.perf_counter()
    nmpc.optimize(x)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        u = nmpc.optimize(x)
        times.append(time.perf_counter() - t0)
        check(bool(nmpc.stats["converged"]), "single solve did not converge")
        x = np.asarray(plant.simulate(u=u, steps=1)["x"][-1])
    check(np.isfinite(x).all(), "closed-loop state not finite")
    log(f"single solve: first (compile) {first_s:.1f} s, warm median "
        f"{np.median(times) * 1e3:.2f} ms over {len(times)} solves")


# -- --four: the sharded path and its one-card comparison --------------------

def phase_four(sz):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as ge
    from hilo_mpc_tpu.parallel import (fused_closed_loop_fn, make_mesh,
                                       shard_batch, sharded_solve_fn)

    n = 4
    mesh = make_mesh(n)
    dev0 = jax.devices()[0]

    def on_all_devices(x, B):
        shards = x.addressable_shards
        devs = {s.device for s in shards}
        rows = sorted(s.data.shape[0] for s in shards)
        check(len(devs) == n and rows == [B // n] * n,
              f"batch not spread over {n} devices: {len(devs)} devices, "
              f"rows {rows}")

    # NMPC
    Bq = sz["nmpc_B"]
    nmpc = ge._build_nmpc(N=20, tol=1e-4, max_iter=25)
    host = ge._batch_inputs(nmpc, n * Bq)
    fn4 = sharded_solve_fn(nmpc, mesh, with_stats=True)
    args4 = shard_batch(host, mesh)
    (sol4, stats), first4 = timed(fn4, *args4)
    (sol4, stats), t4 = timed(fn4, *args4)
    on_all_devices(sol4.U, n * Bq)
    fn1 = nmpc.solve_batch_fn()
    args1 = tuple(jax.device_put(jnp.asarray(a[:Bq]), dev0) for a in host)
    sol1, first1 = timed(fn1, *args1)
    sol1, t1 = timed(fn1, *args1)
    dev = float(np.max(np.abs(np.asarray(sol4.U)[:Bq] - np.asarray(sol1.U))))
    rate = float(stats["rate"])
    log(f"four NMPC: B={n}x{Bq} converged={rate:.4f} 4-card {t4:.3f} s "
        f"(first {first4:.1f} s) vs 1-card share {t1:.3f} s (first "
        f"{first1:.1f} s); weak-scaling efficiency {t1 / t4:.3f}; "
        f"max|U_4 - U_1| on the shared quarter {dev:.2e}")
    check(rate >= MIN_CONVERGED, f"sharded NMPC convergence {rate}")
    check(dev < 1e-4, f"sharded NMPC differs from one card by {dev:.2e}")

    # MHE
    Bm, N = sz["mhe_B"], sz["mhe_N"]
    mhe = ge._build_mhe(N=N)
    Ys, Us, x_arr = ge._mhe_windows(n * Bm, N=N)
    est4 = lambda: mhe.estimate_batch(Ys, Us, x_arrivals=x_arr, mesh=mesh)
    est1 = lambda: mhe.estimate_batch(Ys[:Bm], Us[:Bm], x_arrivals=x_arr[:Bm])
    (xe4, ms4), first4 = timed(est4)
    (xe4, ms4), t4 = timed(est4)
    on_all_devices(ms4.X, n * Bm)
    (xe1, ms1), first1 = timed(est1)
    (xe1, ms1), t1 = timed(est1)
    m_rate = float(np.asarray(ms4.converged).mean())
    dev = float(np.max(np.abs(xe4[:Bm] - xe1)))
    log(f"four MHE: B={n}x{Bm} N={N} converged={m_rate:.4f} 4-card "
        f"{t4:.3f} s vs 1-card share {t1:.3f} s; weak-scaling efficiency "
        f"{t1 / t4:.3f}; max|x_4 - x_1| {dev:.2e} (host window assembly "
        "included on both sides)")
    check(m_rate >= MIN_CONVERGED, f"sharded MHE convergence {m_rate}")
    check(dev < 1e-4, f"sharded MHE differs from one card by {dev:.2e}")

    # fused closed loop
    Bc, steps = sz["loop_B"], sz["loop_steps"]
    ctrl = ge._build_nmpc(N=20, tol=1e-4, max_iter=25)
    plant = ge._loop_parts()[1]
    loop_fn = fused_closed_loop_fn(ctrl, plant, steps=steps,
                                   plant_p=np.ones(6))
    rng = np.random.default_rng(1)
    x0s = np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((n * Bc, 2))
    dtype = ctrl._solver_dtype
    x4 = jax.device_put(jnp.asarray(x0s, dtype), NamedSharding(mesh, P("dp")))
    x1 = jax.device_put(jnp.asarray(x0s[:Bc], dtype), dev0)
    r4, first4 = timed(loop_fn, x4)
    r4, t4 = timed(loop_fn, x4)
    on_all_devices(r4.X, n * Bc)
    r1, _ = timed(loop_fn, x1)
    r1, t1 = timed(loop_fn, x1)
    c_rate = float(np.asarray(r4.converged).mean())
    dev = float(np.max(np.abs(np.asarray(r4.X)[:Bc] - np.asarray(r1.X))))
    log(f"four fused loop: B={n}x{Bc} steps={steps} converged={c_rate:.4f} "
        f"4-card {t4:.3f} s vs 1-card share {t1:.3f} s; weak-scaling "
        f"efficiency {t1 / t4:.3f}; max|X_4 - X_1| {dev:.2e}")
    check(c_rate >= MIN_CONVERGED, f"sharded loop convergence {c_rate}")
    check(dev < 1e-4, f"sharded loop differs from one card by {dev:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded path and its comparison")
    ap.add_argument("--cpu", action="store_true",
                    help="tiny-size rehearsal on the CPU")
    opts = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    from hilo_mpc_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    sz = TINY if opts.cpu else FULL
    phases = ([("four", lambda: phase_four(sz))] if opts.four else [
        ("sweep parity", lambda: phase_sweep_parity(sz)),
        ("NMPC fleet", lambda: phase_nmpc(sz)),
        ("MHE fast path", lambda: phase_mhe(sz)),
        ("fused loop", lambda: phase_loop(sz)),
        ("single solve", phase_single),
    ])
    try:
        dev = phase_environment(opts.cpu, 4 if opts.four else 1)
        for name, run in phases:
            t0 = time.perf_counter()
            log(f"== {name}")
            run()
            log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
