"""Generate frozen golden-parity fixtures for the 5 BASELINE.json configs.

For every config in tests/golden_configs.py this runs the closed loop, and at
every step solves the controller's *captured* NLP instance (identical theta /
initial state / warm start) with the independent SciPy oracle
(tools/golden_oracle.py — single-shooting reduction + L-BFGS-B/trust-constr at
1e-11, nothing shared with ops/ip_solver.py). The oracle control sequence is
frozen into tests/golden/<name>.npz together with the visited states and the
framework's own controls at generation time.

tests/test_golden_parity.py replays the frozen states through the framework and
asserts max |u - u_gold| < 1e-4 per step — the BASELINE "<1e-4 control
deviation" acceptance as a plain test, runnable without casadi or scipy access
to this script. Wherever casadi/IPOPT *is* installable, run
tools/make_golden_ipopt.py to regenerate the same schema from the actual
reference stack; the test picks up either file.

Usage: python tools/make_golden_fixtures.py [config ...]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from hilo_mpc_tpu.utils.compile_cache import use_compile_cache  # noqa: E402
use_compile_cache()

from golden_configs import CONFIGS  # noqa: E402
from golden_oracle import SolveCapture, oracle_solve  # noqa: E402

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden")


def _extract_u0(ctrl, X_roll, U_opt):
    """Mirror NMPC.optimize's first-move extraction (control/nmpc.py)."""
    nx, nu = ctrl._model.n_x, ctrl._model.n_u
    if ctrl._augment_du:
        return np.asarray(X_roll[1, nx:nx + nu]) * ctrl._u_scaling
    return np.asarray(U_opt[0, :nu]) * ctrl._u_scaling


def gen_nmpc_like(name, builder):
    ctrl, sc = builder()
    x = np.asarray(sc["x0"], dtype=float)
    steps = sc["steps"]
    # open-loop planning configs (e.g. minimum-time) provide a sequence of
    # initial states instead of a plant stepper; the parity test replays
    # X_meas either way
    x_seq = sc.get("x_seq")
    X_meas, U_gold, U_mine, opt_meta = [x.copy()], [], [], []
    for k in range(steps):
        if x_seq is not None:
            x = np.asarray(x_seq[k], dtype=float)
            if k:
                X_meas.append(x.copy())
        with SolveCapture(ctrl) as cap:
            u_mine = np.atleast_1d(np.asarray(ctrl.optimize(x), dtype=float))
        theta, xs0, U_init = cap.calls[-1]
        res = oracle_solve(ctrl._funcs, ctrl._dims, ctrl._bounds, theta, xs0,
                           fix_x0=True, U0=U_init)
        u_gold = np.atleast_1d(_extract_u0(ctrl, res["X"], res["U"]))
        U_gold.append(u_gold)
        U_mine.append(u_mine)
        opt_meta.append([res["objective"], res["optimality"],
                         float(res["success"])])
        if x_seq is None:
            x = np.asarray(sc["plant_step"](x, u_gold), dtype=float)
            X_meas.append(x.copy())
    U_gold, U_mine = np.array(U_gold), np.array(U_mine)
    dev = np.abs(U_mine - U_gold).max()
    path = os.path.join(OUT_DIR, f"{name}.npz")
    np.savez(path, X_meas=np.array(X_meas), U_gold=U_gold, U_mine=U_mine,
             opt_meta=np.array(opt_meta), max_dev_at_generation=dev,
             source="scipy-reduced-x64", kind="nmpc")
    print(f"{name}: {steps} steps, max|u_mine-u_gold|={dev:.3e}, "
          f"oracle success={int(np.array(opt_meta)[:, 2].sum())}/{steps} "
          f"-> {path}")
    return dev


def gen_mhe(name, builder):
    mhe, sc = builder()
    rng = np.random.default_rng(sc["seed"])
    steps = sc["steps"]
    x_true = np.asarray(sc["x0_true"], dtype=float)
    Us = 0.3 * np.sin(np.linspace(0.0, 5.0, steps))[:, None]
    X_true, Ys = [x_true.copy()], []
    for k in range(steps):
        y = x_true[1] + sc["meas_std"] * rng.standard_normal()
        Ys.append([y])
        x_true = sc["plant_step"](x_true, Us[k])
        X_true.append(x_true.copy())
    Ys = np.array(Ys)

    Xest_gold, Xest_mine, est_steps, opt_meta = [], [], [], []
    for k in range(steps):
        with SolveCapture(mhe) as cap:
            est = mhe.estimate(y=Ys[k], u=Us[k])
        if est is None:
            continue
        theta, xs0, U_init = cap.calls[-1]
        res = oracle_solve(mhe._funcs, mhe._dims, mhe._bounds, theta, xs0,
                           fix_x0=False, U0=U_init)
        nx = mhe._model.n_x
        Xest_gold.append(np.asarray(res["X"][-1, :nx]))
        Xest_mine.append(np.atleast_1d(np.asarray(est, dtype=float)))
        est_steps.append(k)
        opt_meta.append([res["objective"], res["optimality"],
                         float(res["success"])])
    Xest_gold, Xest_mine = np.array(Xest_gold), np.array(Xest_mine)
    dev = np.abs(Xest_mine - Xest_gold).max()
    path = os.path.join(OUT_DIR, f"{name}.npz")
    np.savez(path, Ys=Ys, Us=Us, X_true=np.array(X_true),
             Xest_gold=Xest_gold, Xest_mine=Xest_mine,
             est_steps=np.array(est_steps), opt_meta=np.array(opt_meta),
             max_dev_at_generation=dev, source="scipy-reduced-x64", kind="mhe")
    print(f"{name}: {len(est_steps)} windows, max|x_mine-x_gold|={dev:.3e} "
          f"-> {path}")
    return dev


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    names = sys.argv[1:] or list(CONFIGS)
    worst = 0.0
    for name in names:
        gen = gen_mhe if name == "mhe_cstr" else gen_nmpc_like
        worst = max(worst, gen(name, CONFIGS[name]))
    print(f"worst-case deviation across configs: {worst:.3e} "
          f"({'OK' if worst < 1e-4 else 'FAIL'} vs 1e-4 budget)")


if __name__ == "__main__":
    main()
