"""Fused on-device closed-loop fleet with an EKF observer in the feedback path.

SURVEY §3.3's accelerator mapping of the reference's SimpleControlLoop + observer
(reference: hilo_mpc/modules/control_loop.py observers): controller solve,
plant step, noisy measurement and EKF predict/update all fuse into ONE
lax.scan body, vmapped over a fleet of scenarios — the device never syncs
with the host inside the run. Use it for Monte-Carlo verification, tuning
sweeps, and output-feedback robustness studies at production batch sizes
(bench: tools/bench_fused_loop.py).
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from hilo_mpc_tpu import NMPC
from hilo_mpc_tpu.estimation import ExtendedKalmanFilter
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu.parallel import fused_closed_loop_ekf_fn

P = np.ones(6)
SETPOINT = [0.3, 0.18055]
B, STEPS = 512, 40

plant = cstr_schaffner_and_zeitz()
plant.setup(dt=0.1, integration_method="rk4")

nmpc = NMPC(cstr_schaffner_and_zeitz())
nmpc.horizon = 12
nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=SETPOINT)
nmpc.quad_stage_cost.add_inputs(weights=0.1)
nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
nmpc.set_parameters(P)
nmpc.setup(options={"dt": 0.1, "tol": 1e-4, "max_iter": 15,
                    "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
                    "mehrotra": False})

# the CSTR measures x_2 only — the EKF reconstructs x_1 for the controller
ekf = ExtendedKalmanFilter(cstr_schaffner_and_zeitz())
ekf.Q = 1e-4 * np.eye(2)
ekf.R = np.array([[1e-4]])
ekf.set_initial_parameter_values(P)
ekf.setup(dt=0.1)

run = fused_closed_loop_ekf_fn(nmpc, plant, ekf, steps=STEPS, plant_p=P,
                               process_noise_std=np.array([0.002, 0.002]),
                               meas_noise_std=np.array([0.003]))

rng = np.random.default_rng(0)
x0_true = np.array([0.2, 0.1]) + 0.04 * rng.standard_normal((B, 2))
x_est0 = x0_true + 0.02 * rng.standard_normal((B, 2))  # imperfect prior

t0 = time.time()
res = run(x0_true, x_est0, 0.05 * np.eye(2), key=jax.random.PRNGKey(0))
jax.block_until_ready(res.X)
compile_s = time.time() - t0
t0 = time.perf_counter()
res = run(x0_true, x_est0, 0.05 * np.eye(2), key=jax.random.PRNGKey(1))
jax.block_until_ready(res.X)
t = time.perf_counter() - t0

X, Xe = np.asarray(res.X), np.asarray(res.X_est)
final_err = np.linalg.norm(X[:, -1, :] - SETPOINT, axis=1)
est_err = np.abs(Xe - X[:, 1:, :]).max(axis=(1, 2))
print(f"fleet: B={B} x {STEPS} steps = {B * STEPS:,} loop steps "
      f"in {t * 1e3:.0f} ms ({B * STEPS / t:,.0f} steps/s; "
      f"compile {compile_s:.0f}s)")
print(f"closed-loop convergence: {float(np.asarray(res.converged).mean()):.1%} "
      f"solves converged; |x_final - x*| p50={np.median(final_err):.2e} "
      f"max={final_err.max():.2e}")
print(f"EKF estimation error (per-scenario max over run): "
      f"p50={np.median(est_err):.2e} max={est_err.max():.2e}")
assert np.median(final_err) < 2e-2

if os.environ.get("HILO_EXAMPLES_OUT"):     # gallery figure
    import _gallery as _g

    t = 0.1 * np.arange(X.shape[1])
    show = min(64, X.shape[0])
    fig, axes = _g.new_fig(1)
    ax = axes[0][0]
    for b in range(show):
        ax.plot(t, X[b, :, 1], color=_g.SERIES[0], lw=0.8, alpha=0.12)
    ax.plot(t, np.median(X[:, :, 1], axis=0), color=_g.SERIES[0], lw=2.5,
            label=f"median of {X.shape[0]:,} scenarios")
    ax.axhline(SETPOINT[1], color=_g.MUTED, lw=1, ls="--", alpha=0.8,
               label="setpoint")
    _g.style(ax, "Fused fleet closed loop with EKF feedback: x2 across the "
             f"fleet ({show} shown)", xlabel="time [h]", ylabel="x2")
    _g.legend(ax)
    _g.save(fig, "fleet.png")
