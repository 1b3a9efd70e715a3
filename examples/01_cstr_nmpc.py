"""Reference-tracking NMPC on the Schaffner-Zeitz CSTR (BASELINE configs[0];
reference example: docs/docsource/examples CSTR).

Also demonstrates the fleet path: the same controller solving thousands of
perturbed scenarios in one batched call.
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

import numpy as np

from hilo_mpc_tpu import NMPC, SimpleControlLoop
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz

P = [1.0] * 6  # a_1, b_1, a_2, b_2, g, E
SETPOINT = [0.3, 0.18055]  # an equilibrium pair (u_ss = -0.1194)

plant = cstr_schaffner_and_zeitz()
plant.setup(dt=0.1, integration_method="rk4")
plant.set_initial_conditions([0.2, 0.1])
plant.set_initial_parameter_values(P)

nmpc = NMPC(cstr_schaffner_and_zeitz())
nmpc.horizon = 20
nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=SETPOINT)
nmpc.quad_stage_cost.add_inputs(weights=0.1)
nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
nmpc.set_parameters(P)
nmpc.setup(options={"dt": 0.1})

loop = SimpleControlLoop(plant, nmpc)
loop.run(30)
x_final = plant.solution["x:f"]
print(f"closed loop: x_final={x_final}, tracking error "
      f"{np.linalg.norm(x_final - SETPOINT):.2e}")

# batched: 2048 perturbed initial states in one call
x0s = np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(0).standard_normal(
    (2048, 2))
u0, sol = nmpc.optimize_batch(x0s)
print(f"batched: {u0.shape[0]} solves, "
      f"{float(np.asarray(sol.converged).mean()) * 100:.1f}% converged, "
      f"median {np.median(np.asarray(sol.iterations))} IP iterations")

if _os.environ.get("HILO_EXAMPLES_OUT"):     # gallery figure (tools/render_examples.py)
    import _gallery as _g

    X = np.asarray(plant.solution["x"])
    X = X.T if X.shape[0] == 2 else X
    t = 0.1 * np.arange(X.shape[0])
    U = np.asarray(nmpc.solution["u"]).reshape(-1)
    fig, axes = _g.new_fig(2)
    ax = axes[0][0]
    for i, (nm, c) in enumerate(zip(["x1", "x2"], _g.SERIES)):
        ax.plot(t, X[:, i], color=c, lw=2, label=nm)
        ax.axhline(SETPOINT[i], color=c, lw=1, ls="--", alpha=0.5)
    _g.style(ax, "Closed-loop CSTR states (dashed = setpoint)", ylabel="state")
    _g.legend(ax)
    ax = axes[1][0]
    ax.step(0.1 * np.arange(U.size), U, color=_g.SERIES[0], lw=2)
    _g.style(ax, "Applied input", xlabel="time [h]", ylabel="u")
    _g.save(fig, "closed_loop.png")
