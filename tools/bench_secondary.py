"""Secondary throughput benchmarks on the GPU: estimators, MHE, GP, ANN.

Complements bench.py's headline NMPC metric with the other hot paths; prints a
small table: `python tools/bench_secondary.py`.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, reps=3):
    import jax
    out = fn()
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def cstr():
    from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz
    m = cstr_schaffner_and_zeitz()
    return m


def bench_filters():
    """Batched EKF/UKF/PF: B parallel filters x T steps in one dispatch."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from hilo_mpc_tpu import EKF, PF, UKF

    B, T = 8192, 100
    p = jnp.asarray([1.0] * 6, jnp.float32)
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(0.25 + 0.02 * rng.standard_normal((B, 2)), jnp.float32)
    ys = jnp.asarray(0.25 + 0.01 * rng.standard_normal((B, T, 1)), jnp.float32)
    us = jnp.zeros((B, T, 1), jnp.float32)
    rows = []
    for name, cls in [("EKF", EKF), ("UKF", UKF)]:
        est = cls(cstr())
        est.setup(dt=0.1)
        est.Q = 1e-4 * np.eye(2)
        est.R = 1e-3 * np.eye(1)
        step = est.step_fn()  # (x, P, u, p, y, t) -> (x, P, y_pred)

        @jax.jit
        def run(x0, ys, us, _step=step):
            P0 = 0.01 * jnp.eye(2, dtype=jnp.float32)

            def one(x0_i, ys_i, us_i):
                def body(carry, inp):
                    x, P, t = carry
                    y, u = inp
                    x, P, yp = _step(x, P, u, p, y, t)
                    return (x, P, t + 0.1), x
                (_, _, _), xs = lax.scan(body, (x0_i, P0, 0.0), (ys_i, us_i))
                return xs

            return jax.vmap(one)(x0, ys, us)

        t = timeit(lambda: run(x0, ys, us))
        rows.append((name, B * T / t, t))
    # particle filter: fewer parallel instances, many particles each
    pf = PF(cstr(), n_particles=1024)
    pf.Q = 1e-4 * np.eye(2)
    pf.R = 1e-3 * np.eye(1)
    pf.setup(dt=0.1)
    Bp = 256
    x0p = jnp.asarray(0.25 + 0.02 * rng.standard_normal((Bp, 2)), jnp.float32)
    ysp = jnp.asarray(0.25 + 0.01 * rng.standard_normal((Bp, T, 1)), jnp.float32)
    usp = jnp.zeros((Bp, T, 1), jnp.float32)
    stepf = pf.step_fn()

    @jax.jit
    def run_pf(x0, ys, us):
        import jax.random as jr

        def one(x0_i, ys_i, us_i, key):
            parts = x0_i[None, :] + 0.01 * jr.normal(key, (1024, 2))

            def body(carry, inp):
                parts, t, key = carry
                y, u = inp
                key, parts, x_est, y_est = stepf(key, parts, u, p, y, t)
                return (parts, t + 0.1, key), x_est
            (_, _, _), xs = lax.scan(body, (parts, 0.0, key), (ys_i, us_i))
            return xs
        keys = jr.split(jr.PRNGKey(0), Bp)
        return jax.vmap(one)(x0, ys, us, keys)

    try:
        t = timeit(lambda: run_pf(x0p, ysp, usp))
        rows.append(("PF(1024 particles)", Bp * T / t, t))
    except Exception as e:
        print(f"  PF bench skipped: {type(e).__name__}: {e}", file=sys.stderr)
    return rows


def bench_mhe():
    import jax
    import jax.numpy as jnp

    from hilo_mpc_tpu import MHE

    mhe = MHE(cstr())
    mhe.horizon = 10
    mhe.Q = 1e-4
    mhe.R = 1e-3
    mhe.P0 = np.eye(2) * 0.1
    mhe.set_initial_parameter_values([1.0] * 6)
    mhe.setup(dt=0.1)
    mhe.set_initial_guess([0.25, 0.15])
    B = 4096
    rng = np.random.default_rng(1)
    ys = 0.25 + 0.01 * rng.standard_normal((B, 11, 1))
    us = np.zeros((B, 11, 1))
    x_arr = np.tile([0.25, 0.15], (B, 1))
    x_est, sol = mhe.estimate_batch(ys, us, x_arrivals=x_arr)  # compile
    t = timeit(lambda: mhe.estimate_batch(ys, us, x_arrivals=x_arr)[1].X)
    conv = float(np.asarray(sol.converged).mean())
    return [("MHE(N=10 window)", B / t, t)], conv


def bench_gp():
    import jax
    import jax.numpy as jnp

    from hilo_mpc_tpu import GP

    rng = np.random.default_rng(2)
    X = rng.uniform(-3, 3, (256, 1))
    y = np.sin(X[:, 0]) + 0.05 * rng.standard_normal(256)
    gp = GP(["x"], ["y"])
    gp.set_training_data(X.T, y[None])
    gp.setup()
    t0 = time.time()
    gp.fit_model(solver="adam", max_iter=300)
    t_fit = time.time() - t0
    Xq = jnp.asarray(rng.uniform(-3, 3, (1, 100000)), jnp.float32)
    import jax as _jax
    pfn = gp.predict_fn()
    pred = _jax.jit(lambda q: _jax.vmap(pfn)(q.T)[0])
    t_pred = timeit(lambda: pred(Xq))
    rows = [("GP fit (256 pts, 300 adam steps, incl compile)", 1.0 / t_fit, t_fit),
            ("GP predict (100k query pts)", 100000 / t_pred, t_pred)]

    # sparse predictive state: same data at n=2048 — the exact predictive
    # pays an O(n^2) triangular solve per query, the VFE state is m-sized
    # (the "embedded GP surrogates get cheaper" claim, measured)
    n2, m2, q2, reps2 = 2048, 64, 10000, 20
    Xb = rng.uniform(-3, 3, (n2, 1))
    yb = np.sin(Xb[:, 0]) + 0.05 * rng.standard_normal(n2)
    Xq2 = jnp.asarray(rng.uniform(-3, 3, (q2, 1)), jnp.float32)
    for label, kwargs in (
            (f"GP predict mu+var exact n={n2} (sustained)", {}),
            (f"GP predict mu+var VFE m={m2} (sustained)",
             dict(inference="vfe", inference_options={"n_inducing": m2}))):
        g = GP(["x"], ["y"], noise_variance=0.2, **kwargs)
        g.set_training_data(Xb, yb)
        g.setup()
        pf = g.predict_fn()

        # sustained rate via the in-jit K-loop (one dispatch for reps2
        # prediction batches).
        # Keep BOTH outputs live in the carry: the variance is the expensive
        # half (the exact path pays an O(n^2) triangular solve per query,
        # the sparse state an O(m^2) one) and it is what SMPC back-offs
        # consume — returning only mu would let XLA dead-code-eliminate it.
        def body(i, acc, pf=pf):
            mu, var = _jax.vmap(pf)(Xq2 + acc * 1e-20)
            return jnp.sum(mu) + jnp.sum(var)

        fn = _jax.jit(
            lambda _: _jax.lax.fori_loop(0, reps2, body, jnp.float32(0.0)))
        t = timeit(lambda: fn(0)) / reps2
        rows.append((label, q2 / t, t))

    # SVGP minibatch training: the whole optimization is ONE lax.scan
    # dispatch (gp.py fit_model batch path), so the honest sustained rate
    # excludes compile by differencing two scan lengths — both calls pay a
    # comparable compile, the extra wall time is pure steps.
    n3, m3, b3 = 8192, 32, 256
    X3 = rng.uniform(-3, 3, (n3, 1))
    y3 = np.sin(2 * X3[:, 0]) + 0.1 * rng.standard_normal(n3)
    # lengths chosen so the 20k-step difference clears the fixed
    # retrace+dispatch overhead per fit call
    steps_lo, steps_hi = 1_000, 21_000

    def _svgp_fit(steps):
        g = GP(["x"], ["y"], noise_variance=0.3, inference="svgp",
               inference_options={"n_inducing": m3, "batch_size": b3})
        g.set_training_data(X3, y3)
        t0 = time.time()
        g.fit_model(solver="adam", max_iter=steps, learning_rate=2e-2)
        return time.time() - t0

    # compile variance swamps one cold difference; the second call per
    # scan length retraces but hits
    # the in-process XLA compilation cache, so warm-warm differencing
    # isolates the step cost
    _svgp_fit(steps_lo), _svgp_fit(steps_hi)
    t_lo = min(_svgp_fit(steps_lo) for _ in range(2))
    t_hi = min(_svgp_fit(steps_hi) for _ in range(2))
    if t_hi > t_lo:
        rate = (steps_hi - steps_lo) / (t_hi - t_lo)
        rows.append((f"GP SVGP train n={n3} m={m3} b={b3} (steps, sust.)",
                     rate, t_hi))
    return rows


def main():
    rows = []
    rows += bench_filters()
    mhe_rows, conv = bench_mhe()
    rows += mhe_rows
    print(f"# MHE convergence: {conv:.3f}", file=sys.stderr)
    rows += bench_gp()
    print(f"{'benchmark':44s} {'throughput':>16s} {'time':>10s}")
    for name, thr, t in rows:
        unit = "steps/s" if "KF" in name or "PF" in name else (
            "solves/s" if "MHE" in name else "x/s")
        print(f"{name:44s} {thr:14.0f} {unit:>7s} {t*1e3:8.1f}ms")


if __name__ == "__main__":
    main()
