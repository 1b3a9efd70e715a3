"""Roofline accounting for the flagship batched NMPC solve on the GPU.

Counts FLOPs and minimum device-memory bytes per solve, measures achieved
FLOP/s and bandwidth on the card, and times the Riccati sweep alone against
its minimum bytes.

Usage:  python tools/roofline.py [B] [--json out.json]
Runs on the GPU only: a roofline share needs the device's own peaks, and a
device missing from PEAKS is an error, not a default.

Workload model: the CSTR OCP has nx=2, nu=1 — every per-scenario operation is
scalar algebra batched over scenarios, i.e. ELEMENTWISE across the batch.
There is no contraction wide enough for the tensor cores, so the compute roof
is the f32 rate outside them; the memory roof is device-memory bandwidth.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Published peaks by device_kind (NVIDIA H100 SXM data sheet, dense rates,
# at the full 700 W power limit): bf16 tensor cores, f32 outside the tensor
# cores, HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100": {"bf16_dense": 989e12, "f32": 67e12, "hbm_Bps": 3.35e12,
                    "source": "NVIDIA H100 SXM data sheet"},
}


def _peaks_for(device) -> dict:
    kind = getattr(device, "device_kind", "")
    for key, val in PEAKS.items():
        if kind.startswith(key):
            return {"device_kind": kind, **val}
    raise ValueError(f"no published peaks for device_kind {kind!r}; add its "
                     "data-sheet row to PEAKS")


# ---------------------------------------------------------------------------
# analytic FLOP / byte counts
# ---------------------------------------------------------------------------


class _Ctr:
    """Scalar stand-in that counts flops flowing through the Riccati algebra.

    Mirrors the backward+forward sweep of ops/riccati.py stage for stage
    (each arithmetic op there is one elementwise op over the batch; here it
    is one counter tick).
    """

    ops = 0

    def _t(self, n=1):
        _Ctr.ops += n
        return self

    def __add__(self, o): return self._t()
    __radd__ = __add__
    def __sub__(self, o): return self._t()
    __rsub__ = __sub__
    def __mul__(self, o): return self._t()
    __rmul__ = __mul__
    def __truediv__(self, o): return self._t()
    __rtruediv__ = __truediv__
    def __neg__(self): return self._t()
    def sqrt(self): return self._t()


def lq_sweep_flops(N: int, nx: int, nu: int) -> int:
    """Per-scenario FLOPs of one backward+forward LQ sweep, counted by
    running the sweep's scalar algebra on counting scalars."""
    _Ctr.ops = 0
    c = lambda: _Ctr()
    sqrt = lambda v: v.sqrt()
    P = [[c() for _ in range(nx)] for _ in range(nx)]
    p = [c() for _ in range(nx)]
    dec = c()
    for _k in range(N):
        Ak = [[c() for _ in range(nx)] for _ in range(nx)]
        Bk = [[c() for _ in range(nu)] for _ in range(nx)]
        ck = [c() for _ in range(nx)]
        Pc_p = [sum((P[i][l] * ck[l] for l in range(nx)), c()) + p[i]
                for i in range(nx)]
        PA = [[sum((P[i][l] * Ak[l][j] for l in range(nx)), c())
               for j in range(nx)] for i in range(nx)]
        PB = [[sum((P[i][l] * Bk[l][j] for l in range(nx)), c())
               for j in range(nu)] for i in range(nx)]
        G = [[c() + sum((Bk[l][i] * PB[l][j] for l in range(nx)), c())
              for j in range(nu)] for i in range(nu)]
        G = [[(G[i][j] + G[j][i]) * 0.5 + (0.0 if i != j else 1e-8)
              for j in range(nu)] for i in range(nu)]
        Hux = [[c() + sum((Bk[l][i] * PA[l][j] for l in range(nx)), c())
                for j in range(nx)] for i in range(nu)]
        g_u = [c() + sum((Bk[l][i] * Pc_p[l] for l in range(nx)), c())
               for i in range(nu)]
        L = [[None] * nu for _ in range(nu)]
        for i in range(nu):
            for j in range(i + 1):
                s_ = G[i][j]
                for l in range(j):
                    s_ = s_ - L[i][l] * L[j][l]
                L[i][j] = sqrt(s_) if i == j else s_ / L[j][j]
        rhs = [Hux[i] + [g_u[i]] for i in range(nu)]
        ncol = nx + 1
        Yc = [[None] * ncol for _ in range(nu)]
        for i in range(nu):
            for m in range(ncol):
                acc = rhs[i][m]
                for l in range(i):
                    acc = acc - L[i][l] * Yc[l][m]
                Yc[i][m] = acc / L[i][i]
        Xc = [[None] * ncol for _ in range(nu)]
        for i in range(nu - 1, -1, -1):
            for m in range(ncol):
                acc = Yc[i][m]
                for l in range(i + 1, nu):
                    acc = acc - L[l][i] * Xc[l][m]
                Xc[i][m] = acc / L[i][i]
        Kk = [[-Xc[i][j] for j in range(nx)] for i in range(nu)]
        kffk = [-Xc[i][nx] for i in range(nu)]
        P_new = [[c() + sum((Ak[l][i] * PA[l][j] for l in range(nx)), c())
                  + sum((Hux[l][i] * Kk[l][j] for l in range(nu)), c())
                  for j in range(nx)] for i in range(nx)]
        P = [[(P_new[i][j] + P_new[j][i]) * 0.5 for j in range(nx)]
             for i in range(nx)]
        p = [c() + sum((Ak[l][i] * Pc_p[l] for l in range(nx)), c())
             + sum((Hux[l][i] * kffk[l] for l in range(nu)), c())
             for i in range(nx)]
        dec = dec - sum((kffk[i] * g_u[i] for i in range(nu)), c()) * 0.5
    # forward rollout
    dx = [c() for _ in range(nx)]
    for _k in range(N):
        Kk = [[c() for _ in range(nx)] for _ in range(nu)]
        du = [sum((Kk[i][j] * dx[j] for j in range(nx)), c()) + c()
              for i in range(nu)]
        dx_n = [sum((c() * dx[j] for j in range(nx)), c())
                + sum((c() * du[j] for j in range(nu)), c()) + c()
                for i in range(nx)]
        _ = [sum((c() * dx_n[j] for j in range(nx)), c()) + c()
             for i in range(nx)]
        dx = dx_n
    return _Ctr.ops


def lq_sweep_bytes(N: int, nx: int, nu: int, itemsize: int = 4) -> int:
    """Minimum device-memory traffic per scenario for one sweep: each input
    read once, each output written once (a fully fused sweep would keep
    everything else on chip)."""
    inputs = N * (2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu) \
        + nx * nx + 2 * nx
    outputs = (N + 1) * nx + N * (2 * nu + nx + nu * nx) + 1
    return (inputs + outputs) * itemsize


# ---------------------------------------------------------------------------
# measurements
# ---------------------------------------------------------------------------


def _timeit(fn, args, reps=3):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def measure_sweep(B: int, N=20, nx=2, nu=1):
    """One f32 Riccati sweep at flagship shapes, as XLA compiles it, with its
    achieved rates against the sweep's minimum bytes."""
    import chip_smoke

    t = chip_smoke.sweep_parity(B, N, nx, nu)["sweep_s"]
    flops = lq_sweep_flops(N, nx, nu)
    bts = lq_sweep_bytes(N, nx, nu)
    return {"sweep_s": t, "sweeps_per_s": B / t,
            "sweep_flops_per_scenario": flops,
            "sweep_min_bytes_per_scenario": bts,
            "sweep_gflops": B * flops / t / 1e9,
            "sweep_GBps_min": B * bts / t / 1e9,
            "arithmetic_intensity": flops / bts}


def measure_flagship(B: int, reps=3):
    """Flagship batched solve: wall time, iterations, convergence."""
    import jax

    import __graft_entry__ as ge

    nmpc = ge._build_nmpc(N=20, tol=1e-4, max_iter=25)
    args = ge._batch_inputs(nmpc, B)
    fn = nmpc.solve_batch_fn()
    t0 = time.time()
    sol = fn(*args)
    jax.block_until_ready(sol.U)
    compile_s = time.time() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sol = fn(*args)
        jax.block_until_ready(sol.U)
        ts.append(time.perf_counter() - t0)
    t = min(ts)
    iters = np.asarray(sol.iterations)
    out = {"B": B, "t_s": t, "solves_per_s": B / t,
           "compile_s": compile_s,
           "iters_p50": float(np.median(iters)),
           "iters_max": float(iters.max()),
           "converged": float(np.asarray(sol.converged).mean())}
    return out


def xla_cost_analysis(B: int = 4096):
    """XLA's own flops/bytes estimate for the flagship solve (body of the IP
    while-loop is counted ONCE — multiply by the measured trip count)."""
    import jax

    import __graft_entry__ as ge

    nmpc = ge._build_nmpc(N=20, tol=1e-4, max_iter=25)
    args = ge._batch_inputs(nmpc, B)
    fn = nmpc.solve_batch_fn()
    compiled = jax.jit(fn).lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return {"flops_per_solve_one_trip": float(ca.get("flops", 0)) / B,
            "bytes_per_solve_one_trip":
                float(ca.get("bytes accessed", 0)) / B}


def merge_report(report, out):
    """MERGE new sections into an existing report file: each tool owns its
    own top-level sections (this tool the flagship ones, roofline_mhe.py
    "mhe", bench_dims.py "dims" — both call this too) and a refresh must
    not clobber the others (a plain overwrite silently dropped both once —
    regression-pinned by tests/test_roofline_merge.py). A PRESENT but
    unparsable file aborts instead of being overwritten: its sections may
    be recoverable (move it aside to proceed); only a missing file starts
    fresh."""
    import os

    merged = {}
    if os.path.exists(out):
        try:
            with open(out) as fh:
                merged = json.load(fh)
        except ValueError as e:
            raise SystemExit(
                f"{out} exists but is not valid JSON ({e}); refusing to "
                f"overwrite — its sections may be recoverable (from git or "
                f"the text itself). Move the file aside and re-run.")
    merged.update(report)
    with open(out, "w") as fh:
        json.dump(merged, fh, indent=2)
    return merged


def main():
    from hilo_mpc_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax

    B = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1][0] != "-" \
        else 131072
    dev = jax.devices()[0]
    peaks = _peaks_for(dev)
    print(f"# device={dev.platform}:{peaks['device_kind']} B={B}",
          file=sys.stderr)

    report = {"B": B, "device": peaks}
    report["flagship"] = measure_flagship(B)
    print(f"#   {report['flagship']['solves_per_s']:.0f} solves/s",
          file=sys.stderr)
    report["sweep"] = measure_sweep(B)
    report["xla_cost"] = xla_cost_analysis()

    # ---- roofline synthesis ----
    fl, sw, xc = report["flagship"], report["sweep"], report["xla_cost"]
    trips = fl["iters_max"]  # while-loop under vmap runs until ALL lanes done
    # executed flops/solve ~= one-trip count x trips (upper bound: the
    # outside-loop work is counted once per trip)
    flops_solve = xc["flops_per_solve_one_trip"] * trips
    bytes_solve = xc["bytes_per_solve_one_trip"] * trips
    achieved = flops_solve * fl["solves_per_s"]
    bw = bytes_solve * fl["solves_per_s"]
    report["roofline"] = {
        "flops_per_solve_xla_est": flops_solve,
        "bytes_per_solve_xla_est": bytes_solve,
        "achieved_flops": achieved,
        "achieved_GBps_xla_est": bw / 1e9,
        "util_vs_f32_peak": achieved / peaks["f32"],
        "hbm_util_est": bw / peaks["hbm_Bps"],
        "sweep_hbm_util_min_bytes": sw["sweep_GBps_min"] * 1e9
        / peaks["hbm_Bps"],
        "ridge_ai_f32": peaks["f32"] / peaks["hbm_Bps"],
    }

    out = os.path.join(ROOT, "results", "ROOFLINE.json")
    for i, a in enumerate(sys.argv):
        if a == "--json" and i + 1 < len(sys.argv):
            out = sys.argv[i + 1]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    merge_report(report, out)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
