"""Plain float64 reference for the stagewise LQ problem of
`ops.riccati.solve_lq`: one dense KKT solve per scenario, independent of the
Riccati recursion under test."""
import numpy as np


def dense_lq_solve(A, B, Q, S, R, q, r, c, P_term, p_term, dx0):
    """Solve min Σ_k ½[dx;du]ᵀ[[Q Sᵀ][S R]][dx;du] + qᵀdx + rᵀdu
    + ½dx_Nᵀ P dx_N + pᵀdx_N  s.t. dx_{k+1} = A dx_k + B du_k + c_k
    for one scenario (shapes as `solve_lq` without a batch axis).

    Returns (dX (N+1, nx), dU (N, nu), lam (N, nx)) with lam_k the
    multiplier of dynamics row k under L = f + Σ lam_kᵀ(A dx_k + B du_k +
    c_k - dx_{k+1}).
    """
    A, B, Q, S, R, q, r, c, P_term, p_term, dx0 = (
        np.asarray(a, np.float64)
        for a in (A, B, Q, S, R, q, r, c, P_term, p_term, dx0))
    N, nx, nu = A.shape[0], A.shape[1], B.shape[2]
    # z = [dx_1..dx_N, du_0..du_{N-1}]
    nz = N * nx + N * nu
    ix = lambda k: slice((k - 1) * nx, k * nx)          # dx_k, k = 1..N
    iu = lambda k: slice(N * nx + k * nu, N * nx + (k + 1) * nu)
    H = np.zeros((nz, nz))
    g = np.zeros(nz)
    E = np.zeros((N * nx, nz))
    e = np.zeros(N * nx)
    for k in range(N):
        H[iu(k), iu(k)] += R[k]
        g[iu(k)] += r[k]
        if k == 0:
            g[iu(0)] += S[0] @ dx0
        else:
            H[ix(k), ix(k)] += Q[k]
            H[iu(k), ix(k)] += S[k]
            H[ix(k), iu(k)] += S[k].T
            g[ix(k)] += q[k]
        rows = slice(k * nx, (k + 1) * nx)
        E[rows, iu(k)] = B[k]
        E[rows, ix(k + 1)] = -np.eye(nx)
        e[rows] = -c[k]
        if k == 0:
            e[rows] -= A[0] @ dx0
        else:
            E[rows, ix(k)] = A[k]
    H[ix(N), ix(N)] += P_term
    g[ix(N)] += p_term
    K = np.block([[H, E.T], [E, np.zeros((N * nx, N * nx))]])
    sol = np.linalg.solve(K, np.concatenate([-g, e]))
    z, lam = sol[:nz], sol[nz:]
    dX = np.concatenate([dx0[None], z[:N * nx].reshape(N, nx)])
    dU = z[N * nx:].reshape(N, nu)
    return dX, dU, lam.reshape(N, nx)
