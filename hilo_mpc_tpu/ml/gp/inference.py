"""GP inference methods (reference: hilo_mpc/modules/machine_learning/gp/
inference.py:44-257 — exact inference implemented, approximate methods declared).

Exact posterior (Rasmussen & Williams alg. 2.1) as pure JAX: Cholesky of
K + sigma_n^2 I, alpha-solve, posterior mean/variance and log marginal likelihood.
Everything is traceable, so a fitted GP embeds straight into MPC/model graphs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


class Inference:
    pass


class ExactInference(Inference):
    @staticmethod
    def posterior_state(kernel, mean, params, X, y, noise_variance, jitter=None):
        """Precompute (L, alpha) for training data X (n, d), y (n,).

        A dtype-aware jitter floor (relative to the gram diagonal) keeps the
        Cholesky factorizable when noise_variance is below the float's
        resolution — e.g. sigma_n=1e-4 means variance 1e-8, invisible next to
        O(1) gram entries in f32. Without it the posterior is silently NaN.
        """
        n = X.shape[0]
        with jax.default_matmul_precision("highest"):
            K = kernel.gram(params, X)
        if jitter is None:
            jitter = 1e-6 if K.dtype == jnp.float32 else 1e-12
        floor = jitter * jnp.mean(jnp.diagonal(K))
        K = K + (noise_variance + floor) * jnp.eye(n, dtype=K.dtype)
        with jax.default_matmul_precision("highest"):
            # reduced-precision default matmuls (TF32 on the GPU) corrupt the
            # factorization enough to
            # flip posterior variances negative — GP numerics always run full
            L = jnp.linalg.cholesky(K)
            m = jax.vmap(lambda a: mean.eval(params, a))(X)
            resid = y - m
            alpha = jax.scipy.linalg.cho_solve((L, True), resid)
        return L, alpha, resid

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, noise_variance):
        n = X.shape[0]
        L, alpha, resid = ExactInference.posterior_state(
            kernel, mean, params, X, y, noise_variance)
        return (-0.5 * jnp.dot(resid, alpha)
                - jnp.sum(jnp.log(jnp.diagonal(L)))
                - 0.5 * n * jnp.log(2 * jnp.pi))

    @staticmethod
    def predict(kernel, mean, params, X, L, alpha, x_star, noise_variance,
                include_noise=False):
        """Posterior mean and variance at a single query point x_star (d,)."""
        with jax.default_matmul_precision("highest"):
            k_star = jax.vmap(lambda a: kernel.eval(params, a, x_star))(X)
            mu = mean.eval(params, x_star) + jnp.dot(k_star, alpha)
            v = jax.scipy.linalg.solve_triangular(L, k_star, lower=True)
            k_ss = kernel.eval(params, x_star, x_star)
            var = k_ss - jnp.dot(v, v)
        # relative floor: below the float's resolution of k(x,x) a posterior
        # variance is numerically indistinguishable from zero anyway
        eps = 1e-6 if var.dtype == jnp.float32 else 1e-12
        var = jnp.maximum(var, eps * k_ss)
        if include_noise:
            var = var + noise_variance
        return mu, var


class Laplace(Inference):
    """Laplace approximation for non-Gaussian likelihoods (GPML algorithms
    3.1/3.2). The reference DECLARES this inference but leaves it a stub
    (reference: hilo_mpc/modules/machine_learning/gp/inference.py:224-230);
    here it is implemented as pure JAX: the posterior mode is found by a
    fixed-trip Newton iteration in the numerically stable
    ``B = I + W^{1/2} K W^{1/2}`` parameterization, everything jits, and the
    log marginal likelihood is differentiable THROUGH the mode finding, so
    hyperparameter fitting uses the same L-BFGS/Adam paths as exact
    inference. Works with any likelihood exposing ``log_pdf(f, y, sn2)``
    (ml/gp/likelihood.py); for the Gaussian likelihood the posterior is
    exactly Gaussian, Newton converges in one step, and results coincide
    with exact inference (pinned by tests/test_gp_laplace.py).
    """

    #: curvature floor for non-log-concave likelihoods (Student's t): W_ii
    #: below this is clipped so B stays positive definite
    W_FLOOR = 1e-8
    NEWTON_ITERS = 25

    @staticmethod
    def _gram(kernel, params, X):
        with jax.default_matmul_precision("highest"):
            K = kernel.gram(params, X)
        jitter = 1e-6 if K.dtype == jnp.float32 else 1e-10
        n = X.shape[0]
        return K + jitter * jnp.mean(jnp.diagonal(K)) * jnp.eye(n, dtype=K.dtype)

    @staticmethod
    def mode_state(kernel, mean, params, X, y, sn2, likelihood,
                   iters: int = None):
        """Find the posterior mode f_hat (GPML alg. 3.1) and return
        ``(f_hat, g, sW, L, lml)`` where g = grad log p(y|f_hat), sW = W^{1/2}
        at the mode, L = chol(I + sW K sW), lml the Laplace log marginal
        likelihood. All traceable; fixed iteration count (Newton converges
        quadratically — 25 trips is far past convergence for log-concave
        likelihoods at f64)."""
        iters = Laplace.NEWTON_ITERS if iters is None else iters
        n = X.shape[0]
        K = Laplace._gram(kernel, params, X)
        m = jax.vmap(lambda a: mean.eval(params, a))(X)
        y = jnp.asarray(y, K.dtype)

        lp_sum = lambda f: jnp.sum(likelihood.log_pdf(f, y, sn2))
        grad_lp = jax.grad(lp_sum)

        def curvature(f):
            # W = -d^2/df^2 log p(y|f), elementwise (diagonal)
            d2 = jax.grad(lambda ff: jnp.sum(grad_lp(ff)))(f)
            W = -d2
            return jnp.maximum(W, Laplace.W_FLOOR)

        eye = jnp.eye(n, dtype=K.dtype)
        # objective of the mode search: psi(f) = log p(y|f) - 0.5 (f-m)' K^-1 (f-m);
        # with a = K^-1 (f-m) carried alongside f the quadratic term is a
        # cheap dot product and candidates along the Newton direction are
        # linear interpolations (no extra gram products)
        alphas = 0.5 ** jnp.arange(8, dtype=K.dtype)

        def newton(carry, _):
            f, a = carry
            W = curvature(f)
            sW = jnp.sqrt(W)
            B = eye + sW[:, None] * K * sW[None, :]
            with jax.default_matmul_precision("highest"):
                L = jnp.linalg.cholesky(B)
                b = W * (f - m) + grad_lp(f)
                t = jax.scipy.linalg.cho_solve((L, True), sW * (K @ b))
                a_full = b - sW * t
                f_full = K @ a_full + m

            # backtracking line search on psi: plain Newton oscillates for
            # non-log-concave likelihoods (Student's t); log-concave cases
            # accept alpha=1 and this reduces to the pure Newton step
            def psi(al):
                a_c = (1.0 - al) * a + al * a_full
                f_c = (1.0 - al) * f + al * f_full
                v = lp_sum(f_c) - 0.5 * jnp.dot(a_c, f_c - m)
                return jnp.where(jnp.isfinite(v), v, -jnp.inf)

            vals = jax.vmap(psi)(alphas)
            best = jnp.argmax(vals)
            al = alphas[best]
            f_new = (1.0 - al) * f + al * f_full
            a_new = (1.0 - al) * a + al * a_full
            # NaN guard: a failed factorization keeps the previous iterate
            ok = jnp.all(jnp.isfinite(f_new)) & (vals[best] > -jnp.inf)
            return (jnp.where(ok, f_new, f), jnp.where(ok, a_new, a)), None

        (f_hat, _), _ = jax.lax.scan(newton, (m, jnp.zeros(n, K.dtype)), None,
                                     length=iters)

        W = curvature(f_hat)
        sW = jnp.sqrt(W)
        B = eye + sW[:, None] * K * sW[None, :]
        with jax.default_matmul_precision("highest"):
            L = jnp.linalg.cholesky(B)
            g = grad_lp(f_hat)
            # a = K^{-1}(f_hat - m) without forming K^{-1}: at the mode
            # a = g (stationarity), but use the stabilized recomputation so
            # the lml stays exact for finite iteration counts
            b = W * (f_hat - m) + g
            t = jax.scipy.linalg.cho_solve((L, True), sW * (K @ b))
            a = b - sW * t
        lml = (-0.5 * jnp.dot(a, f_hat - m) + jnp.sum(
            likelihood.log_pdf(f_hat, y, sn2))
            - jnp.sum(jnp.log(jnp.diagonal(L))))
        return f_hat, g, sW, L, lml

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, sn2, likelihood,
                                iters: int = None):
        return Laplace.mode_state(kernel, mean, params, X, y, sn2,
                                  likelihood, iters=iters)[4]

    @staticmethod
    def predict(kernel, mean, params, X, g, sW, L, x_star):
        """Latent posterior (mu, var) at a single query point (GPML alg. 3.2)."""
        with jax.default_matmul_precision("highest"):
            k_star = jax.vmap(lambda a: kernel.eval(params, a, x_star))(X)
            mu = mean.eval(params, x_star) + jnp.dot(k_star, g)
            v = jax.scipy.linalg.solve_triangular(L, sW * k_star, lower=True)
            k_ss = kernel.eval(params, x_star, x_star)
            var = k_ss - jnp.dot(v, v)
        eps = 1e-6 if var.dtype == jnp.float32 else 1e-12
        return mu, jnp.maximum(var, eps * k_ss)


def _log_erfc(x):
    """Stable log(erfc(x)) over the whole line: direct below the underflow
    knee, the erfcx asymptotic series beyond it (erfc(x) ~
    exp(-x^2)/(x sqrt(pi)) (1 - 1/(2x^2) + 3/(4x^4)))."""
    xs = jnp.maximum(x, 5.0)
    asym = (-xs * xs - jnp.log(xs) - 0.5 * jnp.log(jnp.pi)
            + jnp.log1p(-0.5 / (xs * xs) + 0.75 / (xs * xs * xs * xs)))
    direct = jnp.log(jax.scipy.special.erfc(jnp.minimum(x, 5.0)))
    return jnp.where(x < 5.0, direct, asym)


def _log_ncdf(z):
    """Stable log Phi(z) = log(erfc(-z/sqrt(2))) - log 2."""
    return _log_erfc(-z / jnp.sqrt(jnp.asarray(2.0, z.dtype))) - jnp.log(2.0)


class ExpectationPropagation(Inference):
    """Expectation propagation for probit-likelihood classification (GPML
    algorithms 3.5/3.6). The reference declares this inference but leaves it
    a stub (reference: hilo_mpc/modules/machine_learning/gp/inference.py:
    233-239); here it is implemented in the jit-friendly PARALLEL-EP form:
    each sweep computes every site's cavity from the current posterior,
    moment-matches all sites at once (closed form for probit — the reason
    EP requires that likelihood), applies a damped site update, and
    recomputes the posterior through the stable ``B = I + S^{1/2} K
    S^{1/2}`` factorization. The EP log marginal likelihood is assembled
    from first principles as

        log Z_EP = sum_i [ log Phi(z_i) - log N(mu_cav_i | mu_site_i,
                           s2_cav_i + 1/tau_site_i) ]
                   + log N(mu_site | m, K + S^{-1})

    (site zeroth-moment matching x the Gaussian convolution integral) and is
    pinned against a brute-force 2-D quadrature oracle in
    tests/test_gp_ep.py. Differentiable through the sweeps, so the standard
    L-BFGS/Adam fit paths apply unchanged.
    """

    SWEEPS = 40
    DAMPING = 0.7
    TAU_FLOOR = 1e-10

    @staticmethod
    def site_state(kernel, mean, params, X, y, sweeps: int = None,
                   damping: float = None, likelihood=None, sn2=None):
        """Run parallel EP to convergence; returns
        ``(w, sqrt_tau, L, lml)`` where w = K^{-1}(mu_post - m) drives the
        predictive mean, sqrt_tau/L the predictive variance (GPML alg. 3.6),
        and lml the EP log marginal likelihood.

        ``likelihood`` selects the site family: None/probit = closed-form
        probit classification moments (GPML 3.6); a Laplacian likelihood
        (with ``sn2`` the squared noise scale) = outlier-robust regression
        with the exact Gaussian-x-Laplacian tilted moments (two-sided
        exponential integrals, autodiff for the tilted mean/variance) —
        the standard treatment of the likelihood the Laplace approximation
        cannot handle (zero curvature a.e.); the reference stubs it
        (gp/likelihood.py:85-89)."""
        sweeps = ExpectationPropagation.SWEEPS if sweeps is None else sweeps
        damping = (ExpectationPropagation.DAMPING if damping is None
                   else damping)
        n = X.shape[0]
        K = Laplace._gram(kernel, params, X)
        m = jax.vmap(lambda a: mean.eval(params, a))(X)
        y = jnp.asarray(y, K.dtype)
        eye = jnp.eye(n, dtype=K.dtype)
        floor = ExpectationPropagation.TAU_FLOOR
        lik_name = "probit" if likelihood is None else likelihood.name

        def posterior(tt, tn):
            """(Sigma, mu, L) from site precisions tt and site ev tn."""
            stt = jnp.sqrt(tt)
            B = eye + stt[:, None] * K * stt[None, :]
            with jax.default_matmul_precision("highest"):
                L = jnp.linalg.cholesky(B)
                V = jax.scipy.linalg.solve_triangular(
                    L, stt[:, None] * K, lower=True)
                Sigma = K - V.T @ V
                mu = m + Sigma @ (tn - tt * m)
            return Sigma, mu, L

        def cavity(Sigma, mu, tt, tn):
            sig2 = jnp.diagonal(Sigma)
            tau_c = jnp.maximum(1.0 / sig2 - tt, floor)
            nu_c = mu / sig2 - tn
            return tau_c, nu_c

        def probit_moments(tau_c, nu_c):
            mu_c = nu_c / tau_c
            s2_c = 1.0 / tau_c
            denom = jnp.sqrt(1.0 + s2_c)
            z = y * mu_c / denom
            # N(z)/Phi(z), stable in the deep tail via log-space
            ratio = jnp.exp(jax.scipy.stats.norm.logpdf(z)
                            - jax.scipy.stats.norm.logcdf(z))
            mu_hat = mu_c + y * s2_c * ratio / denom
            s2_hat = s2_c - s2_c ** 2 * ratio * (z + ratio) / (1.0 + s2_c)
            s2_hat = jnp.maximum(s2_hat, floor)
            return mu_hat, s2_hat, jax.scipy.stats.norm.logcdf(z)

        def laplace_logZ(mu_c, s2_c):
            # log of Z = int Lap(y | f, b) N(f | mu_c, s2_c) df, b = sn/sqrt2:
            # split at f = y, each half a Gaussian-times-exponential integral
            # -> exp-shifted normal CDFs; assembled fully in log space
            b = jnp.sqrt(sn2 / 2.0)
            r = y - mu_c
            sig = jnp.sqrt(s2_c)
            t1 = -r / b + _log_ncdf((r - s2_c / b) / sig)
            t2 = r / b + _log_ncdf(-(r + s2_c / b) / sig)
            return (s2_c / (2.0 * b * b) - jnp.log(2.0 * b)
                    + jnp.logaddexp(t1, t2))

        def laplacian_moments(tau_c, nu_c):
            mu_c = nu_c / tau_c
            s2_c = 1.0 / tau_c
            logZ = laplace_logZ(mu_c, s2_c)
            # tilted mean/variance from the logZ derivatives (elementwise, so
            # grad-of-sum gives the diagonal): mu_hat = mu + s2 dlogZ/dmu,
            # s2_hat = s2 (1 + s2 d2logZ/dmu2). logZ is smooth in mu_c (the
            # Gaussian convolution removes the |y-f| kink), so autodiff is
            # exact
            alpha_fn = jax.grad(lambda mu: jnp.sum(laplace_logZ(mu, s2_c)))
            alpha = alpha_fn(mu_c)
            beta = jax.grad(lambda mu: jnp.sum(alpha_fn(mu)))(mu_c)
            mu_hat = mu_c + s2_c * alpha
            s2_hat = jnp.maximum(s2_c * (1.0 + s2_c * beta), floor)
            return mu_hat, s2_hat, logZ

        tilted_moments = (laplacian_moments if lik_name == "laplacian"
                          else probit_moments)

        def sweep(carry, _):
            tt, tn = carry
            Sigma, mu, _ = posterior(tt, tn)
            tau_c, nu_c = cavity(Sigma, mu, tt, tn)
            mu_hat, s2_hat, _ = tilted_moments(tau_c, nu_c)
            tt_new = jnp.maximum(1.0 / s2_hat - tau_c, floor)
            tn_new = mu_hat / s2_hat - nu_c
            tt_d = (1.0 - damping) * tt + damping * tt_new
            tn_d = (1.0 - damping) * tn + damping * tn_new
            ok = jnp.all(jnp.isfinite(tt_d)) & jnp.all(jnp.isfinite(tn_d))
            return (jnp.where(ok, tt_d, tt), jnp.where(ok, tn_d, tn)), None

        tt0 = jnp.full(n, floor, K.dtype)
        tn0 = jnp.zeros(n, K.dtype)
        (tt, tn), _ = jax.lax.scan(sweep, (tt0, tn0), None, length=sweeps)

        Sigma, mu, L = posterior(tt, tn)
        stt = jnp.sqrt(tt)
        # w = K^{-1}(mu_post - m) without forming K^{-1}:
        # K^{-1} Sigma = I - S^{1/2} B^{-1} S^{1/2} K
        r = tn - tt * m
        with jax.default_matmul_precision("highest"):
            t1 = jax.scipy.linalg.cho_solve((L, True), stt * (K @ r))
            w = r - stt * t1

        # -- log Z_EP from the converged cavities -----------------------------
        tau_c, nu_c = cavity(Sigma, mu, tt, tn)
        _, _, log_phis = tilted_moments(tau_c, nu_c)
        mu_c = nu_c / tau_c
        mu_site = tn / tt
        s_tot = 1.0 / tau_c + 1.0 / tt
        # - log N(mu_c | mu_site, s_tot), elementwise
        site_norm = 0.5 * (jnp.log(2 * jnp.pi * s_tot)
                           + (mu_c - mu_site) ** 2 / s_tot)
        # log N(mu_site | m, K + S^{-1}) through the B factorization:
        # log|K + S^{-1}| = 2 sum log L_ii - sum log tau_site
        rs = mu_site - m
        with jax.default_matmul_precision("highest"):
            u = jax.scipy.linalg.solve_triangular(L, stt * rs, lower=True)
        log_det = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L))) - jnp.sum(
            jnp.log(tt))
        log_gauss = -0.5 * (n * jnp.log(2 * jnp.pi) + log_det
                            + jnp.dot(u, u))
        lml = jnp.sum(log_phis + site_norm) + log_gauss
        return w, stt, L, lml

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, sweeps: int = None,
                                damping: float = None, likelihood=None,
                                sn2=None):
        return ExpectationPropagation.site_state(
            kernel, mean, params, X, y, sweeps=sweeps, damping=damping,
            likelihood=likelihood, sn2=sn2)[3]

    @staticmethod
    def predict(kernel, mean, params, X, w, sqrt_tau, L, x_star):
        """Latent posterior (mu, var) at one query point (GPML alg. 3.6)."""
        with jax.default_matmul_precision("highest"):
            k_star = jax.vmap(lambda a: kernel.eval(params, a, x_star))(X)
            mu = mean.eval(params, x_star) + jnp.dot(k_star, w)
            v = jax.scipy.linalg.solve_triangular(
                L, sqrt_tau * k_star, lower=True)
            k_ss = kernel.eval(params, x_star, x_star)
            var = k_ss - jnp.dot(v, v)
        eps = 1e-6 if var.dtype == jnp.float32 else 1e-12
        return mu, jnp.maximum(var, eps * k_ss)


class SparseFITC(Inference):
    """Sparse GP regression with inducing points — the FITC approximation
    (Snelson & Ghahramani 2006; Quinonero-Candela & Rasmussen 2005). BEYOND
    the reference, which has no sparse path at all: exact inference is
    O(n^3)/O(n^2) memory, which caps the GP surrogates used in SMPC/hybrid
    models at a few thousand training points; FITC costs O(n m^2) with m
    inducing points and its predictive state is m-sized, so the traceable
    ``predict_fn`` embedded into solver graphs gets CHEAPER as well.

    Stable formulation (all through two Cholesky factors):

        Luu  = chol(Kuu),  V = Luu^{-1} Kuf,
        Lam  = diag(Kff) - diag(V'V) + sn2        (the FITC heteroscedastic
                                                   correction; Lam = sn2
                                                   exactly when Z = X),
        A    = I_m + Vs Vs',  Vs = V / sqrt(Lam),  La = chol(A),
        lml  = -1/2 [n log 2pi + sum log Lam + log|A|
                     + ||ytil||^2 - ||beta||^2],
               ytil = resid/sqrt(Lam), beta = La^{-1} Vs ytil.

    Predictions: w = Luu^{-1} k(Z, x*), t = La^{-1} w,
    mu* = m(x*) + t.beta, var* = k** - w.w + t.t. With Z = X the
    approximation collapses to EXACT inference (Qff = Kff), pinned by
    tests/test_gp_fitc.py. Differentiable in the hyperparameters (plain
    first-order graph), so the standard L-BFGS/Adam fit paths apply; the
    inducing set is a fixed subset/grid (subset-of-data), not optimized.
    """

    @staticmethod
    def state(kernel, mean, params, X, y, Z, sn2):
        """Returns ``(Luu, La, beta, lml)`` — everything predict needs plus
        the FITC log marginal likelihood."""
        return _sparse_state(kernel, mean, params, X, y, Z, sn2,
                             heteroscedastic=True)

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, Z, sn2):
        return SparseFITC.state(kernel, mean, params, X, y, Z, sn2)[3]

    @staticmethod
    def predict(kernel, mean, params, Z, Luu, La, beta, x_star, sn2,
                include_noise=False):
        """(mu, var) at one query point from the m-sized state."""
        with jax.default_matmul_precision("highest"):
            ku = jax.vmap(lambda zz: kernel.eval(params, zz, x_star))(Z)
            w = jax.scipy.linalg.solve_triangular(Luu, ku, lower=True)
            t = jax.scipy.linalg.solve_triangular(La, w, lower=True)
            mu = mean.eval(params, x_star) + jnp.dot(t, beta)
            k_ss = kernel.eval(params, x_star, x_star)
            var = k_ss - jnp.dot(w, w) + jnp.dot(t, t)
        eps = 1e-6 if var.dtype == jnp.float32 else 1e-12
        var = jnp.maximum(var, eps * k_ss)
        if include_noise:
            var = var + sn2
        return mu, var


def _sparse_state(kernel, mean, params, X, y, Z, sn2, heteroscedastic):
    """Shared inducing-point algebra for FITC and VFE (the unified view of
    Quinonero-Candela & Rasmussen 2005): both replace Kff by the Nystrom
    Qff = Kfu Kuu^{-1} Kuf and differ only in the per-point variance

        FITC:  lam_i = kff_i - [V'V]_ii + sn2   (heteroscedastic correction),
        VFE:   lam_i = sn2, objective -= tr(Kff - Qff) / (2 sn2)
               (Titsias 2009 trace regularizer — the ELBO slack).

    Returns ``(Luu, La, beta, lml)``; the predictive algebra downstream
    (``SparseFITC.predict``) is identical for both because it only consumes
    (Luu, La, beta)."""
    n = X.shape[0]
    m = Z.shape[0]
    with jax.default_matmul_precision("highest"):
        Kuu = kernel.gram(params, Z)
        # the inducing gram carries NO noise term and a smooth kernel's
        # spectrum decays superexponentially — a dense inducing set needs
        # a heavier jitter than the noisy exact-inference gram or the
        # Cholesky NaNs (observed at m=400 SE points in f64 with 1e-10)
        jitter = 1e-5 if Kuu.dtype == jnp.float32 else 1e-8
        Kuu = Kuu + jitter * jnp.mean(jnp.diagonal(Kuu)) * jnp.eye(
            m, dtype=Kuu.dtype)
        Kuf = jax.vmap(lambda zz: jax.vmap(
            lambda xx: kernel.eval(params, zz, xx))(X))(Z)
        kff = jax.vmap(lambda xx: kernel.eval(params, xx, xx))(X)
        Luu = jnp.linalg.cholesky(Kuu)
        V = jax.scipy.linalg.solve_triangular(Luu, Kuf, lower=True)
        # the Nystrom defect kff - diag(Qff) is >= 0 in exact arithmetic
        # (Qff is a lower bound on Kff); floor it against roundoff
        defect = jnp.maximum(kff - jnp.sum(V * V, axis=0), 0.0)
        if heteroscedastic:
            lam = jnp.maximum(defect + sn2,
                              jitter * jnp.mean(kff) + 1e-30)
            trace_penalty = 0.0
        else:
            lam = jnp.full((n,), sn2, dtype=Kuu.dtype)
            trace_penalty = jnp.sum(defect) / (2.0 * sn2)
        Vs = V / jnp.sqrt(lam)[None, :]
        A = jnp.eye(m, dtype=Kuu.dtype) + Vs @ Vs.T
        La = jnp.linalg.cholesky(A)
        mx = jax.vmap(lambda a: mean.eval(params, a))(X)
        ytil = (jnp.asarray(y, Kuu.dtype) - mx) / jnp.sqrt(lam)
        beta = jax.scipy.linalg.solve_triangular(
            La, Vs @ ytil, lower=True)
    lml = -0.5 * (n * jnp.log(2 * jnp.pi) + jnp.sum(jnp.log(lam))
                  + 2.0 * jnp.sum(jnp.log(jnp.diagonal(La)))
                  + jnp.dot(ytil, ytil) - jnp.dot(beta, beta)
                  ) - trace_penalty
    return Luu, La, beta, lml


class SparseVFE(Inference):
    """Sparse GP regression — Titsias's variational free energy (VFE)
    approximation ("Variational Learning of Inducing Variables in Sparse
    Gaussian Processes", AISTATS 2009). BEYOND both trees (the reference has
    no sparse path; reference gp/inference.py declares only dense
    inferences).

    Same O(n m^2) cost and m-sized predictive state as FITC, but the
    objective is a TRUE LOWER BOUND on the exact log marginal likelihood:

        F(Z) = log N(y | m, Qff + sn2 I) - tr(Kff - Qff) / (2 sn2),

    so maximizing F over hyperparameters AND the inducing locations Z is
    principled variational inference — Z never overfits (adding inducing
    points can only increase F, and F == exact LML when Z = X because the
    trace vanishes). FITC, by contrast, is a model approximation whose
    heteroscedastic term can be gamed by the optimizer (pathological
    "noise-absorbing" inducing placements, Bauer et al. 2016); when
    ``optimize_inducing`` is on, VFE is the right objective. Predictions
    use the identical Qff algebra, so ``SparseFITC.predict`` serves both.
    Pinned by tests/test_gp_vfe.py: Z=X collapse, lower-bound dominance
    F <= exact LML for every strict subset, monotonicity in m."""

    @staticmethod
    def state(kernel, mean, params, X, y, Z, sn2):
        """Returns ``(Luu, La, beta, elbo)``; the elbo is the fitting
        objective (a lower bound on the exact LML)."""
        return _sparse_state(kernel, mean, params, X, y, Z, sn2,
                             heteroscedastic=False)

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, Z, sn2):
        return SparseVFE.state(kernel, mean, params, X, y, Z, sn2)[3]

    # the posterior-over-u predictive is the same Qff projection for both
    # sparse families — only (La, beta) differ, computed above
    predict = staticmethod(SparseFITC.predict)


class KullbackLeibler(Inference):
    """Variational Gaussian (KL) inference — minimize KL(q || posterior) over
    all Gaussians q (Opper & Archambeau 2009, "The Variational Gaussian
    Approximation Revisited"; the KL method of GPML section 3.4). The
    reference declares this inference and stubs it (reference:
    hilo_mpc/modules/machine_learning/gp/inference.py:241-248); here it is
    implemented as pure JAX, generic over EVERY likelihood in
    ml/gp/likelihood.py — including the Laplacian, whose kink defeats the
    Laplace approximation but is smoothed away by the Gaussian expectation.

    The optimal q has the Opper-Archambeau form q = N(m + K nu,
    (K^{-1} + Lambda)^{-1}) with Lambda = diag(lam) >= 0, so only 2n
    variational parameters are optimized. Per sweep:

    - sigma_i^2 = diag((K^{-1}+Lambda)^{-1}) through the stable
      ``B = I + Lambda^{1/2} K Lambda^{1/2}`` factorization,
    - the per-site expectations E_i(mu_i, s2_i) = E_{N(mu_i,s2_i)}[log
      p(y_i|f_i)] by Gauss-Hermite quadrature, with dE/dmu and dE/ds2 by
      the Gaussian SCORE identities (quadratures of log p itself, not of
      its derivatives — so the distributional curvature of kinked
      likelihoods, e.g. the Laplacian's delta, is integrated correctly
      where pointwise E[d^2 log p/df^2] would read zero, and the sweep
      body stays first-order for cheap hyperparameter autodiff),
    - lam steps toward the stationarity target -2 dE/ds2 (damped),
    - nu takes a Newton step (I + Lambda K)^{-1}(dE/dmu - nu) with an
      ELBO backtracking line search (for the Gaussian likelihood this
      single step lands exactly on nu = (K + sn2 I)^{-1}(y - m)).

    The ELBO  sum_i E_i - 0.5 [log|B| + nu' K nu - sum_i lam_i s2_i]  is a
    true lower bound on the log marginal likelihood, used as the fitting
    objective (differentiable through the sweeps), and coincides with the
    exact LML for the Gaussian likelihood (q is then the exact posterior —
    pinned by tests/test_gp_kl_vb.py). The predictive carries the same
    ``(nu, sqrt(lam), chol(B))`` state as Laplace, so ``Laplace.predict``
    serves unchanged.
    """

    SWEEPS = 60
    DAMPING = 0.5
    GH_POINTS = 32
    LAM_FLOOR = 1e-8

    @staticmethod
    def _gh(dtype):
        import numpy as np

        t, w = np.polynomial.hermite.hermgauss(KullbackLeibler.GH_POINTS)
        return jnp.asarray(t, dtype), jnp.asarray(w / np.sqrt(np.pi), dtype)

    @staticmethod
    def variational_state(kernel, mean, params, X, y, sn2, likelihood,
                          sweeps: int = None, damping: float = None):
        """Run the damped sweeps; returns ``(nu, sLam, L, elbo)`` — the same
        predictive state layout as ``Laplace.mode_state`` (g -> nu,
        sW -> sqrt(lam))."""
        sweeps = KullbackLeibler.SWEEPS if sweeps is None else sweeps
        damping = KullbackLeibler.DAMPING if damping is None else damping
        n = X.shape[0]
        K = Laplace._gram(kernel, params, X)
        m = jax.vmap(lambda a: mean.eval(params, a))(X)
        y = jnp.asarray(y, K.dtype)
        eye = jnp.eye(n, dtype=K.dtype)
        floor = KullbackLeibler.LAM_FLOOR
        t_gh, w_gh = KullbackLeibler._gh(K.dtype)
        sqrt2 = jnp.sqrt(jnp.asarray(2.0, K.dtype))
        diagK = jnp.diagonal(K)

        def E_sum(mu, s2):
            # sum_i E_{N(mu_i, s2_i)}[log p(y_i | f_i)] by Gauss-Hermite
            sig = jnp.sqrt(s2)
            fs = mu[None, :] + sqrt2 * sig[None, :] * t_gh[:, None]
            vals = likelihood.log_pdf(fs, y[None, :], sn2)
            return jnp.sum(w_gh[:, None] * vals)

        def E_derivs(mu, s2):
            """(dE/dmu_i, dE/ds2_i) by the Gaussian score identities
            dE/dmu = E[logp (f-mu)]/s2 and dE/ds2 = E[logp ((f-mu)^2/s2 -
            1)]/(2 s2) — plain quadratures of logp itself, NOT of its
            derivatives. Two payoffs: the sweep body carries no inner
            jax.grad (hyperparameter fitting differentiates a FIRST-order
            scan — the nested-AD tower made XLA:CPU compile times blow up
            ~50x), and the distributional curvature of kinked likelihoods
            (the Laplacian's delta) is integrated exactly rather than
            sampled past."""
            sig = jnp.sqrt(s2)
            fs = mu[None, :] + sqrt2 * sig[None, :] * t_gh[:, None]
            vals = likelihood.log_pdf(fs, y[None, :], sn2)
            wv = w_gh[:, None] * vals
            e1 = jnp.sum(wv * sqrt2 * t_gh[:, None], axis=0) / sig
            e2 = jnp.sum(wv * (2.0 * t_gh[:, None] ** 2 - 1.0),
                         axis=0) / (2.0 * s2)
            return e1, e2

        alphas = 0.5 ** jnp.arange(8, dtype=K.dtype)

        def factor(lam):
            sl = jnp.sqrt(lam)
            B = eye + sl[:, None] * K * sl[None, :]
            with jax.default_matmul_precision("highest"):
                L = jnp.linalg.cholesky(B)
                V = jax.scipy.linalg.solve_triangular(
                    L, sl[:, None] * K, lower=True)
            s2 = jnp.maximum(diagK - jnp.sum(V * V, axis=0), floor)
            return sl, L, s2

        def sweep(carry, _):
            nu, lam = carry
            sl, L, s2 = factor(lam)
            mu = K @ nu + m
            e1, e2 = E_derivs(mu, s2)

            # lambda: damped step toward the stationarity target -2 dE/ds2
            lam_t = jnp.maximum(-2.0 * e2, floor)
            lam_new = (1.0 - damping) * lam + damping * lam_t

            # nu: Newton step in the (I + Lambda K) metric at the CURRENT
            # lam (whose factorization we already hold); stable form
            # (I + Lam K)^{-1} r = r - sl B^{-1} sl (K r)
            r = e1 - nu
            with jax.default_matmul_precision("highest"):
                u = jax.scipy.linalg.cho_solve((L, True), sl * (K @ r))
            dnu = r - sl * u
            nu_full = nu + dnu
            mu_full = K @ nu_full + m

            # backtracking on the ELBO's nu-dependent part (s2, log|B| are
            # fixed given lam): candidates interpolate linearly in (nu, mu)
            def obj(al):
                nu_c = (1.0 - al) * nu + al * nu_full
                mu_c = (1.0 - al) * mu + al * mu_full
                v = E_sum(mu_c, s2) - 0.5 * jnp.dot(nu_c, mu_c - m)
                return jnp.where(jnp.isfinite(v), v, -jnp.inf)

            vals = jax.vmap(obj)(alphas)
            best = jnp.argmax(vals)
            al = alphas[best]
            nu_new = (1.0 - al) * nu + al * nu_full
            ok = (jnp.all(jnp.isfinite(nu_new))
                  & jnp.all(jnp.isfinite(lam_new)) & (vals[best] > -jnp.inf))
            return (jnp.where(ok, nu_new, nu),
                    jnp.where(ok, lam_new, lam)), None

        nu0 = jnp.zeros(n, K.dtype)
        lam0 = jnp.ones(n, K.dtype)
        (nu, lam), _ = jax.lax.scan(sweep, (nu0, lam0), None, length=sweeps)

        sl, L, s2 = factor(lam)
        mu = K @ nu + m
        elbo = (E_sum(mu, s2)
                - jnp.sum(jnp.log(jnp.diagonal(L)))
                - 0.5 * jnp.dot(nu, mu - m)
                + 0.5 * jnp.dot(lam, s2))
        return nu, sl, L, elbo

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, sn2, likelihood,
                                sweeps: int = None, damping: float = None):
        """The ELBO — a true LOWER bound on log Z (equality for the Gaussian
        likelihood), the standard variational fitting objective."""
        return KullbackLeibler.variational_state(
            kernel, mean, params, X, y, sn2, likelihood, sweeps=sweeps,
            damping=damping)[3]

    # the predictive state (nu, sqrt(lam), L) is layout-identical to
    # Laplace's (g, sW, L): mu_* = m(x*) + k_*' nu, var_* = k** - ||L^{-1}
    # sqrt(lam) k_*||^2
    predict = Laplace.predict


class VariationalBayes(Inference):
    """Variational-bound (VB) inference for logistic-likelihood GP
    classification via the Jaakkola-Jordan quadratic bound. The reference
    declares this inference and stubs it (reference: hilo_mpc/modules/
    machine_learning/gp/inference.py:250-257).

    Each sigmoid is lower-bounded by the exact exponential-quadratic bound
    log sig(z) >= log sig(xi) + (z - xi)/2 - lam(xi) (z^2 - xi^2) with
    lam(xi) = tanh(xi/2)/(4 xi), which makes the bounded posterior exactly
    Gaussian: Sigma_q = (K^{-1} + 2 Lambda)^{-1}, mu_q = m + Sigma_q (y/2 -
    2 Lambda m). Coordinate ascent alternates the closed-form Gaussian with
    the optimal xi_i^2 = E_q[f_i^2] = Sigma_ii + mu_i^2; every step
    monotonically increases the bound (EM on the augmented model). The
    final bound

        log Z >= sum_i [log sig(xi_i) - xi_i/2 + lam_i xi_i^2]
                 - 0.5 log|B| + 0.5 [(y/2 - 2 Lambda m)' mu_q + m' y/2]

    is the fitting objective; the predictive state is again the Laplace
    layout (nu = K^{-1}(mu_q - m) via the stable identity, sW =
    sqrt(2 lam), L = chol(B)). Logistic-only by construction — other
    likelihoods route to the generic KL method (ml/gp/inference.py:
    KullbackLeibler), which subsumes VB in accuracy at higher cost.
    """

    ITERS = 50
    XI_FLOOR = 1e-6

    @staticmethod
    def bound_state(kernel, mean, params, X, y, iters: int = None):
        """Coordinate-ascent on (q, xi); returns ``(nu, sA, L, bound)``."""
        iters = VariationalBayes.ITERS if iters is None else iters
        n = X.shape[0]
        K = Laplace._gram(kernel, params, X)
        m = jax.vmap(lambda a: mean.eval(params, a))(X)
        y = jnp.asarray(y, K.dtype)
        eye = jnp.eye(n, dtype=K.dtype)
        b = 0.5 * y
        diagK = jnp.diagonal(K)

        def lam_of(xi):
            # tanh(xi/2)/(4 xi), smooth limit 1/8 at xi -> 0
            xi = jnp.maximum(xi, VariationalBayes.XI_FLOOR)
            return jnp.tanh(0.5 * xi) / (4.0 * xi)

        def posterior(lam):
            A = 2.0 * lam
            sA = jnp.sqrt(A)
            B = eye + sA[:, None] * K * sA[None, :]
            with jax.default_matmul_precision("highest"):
                L = jnp.linalg.cholesky(B)
                V = jax.scipy.linalg.solve_triangular(
                    L, sA[:, None] * K, lower=True)
                Sigma_diag = diagK - jnp.sum(V * V, axis=0)
                r = b - A * m
                # Sigma_q r = (K - K sA B^{-1} sA K) r without forming Sigma
                t1 = jax.scipy.linalg.cho_solve((L, True), sA * (K @ r))
                mu = m + K @ (r - sA * t1)
            return mu, jnp.maximum(Sigma_diag, 0.0), L, r, sA

        def step(xi2, _):
            lam = lam_of(jnp.sqrt(xi2))
            mu, Sdiag, _, _, _ = posterior(lam)
            xi2_new = Sdiag + mu * mu
            ok = jnp.all(jnp.isfinite(xi2_new))
            return jnp.where(ok, xi2_new, xi2), None

        xi2_0 = jnp.ones(n, K.dtype)
        xi2, _ = jax.lax.scan(step, xi2_0, None, length=iters)

        xi = jnp.sqrt(jnp.maximum(xi2, VariationalBayes.XI_FLOOR ** 2))
        lam = lam_of(xi)
        mu, _, L, r, sA = posterior(lam)
        # nu = K^{-1}(mu_q - m) stably: K^{-1} Sigma_q = I - A Sigma_q
        A = 2.0 * lam
        nu = r - A * (mu - m)
        bound = (jnp.sum(jax.nn.log_sigmoid(xi) - 0.5 * xi + lam * xi * xi)
                 - jnp.sum(jnp.log(jnp.diagonal(L)))
                 + 0.5 * (jnp.dot(r, mu) + jnp.dot(m, b)))
        return nu, sA, L, bound

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, iters: int = None):
        """The Jaakkola-Jordan bound — a true LOWER bound on log Z."""
        return VariationalBayes.bound_state(
            kernel, mean, params, X, y, iters=iters)[3]

    predict = Laplace.predict


class StochasticVariational(Inference):
    """SVGP — stochastic variational inference with an UNCOLLAPSED q(u)
    (Hensman, Fusi & Lawrence 2013, "Gaussian Processes for Big Data";
    Hensman, Matthews & Ghahramani 2015 for the classification extension).
    BEYOND both trees: the reference has no sparse path at all, and unlike
    the collapsed Titsias bound (``SparseVFE``), the ELBO here decomposes
    over data points, so it trains from MINIBATCHES — n is no longer
    bounded by what one device pass holds — and it accepts EVERY likelihood
    in ml/gp/likelihood.py (classification, robust regression), where
    FITC/VFE are Gaussian-only.

    Whitened parameterization (standard for conditioning): with
    u = m_Z(·) + Luu v, Luu = chol(Kuu), the variational family is
    q(v) = N(mv, Lv Lv'), Lv lower-triangular with exp-positive diagonal
    (raw parameter Lraw: Lv = tril(Lraw, -1) + diag(exp(diag(Lraw))); the
    zero init is exactly the prior q(v) = N(0, I)). Then

        q(f(x)) = N( m(x) + a·mv ,  k(x,x) - a·a + |Lv' a|^2 ),
        a = Luu^{-1} k(Z, x),

        ELBO = (n/|B|) sum_{i in B} E_{q(f_i)}[log p(y_i | f_i)]
               - KL(q(v) || N(0, I)),
        KL   = 1/2 (|mv|^2 + |Lv|_F^2 - m) - sum log diag(Lv).

    The per-point expectation is closed-form for the Gaussian likelihood
    (E[log N(y; f, sn2)] = log N(y; mu, sn2) - var/(2 sn2)) and
    Gauss-Hermite quadrature otherwise — quadrature needs only
    ``likelihood.log_pdf``, so every likelihood plugs in. The full-batch
    ELBO is a true lower bound on the exact LML, dominated by the collapsed
    VFE bound (VFE = max over q of this ELBO), with equality at the optimal
    q — both pinned by tests/test_gp_svgp.py. The predictive state
    (Z, Luu, mv, Lv) is m-sized, so like FITC/VFE it embeds cheaply into
    solver graphs (SMPC, hybrid models). Training happens in gp.py:
    full-batch through the generic L-BFGS/Adam fit paths (the variational
    parameters are ordinary Hyperparameters), or minibatch Adam as one
    ``lax.scan`` device dispatch when ``batch_size`` is set.
    """

    #: Gauss-Hermite order for non-Gaussian expected log-likelihoods; 20
    #: nodes integrate the logistic/probit/Student's-t integrands to ~1e-9
    #: at the posterior scales that occur in practice
    GH_POINTS = 20

    @staticmethod
    def chol_kuu(kernel, params, Z):
        """chol of the (jittered) inducing gram — same dense-inducing jitter
        rationale as ``_sparse_state``."""
        m = Z.shape[0]
        with jax.default_matmul_precision("highest"):
            Kuu = kernel.gram(params, Z)
            jitter = 1e-5 if Kuu.dtype == jnp.float32 else 1e-8
            Kuu = Kuu + jitter * jnp.mean(jnp.diagonal(Kuu)) * jnp.eye(
                m, dtype=Kuu.dtype)
            return jnp.linalg.cholesky(Kuu)

    @staticmethod
    def chol_q(Lraw):
        """Raw (m, m) parameter -> lower-triangular Lv with positive
        diagonal; Lraw = 0 gives Lv = I (q starts at the whitened prior)."""
        Lraw = jnp.asarray(Lraw)
        m = Lraw.shape[-1]
        return (jnp.tril(Lraw, -1)
                + jnp.diag(jnp.exp(jnp.clip(jnp.diagonal(Lraw), -30.0, 30.0))))

    @staticmethod
    def latent_moments(kernel, mean, params, Z, Luu, mv, Lv, x_star):
        """(mu, var) of q(f(x*)) at a single query point from the m-sized
        whitened state."""
        with jax.default_matmul_precision("highest"):
            ku = jax.vmap(lambda zz: kernel.eval(params, zz, x_star))(Z)
            a = jax.scipy.linalg.solve_triangular(Luu, ku, lower=True)
            mu = mean.eval(params, x_star) + jnp.dot(a, mv)
            k_ss = kernel.eval(params, x_star, x_star)
            var = k_ss - jnp.dot(a, a) + jnp.sum((Lv.T @ a) ** 2)
        eps = 1e-6 if var.dtype == jnp.float32 else 1e-12
        return mu, jnp.maximum(var, eps * k_ss)

    @staticmethod
    def expected_log_lik(likelihood, mu, var, y, sn2, n_quad: int = None):
        """E_{f ~ N(mu, var)}[log p(y | f)], elementwise over a batch.

        Gaussian likelihood: closed form (the -var/(2 sn2) term is what
        penalizes posterior uncertainty in the ELBO). Anything else:
        probabilists' Gauss-Hermite — f_k = mu + sqrt(var) t_k, weights
        w_k / sqrt(2 pi) (hermegauss carries the N(0,1) weight directly).
        """
        if likelihood.name == "gaussian":
            r = y - mu
            return (-0.5 * (r * r + var) / sn2
                    - 0.5 * jnp.log(2 * jnp.pi * sn2))
        n_quad = StochasticVariational.GH_POINTS if n_quad is None else int(n_quad)
        import numpy as _np

        t, w = _np.polynomial.hermite_e.hermegauss(n_quad)  # weight e^{-t^2/2}
        t = jnp.asarray(t, mu.dtype)
        w = jnp.asarray(w / _np.sqrt(2.0 * _np.pi), mu.dtype)
        f = mu[:, None] + jnp.sqrt(var)[:, None] * t[None, :]
        lp = likelihood.log_pdf(f, jnp.asarray(y)[:, None], sn2)
        return lp @ w

    @staticmethod
    def elbo(kernel, mean, params, Xb, yb, Z, sn2, likelihood, mv, Lraw,
             n_total=None, n_quad: int = None):
        """The (minibatch-estimated) evidence lower bound. With
        ``Xb, yb`` the full training set and ``n_total = n`` this is the
        exact full-batch ELBO; with a minibatch, an unbiased estimate."""
        b = Xb.shape[0]
        n_total = b if n_total is None else n_total
        mv = jnp.atleast_1d(jnp.asarray(mv))
        m = mv.shape[0]
        Lv = StochasticVariational.chol_q(jnp.reshape(jnp.asarray(Lraw), (m, m)))
        Luu = StochasticVariational.chol_kuu(kernel, params, Z)
        mu, var = jax.vmap(lambda x: StochasticVariational.latent_moments(
            kernel, mean, params, Z, Luu, mv, Lv, x))(Xb)
        ell = StochasticVariational.expected_log_lik(
            likelihood, mu, var, jnp.asarray(yb, mu.dtype), sn2, n_quad)
        kl = (0.5 * (jnp.dot(mv, mv) + jnp.sum(Lv * Lv) - m)
              - jnp.sum(jnp.log(jnp.diagonal(Lv))))
        return (n_total / b) * jnp.sum(ell) - kl

    @staticmethod
    def state(kernel, mean, params, Z, mv, Lraw):
        """Predictive state ``(Luu, mv, Lv)`` — m-sized, X/y-free: after
        training, the data never enters prediction again (the point of the
        inducing-variable construction)."""
        mv = jnp.atleast_1d(jnp.asarray(mv))
        m = mv.shape[0]
        Lv = StochasticVariational.chol_q(jnp.reshape(jnp.asarray(Lraw), (m, m)))
        return StochasticVariational.chol_kuu(kernel, params, Z), mv, Lv

    @staticmethod
    def predict(kernel, mean, params, Z, Luu, mv, Lv, x_star,
                noise_variance=0.0, include_noise=False):
        mu, var = StochasticVariational.latent_moments(
            kernel, mean, params, Z, Luu, mv, Lv, x_star)
        if include_noise:
            var = var + noise_variance
        return mu, var
