"""Variational GP inference: KL (Opper-Archambeau variational Gaussian) and
VB (Jaakkola-Jordan logistic bound).

The reference declares BOTH inference names and stubs them (reference:
hilo_mpc/modules/machine_learning/gp/inference.py:241-257); ours are
implemented (ml/gp/inference.py:KullbackLeibler, VariationalBayes).
Correctness pins:

- KL with the Gaussian likelihood recovers EXACT inference (the optimal
  variational Gaussian IS the posterior; the ELBO equals the LML),
- both variational objectives are true LOWER bounds on log Z, checked
  against the same brute-force 2-D quadrature oracle the EP tests use,
- classification decisions agree with Laplace/EP across methods,
- KL is generic over likelihoods: Student's-t and Laplacian robust
  regression resist outliers that wreck an exact-Gaussian fit,
- the kl_sweeps/kl_damping/vb_iters knobs reach the inference layer.
"""
import numpy as np
import pytest

from hilo_mpc_tpu import GP


def _clusters(n=16, seed=1):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(-1.2, 0.3, n // 2),
                        rng.normal(1.2, 0.3, n // 2)])[:, None]
    y = np.concatenate([-np.ones(n // 2), np.ones(n // 2)])
    return X, y


def _quadrature_log_z(gp, X, y, log_lik):
    """Brute-force log Z = log iint N(f|0,K) prod_i p(y_i|f_i) df for n=2."""
    import jax.numpy as jnp

    params = gp._params()
    K = np.asarray(gp.kernel.gram(params, jnp.asarray(X)), dtype=float)
    K = K + 1e-10 * np.mean(np.diag(K)) * np.eye(2)
    g = np.linspace(-6.0, 6.0, 401)
    F1, F2 = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([F1.ravel(), F2.ravel()], axis=1)
    Kinv = np.linalg.inv(K)
    logN = (-0.5 * np.einsum("ni,ij,nj->n", pts, Kinv, pts)
            - 0.5 * np.log((2 * np.pi) ** 2 * np.linalg.det(K)))
    lik = log_lik(pts[:, 0], y[0]) + log_lik(pts[:, 1], y[1])
    h = g[1] - g[0]
    return np.log(np.sum(np.exp(logN + lik)) * h * h)


class TestKLMatchesExactForGaussian:
    def test_posterior_and_elbo_coincide(self):
        rng = np.random.default_rng(0)
        X = rng.uniform(-2, 2, (12, 1))
        y = np.sin(X[:, 0]) + 0.05 * rng.normal(size=12)
        kl = GP(["x"], ["y"], noise_variance=0.1, inference="kl")
        kl.set_training_data(X, y)
        kl.setup()
        ex = GP(["x"], ["y"], noise_variance=0.1, inference="exact")
        ex.set_training_data(X, y)
        ex.setup()
        # q* IS the exact posterior; the ELBO equals the LML
        assert kl.log_marginal_likelihood == pytest.approx(
            ex.log_marginal_likelihood, abs=1e-6)
        Xq = np.linspace(-2, 2, 9)[:, None]
        mu_k, v_k = kl.predict(Xq, include_noise=True)
        mu_e, v_e = ex.predict(Xq, include_noise=True)
        np.testing.assert_allclose(mu_k, mu_e, atol=1e-8)
        np.testing.assert_allclose(v_k, v_e, atol=1e-8)


class TestVariationalLowerBounds:
    """Both variational objectives must sit BELOW the true log Z (and close
    to it) — checked on a 2-point problem against dense quadrature."""

    @pytest.mark.parametrize("y_pair", [(1.0, 1.0), (1.0, -1.0)])
    def test_kl_probit_bound(self, y_pair):
        from scipy.stats import norm

        X = np.array([[-0.5], [0.7]])
        y = np.array(y_pair)
        gp = GP(["x"], ["c"], likelihood="probit", inference="kl")
        gp.set_training_data(X, y)
        gp.setup()
        log_z = _quadrature_log_z(
            gp, X, y, lambda f, yy: norm.logcdf(yy * f))
        elbo = gp.log_marginal_likelihood
        assert elbo <= log_z + 1e-6
        assert elbo == pytest.approx(log_z, abs=0.05)

    @pytest.mark.parametrize("y_pair", [(1.0, 1.0), (1.0, -1.0)])
    def test_vb_logistic_bound(self, y_pair):
        X = np.array([[-0.5], [0.7]])
        y = np.array(y_pair)
        gp = GP(["x"], ["c"], likelihood="logistic", inference="vb")
        gp.set_training_data(X, y)
        gp.setup()
        log_z = _quadrature_log_z(
            gp, X, y, lambda f, yy: -np.logaddexp(0.0, -yy * f))
        bound = gp.log_marginal_likelihood
        assert bound <= log_z + 1e-6
        # the JJ bound is looser than KL but still tight on easy problems
        assert bound == pytest.approx(log_z, abs=0.1)

    def test_kl_tighter_than_vb(self):
        # KL optimizes over ALL Gaussians; VB over the JJ-bounded family —
        # so on the same problem the KL ELBO must dominate the JJ bound
        X, y = _clusters(n=10, seed=5)
        kl = GP(["x"], ["c"], likelihood="logistic", inference="kl")
        kl.set_training_data(X, y)
        kl.setup()
        vb = GP(["x"], ["c"], likelihood="logistic", inference="vb")
        vb.set_training_data(X, y)
        vb.setup()
        assert kl.log_marginal_likelihood >= vb.log_marginal_likelihood - 1e-8


class TestClassificationAgreement:
    def test_vb_kl_laplace_same_decisions(self):
        X, y = _clusters(n=20, seed=3)
        ps = {}
        for inf in ("vb", "kl", "laplace"):
            gp = GP(["x"], ["c"], likelihood="logistic", inference=inf)
            gp.set_training_data(X, y)
            gp.setup()
            ps[inf] = gp.predict_proba(np.linspace(-2, 2, 11)[:, None])
        for inf in ("vb", "kl"):
            assert np.all((ps[inf] > 0.5) == (ps["laplace"] > 0.5))
            assert np.max(np.abs(ps[inf] - ps["laplace"])) < 0.15
        # sharp at the cluster centers (x = -1.2 / +1.2), uncertain in the
        # gap; beyond the clusters the posterior reverts toward the prior
        p = ps["kl"]
        assert p[2] < 0.2 and p[8] > 0.8 and 0.25 < p[5] < 0.75


class TestKLRobustRegression:
    def _contaminated(self):
        X = np.linspace(-2, 2, 20)[:, None]
        y = np.sin(X[:, 0]).copy()
        y[5] += 4.0
        y[12] -= 4.0
        return X, y

    @pytest.mark.parametrize("lik", ["students_t", "laplacian"])
    def test_outliers_rejected(self, lik):
        X, y = self._contaminated()
        gp = GP(["x"], ["y"], noise_variance=0.2, likelihood=lik,
                inference="kl")
        gp.set_training_data(X, y)
        gp.setup()
        ex = GP(["x"], ["y"], noise_variance=0.2, inference="exact")
        ex.set_training_data(X, y)
        ex.setup()
        clean = np.delete(np.arange(20), [5, 12])
        mu_r, _ = gp.predict(X)
        mu_e, _ = ex.predict(X)
        rmse_r = np.sqrt(np.mean((mu_r[clean] - np.sin(X[clean, 0])) ** 2))
        rmse_e = np.sqrt(np.mean((mu_e[clean] - np.sin(X[clean, 0])) ** 2))
        assert rmse_r < 0.2
        assert rmse_r < 0.5 * rmse_e   # robust fit beats the Gaussian fit

    def test_kl_agrees_with_ep_on_laplacian(self):
        X, y = self._contaminated()
        kl = GP(["x"], ["y"], noise_variance=0.2, likelihood="laplacian",
                inference="kl")
        kl.set_training_data(X, y)
        kl.setup()
        ep = GP(["x"], ["y"], noise_variance=0.2, likelihood="laplacian",
                inference="ep")
        ep.set_training_data(X, y)
        ep.setup()
        Xq = np.linspace(-2, 2, 15)[:, None]
        mu_k, _ = kl.predict(Xq)
        mu_p, _ = ep.predict(Xq)
        # two different approximations of the same posterior
        assert np.max(np.abs(mu_k - mu_p)) < 0.15


class TestRoutingAndKnobs:
    def test_vb_requires_logistic(self):
        with pytest.raises(ValueError, match="Jaakkola-Jordan"):
            GP(["x"], ["c"], likelihood="probit", inference="vb")

    def test_kl_accepts_every_likelihood(self):
        for lik in ("gaussian", "logistic", "probit", "students_t",
                    "laplacian"):
            gp = GP(["x"], ["y"], likelihood=lik, inference="kl")
            assert gp.inference == "kl"

    def test_knob_validation(self):
        with pytest.raises(ValueError, match="kl_sweeps"):
            GP(["x"], ["y"], inference="kl",
               inference_options={"kl_sweeps": 0})
        with pytest.raises(ValueError, match="kl_damping"):
            GP(["x"], ["y"], inference="kl",
               inference_options={"kl_damping": 1.5})
        with pytest.raises(ValueError, match="vb_iters"):
            GP(["x"], ["c"], likelihood="logistic", inference="vb",
               inference_options={"vb_iters": 0})

    def test_knobs_reach_inference(self):
        # a single undamped sweep must differ from the converged default
        X, y = _clusters(n=10, seed=2)
        coarse = GP(["x"], ["c"], likelihood="logistic", inference="kl",
                    inference_options={"kl_sweeps": 1})
        coarse.set_training_data(X, y)
        coarse.setup()
        full = GP(["x"], ["c"], likelihood="logistic", inference="kl")
        full.set_training_data(X, y)
        full.setup()
        assert (coarse.log_marginal_likelihood
                != pytest.approx(full.log_marginal_likelihood, abs=1e-8))

    def test_fit_improves_elbo(self):
        X, y = _clusters(n=12, seed=7)
        gp = GP(["x"], ["c"], likelihood="logistic", inference="kl")
        gp.set_training_data(X, y)
        before = gp.log_marginal_likelihood
        gp.fit_model(max_iter=15)
        assert gp.log_marginal_likelihood >= before - 1e-6

    def test_adam_fit_path(self):
        # the on-device fit (one lax.scan dispatch — the device path, no host
        # round-trips) must differentiate through the KL sweeps too
        X, y = _clusters(n=12, seed=9)
        gp = GP(["x"], ["c"], likelihood="logistic", inference="kl")
        gp.set_training_data(X, y)
        before = gp.log_marginal_likelihood
        gp.fit_model(solver="adam", max_iter=40, learning_rate=0.1)
        assert np.isfinite(gp.log_marginal_likelihood)
        assert gp.log_marginal_likelihood >= before - 1e-6
