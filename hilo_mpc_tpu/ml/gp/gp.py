"""Gaussian process regression with exact inference and hyperparameter fitting.

Batched rebuild of the reference's GaussianProcess/GPArray (reference: hilo_mpc/
modules/machine_learning/gp/gp.py:80-1008). The reference builds the posterior as
CasADi SX and fits with IPOPT or a SciPy fallback (gp.py:609-634); here the negative
log marginal likelihood is a pure JAX function over unconstrained (log-space)
hyperparameters, fitted by L-BFGS-B (scipy, gradients from jax) or Adam (optax) —
and `predict_fn()` returns a traceable function so a fitted GP embeds directly into
MPC stage costs, SMPC surrogates, and hybrid models (no symbolic substitution layer
needed).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..hyperparameters import Hyperparameter
from .inference import (ExactInference, ExpectationPropagation,
                        KullbackLeibler, Laplace, StochasticVariational,
                        VariationalBayes)
from .kernels import Kernel, SquaredExponentialKernel
from .likelihood import Gaussian, Likelihood, Logistic, Probit, StudentsT
from .means import Mean, ZeroMean


class GaussianProcess:
    def __init__(self, features: Union[str, List[str]],
                 labels: Union[str, List[str]],
                 kernel: Optional[Kernel] = None,
                 mean: Optional[Mean] = None,
                 noise_variance: float = 1.0,
                 inference: str = "exact",
                 likelihood: str = "gaussian",
                 solver: str = "scipy",
                 inference_options: Optional[dict] = None,
                 id: Optional[str] = None, name: Optional[str] = None):
        self.features = [features] if isinstance(features, str) else list(features)
        labels = [labels] if isinstance(labels, str) else list(labels)
        if len(labels) != 1:
            raise ValueError("one GP handles one output; use GPArray for "
                             "multi-output regression")
        self.labels = labels
        self.kernel = kernel if kernel is not None else SquaredExponentialKernel(
            length_scales=np.ones(len(self.features)))
        self.mean = mean if mean is not None else ZeroMean()
        # exact inference for the Gaussian likelihood; the Laplace
        # approximation for logistic/probit classification and Student's-t
        # robust regression; expectation propagation for probit
        # classification and Laplacian robust regression; variational
        # Gaussian (KL, Opper-Archambeau) for EVERY likelihood; the
        # Jaakkola-Jordan variational bound (VB) for logistic — the
        # reference declares all five inference names and implements only
        # exact (gp/inference.py:224-257, gp/likelihood.py:78-102); here
        # every declared name is real. Unknown names raise ValueError — the
        # reference factories' contract.
        inf_key = inference.lower().replace(" ", "_").replace("-", "_")
        if inf_key not in ("exact", "exactinference", "laplace",
                           "expectation_propagation", "ep",
                           "kullback_leibler", "kl",
                           "variational_bayes", "vb",
                           "fitc", "sparse", "sparse_fitc",
                           "vfe", "titsias", "sparse_vfe",
                           "svgp", "svi", "stochastic_variational",
                           "hensman"):
            raise ValueError(f"Inference {inference!r} not recognized")
        if isinstance(likelihood, Likelihood):
            # a custom instance must actually be usable: Laplace mode finding
            # differentiates log_pdf, so a base Likelihood (or a subclass that
            # forgot to override it) would only fail deep inside jax.grad
            # tracing — fail at construction instead, matching the string path
            if type(likelihood).log_pdf is Likelihood.log_pdf:
                raise ValueError(
                    f"{type(likelihood).__name__} does not override "
                    f"Likelihood.log_pdf — a likelihood instance must "
                    f"implement log_pdf(f, y, sn2)")
            if (likelihood.name == Likelihood.name
                    and type(likelihood).name is Likelihood.name):
                raise ValueError(
                    f"{type(likelihood).__name__} must set a distinct "
                    f"`name` class attribute (used to route inference "
                    f"compatibility checks)")
            self.likelihood = likelihood
        else:
            lik_key = likelihood.lower().replace(" ", "_").replace(
                "-", "_").replace("'", "")
            if lik_key in ("gaussian", "normal"):
                self.likelihood = Gaussian()
            elif lik_key == "logistic":
                self.likelihood = Logistic()
            elif lik_key == "probit":
                self.likelihood = Probit()
            elif lik_key in ("students_t", "studentst", "student_t"):
                self.likelihood = StudentsT()
            elif lik_key == "laplacian":
                from .likelihood import Laplacian

                self.likelihood = Laplacian()
            else:
                raise ValueError(f"Likelihood {likelihood!r} not recognized")
        if inf_key in ("svgp", "svi", "stochastic_variational", "hensman"):
            # uncollapsed sparse variational inference (Hensman 2013/2015) —
            # minibatch-trainable ELBO, and the one sparse path that takes
            # ANY likelihood: quadrature expectations only need log_pdf
            # (ml/gp/inference.py:StochasticVariational)
            self.inference = "svgp"
        elif inf_key in ("fitc", "sparse", "sparse_fitc",
                         "vfe", "titsias", "sparse_vfe"):
            # sparse regression (inducing points) — BEYOND the reference,
            # which has no sparse path; O(n m^2) train, m-sized predictive
            # state. 'fitc' is Snelson-Ghahramani, 'vfe' is Titsias's
            # variational bound (ml/gp/inference.py:SparseFITC,SparseVFE)
            if self.likelihood.name != "gaussian":
                raise ValueError(
                    "sparse FITC/VFE inference is Gaussian-likelihood "
                    "regression; got "
                    f"{self.likelihood.name!r} — use 'laplace'/'ep'/'kl' "
                    "for non-Gaussian likelihoods")
            self.inference = ("vfe" if inf_key in ("vfe", "titsias",
                                                   "sparse_vfe")
                              else "fitc")
        elif inf_key in ("kullback_leibler", "kl"):
            # the variational Gaussian is generic: the Gauss-Hermite
            # expectations only need log_pdf, and the Gaussian smoothing
            # handles even the Laplacian's kink (ml/gp/inference.py)
            self.inference = "kl"
        elif inf_key in ("variational_bayes", "vb"):
            if self.likelihood.name != "logistic":
                raise ValueError(
                    "variational-bayes inference is the Jaakkola-Jordan "
                    "sigmoid bound — logistic likelihood only; got "
                    f"{self.likelihood.name!r} — use inference='kl' (the "
                    "generic variational Gaussian) instead")
            self.inference = "vb"
        elif inf_key in ("expectation_propagation", "ep"):
            if self.likelihood.name not in ("probit", "laplacian"):
                raise ValueError(
                    "expectation propagation requires a likelihood with "
                    "closed-form tilted moments (probit classification, "
                    "GPML 3.6, or Laplacian robust regression); got "
                    f"{self.likelihood.name!r} — use inference='laplace' "
                    "instead")
            self.inference = "ep"
        elif inf_key == "laplace":
            if self.likelihood.name == "laplacian":
                raise ValueError(
                    "the Laplacian likelihood's log-density is piecewise "
                    "linear (zero curvature a.e.), which defeats the "
                    "Laplace approximation's Newton mode search — use "
                    "inference='ep' for Laplacian robust regression")
            self.inference = "laplace"
        else:
            if self.likelihood.name != "gaussian":
                alt = ("ep" if self.likelihood.name == "laplacian"
                       else "laplace")
                raise ValueError(
                    f"exact inference requires the Gaussian likelihood (the "
                    f"reference enforces the same, gp/inference.py:194); use "
                    f"inference='{alt}' (or the generic variational 'kl') "
                    f"for {self.likelihood.name!r}")
            self.inference = "exact"
        # approximate-inference knobs (reference style: kwargs-everywhere
        # options, SURVEY §5.6). Defaults match the class constants in
        # ml/gp/inference.py; hard problems (near-separable clusters, tiny
        # lengthscales) need more sweeps/iters or heavier damping
        inference_options = dict(inference_options or {})
        _known = {"laplace_iters", "ep_sweeps", "ep_damping",
                  "kl_sweeps", "kl_damping", "vb_iters",
                  "n_inducing", "inducing_points", "optimize_inducing",
                  "batch_size", "n_quadrature", "fit_seed"}
        unknown = set(inference_options) - _known
        if unknown:
            raise ValueError(f"unknown inference_options {sorted(unknown)}; "
                             f"valid keys: {sorted(_known)}")
        li = inference_options.get("laplace_iters")
        if li is not None and int(li) < 1:
            raise ValueError("laplace_iters must be >= 1")
        sw = inference_options.get("ep_sweeps")
        if sw is not None and int(sw) < 1:
            raise ValueError("ep_sweeps must be >= 1")
        dp = inference_options.get("ep_damping")
        if dp is not None and not 0.0 < float(dp) <= 1.0:
            raise ValueError("ep_damping must be in (0, 1]")
        ks = inference_options.get("kl_sweeps")
        if ks is not None and int(ks) < 1:
            raise ValueError("kl_sweeps must be >= 1")
        kd = inference_options.get("kl_damping")
        if kd is not None and not 0.0 < float(kd) <= 1.0:
            raise ValueError("kl_damping must be in (0, 1]")
        vi = inference_options.get("vb_iters")
        if vi is not None and int(vi) < 1:
            raise ValueError("vb_iters must be >= 1")
        ni = inference_options.get("n_inducing")
        if ni is not None and int(ni) < 1:
            raise ValueError("n_inducing must be >= 1")
        zp = inference_options.get("inducing_points")
        if zp is not None:
            zp = np.atleast_2d(np.asarray(zp, dtype=float))
            if zp.shape[1] != len(self.features):
                raise ValueError(
                    f"inducing_points must be (m, {len(self.features)}); "
                    f"got {zp.shape}")
            inference_options["inducing_points"] = zp
        oi = inference_options.get("optimize_inducing")
        if oi is not None:
            if self.inference not in ("fitc", "vfe", "svgp"):
                raise ValueError(
                    "optimize_inducing only applies to sparse inference "
                    f"('fitc'/'vfe'/'svgp'); this GP uses {self.inference!r}")
            inference_options["optimize_inducing"] = bool(oi)
        bs = inference_options.get("batch_size")
        if bs is not None:
            if self.inference != "svgp":
                raise ValueError(
                    "batch_size (minibatch ELBO training) only applies to "
                    f"inference='svgp'; this GP uses {self.inference!r} — "
                    "the collapsed bounds need the full data per step")
            if int(bs) < 1:
                raise ValueError("batch_size must be >= 1")
        nqd = inference_options.get("n_quadrature")
        if nqd is not None and int(nqd) < 1:
            raise ValueError("n_quadrature must be >= 1")
        # when optimize_inducing is on, the inducing locations become a
        # trainable hyperparameter (initialized from the training inputs in
        # set_training_data — Titsias 2009 optimizes F jointly over Z)
        self._z_hp: Optional[Hyperparameter] = None
        # SVGP variational parameters (whitened mean mv and raw Cholesky
        # Lraw) — ordinary Hyperparameters, seeded in set_training_data
        # once m is known, so the generic pack/unpack fit paths train them
        # jointly with the kernel hyperparameters
        self._svgp_mv: Optional[Hyperparameter] = None
        self._svgp_lraw: Optional[Hyperparameter] = None
        self.inference_options = inference_options
        self.noise_variance = Hyperparameter("GP.noise_variance",
                                             value=noise_variance, positive=True)
        if not self.likelihood.uses_noise:
            # logistic classification has no observation-noise parameter:
            # exclude it from fitting so the optimizer cannot wander it
            self.noise_variance.fixed = True
        self.solver = solver
        self.name = name or "gp"
        self.X_train: Optional[np.ndarray] = None   # (n, d)
        self.y_train: Optional[np.ndarray] = None   # (n,)
        self._state = None   # (L, alpha) posterior cache
        self._setup_done = False

    # -- data ----------------------------------------------------------------
    def set_training_data(self, X, y):
        if self._setup_done:
            import warnings
            warnings.warn(
                "Gaussian process was already executed. Use the fit_model() "
                "method again to optimize with respect to the newly set "
                "training data.")
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        d = len(self.features)
        if X.ndim == 1:
            X = X[:, None] if d == 1 else X[None, :]
        # accept the reference's (d, n) column layout as well as (n, d)
        if X.shape[1] != d and X.shape[0] == d:
            X = X.T
        if X.shape[1] != d:
            raise ValueError(f"X has {X.shape[1]} features, expected {d}")
        y = y.ravel()
        if y.size != X.shape[0]:
            raise ValueError(f"{X.shape[0]} samples but {y.size} labels")
        if self.likelihood.name in ("logistic", "probit"):
            # classification labels: accept {0, 1} or {-1, +1}, store {-1, +1}
            vals = set(np.unique(y).tolist())
            if vals <= {0.0, 1.0}:
                y = 2.0 * y - 1.0
            elif not vals <= {-1.0, 1.0}:
                raise ValueError(
                    f"{self.likelihood.name} likelihood needs binary labels "
                    f"in {{0,1}} or {{-1,+1}}, got values {sorted(vals)[:5]}")
        self.X_train, self.y_train = X, y
        if self.inference == "svgp":
            # (re)seed the whitened variational distribution at the prior:
            # mv = 0, Lraw = 0 -> Lv = I, i.e. q(v) = N(0, I), ELBO's KL
            # term exactly zero at init
            m = int(np.asarray(self._subset_inducing(X)).shape[0])
            self._svgp_mv = Hyperparameter(
                "GP.svgp_mv", value=np.zeros(m), positive=False)
            self._svgp_lraw = Hyperparameter(
                "GP.svgp_Lraw", value=np.zeros((m, m)), positive=False)
        if self.inference_options.get("optimize_inducing"):
            # (re)seed the trainable inducing set from the data: explicit
            # points when given, else the deterministic strided subset —
            # the optimizer then moves Z freely (continuous locations)
            z0 = np.asarray(self._subset_inducing(X))
            self._z_hp = Hyperparameter(
                "GP.inducing_points", value=z0, positive=False)
        self._state = None
        return self

    @property
    def n_samples(self):
        return 0 if self.X_train is None else self.X_train.shape[0]

    # -- hyperparameters ------------------------------------------------------
    @property
    def hyperparameters(self) -> List[Hyperparameter]:
        hps = (self.kernel.hyperparameters + self.mean.hyperparameters
               + [self.noise_variance])
        if getattr(self, "_z_hp", None) is not None:
            hps = hps + [self._z_hp]
        if getattr(self, "_svgp_mv", None) is not None:
            hps = hps + [self._svgp_mv, self._svgp_lraw]
        return hps

    def _params(self) -> Dict[str, jnp.ndarray]:
        return {hp.key: (jnp.squeeze(jnp.asarray(hp.value)) if hp.size == 1
                          else jnp.asarray(hp.value))
                for hp in self.hyperparameters}

    def _pack(self):
        """Trainable hyperparameters -> flat unconstrained vector + bounds."""
        w0, specs, bounds = [], [], []
        for hp in self.hyperparameters:
            if hp.fixed:
                continue
            w = hp.to_unconstrained().ravel()
            specs.append((hp, len(w)))
            w0.append(w)
            if hp.bounds is not None:
                lb, ub = hp.bounds
                lb = np.log(lb) if hp.positive else lb
                ub = np.log(ub) if hp.positive else ub
                bounds += [(lb, ub)] * len(w)
            elif hp.positive:
                # keep log-space parameters representable: exp(-35) underflows to
                # exactly 0.0 and would violate positivity when written back
                bounds += [(-30.0, 30.0)] * len(w)
            else:
                bounds += [(None, None)] * len(w)
        return (np.concatenate(w0) if w0 else np.zeros(0)), specs, bounds

    def _unpack(self, w, specs):
        params = self._params()
        off = 0
        for hp, n in specs:
            val = w[off:off + n]
            off += n
            val = jnp.exp(val) if hp.positive else val
            params[hp.key] = (jnp.squeeze(val) if hp.size == 1
                               else val.reshape(np.shape(hp.value)))
        return params

    def _subset_inducing(self, X):
        """The seed inducing set: explicit `inducing_points` when given,
        else an evenly strided subset of the training data (subset-of-data
        — deterministic, and with stride 1 the approximation IS exact).
        Static indices, so this traces/vmaps."""
        zp = self.inference_options.get("inducing_points")
        if zp is not None:
            return jnp.asarray(zp)
        n = X.shape[0]
        m = min(int(self.inference_options.get("n_inducing", 64)), n)
        idx = np.unique(np.linspace(0, n - 1, m).round().astype(int))
        return X[jnp.asarray(idx)]

    def _inducing(self, X, params=None):
        """The sparse inducing set actually in effect: the trainable
        `optimize_inducing` locations when enabled (from `params` inside
        traced fit objectives so gradients flow into Z; from the fitted
        hyperparameter value otherwise), else the fixed seed subset."""
        zhp = getattr(self, "_z_hp", None)
        if zhp is not None:
            if params is not None and zhp.key in params:
                return jnp.asarray(params[zhp.key])
            return jnp.asarray(zhp.value)
        return self._subset_inducing(X)

    # -- objective -------------------------------------------------------------
    def _lml(self, params, X, y):
        """Log marginal likelihood (or its variational lower bound) of the
        data (X, y) under `params`, dispatched on this GP's inference —
        pure in (params, X, y), so it vmaps across a GPArray
        (fit_model_batched) as well as serving _nll."""
        # the stored value acts as a standard deviation, like the reference
        # (inference.py:199 exp(2*log_noise))
        sn2 = jnp.squeeze(params[self.noise_variance.key]) ** 2
        if self.inference == "laplace":
            lml = Laplace.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y, sn2, self.likelihood,
                iters=self.inference_options.get("laplace_iters"))
        elif self.inference == "ep":
            lml = ExpectationPropagation.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y,
                sweeps=self.inference_options.get("ep_sweeps"),
                damping=self.inference_options.get("ep_damping"),
                likelihood=self.likelihood, sn2=sn2)
        elif self.inference == "kl":
            # the ELBO — a true lower bound on log Z, the standard
            # variational fitting objective
            lml = KullbackLeibler.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y, sn2, self.likelihood,
                sweeps=self.inference_options.get("kl_sweeps"),
                damping=self.inference_options.get("kl_damping"))
        elif self.inference == "vb":
            lml = VariationalBayes.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y,
                iters=self.inference_options.get("vb_iters"))
        elif self.inference in ("fitc", "vfe"):
            from .inference import SparseFITC, SparseVFE

            inf = SparseVFE if self.inference == "vfe" else SparseFITC
            lml = inf.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y,
                self._inducing(X, params), sn2)
        elif self.inference == "svgp":
            # the FULL-BATCH ELBO — a true lower bound on the exact LML
            # (generic fit paths maximize it over hyperparameters AND the
            # variational parameters, which ride along in `params`)
            lml = StochasticVariational.elbo(
                self.kernel, self.mean, params, X, y,
                self._inducing(X, params), sn2, self.likelihood,
                params[self._svgp_mv.key], params[self._svgp_lraw.key],
                n_quad=self.inference_options.get("n_quadrature"))
        else:
            lml = ExactInference.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y, sn2)
        return lml

    def _nll(self, params):
        lml = self._lml(params, jnp.asarray(self.X_train),
                        jnp.asarray(self.y_train))
        logp = 0.0
        for hp in self.hyperparameters:
            if hp.prior is not None:
                logp = logp + hp.log_prior(params[hp.key])
        return -(lml + logp)

    @property
    def log_marginal_likelihood(self) -> float:
        return float(-self._nll(self._params()))

    # -- setup / fit -----------------------------------------------------------
    def setup(self):
        if self.X_train is None:
            raise RuntimeError("call set_training_data(X, y) first")
        self._refresh_state()
        self._setup_done = True
        return self

    def _refresh_state(self):
        params = self._params()
        sn2 = float(np.squeeze(self.noise_variance.value)) ** 2
        if self.inference == "laplace":
            # mode finding runs once per fit, eagerly (x64 when enabled);
            # predictions stay fully traced/jittable via the stored state
            f_hat, g, sW, L, _ = Laplace.mode_state(
                self.kernel, self.mean, params, jnp.asarray(self.X_train),
                jnp.asarray(self.y_train), sn2, self.likelihood,
                iters=self.inference_options.get("laplace_iters"))
            self._state = ("laplace", np.asarray(g), np.asarray(sW),
                           np.asarray(L))
            return
        if self.inference == "ep":
            w, stt, L, _ = ExpectationPropagation.site_state(
                self.kernel, self.mean, params, jnp.asarray(self.X_train),
                jnp.asarray(self.y_train),
                sweeps=self.inference_options.get("ep_sweeps"),
                damping=self.inference_options.get("ep_damping"),
                likelihood=self.likelihood, sn2=sn2)
            self._state = ("ep", np.asarray(w), np.asarray(stt),
                           np.asarray(L))
            return
        if self.inference == "kl":
            nu, sl, L, _ = KullbackLeibler.variational_state(
                self.kernel, self.mean, params, jnp.asarray(self.X_train),
                jnp.asarray(self.y_train), sn2, self.likelihood,
                sweeps=self.inference_options.get("kl_sweeps"),
                damping=self.inference_options.get("kl_damping"))
            self._state = ("kl", np.asarray(nu), np.asarray(sl),
                           np.asarray(L))
            return
        if self.inference == "vb":
            nu, sA, L, _ = VariationalBayes.bound_state(
                self.kernel, self.mean, params, jnp.asarray(self.X_train),
                jnp.asarray(self.y_train),
                iters=self.inference_options.get("vb_iters"))
            self._state = ("vb", np.asarray(nu), np.asarray(sA),
                           np.asarray(L))
            return
        if self.inference == "svgp":
            X = jnp.asarray(self.X_train)
            Z = self._inducing(X)
            Luu, mv, Lv = StochasticVariational.state(
                self.kernel, self.mean, params, Z,
                params[self._svgp_mv.key], params[self._svgp_lraw.key])
            self._state = ("svgp", np.asarray(Z), np.asarray(Luu),
                           np.asarray(mv), np.asarray(Lv))
            return
        if self.inference in ("fitc", "vfe"):
            from .inference import SparseFITC, SparseVFE

            X = jnp.asarray(self.X_train)
            Z = self._inducing(X)
            inf = SparseVFE if self.inference == "vfe" else SparseFITC
            Luu, La, beta, _ = inf.state(
                self.kernel, self.mean, params, X,
                jnp.asarray(self.y_train), Z, sn2)
            # one "sparse" state tag: the predictive algebra is identical
            # for FITC and VFE (SparseFITC.predict consumes Luu/La/beta)
            self._state = ("fitc", np.asarray(Luu), np.asarray(La),
                           np.asarray(beta), np.asarray(Z))
            return
        # evaluate the gram with the accelerator (cheap, well-conditioned) but
        # FACTORIZE on the host in float64: with small noise the system is
        # condition ~1/(sn2+jitter) and f32 (worse: TF32 or bf16) factorizations
        # give backend-dependent garbage for L/alpha. This runs once per fit,
        # eagerly — predictions stay fully traced/jittable via the stored state.
        X = jnp.asarray(self.X_train)
        K = np.asarray(self.kernel.gram(params, X), dtype=np.float64)
        n = K.shape[0]
        m = np.asarray(
            jax.vmap(lambda a: self.mean.eval(params, a))(X), dtype=np.float64)
        resid = np.asarray(self.y_train, dtype=np.float64) - m
        for jitter in (1e-10, 1e-8, 1e-6, 1e-4, 1e-2):
            try:
                Kj = K + (sn2 + jitter * float(np.mean(np.diagonal(K)))) * np.eye(n)
                L = np.linalg.cholesky(Kj)
                break
            except np.linalg.LinAlgError:
                continue
        else:
            raise RuntimeError("GP gram matrix is not factorizable")
        import scipy.linalg as _sla
        alpha = _sla.cho_solve((L, True), resid)
        self._state = (L, alpha)

    def is_setup(self):
        return self._setup_done

    def fit_model(self, solver: Optional[str] = None, max_iter: int = 200,
                  learning_rate: float = 5e-2):
        """Maximize the (prior-weighted) log marginal likelihood."""
        if self.X_train is None:
            raise RuntimeError("call set_training_data(X, y) first")
        solver = solver or self.solver
        w0, specs, bounds = self._pack()
        if w0.size == 0:
            self._refresh_state()
            return self

        bs = (self.inference_options.get("batch_size")
              if self.inference == "svgp" else None)
        if bs is not None and int(bs) < self.n_samples:
            # minibatch SVGP training (Hensman 2013): unbiased ELBO
            # gradients from random subsamples, the whole optimization one
            # lax.scan device dispatch. L-BFGS is wrong for a stochastic
            # objective, so batch_size always routes here regardless of
            # `solver` — full-batch SVGP still uses the generic paths below.
            import optax

            b = int(bs)
            n = self.n_samples
            X = jnp.asarray(self.X_train)
            y = jnp.asarray(self.y_train)
            n_quad = self.inference_options.get("n_quadrature")
            seed = int(self.inference_options.get("fit_seed", 0))
            tx = optax.adam(learning_rate)

            def nll_batch(w, idx):
                params = self._unpack(w, specs)
                sn2 = jnp.squeeze(params[self.noise_variance.key]) ** 2
                elbo = StochasticVariational.elbo(
                    self.kernel, self.mean, params, X[idx], y[idx],
                    self._inducing(X, params), sn2, self.likelihood,
                    params[self._svgp_mv.key], params[self._svgp_lraw.key],
                    n_total=n, n_quad=n_quad)
                logp = 0.0
                for hp in self.hyperparameters:
                    if hp.prior is not None:
                        logp = logp + hp.log_prior(params[hp.key])
                return -(elbo + logp)

            def fit(w0_):
                state0 = tx.init(w0_)

                def step(carry, k):
                    w, state = carry
                    idx = jax.random.choice(k, n, (b,), replace=False)
                    g = jax.grad(nll_batch)(w, idx)
                    updates, state = tx.update(g, state)
                    return (optax.apply_updates(w, updates), state), None

                keys = jax.random.split(jax.random.PRNGKey(seed), max_iter)
                (w, _), _ = jax.lax.scan(step, (w0_, state0), keys)
                return w

            w_best = np.asarray(jax.jit(fit)(jnp.asarray(w0)))
            params = self._unpack(jnp.asarray(w_best), specs)
            for hp, _ in specs:
                hp.value = np.asarray(params[hp.key])
            self._refresh_state()
            self._setup_done = True
            return self

        obj = jax.jit(lambda w: self._nll(self._unpack(w, specs)))
        grad = jax.jit(jax.grad(lambda w: self._nll(self._unpack(w, specs))))

        if solver in ("scipy", "lbfgs", "ipopt"):
            # 'ipopt' maps to L-BFGS-B: same quasi-Newton accuracy class, and the
            # reference itself falls back to SciPy (util/optimizer.py:145)
            from scipy.optimize import minimize

            # NaN-guard: a trial step can push hyperparameters where the
            # Cholesky fails; report a huge objective (and zero gradient)
            # there so the line search backtracks instead of aborting
            def f_np(w):
                v = float(np.asarray(obj(jnp.asarray(w))))
                return v if np.isfinite(v) else 1e12

            def g_np(w):
                g = np.asarray(grad(jnp.asarray(w)), dtype=float)
                return np.nan_to_num(g, nan=0.0, posinf=1e6, neginf=-1e6)

            res = minimize(f_np, w0, jac=g_np, method="L-BFGS-B",
                           bounds=bounds, options={"maxiter": max_iter})
            w_best = res.x
        elif solver == "adam":
            # whole optimization as ONE device dispatch (lax.scan over steps) —
            # a Python-loop fit pays a host round-trip per step
            import optax

            tx = optax.adam(learning_rate)

            def fit(w0_):
                state0 = tx.init(w0_)

                def step(carry, _):
                    w, state = carry
                    g = jax.grad(lambda ww: self._nll(self._unpack(ww, specs)))(w)
                    updates, state = tx.update(g, state)
                    return (optax.apply_updates(w, updates), state), None

                (w, _), _ = jax.lax.scan(step, (w0_, state0), None,
                                         length=max_iter)
                return w

            w_best = np.asarray(jax.jit(fit)(jnp.asarray(w0)))
        else:
            raise ValueError(f"unknown solver {solver!r} (scipy | adam)")

        params = self._unpack(jnp.asarray(w_best), specs)
        for hp, _ in specs:
            hp.value = np.asarray(params[hp.key])
        self._refresh_state()
        self._setup_done = True
        return self

    # -- prediction -------------------------------------------------------------
    def predict_fn(self, include_noise: bool = False):
        """Pure (mu, var) = f(x) for a single query point — traceable, so it can be
        called inside jitted MPC graphs (the analogue of the reference's symbolic
        predict, gp.py:699-718)."""
        if self._state is None:
            self._refresh_state()
        params = self._params()
        X = jnp.asarray(self.X_train)
        sn2 = float(np.squeeze(self.noise_variance.value)) ** 2
        kernel, mean = self.kernel, self.mean
        if isinstance(self._state[0], str) and self._state[0] == "svgp":
            _, Z, Luu, mv, Lv = self._state

            def fn(x_star):
                x_star = jnp.atleast_1d(x_star)
                mu, var = StochasticVariational.predict(
                    kernel, mean, params, jnp.asarray(Z), jnp.asarray(Luu),
                    jnp.asarray(mv), jnp.asarray(Lv), x_star)
                if include_noise and self.likelihood.uses_noise:
                    var = var + self.likelihood.noise_pred_variance(sn2)
                return mu, var

            return fn
        if isinstance(self._state[0], str) and self._state[0] == "fitc":
            _, Luu, La, beta, Z = self._state

            def fn(x_star):
                from .inference import SparseFITC

                x_star = jnp.atleast_1d(x_star)
                return SparseFITC.predict(
                    kernel, mean, params, jnp.asarray(Z), jnp.asarray(Luu),
                    jnp.asarray(La), jnp.asarray(beta), x_star, sn2,
                    include_noise=include_noise)

            return fn
        if isinstance(self._state[0], str) and self._state[0] in (
                "laplace", "kl", "vb"):
            # KL and VB carry the SAME predictive state layout as Laplace:
            # (nu = K^{-1}(mu_q - m), sqrt(Lambda), chol(I + sL K sL))
            _, g, sW, L = self._state

            def fn(x_star):
                x_star = jnp.atleast_1d(x_star)
                mu, var = Laplace.predict(
                    kernel, mean, params, X, jnp.asarray(g), jnp.asarray(sW),
                    jnp.asarray(L), x_star)
                if include_noise and self.likelihood.uses_noise:
                    # the likelihood's actual noise second moment — sn2 for
                    # Gaussian, sn2*df/(df-2) for Student's-t (plain sn2
                    # would understate heavy-tailed noise ~2x at df=4)
                    var = var + self.likelihood.noise_pred_variance(sn2)
                return mu, var

            return fn
        if isinstance(self._state[0], str) and self._state[0] == "ep":
            _, w, stt, L = self._state

            def fn(x_star):
                x_star = jnp.atleast_1d(x_star)
                mu, var = ExpectationPropagation.predict(
                    kernel, mean, params, X, jnp.asarray(w), jnp.asarray(stt),
                    jnp.asarray(L), x_star)
                # mirrors the Laplace branch; a no-op while EP is probit-only
                # (uses_noise=False), but keeps include_noise honest if EP
                # ever gains a noise-bearing likelihood
                if include_noise and self.likelihood.uses_noise:
                    var = var + self.likelihood.noise_pred_variance(sn2)
                return mu, var

            return fn
        L, alpha = self._state

        def fn(x_star):
            x_star = jnp.atleast_1d(x_star)
            return ExactInference.predict(
                kernel, mean, params, X, jnp.asarray(L), jnp.asarray(alpha),
                x_star, sn2, include_noise=include_noise)

        return fn

    def predict(self, X_query, include_noise: bool = False):
        """Numeric batch prediction: returns (means, variances)."""
        fn = self.predict_fn(include_noise=include_noise)
        Xq = np.asarray(X_query, dtype=float)
        d = len(self.features)
        if Xq.ndim == 1:
            Xq = Xq[:, None] if d == 1 else Xq[None, :]
        if Xq.shape[1] != d and Xq.shape[0] == d:
            Xq = Xq.T
        mu, var = jax.vmap(fn)(jnp.asarray(Xq))
        return np.asarray(mu), np.asarray(var)

    def predict_proba(self, X_query):
        """p(y = +1 | x) for classification GPs. Probit likelihood: the
        predictive integral is EXACT, pi* = Phi(mu / sqrt(1 + sigma_f^2))
        (GPML eq. 3.80). Logistic likelihood: the probit approximation
        pi* ~= sigma(mu / sqrt(1 + pi sigma_f^2 / 8))."""
        if self.likelihood.name not in ("logistic", "probit"):
            raise RuntimeError(
                "predict_proba requires a classification likelihood "
                f"(logistic or probit; this GP uses {self.likelihood.name!r})")
        mu, var = self.predict(X_query)
        if self.likelihood.name == "probit":
            from scipy.stats import norm

            return norm.cdf(mu / np.sqrt(1.0 + var))
        from scipy.special import expit

        return expit(mu / np.sqrt(1.0 + np.pi * var / 8.0))

    def predict_quantiles(self, X_query, quantiles=(0.025, 0.975)):
        """Predictive quantiles with observation noise included.

        Gaussian quantiles of the (moment-matched) predictive distribution:
        exact for the Gaussian likelihood; for non-Gaussian likelihoods the
        noise contribution uses the likelihood's actual second moment
        (e.g. sn2*df/(df-2) for Student's-t) but the interval SHAPE remains
        the Gaussian approximation — heavy tails beyond the variance are
        not represented."""
        from scipy.stats import norm

        mu, var = self.predict(X_query, include_noise=True)
        std = np.sqrt(var)
        return [mu + norm.ppf(q) * std for q in quantiles]

    def __repr__(self):
        return (f"GaussianProcess(features={self.features}, labels={self.labels}, "
                f"kernel={self.kernel!r}, n={self.n_samples})")


class GPArray:
    """Array of independent single-output GPs (reference: gp.py:974-1008)."""

    def __init__(self, n_gps: int):
        if n_gps < 1:
            raise ValueError("n_gps must be >= 1")
        self._gps: List[Optional[GaussianProcess]] = [None] * int(n_gps)

    def __len__(self):
        return len(self._gps)

    def __getitem__(self, i):
        return self._gps[i]

    def __setitem__(self, i, gp):
        if not isinstance(gp, GaussianProcess):
            raise TypeError("GPArray elements must be GaussianProcess instances")
        self._gps[i] = gp

    def __iter__(self):
        return iter(self._gps)

    def setup(self):
        for gp in self._gps:
            gp.setup()
        return self

    def fit_model(self, **kwargs):
        for gp in self._gps:
            gp.fit_model(**kwargs)
        return self

    def fit_model_batched(self, max_iter: int = 200, learning_rate: float = 5e-2,
                          solver: str = "lbfgs"):
        """Fit ALL output GPs in ONE jitted, vmapped on-device optimization.

        The reference fits each output's hyperparameters with a separate
        host-side IPOPT/SciPy run (reference: gp/gp.py:609-641, GPArray loops
        gp.py:974-1008); here the whole array trains as a single device
        dispatch — `vmap` over outputs of an L-BFGS (optax.lbfgs, with its
        zoom linesearch) or Adam scan on the negative log marginal
        likelihood. This is the SMPC/hybrid workflow path: one jit trains 8+
        output GPs (or scenario-stacked datasets) without a host round-trip
        per iteration.

        Requires all GPs to share the hyperparameter structure (same kernel/
        mean families — the values stay per-GP) and training-set shape.
        """
        import jax
        import jax.numpy as jnp
        import optax

        gps = [gp for gp in self._gps]
        if any(gp is None for gp in gps):
            raise RuntimeError("assign every GPArray slot before fitting")
        if any(gp.X_train is None for gp in gps):
            raise RuntimeError("call set_training_data on every GP first")
        gp0 = gps[0]
        # any inference vmaps (every method is a pure scan/Cholesky graph in
        # (params, X, y)), but it must be the SAME configuration across the
        # array — one traced objective serves all outputs
        for gp in gps:
            if gp.inference != gp0.inference:
                raise ValueError(
                    "fit_model_batched needs the same inference across the "
                    f"array (got {gp.inference!r} vs {gp0.inference!r})")
            va, vb = vars(gp.likelihood), vars(gp0.likelihood)
            # per-attribute np.array_equal: plain dict equality compares
            # values with ==, which is ambiguous for array-valued
            # attributes on custom Likelihood subclasses
            same_lik = (type(gp.likelihood) is type(gp0.likelihood)
                        and va.keys() == vb.keys()
                        and all(np.array_equal(va[k], vb[k]) for k in va))
            if not same_lik:
                raise ValueError(
                    "fit_model_batched needs an identical likelihood "
                    "configuration across the array")
            oa, ob = gp.inference_options, gp0.inference_options
            # per-key np.array_equal for the same reason: explicit
            # `inducing_points` are arrays, and dict == on array values
            # raises ambiguous-truth-value
            same_opts = (oa.keys() == ob.keys()
                         and all(np.array_equal(oa[k], ob[k]) for k in oa))
            if not same_opts:
                raise ValueError(
                    "fit_model_batched needs identical inference_options "
                    "across the array")
        packs = [gp._pack() for gp in gps]
        w0s, specs0, bounds0 = packs[0]
        sig0 = [(hp.name, n) for hp, n in specs0]
        fixed0 = [hp for hp in gp0.hyperparameters if hp.fixed]
        fsig0 = [(hp.name, hp.size) for hp in fixed0]
        for gp, (w, specs, _) in zip(gps, packs):
            if [(hp.name, n) for hp, n in specs] != sig0:
                raise ValueError(
                    "fit_model_batched needs identical hyperparameter "
                    "structure across the array (same kernel/mean families)")
            fixed_i = [hp for hp in gp.hyperparameters if hp.fixed]
            if [(hp.name, hp.size) for hp in fixed_i] != fsig0:
                raise ValueError(
                    "fit_model_batched needs the same FIXED hyperparameter "
                    "structure across the array")
            # priors enter the objective as host-side python closures of gp0's
            # hyperparameters — they cannot vary per output inside one jit
            for hp_a, hp_b in zip(gp0.hyperparameters, gp.hyperparameters):
                pa, pb = hp_a.prior, hp_b.prior
                same = (pa is None) == (pb is None) and (
                    pa is None or (type(pa) is type(pb)
                                   and vars(pa) == vars(pb)))
                if not same:
                    raise ValueError(
                        f"fit_model_batched needs identical priors across "
                        f"the array ({hp_a.name} differs); use fit_model() "
                        f"per GP for heterogeneous priors")
            if gp.X_train.shape != gp0.X_train.shape:
                raise ValueError("fit_model_batched needs equal training-set "
                                 "shapes across the array")
        if w0s.size == 0:
            for gp in gps:
                gp._refresh_state()
                gp._setup_done = True
            return self

        W0 = jnp.asarray(np.stack([w for w, _, _ in packs]))
        Xs = jnp.asarray(np.stack([np.asarray(gp.X_train) for gp in gps]))
        ys = jnp.asarray(np.stack([np.asarray(gp.y_train) for gp in gps]))
        prior_hps = [hp for hp in gp0.hyperparameters if hp.prior is not None]
        # per-GP FIXED values, stacked over the array and routed through the
        # vmap so every output is fitted against its OWN fixed parameters
        # (not gp0's)
        fixed_stacks = tuple(
            jnp.asarray(np.stack([
                np.atleast_1d(np.asarray(
                    [h for h in gp.hyperparameters if h.fixed][j].value))
                for gp in gps]))
            for j in range(len(fixed0)))
        # per-GP bounds in the unconstrained space (finding: the host
        # fit_model enforces these via L-BFGS-B; enforce them here by
        # projection after every update)
        lb_ub = []
        for gp, (_, _, bnds) in zip(gps, packs):
            lb = np.array([-np.inf if b[0] is None else b[0] for b in bnds])
            ub = np.array([np.inf if b[1] is None else b[1] for b in bnds])
            lb_ub.append((lb, ub))
        LB = jnp.asarray(np.stack([l for l, _ in lb_ub]))
        UB = jnp.asarray(np.stack([u for _, u in lb_ub]))

        def nll(w, X, y, fixed_vals):
            params = gp0._unpack(w, specs0)
            for hp, val in zip(fixed0, fixed_vals):
                params[hp.key] = (jnp.squeeze(val) if hp.size == 1
                                  else val.reshape(np.shape(hp.value)))
            lml = gp0._lml(params, X, y)
            logp = 0.0
            for hp in prior_hps:
                logp = logp + hp.log_prior(params[hp.key])
            v = -(lml + logp)
            # NaN guard: a failed Cholesky during a trial step must read as a
            # huge value so the linesearch backtracks instead of poisoning w
            return jnp.where(jnp.isfinite(v), v, 1e12)

        if solver == "lbfgs":
            opt = optax.lbfgs(learning_rate=None)

            def fit_one(w0, X, y, fixed_vals, lb, ub):
                fun = lambda w: nll(w, X, y, fixed_vals)
                vag = optax.value_and_grad_from_state(fun)

                def step(carry, _):
                    w, state = carry
                    value, grad = vag(w, state=state)
                    updates, state = opt.update(
                        grad, state, w, value=value, grad=grad, value_fn=fun)
                    w = jnp.clip(optax.apply_updates(w, updates), lb, ub)
                    return (w, state), value

                (w, _), vals = jax.lax.scan(step, (w0, opt.init(w0)), None,
                                            length=max_iter)
                return w, vals[-1]
        elif solver == "adam":
            opt = optax.adam(learning_rate)

            def fit_one(w0, X, y, fixed_vals, lb, ub):
                fun = lambda w: nll(w, X, y, fixed_vals)

                def step(carry, _):
                    w, state = carry
                    value, grad = jax.value_and_grad(fun)(w)
                    updates, state = opt.update(grad, state)
                    w = jnp.clip(optax.apply_updates(w, updates), lb, ub)
                    return (w, state), value

                (w, _), vals = jax.lax.scan(step, (w0, opt.init(w0)), None,
                                            length=max_iter)
                return w, vals[-1]
        else:
            raise ValueError(f"unknown solver {solver!r} (lbfgs | adam)")

        W, finals = jax.jit(jax.vmap(fit_one))(W0, Xs, ys, fixed_stacks,
                                               LB, UB)
        W = np.asarray(W)
        for i, (gp, (_, specs, _)) in enumerate(zip(gps, packs)):
            params = gp._unpack(jnp.asarray(W[i]), specs)
            for hp, _n in specs:
                hp.value = np.asarray(params[hp.key])
            gp._refresh_state()
            gp._setup_done = True
        self.last_fit_nll = np.asarray(finals)
        return self

    def predict(self, X_query, **kwargs):
        out = [gp.predict(X_query, **kwargs) for gp in self._gps]
        means = np.stack([m for m, _ in out], axis=-1)
        variances = np.stack([v for _, v in out], axis=-1)
        return means, variances
