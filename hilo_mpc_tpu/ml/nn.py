"""Feedforward neural networks that embed into control problems.

Rebuild of the reference's ANN stack (reference: hilo_mpc/modules/machine_learning/
nn/nn.py:40-570, nn/layer.py:29-358). The reference trains through PyTorch/TensorFlow
plugin wrappers and then bakes the weights into a CasADi graph
(util/machine_learning.py:521-578 net_to_casadi_graph); here the network *is* a pure
JAX function from the start — training runs natively with optax (minibatch Adam, early
stopping, train/val/test split like plugins/pytorch/wrapper.py), and `predict_fn()` is
directly traceable into Model/NMPC graphs, so there is no export step at all.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": jax.nn.relu,
    "sigmoid": jax.nn.sigmoid,
    "tanh": jnp.tanh,
    "softplus": jax.nn.softplus,
    "softmax": jax.nn.softmax,
    "elu": jax.nn.elu,
    "gelu": jax.nn.gelu,
    "swish": jax.nn.swish,
    "leakyrelu": jax.nn.leaky_relu,
}

_LOSSES = {
    "mse": lambda pred, y: jnp.mean((pred - y) ** 2),
    "mae": lambda pred, y: jnp.mean(jnp.abs(pred - y)),
    "huber": lambda pred, y: jnp.mean(
        jnp.where(jnp.abs(pred - y) < 1.0, 0.5 * (pred - y) ** 2,
                  jnp.abs(pred - y) - 0.5)),
    "rmse": lambda pred, y: jnp.sqrt(jnp.mean((pred - y) ** 2) + 1e-12),
    "msle": lambda pred, y: jnp.mean(
        (jnp.log1p(jnp.maximum(pred, -1 + 1e-6))
         - jnp.log1p(jnp.maximum(y, -1 + 1e-6))) ** 2),
    "mape": lambda pred, y: jnp.mean(jnp.abs((y - pred) / (jnp.abs(y) + 1e-8))),
    "logcosh": lambda pred, y: jnp.mean(
        jnp.log(jnp.cosh(jnp.clip(pred - y, -30.0, 30.0)))),
}


@dataclasses.dataclass
class Layer:
    """Layer spec (reference: nn/layer.py:29 — Layer.dense / Layer.dropout)."""

    kind: str
    units: int = 0
    activation: str = "linear"
    rate: float = 0.0

    @staticmethod
    def dense(units: int, activation: str = "linear") -> "Layer":
        act = activation.lower()
        if act not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; "
                             f"available: {sorted(_ACTIVATIONS)}")
        if units < 1:
            raise ValueError("units must be >= 1")
        return Layer(kind="dense", units=int(units), activation=act)

    @staticmethod
    def dropout(rate: float = 0.5) -> "Layer":
        if not 0 <= rate < 1:
            raise ValueError("dropout rate must be in [0, 1)")
        return Layer(kind="dropout", rate=float(rate))


def Dense(units: int, activation: str = "linear") -> Layer:
    return Layer.dense(units, activation)


def Dropout(rate: float = 0.5) -> Layer:
    return Layer.dropout(rate)


class ArtificialNeuralNetwork:
    """MLP with named input/output features (reference: nn/nn.py:40)."""

    def __init__(self, features=None, labels=None, id: Optional[str] = None,
                 name: Optional[str] = None, seed: int = 0):
        self.name = name or "ann"
        self._layers: List[Layer] = []
        self.features: List[str] = ([features] if isinstance(features, str)
                                    else list(features or []))
        self.labels: List[str] = ([labels] if isinstance(labels, str)
                                  else list(labels or []))
        self._data_set = None
        self._params = None
        self._seed = seed
        self._scaler_mean: Optional[np.ndarray] = None
        self._scaler_scale: Optional[np.ndarray] = None
        self._label_mean: Optional[np.ndarray] = None
        self._label_scale: Optional[np.ndarray] = None
        self._setup_done = False
        self.history: dict = {}

    # -- declaration ----------------------------------------------------------
    def add_layers(self, *layers: Union[Layer, Sequence[Layer]]):
        """Append layers: a single Layer, a sequence, or several as varargs."""
        for entry in layers:
            if isinstance(entry, Layer):
                self._layers.append(entry)
            else:
                self._layers.extend(entry)
        return self

    def set_features(self, names):
        self.features = [names] if isinstance(names, str) else list(names)
        return self

    def set_labels(self, names):
        self.labels = [names] if isinstance(names, str) else list(names)
        return self

    @property
    def n_inputs(self):
        return len(self.features)

    @property
    def n_outputs(self):
        return len(self.labels)

    # -- build ------------------------------------------------------------------
    def setup(self, normalize: bool = True, **kwargs):
        if not self.features or not self.labels:
            raise RuntimeError("set_features(...) and set_labels(...) first")
        if not any(l.kind == "dense" for l in self._layers):
            raise RuntimeError("add at least one dense layer (add_layers)")
        dims = [self.n_inputs]
        for layer in self._layers:
            if layer.kind == "dense":
                dims.append(layer.units)
        dims.append(self.n_outputs)
        key = jax.random.PRNGKey(self._seed)
        params = []
        for i in range(len(dims) - 1):
            key, k1 = jax.random.split(key)
            fan_in = dims[i]
            W = jax.random.normal(k1, (dims[i], dims[i + 1])) * np.sqrt(2.0 / fan_in)
            b = jnp.zeros(dims[i + 1])
            params.append({"W": W, "b": b})
        self._params = params
        self._normalize = normalize
        self._setup_done = True
        return self

    def is_setup(self):
        return self._setup_done

    def _apply(self, params, x, *, train: bool = False, key=None):
        h = x
        if self._scaler_mean is not None:
            h = (h - jnp.asarray(self._scaler_mean,
                                 h.dtype)) / jnp.asarray(self._scaler_scale, h.dtype)
        li = 0
        for layer in self._layers:
            if layer.kind == "dense":
                p = params[li]
                h = _ACTIVATIONS[layer.activation](
                    h @ p["W"].astype(h.dtype) + p["b"].astype(h.dtype))
                li += 1
            elif layer.kind == "dropout" and train and key is not None:
                key, sub = jax.random.split(key)
                keep = jax.random.bernoulli(sub, 1.0 - layer.rate, h.shape)
                h = jnp.where(keep, h / (1.0 - layer.rate), 0.0)
        p = params[-1]
        out = h @ p["W"].astype(h.dtype) + p["b"].astype(h.dtype)
        if self._label_mean is not None:
            out = out * jnp.asarray(self._label_scale, out.dtype) + jnp.asarray(
                self._label_mean, out.dtype)
        return out

    def add_data_set(self, data):
        """Attach training data: a DataSet, a pandas DataFrame with named columns,
        or a dict of named columns (reference: ann.add_data_set(df))."""
        self._data_set = data
        return self

    def _data_from_attached(self):
        data = self._data_set
        if data is None:
            raise RuntimeError("no training data: pass X/y or add_data_set(...)")
        if hasattr(data, "features_values"):
            return data.features_values, data.labels_values
        # pandas DataFrame or dict of columns
        getcol = (data.__getitem__ if not hasattr(data, "loc")
                  else (lambda k: data[k].to_numpy()))
        X = np.stack([np.asarray(getcol(k), dtype=float)
                      for k in self.features], axis=1)
        y = np.stack([np.asarray(getcol(k), dtype=float)
                      for k in self.labels], axis=1)
        return X, y

    # -- training -----------------------------------------------------------------
    def train(self, batch_size: int = 64, epochs: int = 500, X=None, y=None,
              data_set=None, learning_rate: float = 1e-3,
              validation_split: float = 0.2, test_split: Optional[float] = None,
              patience: int = 50, loss: str = "mse", verbose: int = 0,
              shuffle: bool = True, tensorboard: bool = False,
              tensorboard_log_dir: str = "./runs", **_ignored):
        """Native optax training loop (replaces the reference's torch/TF plugin
        dispatch, plugins/pytorch/wrapper.py:281)."""
        import optax

        if not self._setup_done:
            self.setup()
        if test_split is not None:
            validation_split = test_split
        if data_set is not None:
            self._data_set = data_set
        if X is None and self._data_set is not None:
            X, y = self._data_from_attached()
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        if X.ndim == 1:
            X = X[:, None]
        if X.shape[1] != self.n_inputs and X.shape[0] == self.n_inputs:
            X = X.T
        if y.ndim == 1:
            y = y[:, None]
        if y.shape[1] != self.n_outputs and y.shape[0] == self.n_outputs:
            y = y.T
        if loss not in _LOSSES:
            raise ValueError(f"unknown loss {loss!r}; available {sorted(_LOSSES)}")
        loss_fn = _LOSSES[loss]

        if self._normalize:
            self._scaler_mean = X.mean(axis=0)
            self._scaler_scale = X.std(axis=0) + 1e-8
            self._label_mean = y.mean(axis=0)
            self._label_scale = y.std(axis=0) + 1e-8

        n = X.shape[0]
        rng = np.random.default_rng(self._seed)
        idx = rng.permutation(n) if shuffle else np.arange(n)
        n_val = int(n * validation_split)
        val_idx, tr_idx = idx[:n_val], idx[n_val:]
        X_tr, y_tr = jnp.asarray(X[tr_idx]), jnp.asarray(y[tr_idx])
        X_val, y_val = jnp.asarray(X[val_idx]), jnp.asarray(y[val_idx])

        tx = optax.adam(learning_rate)
        params = self._params
        opt_state = tx.init(params)
        key = jax.random.PRNGKey(self._seed + 1)

        @jax.jit
        def train_step(params, opt_state, xb, yb, key):
            def batch_loss(p):
                pred = self._apply(p, xb, train=True, key=key)
                return loss_fn(pred, yb)

            l, g = jax.value_and_grad(batch_loss)(params)
            updates, opt_state = tx.update(g, opt_state)
            return optax.apply_updates(params, updates), opt_state, l

        @jax.jit
        def val_loss(p):
            return loss_fn(self._apply(p, X_val), y_val)

        writer = None
        if tensorboard:
            # reference parity: tensorboard hooks during training
            # (plugins/tensorboard/wrapper.py) — native event writer, zero deps
            from ..utils.tb_events import EventFileWriter

            writer = EventFileWriter(log_dir=tensorboard_log_dir)

        n_tr = X_tr.shape[0]
        steps = max(1, n_tr // batch_size)

        # the full training run is ONE device dispatch: scan over epochs with an
        # inner fori over minibatches. Early stopping becomes best-params
        # tracking inside the scan carry (same selected weights as a loop that
        # breaks, at fixed cost) — a Python loop would pay a host round-trip per
        # step.
        def epoch_body(carry, _):
            params, opt_state, key, best_val, best_params = carry
            key, perm_key = jax.random.split(key)
            order = jax.random.permutation(perm_key, n_tr)

            def mb(s, inner):
                params, opt_state, key, acc = inner
                sel = jax.lax.dynamic_slice_in_dim(order, s * batch_size,
                                                   batch_size)
                key, sub = jax.random.split(key)
                params, opt_state, l = train_step(
                    params, opt_state, X_tr[sel], y_tr[sel], sub)
                return (params, opt_state, key, acc + l)

            params, opt_state, key, acc = jax.lax.fori_loop(
                0, steps, mb, (params, opt_state, key, jnp.zeros(())))
            tr_l = acc / steps
            vl = val_loss(params) if n_val else tr_l
            better = vl < best_val - 1e-9
            best_val = jnp.where(better, vl, best_val)
            best_params = jax.tree.map(
                lambda b, p: jnp.where(better, p, b), best_params, params)
            return (params, opt_state, key, best_val, best_params), (tr_l, vl)

        @jax.jit
        def run_training(params, key):
            opt_state = tx.init(params)
            init = (params, opt_state, key, jnp.asarray(jnp.inf),
                    jax.tree.map(jnp.asarray, params))
            (params, _, _, _, best_params), (tr_hist, vl_hist) = jax.lax.scan(
                epoch_body, init, None, length=epochs)
            return best_params, tr_hist, vl_hist

        best_params, tr_hist, vl_hist = run_training(params, key)
        tr_hist = np.asarray(tr_hist)
        vl_hist = np.asarray(vl_hist)
        # honor patience post-hoc: truncate the history at the stopping epoch the
        # sequential rule would have chosen (best params already tracked)
        stop = len(vl_hist)
        best_seen, bad = np.inf, 0
        for e, v in enumerate(vl_hist):
            if v < best_seen - 1e-9:
                best_seen, bad = v, 0
            else:
                bad += 1
                if bad >= patience:
                    stop = e + 1
                    break
        hist = {"loss": list(tr_hist[:stop]), "val_loss": list(vl_hist[:stop])}
        if writer is not None:
            for e in range(stop):
                writer.add_scalar("loss/train", float(tr_hist[e]), e)
                writer.add_scalar("loss/val", float(vl_hist[e]), e)
            writer.close()
        if verbose:
            for e in range(0, stop, max(1, epochs // 10)):
                print(f"epoch {e}: loss={tr_hist[e]:.5f} val={vl_hist[e]:.5f}")
        self._params = jax.tree.map(jnp.asarray, best_params)
        self.history = hist
        return self

    # -- inference ---------------------------------------------------------------
    def predict_fn(self) -> Callable:
        """Pure y = f(x) for one sample — traceable into model/MPC graphs (the
        analogue of the reference's net_to_casadi_graph)."""
        if self._params is None:
            raise RuntimeError("setup()/train() first")
        params = self._params

        def fn(x):
            return self._apply(params, jnp.atleast_1d(x))

        return fn

    def predict(self, X):
        fn = self.predict_fn()
        X = np.asarray(X, dtype=float)
        if X.ndim == 1 and self.n_inputs == 1:
            X = X[:, None]
        elif X.ndim == 1:
            X = X[None, :]
        if X.shape[1] != self.n_inputs and X.shape[0] == self.n_inputs:
            X = X.T
        return np.asarray(jax.vmap(fn)(jnp.asarray(X)))

    build_graph = predict_fn
