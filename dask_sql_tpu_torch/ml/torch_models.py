"""The engine's own estimators for CREATE MODEL, on an explicit device.

Counterpart of `dask_sql_tpu/ml/jax_models.py`: the same three models with
the same fit rules, in float32, as torch ops on the device the model was
built for (``device``: the CUDA card unless the caller asks for another;
CREATE MODEL passes its Context's).  The device is private
(``_device``), so `get_params` and DESCRIBE MODEL's rows are the
reference's.  sklearn-compatible API (fit/predict/get_params), so the SQL
surface and the wrappers drive either family.

- `LinearRegression`: the normal equations ``(X^T X + l2 I) w = X^T y``
  solved with `torch.linalg.solve`;
- `LogisticRegression`: ``n_iter`` full-batch gradient steps;
- `KMeans`: ``n_iter`` Lloyd steps; an empty cluster keeps its center.
  The initial centers are ``n_clusters`` distinct rows drawn with a
  `torch.Generator` seeded with ``seed``, so a seed picks other rows than
  the reference's ``jax.random.choice`` (ROADMAP.md, divergences);
  ``fit(X, init_centers=...)`` starts from given centers.

A pickled model (EXPORT MODEL, checkpoints) holds its fitted tensors on
the host; `to` moves them to another device.  `fitted` builds a fitted
model from another engine's fitted arrays (``_w``, ``classes_``,
``cluster_centers_``) given as numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: the fitted tensors of each model, moved together by `to` and pickled
#: on the host
_TENSORS = ("_w", "cluster_centers_")


class _TorchEstimator:
    def __init__(self, device=None):
        self._device = torch.device(device if device is not None else "cuda")

    def get_params(self, deep: bool = True):
        # fitted tensors read as numpy, as the reference's arrays print
        return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                for k, v in self.__dict__.items() if not k.startswith("_")}

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self

    def to(self, device) -> "_TorchEstimator":
        """Move the model, and its fitted tensors, to ``device``."""
        self._device = torch.device(device)
        for name in _TENSORS:
            t = self.__dict__.get(name)
            if t is not None:
                setattr(self, name, t.to(self._device))
        return self

    def __getstate__(self):
        state = dict(self.__dict__)
        for name in _TENSORS:
            if state.get(name) is not None:
                state[name] = state[name].detach().cpu()
        state["_device"] = str(self._device)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device = torch.device(state["_device"])

    def _matrix(self, X) -> torch.Tensor:
        """The feature matrix in float32 on the model's device, with the
        column of ones when the model fits an intercept."""
        # a copy: pandas may hand over a read-only buffer
        X = torch.as_tensor(np.array(X, dtype=np.float32),
                            device=self._device)
        if getattr(self, "fit_intercept", False):
            X = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                         device=X.device)], dim=1)
        return X


class LinearRegression(_TorchEstimator):
    """Closed-form linear regression on the device."""

    def __init__(self, fit_intercept: bool = True, l2: float = 0.0,
                 device=None):
        super().__init__(device)
        self.fit_intercept = fit_intercept
        self.l2 = l2
        self._w = None

    def fit(self, X, y, **kwargs):
        X = self._matrix(X)
        y = torch.as_tensor(np.array(y, dtype=np.float32),
                            device=self._device).reshape(-1)
        xtx = X.T @ X + self.l2 * torch.eye(X.shape[1], dtype=X.dtype,
                                            device=X.device)
        self._w = torch.linalg.solve(xtx, X.T @ y)
        return self

    def predict(self, X):
        return (self._matrix(X) @ self._w).cpu().numpy()

    def score(self, X, y):
        pred = self.predict(X)
        y = np.asarray(y, dtype=np.float64)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot else 0.0


class LogisticRegression(_TorchEstimator):
    """Full-batch gradient descent logistic regression."""

    def __init__(self, lr: float = 0.1, n_iter: int = 200,
                 fit_intercept: bool = True, device=None):
        super().__init__(device)
        self.lr = lr
        self.n_iter = n_iter
        self.fit_intercept = fit_intercept
        self._w = None
        self.classes_ = None

    def fit(self, X, y, **kwargs):
        X = self._matrix(X)
        y_np = np.asarray(y)
        self.classes_ = np.unique(y_np)
        y01 = torch.as_tensor((y_np == self.classes_[-1]).astype(np.float32),
                              device=self._device)
        w = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
        for _ in range(int(self.n_iter)):
            p = torch.sigmoid(X @ w)
            w = w - self.lr * (X.T @ (p - y01) / X.shape[0])
        self._w = w
        return self

    def _proba1(self, X) -> np.ndarray:
        return torch.sigmoid(self._matrix(X) @ self._w).cpu().numpy()

    def predict(self, X):
        p = self._proba1(X)
        return np.where(p > 0.5, self.classes_[-1], self.classes_[0])

    def predict_proba(self, X):
        p = self._proba1(X)
        return np.stack([1 - p, p], axis=1)

    def score(self, X, y):
        return float((self.predict(X) == np.asarray(y)).mean())


def _lloyd(X: torch.Tensor, centers: torch.Tensor, n_iter: int,
           n_clusters: int) -> torch.Tensor:
    """``n_iter`` Lloyd steps from ``centers``; a cluster that loses every
    row keeps its center."""
    c = centers
    for _ in range(int(n_iter)):
        d = ((X[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        one_hot = torch.nn.functional.one_hot(
            torch.argmin(d, dim=1), n_clusters).to(X.dtype)
        del d
        counts = one_hot.sum(0)
        sums = one_hot.T @ X
        new_c = sums / torch.clamp(counts[:, None], min=1)
        c = torch.where(counts[:, None] > 0, new_c, c)
    return c


class KMeans(_TorchEstimator):
    """Lloyd's iterations as a distance, an argmin and a matmul."""

    def __init__(self, n_clusters: int = 8, n_iter: int = 50, seed: int = 0,
                 device=None):
        super().__init__(device)
        self.n_clusters = n_clusters
        self.n_iter = n_iter
        self.seed = seed
        self.cluster_centers_ = None

    def fit(self, X, y=None, init_centers: Optional[np.ndarray] = None,
            **kwargs):
        X = self._matrix(X)
        if init_centers is None:
            gen = torch.Generator().manual_seed(int(self.seed))
            idx = torch.randperm(X.shape[0], generator=gen)[:self.n_clusters]
            centers = X[idx.to(X.device)]
        else:
            centers = torch.as_tensor(np.asarray(init_centers,
                                                 dtype=np.float32),
                                      device=self._device)
        self.cluster_centers_ = _lloyd(X, centers, self.n_iter,
                                       self.n_clusters)
        return self

    def predict(self, X):
        X = self._matrix(X)
        d = ((X[:, None, :] - self.cluster_centers_[None, :, :]) ** 2).sum(-1)
        return torch.argmin(d, dim=1).cpu().numpy()

    def fit_predict(self, X, y=None):
        self.fit(X)
        return self.predict(X)


class GradientBoostedTreesStub(_TorchEstimator):  # pragma: no cover
    """Placeholder slot so GBDT names resolve with a clear error."""

    def __init__(self, **kwargs):
        raise NotImplementedError(
            "Gradient boosted trees are not yet engine-native; use a "
            "sklearn class")


def fitted(model_class, params: Optional[dict] = None, device=None,
           **arrays) -> _TorchEstimator:
    """A fitted ``model_class`` built from fitted arrays given as numpy
    (``_w``, ``classes_``, ``cluster_centers_``), with ``params`` as its
    constructor arguments, on ``device``."""
    model = model_class(device=device, **(params or {}))
    for name, value in arrays.items():
        if name in _TENSORS:
            value = torch.tensor(np.asarray(value, dtype=np.float32),
                                 device=model._device)
        elif name == "classes_":
            value = np.asarray(value)
        else:
            raise ValueError(f"{model_class.__name__} has no fitted {name!r}")
        setattr(model, name, value)
    return model
