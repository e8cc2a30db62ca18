"""Estimator wrappers for partitioned/device data.

Role parity: reference wrappers.py (vendored dask-ml): ParallelPostFit
(wrappers.py:51) — train once, predict/transform/score partition-wise;
Incremental (wrappers.py:425) — stream partial_fit across partitions.
Here "partitions" are device-table row blocks; predictions run blockwise on
host (sklearn) or on device (ml/torch_models.py).

Copied from `dask_sql_tpu/ml/wrappers.py`.

All reference constructor knobs are honored: `scoring` drives score()
through sklearn's scorer registry (wrappers.py:233-270 there), the
`*_meta` hints pin output dtypes (the reference uses them for dask meta;
here they fix the result dtype without an inference call), and
Incremental's `shuffle_blocks`/`random_state` control the partial_fit
block order (wrappers.py:493-505).
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np


def _resolve_scorer(scoring):
    if callable(scoring):
        return scoring
    from sklearn.metrics import get_scorer

    return get_scorer(scoring)


def _meta_dtype(meta):
    if meta is None:
        return None
    dtype = getattr(meta, "dtype", None)
    if dtype is not None:
        return np.dtype(dtype)
    try:
        return np.dtype(meta)
    except TypeError:
        return None


class ParallelPostFit:
    """Meta-estimator: fit on (sub)sampled data, apply blockwise."""

    def __init__(self, estimator: Any = None, scoring=None, predict_meta=None,
                 predict_proba_meta=None, transform_meta=None,
                 block_rows: int = 1_000_000):
        self.estimator = estimator
        self.scoring = scoring
        self.predict_meta = predict_meta
        self.predict_proba_meta = predict_proba_meta
        self.transform_meta = transform_meta
        self.block_rows = block_rows

    def fit(self, X, y=None, **kwargs):
        self.estimator.fit(X, y, **kwargs) if y is not None else self.estimator.fit(X, **kwargs)
        return self

    def _blockwise(self, method, X, meta=None):
        n = len(X)
        outs = []
        for start in range(0, n, self.block_rows):
            block = X[start : start + self.block_rows]
            outs.append(np.asarray(method(block)))
        if not outs:
            out = np.array([])
        else:
            out = np.concatenate(outs) if outs[0].ndim == 1 else np.vstack(outs)
        dtype = _meta_dtype(meta)
        if dtype is not None and out.dtype != dtype:
            out = out.astype(dtype)
        return out

    def predict(self, X):
        return self._blockwise(self.estimator.predict, np.asarray(X),
                               self.predict_meta)

    def predict_proba(self, X):
        return self._blockwise(self.estimator.predict_proba, np.asarray(X),
                               self.predict_proba_meta)

    def predict_log_proba(self, X):
        return np.log(self.predict_proba(X))

    def transform(self, X):
        return self._blockwise(self.estimator.transform, np.asarray(X),
                               self.transform_meta)

    def score(self, X, y):
        """Default estimator score, or the configured `scoring` (parity:
        reference score() resolves self.scoring via sklearn, wrappers.py:251)."""
        X = np.asarray(X)
        y = np.asarray(y)
        if self.scoring:
            return float(_resolve_scorer(self.scoring)(self.estimator, X, y))
        return self.estimator.score(X, y)

    # -- sklearn estimator protocol (clone/GridSearchCV compatibility) ------
    _param_names = ("estimator", "scoring", "predict_meta",
                    "predict_proba_meta", "transform_meta", "block_rows")

    def get_params(self, deep: bool = True):
        params = {k: getattr(self, k) for k in self._param_names}
        if deep and hasattr(self.estimator, "get_params"):
            for k, v in self.estimator.get_params(deep).items():
                params[f"estimator__{k}"] = v
        return params

    def set_params(self, **params):
        nested = {}
        for k, v in params.items():
            if k.startswith("estimator__"):
                nested[k[len("estimator__"):]] = v
            elif k in self._param_names:
                setattr(self, k, v)
            else:
                raise ValueError(f"Invalid parameter {k!r} for {type(self).__name__}")
        if nested:
            self.estimator.set_params(**nested)
        return self

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return getattr(self.estimator, item)


class Incremental(ParallelPostFit):
    """Streamed training via partial_fit over row blocks (parity:
    wrappers.py:718-760 fit loop; shuffle_blocks/random_state wrappers.py:493)."""

    _param_names = ParallelPostFit._param_names + (
        "shuffle_blocks", "random_state")

    def __init__(self, estimator: Any = None, scoring=None,
                 shuffle_blocks: bool = True, random_state=None,
                 block_rows: int = 100_000, **kwargs):
        super().__init__(estimator, scoring=scoring, block_rows=block_rows,
                         **kwargs)
        self.shuffle_blocks = shuffle_blocks
        self.random_state = random_state

    def fit(self, X, y=None, classes=None, **kwargs):
        X = np.asarray(X)
        y_arr = np.asarray(y) if y is not None else None
        n = len(X)
        starts = list(range(0, n, self.block_rows))
        if self.shuffle_blocks and len(starts) > 1:
            rng = (self.random_state
                   if isinstance(self.random_state, np.random.RandomState)
                   else np.random.RandomState(self.random_state))
            rng.shuffle(starts)
        if classes is None and y_arr is not None and hasattr(self.estimator, "partial_fit"):
            classes = np.unique(y_arr)
        for start in starts:
            xb = X[start : start + self.block_rows]
            yb = y_arr[start : start + self.block_rows] if y_arr is not None else None
            if yb is not None:
                try:
                    self.estimator.partial_fit(xb, yb, classes=classes, **kwargs)
                except TypeError:
                    self.estimator.partial_fit(xb, yb, **kwargs)
            else:
                self.estimator.partial_fit(xb, **kwargs)
        return self
