"""Blockwise ML metrics (parity: reference metrics.py:16-178 — dask-aware
accuracy_score, log_loss, mean_squared_error, r2_score), on numpy inputs.

Copied from `dask_sql_tpu/ml/metrics.py`."""
from __future__ import annotations

import numpy as np


def _np(x):
    return np.asarray(x)


def accuracy_score(y_true, y_pred, normalize: bool = True, sample_weight=None):
    yt, yp = _np(y_true), _np(y_pred)
    hits = (yt == yp).astype(np.float64)
    if sample_weight is not None:
        w = _np(sample_weight)
        return float((hits * w).sum() / (w.sum() if normalize else 1.0))
    return float(hits.mean() if normalize else hits.sum())


def log_loss(y_true, y_pred, eps: float = 1e-15, normalize: bool = True,
             sample_weight=None, labels=None):
    yt, yp = _np(y_true), np.clip(_np(y_pred), eps, 1 - eps)
    if yp.ndim == 1:
        classes = np.unique(yt) if labels is None else np.asarray(labels)
        pos = (yt == classes[-1]).astype(np.float64)
        losses = -(pos * np.log(yp) + (1 - pos) * np.log(1 - yp))
    else:
        classes = np.unique(yt) if labels is None else np.asarray(labels)
        idx = np.searchsorted(classes, yt)
        yp = yp / yp.sum(axis=1, keepdims=True)
        losses = -np.log(yp[np.arange(len(yt)), idx])
    if sample_weight is not None:
        w = _np(sample_weight)
        return float((losses * w).sum() / (w.sum() if normalize else 1.0))
    return float(losses.mean() if normalize else losses.sum())


def mean_squared_error(y_true, y_pred, squared: bool = True, sample_weight=None):
    yt, yp = _np(y_true).astype(np.float64), _np(y_pred).astype(np.float64)
    se = (yt - yp) ** 2
    if sample_weight is not None:
        w = _np(sample_weight)
        mse = float((se * w).sum() / w.sum())
    else:
        mse = float(se.mean())
    return mse if squared else float(np.sqrt(mse))


def mean_absolute_error(y_true, y_pred, sample_weight=None):
    yt, yp = _np(y_true).astype(np.float64), _np(y_pred).astype(np.float64)
    ae = np.abs(yt - yp)
    if sample_weight is not None:
        w = _np(sample_weight)
        return float((ae * w).sum() / w.sum())
    return float(ae.mean())


def r2_score(y_true, y_pred, sample_weight=None):
    yt, yp = _np(y_true).astype(np.float64), _np(y_pred).astype(np.float64)
    ss_res = float(((yt - yp) ** 2).sum())
    ss_tot = float(((yt - yt.mean()) ** 2).sum())
    return 1.0 - ss_res / ss_tot if ss_tot else 0.0
