"""Model -> tensor-program lowering: PREDICT as pure tensor algebra.

Counterpart of `dask_sql_tpu/inference/programs.py`, with ``apply`` over
torch tensors: the same lowerings, parameter layouts, shape keys and
decline reasons.  The tree walk (`_navigate`) is a static loop of
``depth`` gather/compare steps over ``(rows, trees)``; the leaf sums and
the kmeans distance are plain products (``torch.matmul``).  Params stay
numpy until the registry commits them to the device (inference/registry.py
``_commit``).

"Accelerating Machine Learning Queries with Linear Algebra Query
Processing" (arXiv:2306.08367) and the Tensor Relational Algebra framing
(arXiv:2009.00524) both show that classical models — including tree
ensembles — recast as gather/compare/matmul tensor programs fuse into a
relational plan and compile as ONE program.  This module is that compiler
for the engine's CREATE MODEL registry: `try_lower` turns a fitted
estimator into a `ModelProgram`, a params tuple plus a pure
``apply(params, X)`` function the compiled-predict rung
(physical/compiled_predict.py) runs inside the compiled select's gather
program, over the survivors the scan/filter keeps.

The contract that makes retraining free (the family ParamRef discipline,
applied to model weights):

- ``apply`` closes over STRUCTURE only (tree count, padded node/depth
  buckets, feature width, class count);
- every weight — split features/thresholds/children, leaf values, linear
  coefficients, centroids, class labels — enters as a *runtime argument*
  through ``params``, so ``shape_key`` (the recompile identity) covers
  shapes and dtypes but never values: `CREATE OR REPLACE MODEL` with the
  same hyper-shape swaps params on the cached pipeline, with no build.

Tree ensembles lower per 2306.08367: each fitted sklearn tree becomes
split matrices ``features/thresholds/left/right`` padded to a shared pow2
node bucket (leaves self-loop, so padded navigation steps are no-ops), and
navigation is a static-depth loop of vectorized gather/compare over
``(rows, trees)`` — no per-row Python, no host sync.  Leaf
aggregation is one matmul (regression / GBDT raw scores) or a mean+argmax
(classifier probability leaves).

Models that cannot lower (wrappers, arbitrary FQCNs, non-numeric classes,
pathological depth) return ``(None, reason)`` from `try_lower` and keep
the host predict path — declining is a verdict, never an error.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: hard ceiling on the padded navigation depth (loop trip count baked into
#: the trace) — a deeper ensemble declines to the host path
MAX_TREE_DEPTH = 64

#: hard ceiling on the padded per-tree node bucket: beyond this the split
#: matrices stop being "tiny constants-shaped params" and the host path is
#: the better citizen
MAX_TREE_NODES = 1 << 16

#: hard ceiling on TOTAL padded nodes across an ensemble (trees x bucket):
#: bounds the split-matrix footprint (~28 B/node) that lowering
#: materializes host-side and a fused launch carries — a wider ensemble
#: declines rather than building ~100MB+ of matrices for a verdict
MAX_ENSEMBLE_NODES = 1 << 22


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass(frozen=True)
class ModelProgram:
    """One lowered model: weights as a params pytree + a pure apply fn.

    ``apply(params, X)`` takes ``params`` as tensors on ``X``'s device and
    ``X`` a float64 ``(rows, n_features)`` tensor;
    it returns a 1-d prediction vector (``output == "vector"``) or a
    transformed matrix (``output == "matrix"``, e.g. StandardScaler —
    ineligible for the fused PREDICT rung, which appends one column)."""

    kind: str
    params: Tuple[Any, ...]
    apply: Callable[[Tuple[Any, ...], Any], Any]
    #: recompile identity: structure + param shapes/dtypes, never values
    shape_key: Tuple
    meta: Dict[str, Any] = field(default_factory=dict)
    output: str = "vector"

    @property
    def param_bytes(self) -> int:
        # numpy arrays/scalars and torch tensors all expose .nbytes, so
        # committed (device-resident) params are sized WITHOUT a d2h pull —
        # this property sits on the ledger/metrics scrape path
        return int(sum(p.nbytes if hasattr(p, "nbytes")
                       else np.asarray(p).nbytes for p in self.params))

    def describe(self) -> str:
        """Compact human-readable shape summary for SHOW/DESCRIBE MODEL."""
        m = self.meta
        parts = [self.kind]
        if "trees" in m:
            parts.append(f"trees={m['trees']}")
        if "depth" in m:
            parts.append(f"depth={m['depth']}")
        if "nodes" in m:
            parts.append(f"nodes={m['nodes']}")
        if "features" in m:
            parts.append(f"features={m['features']}")
        if "classes" in m:
            parts.append(f"classes={m['classes']}")
        if "clusters" in m:
            parts.append(f"clusters={m['clusters']}")
        return " ".join(parts)


def _shapes_of(params) -> Tuple:
    return tuple((tuple(np.asarray(p).shape), str(np.asarray(p).dtype))
                 for p in params)


# ---------------------------------------------------------------------------
# tree ensembles: split matrices + static-depth gather/compare navigation
# ---------------------------------------------------------------------------
def _tree_split_matrices(trees, node_bucket: int):
    """Stack fitted sklearn ``Tree`` objects into padded split matrices.

    Leaves (and every padded slot) self-loop — ``left == right == self`` —
    so navigating past a leaf, or past the real depth, is a no-op: ONE
    static trip count serves every tree in the ensemble."""
    T = len(trees)
    idx = np.arange(node_bucket, dtype=np.int32)
    feats = np.zeros((T, node_bucket), dtype=np.int32)
    thrs = np.zeros((T, node_bucket), dtype=np.float64)
    lefts = np.tile(idx, (T, 1))
    rights = np.tile(idx, (T, 1))
    for t, tree in enumerate(trees):
        n = tree.node_count
        leaf = tree.children_left[:n] < 0
        feats[t, :n] = np.where(leaf, 0, tree.feature[:n]).astype(np.int32)
        thrs[t, :n] = np.where(leaf, 0.0, tree.threshold[:n])
        lefts[t, :n] = np.where(leaf, idx[:n],
                                tree.children_left[:n]).astype(np.int32)
        rights[t, :n] = np.where(leaf, idx[:n],
                                 tree.children_right[:n]).astype(np.int32)
    return feats, thrs, lefts, rights


def _navigate(feats, thrs, lefts, rights, X, depth: int) -> torch.Tensor:
    """Leaf node per (row, tree), as an index into the trees' flattened
    ``(trees * bucket)`` node tables: ``depth`` vectorized gather/compare
    steps — the tensorized tree walk of 2306.08367.

    sklearn evaluates splits on float32-cast inputs against float64
    thresholds; the double cast reproduces its boundary behavior exactly.
    A step holds the int64 node matrix and at most two more ``(rows,
    trees)`` temporaries of 8 bytes and one mask (`walk_bytes_per_row`):
    the feature ids, then the gathered value and the threshold, then the
    two children, the next node written in place."""
    T, B = feats.shape
    base = torch.arange(T, dtype=torch.int64, device=X.device)[:, None] * B
    f_tab = feats.reshape(-1).long()
    th_tab = thrs.reshape(-1)
    l_tab = (lefts.long() + base).reshape(-1)
    r_tab = (rights.long() + base).reshape(-1)
    Xd = X.to(torch.float32).to(torch.float64)
    node = base.reshape(1, T).expand(X.shape[0], T).clone()
    for _ in range(depth):
        go = torch.gather(Xd, 1, f_tab[node]) <= th_tab[node]
        torch.where(go, l_tab[node], r_tab[node], out=node)
        del go  # not alive beside the next step's mask
    return node


def walk_bytes_per_row(program: "ModelProgram", n_features: int) -> int:
    """Device bytes a tree program holds per row at its peak in the port's
    eager walk: the float64 feature matrix and its double-cast copy, the
    int64 node matrix, and the larger of a navigation step's temporaries
    (17 bytes a tree) and the leaf gather (8 bytes a tree, times the
    classes for probability leaves), plus the row's outputs."""
    trees = int(program.meta.get("trees", 0))
    leaf = 8
    if program.kind in ("tree_classifier", "forest_classifier"):
        leaf = 8 * int(program.meta.get("classes", 1))
    return 16 * max(int(n_features), 1) + trees * (8 + max(17, leaf)) \
        + 8 * (int(program.meta.get("classes", 1)) + 2)


def _ensemble_shape(trees, max_depth_hint: Optional[int]
                    ) -> Optional[Tuple[int, int]]:
    """(node_bucket, depth) for an ensemble, padded so a RETRAIN with the
    same hyper-shape lands in the same buckets: depth pads to the model's
    ``max_depth`` when set (else the observed pow2), and the node bucket
    pads to the full-tree bound ``2^(depth+1) - 1`` when that is small
    enough — a bounded-depth retrain then provably reuses the pipeline.
    None = decline (too deep / too wide)."""
    obs_nodes = max(t.node_count for t in trees)
    obs_depth = max(int(t.max_depth) for t in trees)
    if max_depth_hint is not None and max_depth_hint > 0:
        depth = int(max_depth_hint)
    else:
        depth = _pow2(obs_depth)
    depth = max(depth, obs_depth, 1)
    if depth > MAX_TREE_DEPTH:
        return None
    nodes = obs_nodes
    full = (1 << (depth + 1)) - 1
    if full <= MAX_TREE_NODES:
        nodes = max(nodes, full)
    bucket = _pow2(nodes)
    if bucket > MAX_TREE_NODES:
        return None
    if len(trees) * bucket > MAX_ENSEMBLE_NODES:
        return None
    return bucket, depth


def _numeric_classes(model) -> Optional[np.ndarray]:
    classes = getattr(model, "classes_", None)
    if classes is None:
        return None
    arr = np.asarray(classes)
    if arr.dtype.kind not in "iufb":
        return None  # string labels cannot ride the DOUBLE target column
    return arr.astype(np.float64)


def _lower_tree_regression(trees, weights: np.ndarray, baseline: float,
                           n_features: int, kind: str,
                           max_depth_hint: Optional[int]
                           ) -> Optional[ModelProgram]:
    """Shared lowering of additive regression ensembles: prediction =
    ``leaf_values @ weights + baseline`` (DT: weight 1; RF: 1/T mean;
    GBDT: learning rate folded into ``weights``)."""

    shape = _ensemble_shape(trees, max_depth_hint)
    if shape is None:
        return None
    bucket, depth = shape
    feats, thrs, lefts, rights = _tree_split_matrices(trees, bucket)
    T = len(trees)
    vals = np.zeros((T, bucket), dtype=np.float64)
    for t, tree in enumerate(trees):
        n = tree.node_count
        vals[t, :n] = tree.value[:n, 0, 0]
    params = (feats, thrs, lefts, rights, vals,
              np.asarray(weights, dtype=np.float64),
              np.asarray(baseline, dtype=np.float64))

    def apply(p, X):
        f, th, l, r, v, w, b = p
        node = _navigate(f, th, l, r, X, depth)
        return v.reshape(-1)[node] @ w + b

    meta = {"trees": T, "depth": depth, "nodes": bucket,
            "features": n_features}
    return ModelProgram(kind, params, apply,
                        (kind, T, bucket, depth, n_features,
                         _shapes_of(params)), meta)


def _lower_tree_classifier(trees, classes: np.ndarray, n_features: int,
                           kind: str, max_depth_hint: Optional[int]
                           ) -> Optional[ModelProgram]:
    """DecisionTree/RandomForest classifiers: probability leaves averaged
    across trees, argmax, class-label gather — matching sklearn's
    mean-of-proba vote exactly (first-max tie-breaking included)."""

    shape = _ensemble_shape(trees, max_depth_hint)
    if shape is None:
        return None
    bucket, depth = shape
    C = len(classes)
    feats, thrs, lefts, rights = _tree_split_matrices(trees, bucket)
    T = len(trees)
    vals = np.zeros((T, bucket, C), dtype=np.float64)
    for t, tree in enumerate(trees):
        n = tree.node_count
        counts = tree.value[:n, 0, :].astype(np.float64)
        totals = counts.sum(axis=1, keepdims=True)
        vals[t, :n] = counts / np.maximum(totals, 1e-300)
    params = (feats, thrs, lefts, rights, vals, classes)

    def apply(p, X):
        f, th, l, r, v, cls = p
        node = _navigate(f, th, l, r, X, depth)
        pv = v.reshape(T * v.shape[1], -1)[node]  # (rows, trees, classes)
        proba = pv.mean(dim=1)
        return cls[torch.argmax(proba, dim=1)]

    meta = {"trees": T, "depth": depth, "nodes": bucket,
            "features": n_features, "classes": C}
    return ModelProgram(kind, params, apply,
                        (kind, T, bucket, depth, n_features, C,
                         _shapes_of(params)), meta)


def _gbdt_baseline(model, n_features: int) -> Optional[np.ndarray]:
    """Exact raw-score baseline of a fitted GradientBoosting model, probed
    instead of reverse-engineering ``init_``: with the default (or
    ``'zero'``) init the raw scores are ``const + lr * sum(trees)``, so
    one zero-row probe minus the tree sum recovers the constant.  A
    custom ``init`` estimator makes the init term ROW-DEPENDENT — no
    constant baseline exists and the lowering must decline (a probed
    constant would yield silently wrong fused predictions)."""
    init_param = getattr(model, "init", None)
    if init_param is not None and init_param != "zero":
        return None
    raw_fn = getattr(model, "_raw_predict", None)
    if raw_fn is None:
        return None
    probe = np.zeros((1, n_features), dtype=np.float32)
    try:
        raw = np.asarray(raw_fn(probe), dtype=np.float64).reshape(-1)
    except Exception:  # dsql: allow-broad-except — a probe failure is a
        # decline verdict, never a query error
        return None
    lr = float(model.learning_rate)
    tree_sum = np.array([
        lr * sum(float(est.predict(probe)[0])
                 for est in model.estimators_[:, k])
        for k in range(model.estimators_.shape[1])])
    return raw - tree_sum


def _lower_gbdt_classifier(model, classes: np.ndarray, n_features: int,
                           max_depth_hint: Optional[int]
                           ) -> Optional[ModelProgram]:
    """GradientBoostingClassifier: flattened trees matmul into K raw-score
    columns through a constant stage->class routing matrix, then the loss
    link's decision (binary: raw > 0; multiclass: argmax)."""

    baseline = _gbdt_baseline(model, n_features)
    if baseline is None:
        return None
    stages, K = model.estimators_.shape
    trees = [est.tree_ for k in range(K)
             for est in model.estimators_[:, k]]
    shape = _ensemble_shape(trees, max_depth_hint)
    if shape is None:
        return None
    bucket, depth = shape
    feats, thrs, lefts, rights = _tree_split_matrices(trees, bucket)
    T = len(trees)
    vals = np.zeros((T, bucket), dtype=np.float64)
    route = np.zeros((T, K), dtype=np.float64)
    lr = float(model.learning_rate)
    i = 0
    for k in range(K):
        for est in model.estimators_[:, k]:
            n = est.tree_.node_count
            vals[i, :n] = est.tree_.value[:n, 0, 0]
            route[i, k] = lr
            i += 1
    params = (feats, thrs, lefts, rights, vals, route,
              baseline.astype(np.float64), classes)
    binary = K == 1

    def apply(p, X):
        f, th, l, r, v, m, b, cls = p
        node = _navigate(f, th, l, r, X, depth)
        raw = v.reshape(-1)[node] @ m + b
        if binary:
            idx = (raw[:, 0] > 0).long()
        else:
            idx = torch.argmax(raw, dim=1)
        return cls[idx]

    meta = {"trees": T, "depth": depth, "nodes": bucket,
            "features": n_features, "classes": len(classes)}
    return ModelProgram("gbdt_classifier", params, apply,
                        ("gbdt_classifier", T, bucket, depth, n_features,
                         K, len(classes), _shapes_of(params)), meta)


# ---------------------------------------------------------------------------
# linear / logistic / kmeans / scaler
# ---------------------------------------------------------------------------
def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.float32 if np.dtype(dt) == np.float32 else torch.float64


def _lower_linear(W: np.ndarray, b: np.ndarray, n_features: int,
                  x_dtype: np.dtype) -> ModelProgram:
    params = (np.asarray(W), np.asarray(b))
    dt = np.dtype(x_dtype)
    tdt = _torch_dtype(dt)

    def apply(p, X):
        w, bias = p
        return (X.to(tdt) @ w + bias).to(torch.float64)

    meta = {"features": n_features}
    return ModelProgram("linear", params, apply,
                        ("linear", n_features, str(dt), _shapes_of(params)),
                        meta)


def _lower_logistic(W: np.ndarray, b: np.ndarray, classes: np.ndarray,
                    n_features: int, x_dtype: np.dtype) -> ModelProgram:
    """Binary: decision_function > 0 -> classes[1] (sklearn semantics and
    the engine model's ``sigmoid > 0.5`` are the same boundary).  Multiclass
    (one-vs-rest raw scores): argmax."""
    W = np.asarray(W)
    binary = W.ndim == 1
    params = (W, np.asarray(b), classes)
    dt = np.dtype(x_dtype)
    tdt = _torch_dtype(dt)

    def apply(p, X):
        w, bias, cls = p
        raw = X.to(tdt) @ (w if binary else w.T) + bias
        if binary:
            idx = (raw > 0).long()
        else:
            idx = torch.argmax(raw, dim=1)
        return cls[idx]

    meta = {"features": n_features, "classes": len(classes)}
    return ModelProgram("logistic", params, apply,
                        ("logistic", n_features, len(classes), binary,
                         str(dt), _shapes_of(params)), meta)


def _lower_kmeans(centers: np.ndarray, n_features: int,
                  x_dtype: np.dtype) -> ModelProgram:
    """Distance-argmin as one matmul: ``argmin(||c||^2 - 2 X c^T)`` (the
    row's own norm is constant under argmin)."""
    params = (np.asarray(centers),)
    dt = np.dtype(x_dtype)
    tdt = _torch_dtype(dt)

    def apply(p, X):
        (c,) = p
        d = torch.sum(c * c, dim=1)[None, :] - 2.0 * (X.to(tdt) @ c.T)
        return torch.argmin(d, dim=1).to(torch.float64)

    meta = {"features": n_features, "clusters": int(centers.shape[0])}
    return ModelProgram("kmeans", params, apply,
                        ("kmeans", n_features, int(centers.shape[0]),
                         str(dt), _shapes_of(params)), meta)


def _lower_scaler(mean: np.ndarray, scale: np.ndarray,
                  n_features: int) -> ModelProgram:
    """StandardScaler transform as subtract+scale — a ``matrix`` program:
    composable in tensor pipelines, ineligible for the one-column fused
    PREDICT rung."""
    params = (np.asarray(mean, dtype=np.float64),
              np.asarray(scale, dtype=np.float64))

    def apply(p, X):
        m, s = p
        return (X - m) / s

    return ModelProgram("scaler", params, apply,
                        ("scaler", n_features, _shapes_of(params)),
                        {"features": n_features}, output="matrix")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def try_lower(model, n_features: Optional[int] = None
              ) -> Tuple[Optional[ModelProgram], str]:
    """``(program, reason)``: the lowered tensor program, or ``(None,
    why)`` when the model keeps the host predict path.  Never raises —
    declining is a verdict, not an error."""
    try:
        program = _dispatch(model, n_features)
    except Exception as exc:  # dsql: allow-broad-except — an exotic fitted
        # model must decline to the host path, never fail the query
        logger.debug("model lowering failed open", exc_info=True)
        return None, f"lowering error: {type(exc).__name__}: {exc}"
    if isinstance(program, str):
        return None, program
    if program is None:
        return None, f"no tensor lowering for {type(model).__name__}"
    return program, "lowered"


def _host_f32(t) -> np.ndarray:
    """A fitted model tensor as host float32 numpy (lowering reads the
    weights once; the registry commits them to the device)."""
    return t.detach().cpu().numpy().astype(np.float32, copy=False)


def _dispatch(model, n_features: Optional[int]):
    """Returns a ModelProgram, a decline-reason string, or None."""
    from ..ml import torch_models
    from ..ml.wrappers import Incremental, ParallelPostFit

    if isinstance(model, (ParallelPostFit, Incremental)):
        return "wrapped model (wrap_predict/wrap_fit) keeps the host path"

    # --- engine-native torch models ---------------------------------------
    if isinstance(model, torch_models.LinearRegression):
        if model._w is None:
            return "model is not fitted"
        w = _host_f32(model._w)
        if model.fit_intercept:
            return _lower_linear(w[:-1], w[-1], len(w) - 1, np.float32)
        return _lower_linear(w, np.float32(0.0), len(w), np.float32)
    if isinstance(model, torch_models.LogisticRegression):
        if model._w is None:
            return "model is not fitted"
        classes = _numeric_classes(model)
        if classes is None:
            return "non-numeric class labels"
        w = _host_f32(model._w)
        if model.fit_intercept:
            return _lower_logistic(w[:-1], w[-1], classes, len(w) - 1,
                                   np.float32)
        return _lower_logistic(w, np.float32(0.0), classes, len(w),
                               np.float32)
    if isinstance(model, torch_models.KMeans):
        if model.cluster_centers_ is None:
            return "model is not fitted"
        centers = _host_f32(model.cluster_centers_)
        return _lower_kmeans(centers, centers.shape[1], np.float32)

    # --- sklearn ----------------------------------------------------------
    name = type(model).__name__
    mod = type(model).__module__
    if not mod.startswith("sklearn."):
        return None
    nf = getattr(model, "n_features_in_", n_features)
    if nf is None:
        return "model is not fitted"
    nf = int(nf)
    if int(getattr(model, "n_outputs_", 1) or 1) != 1:
        # tree.value[:, 0, :] would silently discard every output but the
        # first — multi-output models keep the host path
        return "multi-output model"
    depth_hint = getattr(model, "max_depth", None)
    if name == "StandardScaler":
        mean = getattr(model, "mean_", None)
        scale = getattr(model, "scale_", None)
        if scale is None:
            return "model is not fitted"
        if mean is None:
            mean = np.zeros(nf)
        return _lower_scaler(mean, scale, nf)
    if name in ("LinearRegression", "Ridge", "Lasso", "SGDRegressor"):
        coef = np.asarray(model.coef_, dtype=np.float64)
        if coef.ndim > 1 and coef.shape[0] != 1:
            return "multi-output model"  # reshape(-1) would mis-shape it
        coef = coef.reshape(-1)
        intercept = np.asarray(model.intercept_,
                               dtype=np.float64).reshape(-1)[0]
        return _lower_linear(coef, np.float64(intercept), nf, np.float64)
    if name in ("LogisticRegression", "SGDClassifier"):
        classes = _numeric_classes(model)
        if classes is None:
            return "non-numeric class labels"
        W = np.asarray(model.coef_, dtype=np.float64)
        b = np.asarray(model.intercept_, dtype=np.float64)
        if W.shape[0] == 1:
            return _lower_logistic(W[0], b[0], classes, nf, np.float64)
        return _lower_logistic(W, b, classes, nf, np.float64)
    if name == "KMeans":
        return _lower_kmeans(np.asarray(model.cluster_centers_,
                                        dtype=np.float64), nf, np.float64)
    if name == "DecisionTreeRegressor":
        return _lower_tree_regression([model.tree_], np.ones(1), 0.0, nf,
                                      "tree_regressor", depth_hint)
    if name == "DecisionTreeClassifier":
        classes = _numeric_classes(model)
        if classes is None:
            return "non-numeric class labels"
        return _lower_tree_classifier([model.tree_], classes, nf,
                                      "tree_classifier", depth_hint)
    if name == "RandomForestRegressor":
        trees = [e.tree_ for e in model.estimators_]
        return _lower_tree_regression(
            trees, np.full(len(trees), 1.0 / len(trees)), 0.0, nf,
            "forest_regressor", depth_hint)
    if name == "RandomForestClassifier":
        classes = _numeric_classes(model)
        if classes is None:
            return "non-numeric class labels"
        return _lower_tree_classifier([e.tree_ for e in model.estimators_],
                                      classes, nf, "forest_classifier",
                                      depth_hint)
    if name == "GradientBoostingRegressor":
        baseline = _gbdt_baseline(model, nf)
        if baseline is None:
            return "gbdt baseline probe failed"
        trees = [e.tree_ for e in model.estimators_[:, 0]]
        lr = float(model.learning_rate)
        return _lower_tree_regression(
            trees, np.full(len(trees), lr), float(baseline[0]), nf,
            "gbdt_regressor", depth_hint)
    if name == "GradientBoostingClassifier":
        classes = _numeric_classes(model)
        if classes is None:
            return "non-numeric class labels"
        return _lower_gbdt_classifier(model, classes, nf, depth_hint)
    return None
