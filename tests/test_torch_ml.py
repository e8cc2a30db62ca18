"""The model layer of the port (`dask_sql_tpu_torch/ml/`, the ML statements
of `physical/rel/custom/ml.py`) against the reference's.

The engine's own models (`ml/torch_models.py`) fit in float32 as the
reference's `ml/jax_models.py` do, so their weights agree to rounding
(1e-4 relative); held on the reference's fitted arrays (carried across
with `torch_models.fitted`), their predictions agree to 5e-6 relative and
their labels exactly.  KMeans draws its initial centers from a
`torch.Generator`, so the Lloyd steps are held on the reference's initial
centers.  The copies (`metrics.py`, `wrappers.py`, `ml_classes.py`) give
the reference's answers.  The statements run as
`tests/integration/test_model.py` drives them, on a port CPU Context and a
reference Context fed the same SQL: CREATE, PREDICT on the host tier,
DESCRIBE, SHOW, DROP and EXPORT MODEL, CREATE EXPERIMENT, and the error
taxonomy.
"""
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu.ml import jax_models
from dask_sql_tpu.ml import metrics as ref_metrics
from dask_sql_tpu.ml import ml_classes as ref_classes
from dask_sql_tpu.ml import wrappers as ref_wrappers
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.ml import metrics, ml_classes, torch_models, wrappers
from dask_sql_tpu_torch.physical.rel.custom.ml import _model_boundary
from dask_sql_tpu_torch.resilience.errors import (
    ModelError,
    ResourceExhaustedError,
)

HOST = {"sql.compile.predict": False}
ENGINES = ("port", "ref")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _training_df(n=100):
    rng = np.random.RandomState(0)
    df = pd.DataFrame({"x": rng.rand(n), "y": rng.rand(n)})
    df["target"] = (df.x * 2 + df.y > 1.5).astype(np.int64)
    return df


def _new(engine):
    c = Context(device="cpu") if engine == "port" \
        else dask_sql_tpu.Context()
    c.create_table("timeseries", _training_df())
    return c


@pytest.fixture(scope="module")
def pair():
    return {e: _new(e) for e in ENGINES}


def _both(pair, sql, **kw):
    return {e: pair[e].sql(sql, return_futures=False, **kw)
            for e in ENGINES}


# --------------------------------------------------------- the copies
def test_ml_classes_name_the_ports_models():
    assert ml_classes.SKLEARN_CLASSES == ref_classes.SKLEARN_CLASSES
    assert set(ml_classes.TPU_CLASSES) == set(ref_classes.TPU_CLASSES)
    for name in ml_classes.TPU_CLASSES:
        cls = ml_classes.get_model_class(name)
        assert cls.__module__ == "dask_sql_tpu_torch.ml.torch_models"
        assert cls.__name__ == ref_classes.get_model_class(name).__name__
        sk = ml_classes.get_model_class(name, backend="cpu")
        assert sk is ref_classes.get_model_class(name, backend="cpu")
    with pytest.raises(ValueError, match="Unknown model class 'Nope'"):
        ml_classes.get_model_class("Nope")


@pytest.mark.parametrize("fn, args", [
    ("accuracy_score", ([0, 1, 1, 0], [0, 1, 0, 0])),
    ("log_loss", ([0, 1, 1, 0], [0.1, 0.9, 0.4, 0.2])),
    ("log_loss", ([0, 1, 2, 1], [[0.7, 0.2, 0.1], [0.1, 0.8, 0.1],
                                 [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]])),
    ("mean_squared_error", ([1.0, 2.0, 4.0], [1.0, 3.0, 3.5])),
    ("mean_absolute_error", ([1.0, 2.0, 4.0], [1.0, 3.0, 3.5])),
    ("r2_score", ([1.0, 2.0, 3.0], [1.1, 1.9, 3.2])),
])
def test_metrics_match_reference(fn, args):
    got = getattr(metrics, fn)(*args)
    assert got == getattr(ref_metrics, fn)(*args)
    w = np.array([1.0, 2.0, 1.0, 0.5][:len(args[0])])
    assert getattr(metrics, fn)(*args, sample_weight=w) \
        == getattr(ref_metrics, fn)(*args, sample_weight=w)


@pytest.mark.parametrize("wrapper", ["ParallelPostFit", "Incremental"])
def test_wrappers_match_reference(wrapper):
    from sklearn.linear_model import SGDClassifier

    df = _training_df()
    X, y = df[["x", "y"]].to_numpy(), df.target.to_numpy()
    outs = []
    for mod in (wrappers, ref_wrappers):
        kw = {"random_state": 3} if wrapper == "Incremental" else {}
        m = getattr(mod, wrapper)(SGDClassifier(random_state=0),
                                  block_rows=32, **kw)
        m.fit(X, y)
        outs.append((m.predict(X), sorted(m.get_params()),
                     m.score(X, y)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]


# ----------------------------------------------- the engine's own models
def _xy(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 3) * np.array([50.0, 0.1, 0.08])
    y = X @ np.array([900.0, -3000.0, 500.0]) + 40.0 + rng.randn(n)
    return X, y


@pytest.mark.parametrize("name", ["LinearRegression", "LogisticRegression"])
def test_native_fits_agree_with_the_reference(name):
    """Both fit in float32: the weights agree to 1e-4 relative.  The
    gradient steps take unit-scaled features (at lr 0.1 a feature of
    scale 50 makes the steps oscillate, where float32 rounding in either
    engine decides the path)."""
    X, y = _xy()
    if name == "LogisticRegression":
        X = X / X.max(axis=0)
        y = (y > np.median(y)).astype(np.int64)
    ref = getattr(jax_models, name)().fit(X, y)
    port = getattr(torch_models, name)(device="cpu").fit(X, y)
    rw = np.asarray(ref._w)
    np.testing.assert_allclose(port._w.numpy(), rw,
                               rtol=1e-4, atol=1e-4 * np.abs(rw).max())
    if name == "LogisticRegression":
        np.testing.assert_array_equal(port.classes_, ref.classes_)
    assert set(port.get_params()) == set(ref.get_params())


def test_kmeans_lloyd_steps_agree_on_the_references_initial_centers():
    """The reference draws its initial centers with jax.random.choice, the
    port with a torch.Generator (a divergence by design); from the same
    initial centers the Lloyd steps agree."""
    import jax

    X, _ = _xy(300, seed=4)
    X = X[:, :2]
    ref = jax_models.KMeans(n_clusters=4, n_iter=20, seed=2).fit(X)
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(2), X.shape[0],
                                       (4,), replace=False))
    init = X.astype(np.float32)[idx]
    port = torch_models.KMeans(n_clusters=4, n_iter=20, seed=2,
                               device="cpu").fit(X, init_centers=init)
    np.testing.assert_allclose(port.cluster_centers_.numpy(),
                               np.asarray(ref.cluster_centers_), rtol=1e-4)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    # a seed picks distinct rows, the same ones each fit
    a = torch_models.KMeans(n_clusters=4, seed=5, n_iter=0,
                            device="cpu").fit(X)
    b = torch_models.KMeans(n_clusters=4, seed=5, n_iter=0,
                            device="cpu").fit(X)
    assert torch.equal(a.cluster_centers_, b.cluster_centers_)
    assert len(np.unique(a.cluster_centers_.numpy(), axis=0)) == 4


@pytest.mark.parametrize("name", ["LinearRegression", "LogisticRegression",
                                  "KMeans"])
def test_native_predictions_on_carried_weights(name):
    X, y = _xy(seed=1)
    if name == "LogisticRegression":
        y = (y > np.median(y)).astype(np.int64)
    ref = getattr(jax_models, name)()
    ref.fit(X) if name == "KMeans" else ref.fit(X, y)
    arrays = {k: np.asarray(getattr(ref, k))
              for k in ("_w", "classes_", "cluster_centers_")
              if getattr(ref, k, None) is not None}
    params = {k: v for k, v in ref.get_params().items()
              if k not in arrays}
    port = torch_models.fitted(getattr(torch_models, name), params,
                               device="cpu", **arrays)
    Xt = _xy(50, seed=7)[0]
    got, want = port.predict(Xt), np.asarray(ref.predict(Xt))
    if name == "LinearRegression":
        np.testing.assert_allclose(got, want, rtol=5e-6)
    else:
        np.testing.assert_array_equal(got, want)
    if name == "LogisticRegression":
        np.testing.assert_allclose(port.predict_proba(Xt),
                                   np.asarray(ref.predict_proba(Xt)),
                                   rtol=5e-6, atol=1e-7)
    with pytest.raises(ValueError, match="no fitted"):
        torch_models.fitted(getattr(torch_models, name), params,
                            device="cpu", coef_=np.zeros(3))


def test_models_pickle_their_tensors_on_the_host():
    X, y = _xy()
    m = torch_models.LinearRegression(device="cpu").fit(X, y)
    state = m.__getstate__()
    assert state["_w"].device.type == "cpu" and state["_device"] == "cpu"
    back = pickle.loads(pickle.dumps(m))
    np.testing.assert_array_equal(back.predict(X), m.predict(X))
    assert back.get_params() == m.get_params()
    # a model built by hand runs on the card unless asked otherwise
    assert torch_models.KMeans()._device.type == "cuda"
    assert "device" not in torch_models.KMeans().get_params()


# -------------------------------------------------------- the statements
@pytest.mark.parametrize("model_class, extra", [
    ("LinearRegression", "target_column = 'target'"),
    ("LogisticRegression", "target_column = 'target'"),
    ("sklearn.linear_model.LogisticRegression",
     "wrap_predict = True, target_column = 'target'"),
    ("sklearn.linear_model.SGDClassifier",
     "wrap_fit = True, target_column = 'target'"),
])
def test_create_model_and_predict_on_the_host_tier(pair, model_class,
                                                   extra):
    _both(pair, f"""CREATE OR REPLACE MODEL hm WITH (
                        model_class = '{model_class}', {extra}
                    ) AS (SELECT x, y, target FROM timeseries)""")
    out = _both(pair, "SELECT * FROM PREDICT(MODEL hm, "
                      "SELECT x, y FROM timeseries)", config_options=HOST)
    for e in ENGINES:
        model, cols = pair[e].get_model(pair[e].schema_name, "hm")
        assert cols == ["x", "y"]
        np.testing.assert_array_equal(
            out[e]["target"].to_numpy(),
            model.predict(_training_df()[cols].to_numpy()))
    assert list(out["port"].columns) == list(out["ref"].columns)
    if model_class == "sklearn.linear_model.LogisticRegression":
        # deterministic: the same fit on the same rows (SGDClassifier
        # shuffles with an unseeded state)
        pd.testing.assert_frame_equal(out["port"], out["ref"],
                                      check_dtype=False)
    elif model_class == "LinearRegression":
        np.testing.assert_allclose(out["port"]["target"],
                                   out["ref"]["target"], rtol=1e-4,
                                   atol=1e-4)
    ported, _ = pair["port"].get_model("root", "hm")
    if not model_class.startswith("sklearn"):
        assert ported._device == pair["port"].device


def test_kmeans_statement_trains_on_the_context_device(pair):
    _both(pair, """CREATE OR REPLACE MODEL km WITH (
                       model_class = 'KMeans', n_clusters = 2
                   ) AS (SELECT x, y FROM timeseries)""")
    out = _both(pair, "SELECT * FROM PREDICT(MODEL km, "
                      "SELECT x, y FROM timeseries)", config_options=HOST)
    for e in ENGINES:
        assert set(out[e]["target"]) <= {0, 1}
    model, _ = pair["port"].get_model("root", "km")
    assert model.cluster_centers_.device == pair["port"].device


def test_show_describe_drop_model_match_reference(pair):
    for name in ("m1", "m2"):
        _both(pair, f"""CREATE OR REPLACE MODEL {name} WITH (
                            model_class = 'LinearRegression',
                            target_column = 'target'
                        ) AS (SELECT x, y, target FROM timeseries)""")
    shows = _both(pair, "SHOW MODELS")
    for s in shows.values():
        s.sort_values("Model", inplace=True, ignore_index=True)
    pd.testing.assert_frame_equal(shows["port"], shows["ref"])
    desc = _both(pair, "DESCRIBE MODEL m1")
    pd.testing.assert_frame_equal(desc["port"], desc["ref"])
    assert dict(zip(desc["port"]["Params"], desc["port"]["Value"]))[
        "lowering.tier"] == "compiled"
    _both(pair, "DROP MODEL m1")
    _both(pair, "DROP MODEL IF EXISTS m1")
    for e in ENGINES:
        assert "m1" not in pair[e].schema[pair[e].schema_name].models
        with pytest.raises(RuntimeError):
            pair[e].sql("DROP MODEL m1")


def test_export_model_match_reference(pair, tmp_path):
    _both(pair, """CREATE OR REPLACE MODEL ex WITH (
                       model_class = 'LinearRegression',
                       target_column = 'target'
                   ) AS (SELECT x, y, target FROM timeseries)""")
    X = _training_df()[["x", "y"]].to_numpy()
    for e in ENGINES:
        path = tmp_path / f"{e}.pkl"
        pair[e].sql(f"EXPORT MODEL ex WITH (format = 'pickle', "
                    f"location = '{path}')")
        with open(path, "rb") as f:
            model = pickle.load(f)
        np.testing.assert_array_equal(
            model.predict(X), pair[e].get_model("root", "ex")[0].predict(X))
        jl = tmp_path / f"{e}.joblib"
        pair[e].sql(f"EXPORT MODEL ex WITH (format = 'joblib', "
                    f"location = '{jl}')")
        assert jl.exists()
    errors = {}
    for e in ENGINES:
        got = []
        for fmt in ("carbonite", "mlflow", "onnx"):
            with pytest.raises(RuntimeError) as ei:
                pair[e].sql(f"EXPORT MODEL ex WITH (format = '{fmt}', "
                            f"location = '{tmp_path / fmt}')")
            got.append((type(ei.value).__name__, str(ei.value)))
        errors[e] = got
    assert errors["port"] == errors["ref"]
    assert [n for n, _ in errors["port"]] == ["ModelError", "RuntimeError",
                                              "ModelError"]
    assert pickle.load(open(tmp_path / "port.pkl", "rb")).__getstate__()[
        "_w"].device.type == "cpu"


def test_create_experiment_match_reference(pair):
    out = _both(pair, """CREATE OR REPLACE EXPERIMENT grid_exp WITH (
                             model_class =
                                 'sklearn.linear_model.LogisticRegression',
                             tune_parameters = (C = (0.1, 1.0, 10.0)),
                             target_column = 'target'
                         ) AS (SELECT x, y, target FROM timeseries)""")
    assert list(out["port"].columns) == list(out["ref"].columns)
    for col in ("params", "mean_test_score", "rank_test_score"):
        assert list(out["port"][col]) == list(out["ref"][col])
    res = {e: pair[e].schema[pair[e].schema_name].experiments["grid_exp"]
           for e in ENGINES}
    assert len(res["port"]) == 3
    pred = _both(pair, "SELECT * FROM PREDICT(MODEL grid_exp, "
                       "SELECT x, y FROM timeseries)", config_options=HOST)
    pd.testing.assert_frame_equal(pred["port"], pred["ref"],
                                  check_dtype=False)


@pytest.mark.parametrize("sql", [
    """CREATE MODEL bad WITH (target_column = 'target')
       AS (SELECT x, y, target FROM timeseries)""",
    """CREATE MODEL bad WITH (model_class = 'NotARealModelClass',
       target_column = 'target') AS (SELECT x, y, target FROM timeseries)""",
    """CREATE MODEL bad WITH (model_class = 'LinearRegression',
       experiment_class = 'sklearn.model_selection.GridSearchCV',
       target_column = 'target') AS (SELECT x, y, target FROM timeseries)""",
    """CREATE MODEL bad WITH (model_class = 'LinearRegression',
       target_column = 'no_such_column')
       AS (SELECT x, y, target FROM timeseries)""",
    "SELECT * FROM PREDICT(MODEL ghost, SELECT x, y FROM timeseries)",
    "DESCRIBE MODEL ghost",
    "DROP MODEL ghost",
    """CREATE EXPERIMENT bad_exp WITH (tune_parameters = (C = (0.1, 1.0)),
       target_column = 'target') AS (SELECT x, y, target FROM timeseries)""",
])
def test_error_taxonomy_matches_reference(pair, sql):
    got = {}
    for e in ENGINES:
        with pytest.raises(Exception) as ei:
            pair[e].sql(sql, return_futures=False)
        got[e] = (type(ei.value).__name__, getattr(ei.value, "code", None))
    assert got["port"] == got["ref"]


def test_duplicate_model_and_replace(pair):
    create = """CREATE MODEL dup WITH (
                    model_class = 'LinearRegression', target_column = 'target'
                ) AS (SELECT x, y, target FROM timeseries)"""
    for e in ENGINES:
        pair[e].sql(create)
        with pytest.raises(ModelError if e == "port" else RuntimeError,
                           match="already present"):
            pair[e].sql(create)
        first = pair[e].get_model("root", "dup")[0]
        pair[e].sql(create.replace("CREATE MODEL", "CREATE MODEL IF NOT "
                                                   "EXISTS"))
        assert pair[e].get_model("root", "dup")[0] is first
        pair[e].sql(create.replace("CREATE MODEL", "CREATE OR REPLACE MODEL"))
        assert pair[e].get_model("root", "dup")[0] is not first


def test_model_boundary_keeps_resource_taxonomy():
    def oom():
        raise MemoryError("predict allocation")

    with pytest.raises(ResourceExhaustedError):
        _model_boundary("PREDICT(MODEL m)", oom)

    def bad():
        raise TypeError("bad feature matrix")

    with pytest.raises(ModelError) as ei:
        _model_boundary("PREDICT(MODEL m)", bad)
    assert ei.value.code == "MODEL_ERROR"


@pytest.mark.parametrize("wrap_predict,wrap_fit", [
    (False, False), (True, False), (False, True), (True, True)])
def test_wrap_matrix(pair, wrap_predict, wrap_fit):
    c = pair["port"]
    c.sql(f"""CREATE OR REPLACE MODEL wm WITH (
                  model_class = 'sklearn.linear_model.SGDClassifier',
                  wrap_predict = {str(wrap_predict)},
                  wrap_fit = {str(wrap_fit)},
                  target_column = 'target'
              ) AS (SELECT x, y, target FROM timeseries)""")
    model, cols = c.get_model(c.schema_name, "wm")
    if wrap_fit:
        assert isinstance(model, wrappers.Incremental)
    elif wrap_predict:
        assert isinstance(model, wrappers.ParallelPostFit)
    result = c.sql("SELECT * FROM PREDICT(MODEL wm, "
                   "SELECT x, y FROM timeseries)").compute()
    assert len(result) == 100
