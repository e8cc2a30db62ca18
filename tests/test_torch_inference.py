"""Compiled in-plan inference in the port (`dask_sql_tpu_torch/inference/`,
`physical/compiled_predict.py`) against the reference's
(`tests/unit/test_inference.py`).

Every lowering runs against the reference's program on the same fitted
sklearn model (trees, forests and GBDTs, regressor and classifier, binary
and multiclass, depths 2 and 5, float32 and float64 inputs): the same
params, shape keys and decline reasons, labels exact and sums within
1e-12.  The engine's own models are held on carried weights.  The fused
``compiled_predict`` rung runs on a port CPU Context and a reference
Context fed the same statements: the same rows and the same
``resilience.rung.*`` counters; a literal variant and a same-shape retrain
build no pipeline; the ``predict`` fault steps down to the host tier and
trips the breaker; a nullable feature and ``sql.compile.predict`` off keep
the host tier; EXPLAIN ESTIMATE's ``model:`` row; the ledger's model bytes,
the pressure controller's model tier and DROP MODEL's eviction.  The
reference's config is process-wide: what a test sets there is restored
after it.
"""
import types

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu import config as ref_config_module
from dask_sql_tpu.inference import try_lower as ref_try_lower
from dask_sql_tpu.ml import jax_models
from dask_sql_tpu.resilience import faults as ref_faults
from dask_sql_tpu_torch import Context, inference, utils
from dask_sql_tpu_torch.inference import programs
from dask_sql_tpu_torch.inference import try_lower
from dask_sql_tpu_torch.ml import torch_models
from dask_sql_tpu_torch.physical import compiled, compiled_predict as cp
from dask_sql_tpu_torch.resilience import faults

ENGINES = ("port", "ref")
FOREST = dict(n_estimators=6, max_depth=4, random_state=0)
PRED = "SELECT * FROM PREDICT(MODEL m, SELECT x, y FROM t WHERE x < {})"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the reference config keys the tests set (its config is process-wide)
_REF_KEYS = ("serving.cache.enabled", "resilience.inject",
             "serving.admission.max_estimated_bytes", "sql.compile.predict",
             "serving.bg_compile.enabled",
             "resilience.pressure.model_idle_s")


@pytest.fixture(autouse=True, scope="module")
def _restore_ref_config_after_the_module():
    """Set up before the module-scoped Context pair (which turns the
    reference's result cache off), restored after the module."""
    before = {k: ref_config_module.config.get(k) for k in _REF_KEYS}
    yield
    ref_config_module.config.update(before)


@pytest.fixture(autouse=True)
def _restore_ref_config():
    before = {k: ref_config_module.config.get(k) for k in _REF_KEYS}
    faults.reset()
    ref_faults.reset()
    yield
    ref_config_module.config.update(before)
    faults.reset()
    ref_faults.reset()


def _df(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({
        "x": rng.rand(n),
        "y": rng.rand(n),
        "code": rng.choice([10, 20, 30, 40], n).astype(np.int64),
    })
    df["target"] = (df.x + df.y > 1).astype(np.int64)
    return df


def _ctx(engine, df=None):
    df = _df() if df is None else df
    if engine == "port":
        c = Context(device="cpu",
                    config_options={"serving.cache.enabled": False})
    else:
        c = dask_sql_tpu.Context()
        c.config.update({"serving.cache.enabled": False})
    c.create_table("t", df)
    return c


def _forest(c, **kw):
    opts = dict(FOREST)
    opts.update(kw)
    with_opts = ", ".join(f"{k} = {v}" for k, v in opts.items())
    c.sql(f"""CREATE OR REPLACE MODEL m WITH (
              model_class = 'sklearn.ensemble.RandomForestClassifier',
              target_column = 'target', {with_opts})
              AS (SELECT x, y, target FROM t)""")


def _counters(c, *prefixes):
    return {k: v for k, v in c.metrics.snapshot()["counters"].items()
            if k.startswith(prefixes)}


def _port_apply(program, X):
    params = tuple(torch.as_tensor(p) for p in program.params)
    return program.apply(params, torch.as_tensor(
        np.asarray(X, dtype=np.float64))).numpy()


def _ref_apply(program, X):
    import jax
    import jax.numpy as jnp

    params = tuple(jnp.asarray(p) for p in program.params)
    return np.asarray(jax.jit(program.apply)(
        params, jnp.asarray(np.asarray(X), dtype=jnp.float64)))


def _same_program(port, ref):
    assert port.kind == ref.kind and port.output == ref.output
    assert port.shape_key == ref.shape_key
    assert port.meta == ref.meta and port.describe() == ref.describe()
    assert port.param_bytes == ref.param_bytes
    for a, b in zip(port.params, ref.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- lowering
def _sk(path):
    mod, _, name = path.rpartition(".")
    return getattr(__import__(mod, fromlist=["x"]), name)


MAKERS = {
    "tree_regressor": ("sklearn.tree.DecisionTreeRegressor", {}, False),
    "tree_classifier": ("sklearn.tree.DecisionTreeClassifier", {}, True),
    "forest_regressor": ("sklearn.ensemble.RandomForestRegressor",
                         {"n_estimators": 10}, False),
    "forest_classifier": ("sklearn.ensemble.RandomForestClassifier",
                          {"n_estimators": 10}, True),
    "gbdt_regressor": ("sklearn.ensemble.GradientBoostingRegressor",
                       {"n_estimators": 10}, False),
    "gbdt_classifier": ("sklearn.ensemble.GradientBoostingClassifier",
                        {"n_estimators": 6}, True),
}


@pytest.mark.parametrize("kind", list(MAKERS))
@pytest.mark.parametrize("depth", [2, 5])
def test_tree_lowerings_match_reference(kind, depth):
    """Binary and multiclass for classifiers, float64 and float32 inputs:
    the port's program has the reference's params and shape key, labels
    equal exactly and sums within 1e-12, and both equal sklearn."""
    path, kw, classify = MAKERS[kind]
    for seed, dtype in ((1, np.float64), (2, np.float32)):
        rng = np.random.RandomState(seed)
        X = (rng.rand(200, 4) * 100).astype(dtype)
        s = X[:, 0].astype(np.float64) + X[:, 1].astype(np.float64)
        if classify:
            # binary on the first seed, three classes on the second
            y = (s > 100).astype(np.int64) if seed == 1 \
                else np.digitize(s, [70, 130]).astype(np.int64)
        else:
            y = X.astype(np.float64) @ rng.rand(4) + rng.randn(200)
        model = _sk(path)(max_depth=depth, random_state=seed, **kw).fit(X, y)
        program, reason = try_lower(model)
        ref, _ = ref_try_lower(model)
        assert program is not None, reason
        assert program.kind == kind
        _same_program(program, ref)
        Xt = (rng.rand(97, 4) * 100).astype(dtype)
        out, want = _port_apply(program, Xt), _ref_apply(ref, Xt)
        if classify:
            np.testing.assert_array_equal(out, want)
            np.testing.assert_array_equal(out, model.predict(Xt))
        else:
            np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(out, model.predict(Xt), rtol=1e-9,
                                       atol=1e-9)


def test_linear_logistic_kmeans_scaler_lowerings_match_reference():
    from sklearn.cluster import KMeans
    from sklearn.linear_model import LinearRegression, LogisticRegression
    from sklearn.preprocessing import StandardScaler

    rng = np.random.RandomState(0)
    X = rng.rand(150, 3)
    Xt = rng.rand(40, 3)
    yreg = X @ rng.rand(3)
    for model, y, classify in (
            (LinearRegression(), yreg, False),
            (LogisticRegression(max_iter=300), (X[:, 0] > 0.5).astype(int),
             True),
            (LogisticRegression(max_iter=300),
             np.digitize(X[:, 0] + X[:, 1], [0.7, 1.3]), True),
            (KMeans(n_clusters=3, n_init=2, random_state=0), None, True),
            (StandardScaler(), None, False)):
        model.fit(X) if y is None else model.fit(X, y)
        program, reason = try_lower(model)
        ref, _ = ref_try_lower(model)
        assert program is not None, reason
        _same_program(program, ref)
        out, want = _port_apply(program, Xt), _ref_apply(ref, Xt)
        if program.output == "matrix":
            np.testing.assert_allclose(out, model.transform(Xt), rtol=1e-12)
        elif classify:
            np.testing.assert_array_equal(out, want)
            np.testing.assert_array_equal(out, model.predict(Xt))
        else:
            np.testing.assert_allclose(out, want, rtol=1e-12)


@pytest.mark.parametrize("name", ["LinearRegression", "LogisticRegression",
                                  "KMeans"])
def test_native_programs_on_carried_weights(name):
    """The reference's fitted arrays carried into a port model lower to
    the reference's program: predictions within 5e-6 relative, labels and
    cluster ids exact."""
    rng = np.random.RandomState(3)
    X = rng.rand(300, 3)
    y = X @ np.array([3.0, -2.0, 0.5]) + 0.25
    if name == "LogisticRegression":
        y = (y > np.median(y)).astype(np.int64)
    ref_model = getattr(jax_models, name)()
    ref_model.fit(X) if name == "KMeans" else ref_model.fit(X, y)
    arrays = {k: np.asarray(getattr(ref_model, k))
              for k in ("_w", "classes_", "cluster_centers_")
              if getattr(ref_model, k, None) is not None}
    params = {k: v for k, v in ref_model.get_params().items()
              if k not in arrays}
    model = torch_models.fitted(getattr(torch_models, name), params,
                                device="cpu", **arrays)
    program, reason = try_lower(model)
    ref, _ = ref_try_lower(ref_model)
    assert program is not None, reason
    _same_program(program, ref)
    Xt = rng.rand(64, 3)
    out, want = _port_apply(program, Xt), _ref_apply(ref, Xt)
    if name == "LinearRegression":
        np.testing.assert_allclose(out, want, rtol=5e-6)
    else:
        np.testing.assert_array_equal(out, want)
    # and the program agrees with the model's own predict (its bias rides
    # the column of ones there: float32 rounding apart)
    if name == "LinearRegression":
        np.testing.assert_allclose(out, model.predict(Xt), rtol=5e-6)
    else:
        np.testing.assert_array_equal(out, model.predict(Xt))


def _decline_models(native):
    from sklearn.ensemble import (GradientBoostingRegressor,
                                  RandomForestRegressor)
    from sklearn.linear_model import LinearRegression
    from sklearn.naive_bayes import GaussianNB
    from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

    rng = np.random.RandomState(0)
    X = rng.rand(64, 3)
    y = X @ rng.rand(3)
    labels = np.array(["a", "b"] * 32)
    broken = DecisionTreeRegressor(max_depth=2).fit(X, y)
    broken.tree_ = None
    return [
        native.ParallelPostFit(DecisionTreeClassifier(max_depth=2).fit(
            X, (labels == "a").astype(int))),
        DecisionTreeClassifier(max_depth=2).fit(X, labels),
        RandomForestRegressor(n_estimators=3, max_depth=3,
                              random_state=0).fit(X, np.stack([y, -y], 1)),
        GradientBoostingRegressor(n_estimators=3, max_depth=2,
                                  init=LinearRegression(),
                                  random_state=0).fit(X, y),
        GaussianNB().fit(X, (y > y.mean()).astype(int)),
        broken,
        native.models.LinearRegression(),
        native.models.LogisticRegression(),
        native.models.KMeans(),
    ]


def test_every_decline_reason_is_the_references():
    from dask_sql_tpu.ml import wrappers as ref_wrappers
    from dask_sql_tpu_torch.ml import wrappers

    port = types.SimpleNamespace(models=torch_models, **{
        "ParallelPostFit": wrappers.ParallelPostFit})
    ref = types.SimpleNamespace(models=jax_models, **{
        "ParallelPostFit": ref_wrappers.ParallelPostFit})
    port_reasons = [try_lower(m) for m in _decline_models(port)]
    ref_reasons = [ref_try_lower(m) for m in _decline_models(ref)]
    assert all(p is None for p, _ in port_reasons)
    assert [r for _, r in port_reasons] == [r for _, r in ref_reasons]
    assert [r for _, r in port_reasons][:5] == [
        "wrapped model (wrap_predict/wrap_fit) keeps the host path",
        "non-numeric class labels", "multi-output model",
        "gbdt baseline probe failed", "no tensor lowering for GaussianNB"]
    assert port_reasons[5][1].startswith("lowering error: AttributeError")
    assert {r for _, r in port_reasons[6:]} == {"model is not fitted"}


def test_shape_key_kept_across_retrain():
    from sklearn.ensemble import GradientBoostingRegressor

    rng = np.random.RandomState(0)
    X = rng.rand(300, 5)
    y = X @ rng.rand(5)
    a = GradientBoostingRegressor(n_estimators=10, max_depth=3,
                                  random_state=1).fit(X, y)
    b = GradientBoostingRegressor(n_estimators=10, max_depth=3,
                                  random_state=9).fit(X[::-1], y[::-1])
    pa, pb = try_lower(a)[0], try_lower(b)[0]
    assert pa.shape_key == pb.shape_key
    assert any((np.asarray(x) != np.asarray(z)).any()
               for x, z in zip(pa.params, pb.params))
    la = torch_models.LinearRegression(device="cpu").fit(X, y)
    lb = torch_models.LinearRegression(device="cpu", l2=5.0).fit(X, y)
    assert try_lower(la)[0].shape_key == try_lower(lb)[0].shape_key


# ------------------------------------------------------------ fused rung
@pytest.fixture(scope="module")
def forest_pair():
    """Module-shared port and reference Contexts with the same forest;
    tests read counter deltas."""
    pair = {e: _ctx(e) for e in ENGINES}
    for c in pair.values():
        _forest(c)
    return pair


def test_fused_rung_matches_host_tier_and_reference(forest_pair):
    df = _df()
    sub = df[df.x < 0.5]
    out, rungs = {}, {}
    for e in ENGINES:
        c = forest_pair[e]
        if e == "ref":
            c.config.update({"serving.cache.enabled": False})
        before = _counters(c, "resilience.rung.", "inference.predict")
        t0 = utils.TRANSFER_STATS["d2h"]
        out[e] = c.sql(PRED.format(0.5), return_futures=False)
        if e == "port":
            # the mask's count, then the one packed gather
            assert utils.TRANSFER_STATS["d2h"] - t0 == 2
        after = _counters(c, "resilience.rung.", "inference.predict")
        rungs[e] = {k: v - before.get(k, 0) for k, v in after.items()
                    if v != before.get(k, 0)}
    assert rungs["port"] == rungs["ref"] == {
        "resilience.rung.compiled_predict": 1,
        "inference.predict.compiled": 1}
    pd.testing.assert_frame_equal(out["port"], out["ref"], check_dtype=False)
    model, cols = forest_pair["port"].get_model("root", "m")
    np.testing.assert_array_equal(out["port"]["target"].to_numpy(),
                                  model.predict(sub[cols].to_numpy()))
    host = forest_pair["port"].sql(
        PRED.format(0.5), return_futures=False,
        config_options={"sql.compile.predict": False})
    pd.testing.assert_frame_equal(host, out["port"], check_dtype=False)


def test_native_model_fused_rung_matches_host_tier():
    c = _ctx("port")
    c.sql("""CREATE MODEL lin WITH (model_class = 'LinearRegression',
             target_column = 'target') AS (SELECT x, y, target FROM t)""")
    sql = "SELECT * FROM PREDICT(MODEL lin, SELECT x, y FROM t " \
          "WHERE x < 0.3)"
    fused = c.sql(sql, return_futures=False)
    host = c.sql(sql, return_futures=False,
                 config_options={"sql.compile.predict": False})
    assert c.metrics.counter("inference.predict.compiled") == 1
    assert c.metrics.counter("inference.predict.host") == 1
    np.testing.assert_allclose(fused["target"], host["target"], rtol=5e-6,
                               atol=1e-6)


def _builds(c):
    hist = c.metrics.snapshot()["histograms"]
    return hist.get("resilience.compile_ms.compiled_predict",
                    {}).get("count", 0)


def test_variant_and_swap_build_no_pipeline():
    c = _ctx("port")
    _forest(c, random_state=3)
    c.sql(PRED.format(0.74), return_futures=False)
    assert _builds(c) == 1
    c.sql(PRED.format(0.75), return_futures=False)
    assert _builds(c) == 1
    assert c.metrics.counter("families.hit") == 1
    # a retrain of the same hyper-shape swaps the weights
    _forest(c, random_state=11)
    res = c.sql(PRED.format(0.75), return_futures=False)
    assert _builds(c) == 1
    assert c.metrics.counter("inference.model.swap") == 1
    assert c.metrics.counter("families.hit") == 2
    df = _df()
    model, cols = c.get_model("root", "m")
    np.testing.assert_array_equal(
        res["target"].to_numpy(),
        model.predict(df[df.x < 0.75][cols].to_numpy()))
    from dask_sql_tpu_torch.observability import flight

    assert flight.RECORDER.events(name="model.swap")


def test_predict_fault_steps_down_and_trips_breaker():
    got = {}
    for e in ENGINES:
        c = _ctx(e)
        _forest(c)
        model, cols = c.get_model(c.schema_name, "m")
        df = _df()
        expected = model.predict(df[df.x < 0.5][cols].to_numpy())
        before = _counters(c, "resilience.", "inference.")
        c.config.update({"resilience.inject": "predict:3"})
        for _ in range(4):
            res = c.sql(PRED.format(0.5), return_futures=False)
            np.testing.assert_array_equal(res["target"].to_numpy(), expected)
        after = _counters(c, "resilience.", "inference.")
        got[e] = {k: after[k] - before.get(k, 0) for k in (
            "resilience.degraded.compiled_predict", "inference.predict.host",
            "resilience.breaker.trip",
            "resilience.breaker.skip.compiled_predict")}
    assert got["port"] == got["ref"]
    assert got["port"]["resilience.degraded.compiled_predict"] == 3
    assert got["port"]["inference.predict.host"] == 4
    assert got["port"]["resilience.breaker.skip.compiled_predict"] >= 1


def test_predict_fault_propagates_with_the_ladder_off():
    c = _ctx("port")
    _forest(c)
    with pytest.raises(Exception) as ei:
        c.sql(PRED.format(0.5), return_futures=False, config_options={
            "resilience.inject": "predict:once",
            "resilience.ladder.enabled": False})
    assert ei.value.code == "INJECTED_RESOURCE_EXHAUSTED"


def test_nullable_feature_and_off_switch_keep_the_host_tier():
    df2 = _df()
    df2.loc[df2.index[:5], "x"] = np.nan
    got = {}
    for e in ENGINES:
        c = _ctx(e)
        _forest(c)
        c.create_table("tn", df2)
        before = _counters(c, "inference.predict")
        res = c.sql("SELECT * FROM PREDICT(MODEL m, SELECT x, y FROM tn "
                    "WHERE y < 0.9)", return_futures=False)
        model, cols = c.get_model(c.schema_name, "m")
        np.testing.assert_array_equal(
            res["target"].to_numpy(),
            model.predict(df2[df2.y < 0.9][cols].to_numpy()))
        c.config.update({"sql.compile.predict": False})
        off = c.sql(PRED.format(0.5), return_futures=False)
        assert len(off) == (_df().x < 0.5).sum()
        after = _counters(c, "inference.predict")
        got[e] = {k: v - before.get(k, 0) for k, v in after.items()}
    assert got["port"] == got["ref"] == {"inference.predict.host": 2}


def test_explain_estimate_model_row_against_reference():
    rows = {}
    for e in ENGINES:
        c = _ctx(e)
        _forest(c)
        c.sql("""CREATE MODEL lin WITH (model_class = 'LinearRegression',
                 target_column = 'target') AS (SELECT x, y, target FROM t)""")
        out = {}
        for name in ("m", "lin"):
            for off in (False, True):
                opts = {"sql.compile.predict": not off}
                if e == "ref":
                    c.config.update(opts)
                res = c.sql(
                    f"EXPLAIN ESTIMATE SELECT * FROM PREDICT(MODEL {name}, "
                    "SELECT x, y FROM t WHERE x < 0.5)",
                    return_futures=False, config_options=opts
                    if e == "port" else None)
                text = list(res[res.columns[0]].astype(str))
                out[(name, off)] = (
                    [r for r in text if r.startswith("model:")],
                    next(r for r in text if r.startswith("estimate:")))
        rows[e] = out
    # the forest's rows are the reference's but the per-row floor, which
    # is the port's walk where that holds more
    program, _ = try_lower(_forest_model())
    ref_floor = 16 + 6 * 12 + 6 * 8 * 2
    walk = programs.walk_bytes_per_row(program, 2)
    assert walk > ref_floor
    assert inference.predict_scratch_bytes(program, 2) == walk
    for key in rows["port"]:
        port_model, port_est = rows["port"][key]
        ref_model, ref_est = rows["ref"][key]
        assert len(port_model) == len(ref_model) == 1
        if key[0] == "m":
            ref_model = [r.replace(f"row_floor={ref_floor}",
                                   f"row_floor={walk}") for r in ref_model]
        assert port_model == ref_model
        assert "rows_hi=3000" in port_est
    assert "tier=compiled" in rows["port"][("m", False)][0][0]
    assert "tier=host" in rows["port"][("m", True)][0][0]

    def bound(est, tag):
        return int(est.split(tag)[1].split()[0])

    on, off = rows["port"][("m", False)][1], rows["port"][("m", True)][1]
    assert bound(on, "bytes_lo=") == bound(off, "bytes_lo=")
    assert bound(off, "bytes_hi=") < bound(on, "bytes_hi=")


def _forest_model():
    from sklearn.ensemble import RandomForestClassifier

    df = _df()
    return RandomForestClassifier(**FOREST).fit(
        df[["x", "y"]].to_numpy(), df.target.to_numpy())


def test_tree_walk_charge_covers_the_walks_temporaries():
    """`peak_bytes.hi` of a tree PREDICT charges what the port's eager
    walk holds (ROADMAP.md divergences): per (row, tree) the int64 node
    and a step's two 8-byte temporaries and mask, or the leaf gather of
    8 bytes a class, above the reference's 12 (+ 8 a class)."""
    program, _ = try_lower(_forest_model())
    T, C = 6, 2
    assert programs.walk_bytes_per_row(program, 2) == \
        16 * 2 + T * (8 + 17) + 8 * (C + 2)
    regressor = types.SimpleNamespace(kind="gbdt_regressor",
                                      meta={"trees": 100})
    assert programs.walk_bytes_per_row(regressor, 3) == \
        48 + 100 * 25 + 8 * 3
    assert inference.predict_scratch_bytes(None, 3) == 24


def test_ledger_pressure_tier_and_drop_eviction():
    got = {}
    for e in ENGINES:
        c = _ctx(e)
        _forest(c)
        c.sql("SHOW MODELS", return_futures=False)
        c.sql("DESCRIBE MODEL m", return_futures=False)
        # advisory readers commit nothing
        assert c.ledger.snapshot()["modelBytes"] == 0
        c.sql(PRED.format(0.5), return_futures=False)
        committed = c.ledger.snapshot()["modelBytes"]
        c.ledger.publish(c.metrics)
        assert c.metrics.snapshot()["gauges"][
            "serving.ledger.model_bytes"] == committed
        c.config.update({"resilience.pressure.model_idle_s": 0.0})
        freed = c.pressure.reclaim(None, reason="oom")
        after_reclaim = c.ledger.snapshot()["modelBytes"]
        c.sql(PRED.format(0.5), return_futures=False)
        recommitted = c.ledger.snapshot()["modelBytes"]
        if e == "port":
            program, _ = try_lower(c.get_model("root", "m")[0])
            assert committed == program.param_bytes
        c.sql("DROP MODEL m", return_futures=False)
        got[e] = (committed, freed, after_reclaim, recommitted,
                  c.ledger.snapshot()["modelBytes"])
        if e == "port":
            token = compiled.pipeline_owner(c)
            assert not any(k[0] == token for k in cp._cache)
    assert got["port"] == got["ref"]
    committed = got["port"][0]
    assert committed > 0 and got["port"] == (committed, committed, 0,
                                             committed, 0)


def test_grown_table_rebuilds_the_predict_pipeline_in_background():
    """A seen PREDICT family over a replaced, larger table rebuilds on the
    background compiler while that query is served on the host tier (the
    reference's defer_rebuild); the next one answers on the fused rung."""
    c = _ctx("port")
    _forest(c)
    c.sql(PRED.format(0.5), return_futures=False)
    c.config.update({"serving.bg_compile.enabled": True})
    rng = np.random.RandomState(1)
    big = pd.DataFrame({"x": rng.rand(9000), "y": rng.rand(9000),
                        "code": rng.choice([10, 20, 30, 40], 9000)})
    big["target"] = (big.x + big.y > 1).astype(np.int64)
    c.create_table("t", big)
    res = c.sql(PRED.format(0.5), return_futures=False)
    assert c.metrics.counter("serving.bg_compile.deferred") == 1
    assert c.metrics.counter("inference.predict.host") == 1
    assert c.metrics.counter("resilience.degraded") == 0
    model, cols = c.get_model("root", "m")
    want = model.predict(big[big.x < 0.5][cols].to_numpy())
    np.testing.assert_array_equal(res["target"].to_numpy(), want)
    assert c.background_compiler().wait_idle(60)
    assert c.metrics.counter("serving.bg_compile.completed") == 1
    again = c.sql(PRED.format(0.5), return_futures=False)
    assert c.metrics.counter("inference.predict.compiled") == 2
    np.testing.assert_array_equal(again["target"].to_numpy(), want)
    bg = c.background_compiler()
    bg.cancel()
    bg.join(10)
    # no compiler thread outlives the test: another engine's chaos check
    # counts every thread of the process by name
    assert not bg._thread.is_alive()


def test_drop_model_evicts_only_its_pipelines():
    c = _ctx("port")
    _forest(c)
    c.sql("""CREATE MODEL lin WITH (model_class = 'LinearRegression',
             target_column = 'target') AS (SELECT x, y, target FROM t)""")
    c.sql(PRED.format(0.5), return_futures=False)
    c.sql("SELECT * FROM PREDICT(MODEL lin, SELECT x, y FROM t)",
          return_futures=False)
    token = compiled.pipeline_owner(c)
    mine = lambda: sorted(k[5] for k in cp._cache if k[0] == token)  # noqa
    assert mine() == ["lin", "m"]
    c.sql("DROP MODEL m", return_futures=False)
    assert mine() == ["lin"]
    del c
    import gc

    gc.collect()
    assert not any(k[0] == token for k in cp._cache)


def test_predict_over_dict_column_decodes_survivors_only(monkeypatch):
    """A DICT feature reaches the fused rung as codes; the gather program
    decodes the survivors' bucket only, never the whole column."""
    from dask_sql_tpu_torch.columnar.encodings import Encoding

    c = _ctx("port")
    tab = c.get_table_data(c.schema_name, "t")
    assert tab.columns["code"].encoding is Encoding.DICT
    c.sql("""CREATE MODEL dm WITH (
             model_class = 'sklearn.tree.DecisionTreeClassifier',
             target_column = 'target', max_depth = 4, random_state = 0)
             AS (SELECT x, y, code, target FROM t)""")
    decoded = []
    real = compiled._TraceEval._decode_slot

    def spy(self, index, slots):
        out = real(self, index, slots)
        decoded.append(int(out[0].shape[0]) if out[0].dim() else 1)
        return out

    monkeypatch.setattr(compiled._TraceEval, "_decode_slot", spy)
    res = c.sql("SELECT * FROM PREDICT(MODEL dm, SELECT x, y, code FROM t "
                "WHERE code = 20)", return_futures=False)
    df = _df()
    sub = df[df.code == 20]
    assert c.metrics.counter("inference.predict.compiled") == 1
    assert c.metrics.counter("columnar.encoding.late_rows") == len(sub)
    bucket = 1 << (len(sub) - 1).bit_length()
    # the construction check's one row, then the survivors' bucket
    assert decoded and max(decoded) == bucket < len(df)
    model, cols = c.get_model(c.schema_name, "dm")
    np.testing.assert_array_equal(res["target"].to_numpy(),
                                  model.predict(sub[cols].to_numpy()))


def test_predict_burst_runs_solo_launches():
    """The reference's batcher stacks a burst of PREDICT members into one
    launch; the port's compiled select has no batcher, so each member of
    a burst runs its own launch with its solo answer and the
    ``serving.batch.*`` counters stay 0 (ROADMAP.md divergences)."""
    from dask_sql_tpu_torch.serving import ServingRuntime

    c = _ctx("port")
    _forest(c)
    c.config.update({"serving.batch.window_ms": 50.0})
    c.sql(PRED.format(0.5), return_futures=False)
    rt = ServingRuntime.from_config(c.config, c.metrics)
    c.serving = rt
    try:
        lits = (0.2, 0.4, 0.6, 0.8)
        futs = [c.submit(PRED.format(v))[1] for v in lits]
        outs = [f.result(60) for f in futs]
    finally:
        rt.shutdown(wait=True)
        c.serving = None
    df = _df()
    model, cols = c.get_model("root", "m")
    for v, out in zip(lits, outs):
        np.testing.assert_array_equal(
            out["target"].to_numpy(),
            model.predict(df[df.x < v][cols].to_numpy()))
    counters = _counters(c, "serving.batch.", "inference.predict")
    assert counters.get("inference.predict.compiled") == 5
    assert not {k: v for k, v in counters.items()
                if k.startswith("serving.batch.") and v}


# ------------------------------------- the drawn ensembles of the chip run
def test_chip_smoke_ensembles_lower_and_walk_on_the_cpu():
    """`chip_smoke.py`'s `ml` phase draws tree ensembles as records with
    sklearn Tree's attributes and holds the port's program against a numpy
    walk; the same helpers here at a small size."""
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    X = rng.random((500, 3)) * np.array([50.0, 0.1, 0.08])
    for kind in ("gbdt", "forest"):
        trees = cs.draw_ensemble(kind, 4 if kind == "gbdt" else 3, X, seed=1,
                                 depth=3 if kind == "gbdt" else 6)
        program = cs.lower_ensemble(kind, trees, X.shape[1])
        assert program is not None
        out = _port_apply(program, X)
        want = cs.numpy_tree_walk(kind, trees, X, program)
        if kind == "gbdt":
            np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(out, want)
        if kind == "forest":
            # the forest's depth hint: a full depth-10 tree's bucket
            assert program.meta["depth"] == cs.ML_ENSEMBLES["forest"][1]
            assert program.meta["nodes"] == 2048
        else:
            assert program.meta["depth"] == 3
