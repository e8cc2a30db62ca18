"""Checkpoints in the port (`dask_sql_tpu_torch/checkpoint.py`) against
the reference's (`tests/unit/test_checkpoint.py`,
`tests/integration/test_checkpoint.py`).

The snapshot layout (parquet tables, then ``manifest.json`` and the
atomic ``CURRENT`` repoint) does not depend on the engine, so each
round trip runs in three directions: the port to the port, the reference
to the port and the port to the reference; the loaded Context answers the
same SQL as the one that saved, with exact keys, counts, NULLs and types.
The port reloads a table onto its own device with its encodings chosen
again, so its resident bytes after a load equal those before the save.
Models ride a port snapshot (pickled with their tensors on the host); a
reference snapshot's models are not loaded.
"""
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu.resilience import faults as ref_faults
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.resilience import faults
from dask_sql_tpu_torch.resilience.errors import InjectedFault
from dask_sql_tpu_torch.serving.cache import table_nbytes

#: (saving engine, loading engine)
DIRECTIONS = [("port", "port"), ("ref", "port"), ("port", "ref")]
NO_WARM = {"serving.warmup.enabled": False}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_injector():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _new(engine):
    if engine == "port":
        c = Context(device="cpu")
        c.config.update(NO_WARM)
        return c
    return dask_sql_tpu.Context()


def _sql(c, sql):
    with c.config.set(NO_WARM):
        return c.sql(sql).compute()


def _save(c, loc):
    with c.config.set(NO_WARM):
        return c.save_state(loc)


def _load(c, loc):
    with c.config.set(NO_WARM):
        return c.load_state(loc)


def _frame():
    return pd.DataFrame({
        "i": np.array([1, 2, 3, 4], dtype=np.int64),
        "f": np.array([1.5, np.nan, 3.25, -0.5], dtype=np.float64),
        "s": ["alpha", "beta", None, "delta"],
        "b": np.array([True, False, True, False]),
    })


def _manifest(loc):
    cur = open(os.path.join(loc, "CURRENT")).read().strip()
    return json.load(open(os.path.join(loc, cur, "manifest.json"))), cur


@pytest.mark.parametrize("saver,loader", DIRECTIONS)
def test_round_trip_save_restore(tmp_path, saver, loader):
    c = _new(saver)
    c.create_table("t", _frame())
    loc = str(tmp_path / "snaps")
    manifest = _save(c, loc)
    assert "t" in manifest["schemas"]["root"]["tables"]
    c2 = _new(loader)
    _load(c2, loc)
    out = _sql(c2, "SELECT * FROM t")
    expected = _frame()
    assert list(out.columns) == list(expected.columns)
    pd.testing.assert_series_equal(out["i"], expected["i"])
    assert out["f"].isna().tolist() == expected["f"].isna().tolist()
    assert out["s"].isna().tolist() == [False, False, True, False]
    assert out["s"][0] == "alpha"
    assert out["b"].tolist() == expected["b"].tolist()
    assert c2.schema["root"].statistics["t"].row_count == 4


@pytest.mark.parametrize("saver,loader", DIRECTIONS)
def test_grouped_answers_and_types_survive(tmp_path, saver, loader):
    """The integration round trip: string keys with NULLs, float sums,
    timestamps, nullable BIGINT with real NULLs, a second schema; DESCRIBE
    gives the same types after the load."""
    rng = np.random.RandomState(6)
    df = pd.DataFrame({
        "g": rng.choice(["a", "b", None], 500),
        "v": rng.randn(500),
        "d": pd.to_datetime("2022-03-01")
        + pd.to_timedelta(rng.randint(0, 30, 500), "D"),
        "i": pd.array([None if k % 7 == 0 else k for k in range(500)],
                      dtype="Int64"),
    })
    c1 = _new(saver)
    c1.create_table("t", df)
    c1.create_schema("aux")
    c1.create_table("u", pd.DataFrame({"k": [1, 2], "w": [0.5, 1.5]}),
                    schema_name="aux")
    q = ("SELECT g, COUNT(*) AS n, SUM(v) AS s, MAX(d) AS md, "
         "COUNT(i) AS ci, SUM(i) AS si FROM t "
         "GROUP BY g ORDER BY g NULLS LAST")
    before = _sql(c1, q)
    d1 = _sql(c1, "DESCRIBE t")
    _save(c1, str(tmp_path / "snap"))
    c2 = _new(loader)
    _load(c2, str(tmp_path / "snap"))
    after = _sql(c2, q)
    assert list(before["g"].fillna("~")) == list(after["g"].fillna("~"))
    np.testing.assert_allclose(before["s"], after["s"], rtol=1e-12)
    for col in ("n", "md", "ci", "si"):
        assert list(before[col]) == list(after[col]), col
    assert list(_sql(c2, "DESCRIBE t")["Type"]) == list(d1["Type"])
    assert float(_sql(c2, "SELECT SUM(w) AS sw FROM aux.u")["sw"][0]) == 2.0


def test_card_bytes_and_encodings_come_back(tmp_path):
    """The port's table after a load: the same encodings and resident
    bytes as before the save (chosen again at the load)."""
    import bench

    df = bench.gen_lineitem(20_000)
    c = _new("port")
    c.create_table("lineitem", df)
    t0 = c.schema["root"].tables["lineitem"].table
    _save(c, str(tmp_path / "s"))
    c2 = _new("port")
    _load(c2, str(tmp_path / "s"))
    t1 = c2.schema["root"].tables["lineitem"].table
    assert {n: col.encoding for n, col in t0.columns.items()} == \
        {n: col.encoding for n, col in t1.columns.items()}
    assert table_nbytes(t1) == table_nbytes(t0)
    pd.testing.assert_frame_equal(_sql(c2, bench.QUERY), _sql(c, bench.QUERY))


def test_save_prunes_old_snapshots_and_repoints(tmp_path):
    c = _new("port")
    c.create_table("t", _frame())
    loc = str(tmp_path / "snaps")
    _save(c, loc)
    _, cur1 = _manifest(loc)
    c.create_table("t", pd.DataFrame({"x": [10, 20]}))
    _save(c, loc)
    _, cur2 = _manifest(loc)
    assert (cur1, cur2) == ("snap-000001", "snap-000002")
    assert not os.path.isdir(os.path.join(loc, cur1))
    c2 = _new("port")
    _load(c2, loc)
    assert int(_sql(c2, "SELECT SUM(x) AS s FROM t")["s"][0]) == 30


def test_mid_write_fault_leaves_previous_snapshot_live(tmp_path):
    c = _new("port")
    c.create_table("t", _frame())
    loc = str(tmp_path / "snaps")
    _save(c, loc)
    c.create_table("t", pd.DataFrame({"x": [99]}))
    with c.config.set({"resilience.inject": "checkpoint:once"}):
        with pytest.raises(InjectedFault):
            _save(c, loc)
    assert _manifest(loc)[1] == "snap-000001"
    c2 = _new("port")
    _load(c2, loc)
    assert int(_sql(c2, "SELECT COUNT(*) AS n FROM t")["n"][0]) == 4
    with c.config.set({"resilience.inject": "checkpoint:once"}):
        _save(c, loc)  # the budget is spent: this one repoints
    assert _manifest(loc)[1] == "snap-000003"
    c3 = _new("port")
    _load(c3, loc)
    assert int(_sql(c3, "SELECT SUM(x) AS s FROM t")["s"][0]) == 99


def test_manifest_carries_table_epochs_and_restore_is_monotone(tmp_path):
    c = _new("port")
    c.create_table("t", _frame())
    for k in (100, 200):
        c.sql(f"INSERT INTO t SELECT i + {k}, f, s, b FROM t WHERE i = 1")
    assert c.table_epoch("root", "t") == 3
    loc = str(tmp_path / "snaps")
    assert _save(c, loc)["table_epochs"]["root"]["t"] == 3
    c2 = _new("port")
    _load(c2, loc)
    assert c2.table_epoch("root", "t") == 3
    assert int(_sql(c2, "SELECT COUNT(*) AS n FROM t")["n"][0]) == 6
    c3 = _new("port")
    c3.create_table("t", _frame())
    for k in range(5):
        c3.sql(f"INSERT INTO t SELECT i + {300 + k}, f, s, b FROM t "
               "WHERE i = 2")
    assert c3.table_epoch("root", "t") == 6
    _load(c3, loc)
    assert c3.table_epoch("root", "t") == 6


def test_dotted_names_do_not_collide(tmp_path):
    c = _new("port")
    c.create_schema("a.b")
    c.create_table("c", pd.DataFrame({"x": [1]}), schema_name="a.b")
    c.create_schema("a")
    c.create_table("b.c", pd.DataFrame({"x": [2]}), schema_name="a")
    _save(c, str(tmp_path / "s"))
    c2 = _new("port")
    _load(c2, str(tmp_path / "s"))
    assert list(c2.schema["a.b"].tables["c"].table.to_pandas()["x"]) == [1]
    assert list(c2.schema["a"].tables["b.c"].table.to_pandas()["x"]) == [2]


def test_views_and_functions_reported_not_restored(tmp_path):
    c = _new("port")
    c.create_table("t", pd.DataFrame({"x": [1, 2]}))
    c.sql("CREATE VIEW v AS SELECT x FROM t")
    c.register_function(lambda x: x + 1, "inc", [("x", np.int64)],
                        np.int64)
    _save(c, str(tmp_path / "s"))
    m, _ = _manifest(str(tmp_path / "s"))
    assert m["not_restored"]["root"]["views"] == ["v"]
    assert m["not_restored"]["root"]["functions"] == ["inc"]
    assert m["schemas"]["root"]["models"] == []


def _model_frame():
    rng = np.random.RandomState(0)
    df = pd.DataFrame({"x": rng.rand(64), "y": rng.rand(64)})
    df["target"] = (df.x + df.y > 1).astype(np.int64)
    return df


def test_models_ride_the_snapshot(tmp_path):
    """A port snapshot carries its models (an engine model and a sklearn
    one) with their training columns; the load registers them on the
    loading Context's device, and a model saved from the card (its
    tensors pickled on the host) loads on a CPU Context.  Experiments are
    reported not restored, as in the reference."""
    c = _new("port")
    df = _model_frame()
    c.create_table("t", df)
    c.sql("""CREATE MODEL lin WITH (model_class = 'LinearRegression',
             target_column = 'target') AS (SELECT x, y, target FROM t)""")
    c.sql("""CREATE EXPERIMENT grid WITH (
             model_class = 'sklearn.linear_model.LogisticRegression',
             tune_parameters = (C = (0.1, 1.0)), target_column = 'target')
             AS (SELECT x, y, target FROM t)""")
    # as a card Context's model pickles: its device the card's
    c.get_model("root", "lin")[0]._device = torch.device("cuda")
    manifest = _save(c, str(tmp_path / "s"))
    entries = manifest["schemas"]["root"]["models"]
    assert sorted(m["name"] for m in entries) == ["grid", "lin"]
    assert {m["engine"] for m in entries} == {"torch"}
    assert manifest["not_restored"]["root"]["experiments"] == ["grid"]
    c.get_model("root", "lin")[0]._device = c.device
    c2 = _new("port")
    _load(c2, str(tmp_path / "s"))
    X = df[["x", "y"]].to_numpy()
    for name in ("lin", "grid"):
        model, cols = c2.get_model("root", name)
        assert cols == ["x", "y"]
        np.testing.assert_array_equal(model.predict(X),
                                      c.get_model("root", name)[0].predict(X))
    loaded = c2.get_model("root", "lin")[0]
    assert loaded._device == c2.device and loaded._w.device == c2.device
    got = _sql(c2, "SELECT * FROM PREDICT(MODEL lin, SELECT x, y FROM t)")
    np.testing.assert_allclose(got["target"], loaded.predict(X), rtol=5e-6)
    assert c2.metrics.counter("inference.predict.compiled") == 1


def test_reference_snapshot_models_are_not_loaded(tmp_path, caplog):
    """Unpickling a reference model imports the JAX package: the port's
    load skips it with a warning, and loads the tables."""
    r = _new("ref")
    r.create_table("t", _model_frame())
    r.sql("""CREATE MODEL lin WITH (model_class = 'LinearRegression',
             target_column = 'target') AS (SELECT x, y, target FROM t)""")
    _save(r, str(tmp_path / "s"))
    c = _new("port")
    with caplog.at_level("WARNING"):
        _load(c, str(tmp_path / "s"))
    assert "lin" not in c.schema["root"].models
    assert "another engine saved" in caplog.text
    assert len(_sql(c, "SELECT * FROM t")) == 64


def test_lazy_parquet_tables_reregister_by_path(tmp_path):
    df = pd.DataFrame({"x": np.arange(100), "y": np.arange(100) * 0.5})
    pqpath = str(tmp_path / "data.parquet")
    df.to_parquet(pqpath)
    c1 = _new("port")
    c1.create_table("lazy", pqpath, persist=False)
    _save(c1, str(tmp_path / "snap"))
    spec = _manifest(str(tmp_path / "snap"))[0]["schemas"]["root"][
        "tables"]["lazy"]
    assert spec == {"kind": "parquet", "path": pqpath}
    c2 = _new("port")
    _load(c2, str(tmp_path / "snap"))
    assert int(_sql(c2, "SELECT SUM(x) AS s FROM lazy")["s"][0]) == \
        int(df.x.sum())
