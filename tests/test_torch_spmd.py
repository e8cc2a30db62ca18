"""Sharded tables through SQL in the port: the three sharded rungs, the
collectives engine, sharded storage and what reads it, on the CPU.

A reference `Context` shards its tables over the eight virtual devices of
`tests/conftest.py`; a port ``Context(device="cpu")`` over a mesh of eight
shards on the CPU.  Both get the same seeded frames, ``distributed=True``.
Where the reference's collectives engine answers (the dist aggregate, the
broadcast and shuffle joins, the range-partition sort, the DISTINCT
fallback) the port is held to its results and to its counters query by
query.  The reference's own sharded rungs (``spmd_*``) decline on this JAX
version, so there the port is held against the reference's unsharded
Context and a float64 numpy oracle, and its counters against the path the
reference's code takes.  Tolerances: group keys, counts, integer sums,
MIN and MAX exact; float sums within 1e-9 relative of the float64 oracle.
The uneven-block cases run a seven-shard mesh over 100,003 rows (the
concerns of the reference's padded-sharding tests, without padding).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax

import dask_sql_tpu
from dask_sql_tpu import config as ref_config_module
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.parallel import dist_plan as dp
from dask_sql_tpu_torch.parallel import mesh as pm

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the eight virtual devices")

N = 20_003
CFG = {"serving.cache.enabled": False, "columnar.encoding.min_rows": 1024}
Q1_SHAPE = ("SELECT g, SUM(q) AS sum_qty, SUM(x) AS sum_price, "
            "AVG(x) AS avg_price, MIN(k) AS min_k, MAX(k) AS max_k, "
            "COUNT(*) AS cnt FROM t WHERE k < {lit} GROUP BY g")


def _df(n=N, seed=11):
    """Float sums exact in float64 (quarters of bounded ints); ``k`` small
    enough to DICT-encode; ``y`` a float key of many values."""
    rng = np.random.RandomState(seed)
    return pd.DataFrame({
        "g": rng.choice(["a", "b", "c", "d", "e"], n),
        "k": rng.randint(0, 40, n).astype(np.int64),
        "x": rng.randint(0, 4000, n) * 0.25,
        "q": rng.randint(1, 51, n).astype(np.int64),
        "y": rng.rand(n) * 500,
        "v": rng.randint(0, 300, n) * 0.5,
    })


def _dim():
    rng = np.random.RandomState(12)
    return pd.DataFrame({"dk": np.arange(40, dtype=np.int64),
                         "w": rng.rand(40),
                         "lbl": [f"l{i % 7}" for i in range(40)]})


@pytest.fixture(scope="module", autouse=True)
def _mesh_thread_and_ref_config():
    """The port's CPU mesh and one torch thread for the module; the
    reference's config is process-wide, and its Contexts below set CFG on
    it, so its values come back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pm.set_default_mesh(pm.make_mesh(8, devices=["cpu"]))
    before = {k: ref_config_module.config.get(k) for k in CFG}
    yield
    ref_config_module.config.update(before)
    pm.reset_default_mesh("cpu")
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return _df(), _dim()


def _port(df, dim, distributed=True, **cfg):
    c = Context(device="cpu", config_options=dict(CFG, **cfg))
    c.create_table("t", df, distributed=distributed)
    c.create_table("dim", dim, distributed=distributed)
    return c


def _ref(df, dim, distributed):
    c = dask_sql_tpu.Context()
    c.config.update(CFG)
    c.create_table("t", df, distributed=distributed)
    c.create_table("dim", dim, distributed=distributed)
    return c


@pytest.fixture(scope="module")
def port(frames):
    return _port(*frames)


@pytest.fixture(scope="module")
def ref_sharded(frames):
    return _ref(*frames, True)


@pytest.fixture(scope="module")
def ref_single(frames):
    return _ref(*frames, False)


def _moved(c, q, prefixes=("resilience.", "parallel."), **opts):
    before = dict(c.metrics.snapshot()["counters"])
    out = c.sql(q, config_options=opts).compute() if opts else \
        c.sql(q).compute()
    after = c.metrics.snapshot()["counters"]
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0) and k.startswith(prefixes)
                 and "pressure" not in k}


def _sorted(df):
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def _assert_same(got, want, float_cols=()):
    got, want = _sorted(got), _sorted(want)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in got.columns:
        a, b = got[col].to_numpy(), want[col].to_numpy()
        if col in float_cols:
            np.testing.assert_allclose(a.astype(float), b.astype(float),
                                       rtol=1e-9)
        else:
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the sharded rungs, against the reference's unsharded Context
# ---------------------------------------------------------------------------
def test_spmd_aggregate_q1_shape(port, ref_single, frames):
    df, _ = frames
    st = port.schema["root"].tables["t"].table
    assert st.has_encoded_columns() and st.sharding.mesh.size == 8
    got, moved = _moved(port, Q1_SHAPE.format(lit=33))
    assert moved == {"resilience.rung.spmd_aggregate": 1,
                     "parallel.spmd.launches": 1, "parallel.spmd.rows": N}
    spans = [(s.name, dict(s.attrs)) for s in port.last_trace.spans
             if s.name.startswith("rung:")]
    assert ("rung:spmd_aggregate",
            {"rung": "spmd_aggregate", "spmd": True}) in spans
    want = ref_single.sql(Q1_SHAPE.format(lit=33)).compute()
    _assert_same(got, want, float_cols=("sum_price", "avg_price"))
    # and against the float64 oracle
    sel = df[df.k < 33].groupby("g")
    oracle = sel.x.sum().sort_index().to_numpy()
    np.testing.assert_allclose(got.sort_values("g")["sum_price"], oracle,
                               rtol=1e-9)
    # a second literal builds nothing: the family's pipeline serves it
    port.sql(Q1_SHAPE.format(lit=22)).compute()
    assert not [s for s in port.last_trace.spans
                if s.name.startswith("compile:")]
    assert port.metrics.counter("families.hit") >= 1
    # the same bits on every run
    runs = [port.sql(Q1_SHAPE.format(lit=33)).compute() for _ in range(2)]
    for r in runs:
        pd.testing.assert_frame_equal(r, got)


def test_spmd_select_global_order_and_windows(port, ref_single):
    for q in ("SELECT g, x * 2 AS x2 FROM t WHERE k < 7 LIMIT 11",
              "SELECT g, q, x FROM t WHERE k < 3",
              # the window spans shards: the ordinal carries across them
              "SELECT g, x FROM t WHERE k < 9 LIMIT 2000 OFFSET 700"):
        got, moved = _moved(port, q)
        assert moved["resilience.rung.spmd_select"] == 1, q
        want = ref_single.sql(q).compute()
        pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                      want.reset_index(drop=True))


def test_spmd_join_aggregate(port, ref_single):
    q = ("SELECT lbl, SUM(x) AS sx, COUNT(*) AS n FROM t JOIN dim "
         "ON k = dk WHERE q > 10 GROUP BY lbl")
    got, moved = _moved(port, q)
    assert moved == {"resilience.rung.spmd_join_aggregate": 1,
                     "parallel.spmd.launches": 1, "parallel.spmd.rows": N}
    _assert_same(got, ref_single.sql(q).compute(), float_cols=("sx",))
    # a build side over parallel.spmd.broadcast_rows declines to the
    # one-device pipeline
    got2, moved2 = _moved(port, q, **{"parallel.spmd.broadcast_rows": 10})
    assert "resilience.rung.spmd_join_aggregate" not in moved2
    assert moved2["resilience.rung.compiled_join_aggregate"] == 1
    _assert_same(got2, got, float_cols=("sx",))


def test_spmd_batched_members_equal_solo(port):
    from dask_sql_tpu_torch.spmd import aggregate as sa

    port.sql(Q1_SHAPE.format(lit=20)).compute()
    key, obj = list(sa._cache.items())[-1]  # the family's, touched last
    projection = key[7]  # (owner, rung, mesh, uid, epoch, schema, table, ..)
    table = port.schema["root"].tables["t"].table.select(list(projection))
    params_list = [(np.int64(20),), (np.int64(10),), (np.int64(5),)]
    outs = obj.run_batched(table, params_list)
    for p, out in zip(params_list, outs):
        solo = obj.run(table, p).to_pandas()
        got = out.to_pandas()
        for col in got.columns:
            assert (got[col].to_numpy() == solo[col].to_numpy()).all(), col


def test_grown_sharded_table_rebuilds_in_background(frames):
    df, dim = frames
    c = _port(df.head(5000), dim, **{"serving.bg_compile.enabled": True})
    q = Q1_SHAPE.format(lit=33)
    c.sql(q).compute()
    c.create_table("t", df.head(8000), distributed=True)  # a new table
    r2 = c.sql(q).compute()  # served below while the rung rebuilds
    m = c.metrics
    assert m.counter("serving.bg_compile.deferred") == 1
    assert m.counter("resilience.rung.compiled_aggregate") == 1
    assert c.background_compiler().wait_idle(60)
    assert m.counter("serving.bg_compile.completed") == 1
    r3 = c.sql(q).compute()
    assert m.counter("resilience.rung.spmd_aggregate") == 2
    pd.testing.assert_frame_equal(
        r3.sort_values("g").reset_index(drop=True),
        r2.sort_values("g").reset_index(drop=True), rtol=1e-12)
    c.background_compiler().cancel()


# ---------------------------------------------------------------------------
# the collectives engine, against the reference's sharded Context
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q, opts, floats", [
    # a computed float key: the compiled rungs decline, the engine answers
    ("SELECT v * 2 AS v2, COUNT(*) AS n, SUM(q) AS sq, MAX(x) AS mx "
     "FROM t GROUP BY v * 2", {}, ()),
    ("SELECT t.q, t.x, dim.w FROM t JOIN dim ON t.k = dim.dk "
     "WHERE t.x > 900", {}, ("w",)),
    ("SELECT t.q, t.x, dim.w FROM t JOIN dim ON t.k = dim.dk "
     "WHERE t.x > 900", {"sql.join.broadcast": False}, ("w",)),
    ("SELECT * FROM (SELECT q, k, y FROM t ORDER BY y DESC, k) s LIMIT 25",
     {}, ()),
])
def test_collectives_engine_matches_reference(port, ref_sharded, q, opts,
                                              floats):
    got, moved = _moved(port, q, **opts)
    want, ref_moved = _moved(ref_sharded, q, **opts)
    moved.pop("parallel.dist.gather", None)  # the port's own count
    assert moved == ref_moved, (moved, ref_moved)
    assert moved  # the engine answered
    if "ORDER BY" in q:
        pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                      want.reset_index(drop=True),
                                      check_dtype=False)
    else:
        _assert_same(got, want, float_cols=floats)


def _oracle_distinct(df, dim):
    return df.groupby("g").k.nunique().reset_index(name="n")


def _oracle_join_group(df, dim):
    m = df.merge(dim, left_on="k", right_on="dk")
    return m.groupby("w").size().reset_index(name="n")


def _oracle_sort(df, dim):
    s = df[df.x > 500].sort_values(["y", "q"], ascending=[True, False],
                                   kind="mergesort")
    return s[["q", "y"]]


def _oracle_many_groups(df, dim):
    return df.groupby("y").agg(n=("q", "size"), sq=("q", "sum")) \
        .reset_index()


@pytest.mark.parametrize("q, counters, oracle", [
    # the reference's counters on its sharded Context for these shapes
    ("SELECT g, COUNT(DISTINCT k) AS n FROM t GROUP BY g",
     {"resilience.fallback": 1, "resilience.fallback.dist_aggregate": 1},
     _oracle_distinct),
    ("SELECT w, COUNT(*) AS n FROM t JOIN dim ON t.k = dim.dk GROUP BY w",
     {"parallel.dist.broadcast_join": 1, "parallel.dist.agg_kernel": 1,
      "resilience.rung.dist_aggregate": 1}, _oracle_join_group),
    ("SELECT q, y FROM t WHERE x > 500 ORDER BY y, q DESC",
     {"parallel.dist.sort_kernel": 1, "resilience.rung.dist_sort": 1},
     _oracle_sort),
    # ~2,500 groups a shard: the reference's first capacity (1,024)
    # overflows and its kernel runs again; the port sizes the exchange
    # exactly and runs once (a divergence by design)
    ("SELECT y, COUNT(*) AS n, SUM(q) AS sq FROM t GROUP BY y",
     {"parallel.dist.agg_kernel": 1, "resilience.rung.dist_aggregate": 1},
     _oracle_many_groups),
])
def test_collectives_engine_paths_and_results(port, frames, q, counters,
                                              oracle):
    got, moved = _moved(port, q)
    moved.pop("parallel.dist.gather", None)
    assert moved == counters
    want = oracle(*frames)
    if "ORDER BY" in q:
        np.testing.assert_array_equal(got["q"].to_numpy(), want["q"])
        np.testing.assert_array_equal(got["y"].to_numpy(), want["y"])
    else:
        _assert_same(got, want.astype(got.dtypes.to_dict()))


def test_operators_without_a_sharded_path_gather(port):
    _, moved = _moved(port, "SELECT q, y FROM t ORDER BY y LIMIT 3")
    assert moved == {"parallel.dist.gather": 1}


# ---------------------------------------------------------------------------
# resilience: the spmd fault site and the breaker
# ---------------------------------------------------------------------------
def test_spmd_fault_steps_down_and_charges_its_breaker(frames):
    c = _port(*frames, **{"resilience.inject": "spmd:always"})
    got = c.sql(Q1_SHAPE.format(lit=25)).compute()
    assert len(got) == 5
    m = c.metrics
    assert m.counter("resilience.degraded.spmd_aggregate") == 1
    assert m.counter("resilience.rung.compiled_aggregate") == 1
    assert m.counter("resilience.rung.spmd_aggregate") == 0
    for lit in (24, 23, 21):
        c.sql(Q1_SHAPE.format(lit=lit)).compute()
    # (family, rung): three strikes skip only the sharded rung
    assert m.counter("resilience.breaker.skip.spmd_aggregate") >= 1
    assert m.counter("resilience.rung.compiled_aggregate") == 4


# ---------------------------------------------------------------------------
# storage: auto-shard, the WITH passthrough, opt-outs, one-shard meshes
# ---------------------------------------------------------------------------
def test_auto_shard_policy_and_opt_outs(frames, tmp_path):
    df, _ = frames
    c = Context(device="cpu", config_options=dict(
        CFG, **{"parallel.auto_shard": "on",
                "parallel.auto_shard.min_rows": 1024}))
    c.create_table("t", df)
    assert dp.table_is_sharded(c.schema["root"].tables["t"].table)
    assert c.metrics.counter("parallel.auto_shard.tables") == 1
    c.create_table("tiny", df.head(100))
    assert not dp.table_is_sharded(c.schema["root"].tables["tiny"].table)
    c.create_table("optout", df, distributed=False)
    assert not dp.table_is_sharded(c.schema["root"].tables["optout"].table)
    path = tmp_path / "t.csv"
    df.head(3000).to_csv(path, index=False)
    d = Context(device="cpu")
    d.sql(f"CREATE TABLE w WITH (location = '{path}', format = 'csv', "
          "distributed = true)")
    assert dp.table_is_sharded(d.schema["root"].tables["w"].table)
    d.create_table("s_true", df.head(50), distributed="true")
    d.create_table("s_false", df.head(50), distributed="false")
    assert dp.table_is_sharded(d.schema["root"].tables["s_true"].table)
    assert not dp.table_is_sharded(d.schema["root"].tables["s_false"].table)


def test_one_shard_mesh_declines_like_the_reference(frames):
    df, dim = frames
    pm.set_default_mesh(pm.make_mesh(1, devices=["cpu"]))
    try:
        c = _port(df, dim)
    finally:
        pm.set_default_mesh(pm.make_mesh(8, devices=["cpu"]))
    assert c.schema["root"].tables["t"].table.sharding.mesh.size == 1
    _, moved = _moved(c, Q1_SHAPE.format(lit=33))
    assert moved == {"resilience.rung.compiled_aggregate": 1}


# ---------------------------------------------------------------------------
# analysis, streaming and reuse over sharded storage
# ---------------------------------------------------------------------------
def test_explain_estimate_mesh_row_and_lint_advisory(port, frames):
    q = "SELECT g, SUM(x) AS s FROM t GROUP BY g"
    rows = list(port.sql("EXPLAIN ESTIMATE " + q).compute().iloc[:, 0])
    assert "mesh: devices=8 (sharded scans budgeted per device)" in rows
    single = _port(*frames, distributed=False)
    est_s = port.sql(q).plan._dsql_estimate
    est_1 = single.sql(q).plan._dsql_estimate
    assert est_s.devices == 8 and est_1.devices == 1
    assert est_s.peak_bytes.lo < est_1.peak_bytes.lo
    lint = list(port.sql("EXPLAIN LINT " + q,
                         return_futures=False)["LINT"])
    spmd = [r for r in lint if "[spmd]" in r]
    assert len(spmd) == 1 and "devices=8" in spmd[0]
    assert "per_device_bytes=" in spmd[0] and "eligible" in spmd[0]
    lint1 = list(single.sql("EXPLAIN LINT " + q,
                            return_futures=False)["LINT"])
    assert not [r for r in lint1 if "[spmd]" in r]


def test_streaming_and_materialize_decline_sharded_storage(frames):
    from dask_sql_tpu_torch.streaming.plan import stream_decision

    q = "SELECT g, SUM(x) AS s FROM t GROUP BY g"
    cfg = {"serving.cache.enabled": True, "serving.materialize.min_bytes": 1}
    for distributed in (False, True):
        c = _port(*frames, distributed=distributed, **cfg)
        plan = c.sql(q).plan
        est = plan._dsql_estimate
        got = stream_decision(plan, est, c, c.config,
                              est.peak_bytes.lo // 4)
        assert (got is None) == distributed
        c.sql("SELECT q FROM t WHERE x > 10").compute()
        c.sql("SELECT y FROM t WHERE x > 10").compute()
        assert (len(c.materialize.rows()) == 0) == distributed


# ---------------------------------------------------------------------------
# uneven blocks: seven shards over 100,003 rows
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ctx7():
    rng = np.random.RandomState(3)
    n = 100_003
    df = pd.DataFrame({"g": rng.randint(0, 5, n), "x": rng.rand(n),
                       "k": rng.randint(0, 50, n)})
    pm.set_default_mesh(pm.make_mesh(7, devices=["cpu"]))
    try:
        c = Context(device="cpu", config_options=CFG)
        c.create_table("t", df, distributed=True)
    finally:
        pm.set_default_mesh(pm.make_mesh(8, devices=["cpu"]))
    return c, df


def test_uneven_blocks_aggregate_and_count(ctx7):
    c, df = ctx7
    t = c.schema["root"].tables["t"].table
    assert t.sharding.sizes == [14_287] + [14_286] * 6
    got = c.sql("SELECT g, SUM(x) AS s, COUNT(*) AS n FROM t "
                "WHERE x > 0.25 GROUP BY g ORDER BY g", return_futures=False)
    sel = df[df.x > 0.25]
    exp = sel.groupby("g", as_index=False).agg(
        s=("x", "sum"), n=("x", "size")).sort_values("g")
    np.testing.assert_allclose(got["s"], exp["s"], rtol=1e-9)
    assert list(got["n"].astype(np.int64)) == list(exp["n"])
    got = c.sql("SELECT COUNT(*) AS n, SUM(x) AS s FROM t",
                return_futures=False)
    assert int(got["n"][0]) == len(df)
    np.testing.assert_allclose(float(got["s"][0]), df.x.sum(), rtol=1e-9)


def test_uneven_blocks_join_pipeline(ctx7):
    c, df = ctx7
    dim = pd.DataFrame({"dk": np.arange(50), "w": np.arange(50) * 2.0})
    c.create_table("dim", dim)
    got, moved = _moved(c, "SELECT g, SUM(w) AS sw FROM t JOIN dim "
                           "ON k = dk GROUP BY g ORDER BY g")
    assert moved.get("resilience.rung.spmd_join_aggregate") == 1
    m = df.merge(dim, left_on="k", right_on="dk")
    exp = m.groupby("g", as_index=False).agg(sw=("w", "sum")) \
        .sort_values("g")
    np.testing.assert_allclose(got["sw"], exp["sw"], rtol=1e-9)


def test_uneven_blocks_eager_paths_and_arrow(ctx7):
    c, df = ctx7
    got = c.sql("SELECT x FROM t ORDER BY x DESC LIMIT 5",
                return_futures=False)
    np.testing.assert_allclose(got["x"], df.x.nlargest(5).to_numpy(),
                               rtol=1e-9)
    allrows = c.sql("SELECT * FROM t", return_futures=False)
    assert len(allrows) == len(df)
    np.testing.assert_array_equal(allrows["x"].to_numpy(), df.x.to_numpy())
    at = c.schema["root"].tables["t"].table.to_arrow()
    assert at.num_rows == len(df)


def test_uneven_blocks_checkpoint_roundtrip(ctx7, tmp_path):
    c, df = ctx7
    c.save_state(str(tmp_path / "snap"))
    pm.set_default_mesh(pm.make_mesh(7, devices=["cpu"]))
    try:
        c2 = Context(device="cpu", config_options=CFG)
        c2.load_state(str(tmp_path / "snap"))
    finally:
        pm.set_default_mesh(pm.make_mesh(8, devices=["cpu"]))
    t2 = c2.schema["root"].tables["t"].table
    assert t2.sharding.sizes == [14_287] + [14_286] * 6
    got = c2.sql("SELECT COUNT(*) AS n, SUM(x) AS s FROM t",
                 return_futures=False)
    assert int(got["n"][0]) == len(df)
    np.testing.assert_allclose(float(got["s"][0]), df.x.sum(), rtol=1e-9)


def test_uneven_blocks_frame_filter(ctx7):
    c, df = ctx7
    t = c.schema["root"].tables["t"].table
    out = t.filter(t.columns["x"].data >= 0.5)
    assert out.num_rows == int((df.x >= 0.5).sum())
    assert sum(out.sharding.sizes) == out.num_rows
