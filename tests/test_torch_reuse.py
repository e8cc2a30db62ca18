"""Semantic result reuse in the port (`dask_sql_tpu_torch/materialize/`)
against the reference's (`tests/unit/test_reuse.py`): subsumption answering
(served, declined on a nullable column, the float boundary, a property
sweep), stem materialization and the rewrite onto the pinned table, flight
events and the ledger, targeted invalidation by append and by replace, the
stem refresh over the delta alone, incremental folds over repeated appends,
INSERT INTO, and a warm Context's rungs over a Q1-family dashboard and a
stem under three downstream shapes.

Every case runs the same statements on a port CPU Context and a reference
Context, each warm with what came before, and compares the rows and the
``serving.materialize.*``, ``serving.reuse.*`` and ``resilience.rung.*``
counters each statement moves.  Keys, counts and integers are exact;
floats within `MATMUL_FLOAT_REL_ERR_BOUND` (5e-6) of the reference, whose
float32 sums run with ``sql.compile.segsum = "matmul"`` (a float64 carry),
or 1e-9 of a float64 numpy oracle.  The reference's config is process-wide,
so each case sets its keys in a scope.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import bench
import dask_sql_tpu
from dask_sql_tpu.analysis import estimator as ref_estimator
from dask_sql_tpu.observability import flight as ref_flight
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.analysis import estimator
from dask_sql_tpu_torch.observability import flight
from dask_sql_tpu_torch.ops.segsum import MATMUL_FLOAT_REL_ERR_BOUND

ENGINES = ("port", "ref")
PREFIXES = ("serving.materialize.", "serving.reuse.", "resilience.rung.")
ORACLE_REL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are tiny: one torch thread runs them fastest on a
    machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _df(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "a": rng.integers(0, 100, n).astype(np.int64),
        "b": rng.random(n) * 100.0,
        "k": rng.integers(0, 5, n).astype(np.int64),
    })


def _ctx(engine, df=None, name="t"):
    c = Context(device="cpu") if engine == "port" else dask_sql_tpu.Context()
    if df is not None:
        c.create_table(name, df)
    return c


def _counters(c):
    return {k: v for k, v in c.metrics.snapshot()["counters"].items()
            if k.startswith(PREFIXES)}


def _moves(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _recorder(engine):
    return flight.RECORDER if engine == "port" else ref_flight.RECORDER


class _Step:
    """One Context's statements, each with the reuse counters it moved."""

    def __init__(self, c):
        self.c = c
        self.moves = []

    def sql(self, sql, **kw):
        before = _counters(self.c)
        out = self.c.sql(sql, return_futures=False, **kw)
        self.moves.append(_moves(before, _counters(self.c)))
        return out

    def append(self, name, rows):
        before = _counters(self.c)
        n = self.c.append_rows(name, rows)
        self.moves.append(_moves(before, _counters(self.c)))
        return n


def _both(scenario, frames, **config):
    """``scenario(step, engine)`` on a port and a reference Context over
    ``frames`` ({name: frame}) under ``config``: the same counter moves,
    statement by statement.  Returns {engine: (scenario's value, Context)}."""
    out = {}
    moves = {}
    for engine in ENGINES:
        c = _ctx(engine)
        for name, frame in frames.items():
            c.create_table(name, frame)
        step = _Step(c)
        with c.config.set(config):
            value = scenario(step, engine)
        out[engine] = (value, c)
        moves[engine] = step.moves
    assert moves["port"] == moves["ref"]
    out["moves"] = moves["port"]
    return out


def _same(got, want, rel=MATMUL_FLOAT_REL_ERR_BOUND, sort=None):
    """Equal frames: columns, rows and order (sorted by ``sort`` first);
    floats within ``rel``, everything else exact."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if sort is not None:
        got = got.sort_values(sort).reset_index(drop=True)
        want = want.sort_values(sort).reset_index(drop=True)
    for name in want.columns:
        g, w = got[name].reset_index(drop=True), want[name].reset_index(
            drop=True)
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64), rtol=rel,
                                       err_msg=name)
        else:
            assert g.tolist() == w.tolist(), name


# ----------------------------------------------------------- subsumption
def test_subsumption_serves_tighter_literal():
    df = _df()

    def scenario(s, engine):
        s.sql("SELECT a, k FROM t WHERE a < 80")
        return s.sql("SELECT a, k FROM t WHERE a < 30")

    out = _both(scenario, {"t": df})
    (got, pc), (want, _) = out["port"], out["ref"]
    assert pc.metrics.counter("serving.reuse.subsumption.hits") == 1
    _same(got, want)
    _same(got, df.loc[df.a < 30, ["a", "k"]])


#: comparators of the sweep: SQL, the estimator's name, the numpy oracle
SWEEP_OPS = (("<", "lt", np.less), ("<=", "le", np.less_equal),
             (">", "gt", np.greater), (">=", "ge", np.greater_equal),
             ("=", "eq", np.equal))


def test_subsumption_property_sweep():
    """Random parameter intervals under each comparator, 30 trials on
    fresh port Contexts: the answer equals the oracle's whether
    subsumption served it or not, and a trial is served exactly when the
    reference's algebra proves containment of two different values (an
    identical value is the exact cache's).  The first trial of each
    comparator runs on a reference Context too, with the same verdict."""
    rng = np.random.default_rng(7)
    df = _df(300, seed=3)
    served = []
    for trial in range(30):
        op, name, fn = SWEEP_OPS[trial % len(SWEEP_OPS)]
        v1, v2 = sorted(rng.integers(0, 100, 2).tolist())
        if op in ("<", "<="):
            cached_v, probe_v = v2, v1
        elif op in (">", ">="):
            cached_v, probe_v = v1, v2
        else:
            cached_v = probe_v = v1
        want = df.loc[fn(df.a, probe_v), ["a", "k"]]
        proven = int(cached_v != probe_v and ref_estimator.param_slot_contains(
            name, cached_v, probe_v))
        for engine in ENGINES if trial < len(SWEEP_OPS) else ("port",):
            c = _ctx(engine, df)
            c.sql(f"SELECT a, k FROM t WHERE a {op} {cached_v}").compute()
            got = c.sql(f"SELECT a, k FROM t WHERE a {op} {probe_v}"
                        ).compute()
            hits = c.metrics.counter("serving.reuse.subsumption.hits")
            assert hits == proven, (trial, engine, op, cached_v, probe_v)
            _same(got, want)
        served.append(hits)
    assert sum(served) >= 10


def test_subsumption_declines_nullable_column():
    """A float column is nullable by the catalog's convention: its slot
    matches exact values only, so a tighter float literal is never served
    by re-filtering, and the answer stays right."""
    df = _df()

    def scenario(s, engine):
        s.sql("SELECT a FROM t WHERE b < 80.0")
        return s.sql("SELECT a FROM t WHERE b < 30.0")

    out = _both(scenario, {"t": df})
    (got, pc), (want, _) = out["port"], out["ref"]
    assert pc.metrics.counter("serving.reuse.subsumption.hits") == 0
    _same(got, want)
    _same(got, df.loc[df.b < 30.0, ["a"]])


@pytest.mark.parametrize("op, cached, new, float_domain, verdict", [
    ("lt", 100, 50, False, True),
    ("lt", 50, 100, False, False),
    ("le", 50, 50, False, True),
    ("le", 50.0, 50.0, True, False),
    ("lt", 100.0, 50.0, True, True),
    ("eq", 5, 5, False, True),
    ("eq", 5.0, 5.0, True, False),
    ("ge", 10, 10, False, True),
    ("gt", 10, 9, False, False),
    ("lt", 2 ** 62 + 1, 2 ** 62, False, True),
])
def test_interval_algebra_float_boundary_declines(op, cached, new,
                                                  float_domain, verdict):
    """The interval algebra proves only: equality at a float endpoint
    declines, integer endpoints prove exactly (past 2**53 too); the port's
    verdict is the reference's."""
    got = estimator.param_slot_contains(op, cached, new,
                                        float_domain=float_domain)
    want = ref_estimator.param_slot_contains(op, cached, new,
                                             float_domain=float_domain)
    assert got is want is verdict


def test_interval_containment_open_and_closed_endpoints():
    for outer, inner, want in ((("lt", 100), ("le", 99), True),
                               (("lt", 99), ("le", 99), False),
                               (("ge", 3), ("gt", 3), True),
                               (("gt", 3), ("ge", 3), False)):
        got = estimator.interval_contains(estimator.pred_interval(*outer),
                                          estimator.pred_interval(*inner))
        ref = ref_estimator.interval_contains(
            ref_estimator.pred_interval(*outer),
            ref_estimator.pred_interval(*inner))
        assert got is ref is want, (outer, inner)


def test_subsumption_in_the_column_domains():
    """The re-filter puts the new value into the column's own
    representation: a date window (int64 ns in the port), an int32
    column against an int64 parameter, and an int16 one.  Served as in
    the reference, the rows those of a fresh Context."""
    rng = np.random.default_rng(5)
    n = 3000
    df = pd.DataFrame({
        "d": pd.Timestamp("2020-01-01") + pd.to_timedelta(
            rng.integers(0, 400, n), unit="D"),
        "i": rng.integers(-50_000, 50_000, n).astype(np.int32),
        "s": rng.integers(-300, 300, n).astype(np.int16),
    })
    queries = [
        "SELECT d, i FROM t WHERE d >= DATE '2020-02-01' "
        "AND d < DATE '2020-12-01'",
        "SELECT d, i FROM t WHERE d >= DATE '2020-03-15' "
        "AND d < DATE '2020-11-01'",
        "SELECT d, i FROM t WHERE d >= DATE '2020-06-01' "
        "AND d < DATE '2020-06-02'",
        "SELECT i, s FROM t WHERE i > -40000 AND s <= 250",
        "SELECT i, s FROM t WHERE i > 1000 AND s <= 7",
    ]

    def scenario(s, engine):
        return [s.sql(q) for q in queries]

    out = _both(scenario, {"t": df})
    (got, pc), (want, _) = out["port"], out["ref"]
    assert pc.metrics.counter("serving.reuse.subsumption.hits") == 3
    fresh = _ctx("port", df)
    for g, w, q in zip(got, want, queries):
        _same(g, w)
        _same(g, fresh.sql(q, return_futures=False))


def test_a_card_context_refilters_only_rows_on_the_card():
    """Rows the compiled select brought to the host are not re-filtered
    for a card Context (it runs the tighter query afresh on the card);
    rows on the card are, and a CPU Context re-filters its own."""
    from dask_sql_tpu_torch.columnar.table import Table
    from dask_sql_tpu_torch.materialize.subsume import servable_on

    host = Table.from_pandas(_df(10))
    assert servable_on(torch.device("cpu"), host)
    assert not servable_on(torch.device("cuda"), host)
    card = type("CardTable", (), {"device": torch.device("cuda", 0)})()
    assert servable_on(torch.device("cuda"), card)


# ------------------------------------------------- stem materialization
def test_stem_materialization_and_rewrite():
    """Two siblings over one scan->filter stem pin it; a third scans the
    pinned table on the interpreted walk (no compiled rung counts)."""
    df = _df(4000, seed=1)
    stem = "FROM t WHERE a > 3 AND b < 90.0"

    def scenario(s, engine):
        s.sql(f"SELECT a {stem}")
        s.sql(f"SELECT b {stem}")
        return s.sql(f"SELECT k, a {stem}")

    out = _both(scenario, {"t": df}, **{"serving.materialize.min_bytes": 1})
    (got, pc), (want, _) = out["port"], out["ref"]
    assert pc.metrics.counter("serving.materialize.stored") == 1
    assert pc.metrics.counter("serving.materialize.hits") == 1
    _same(got, want)
    _same(got, df.loc[(df.a > 3) & (df.b < 90.0), ["k", "a"]])


def test_stem_flight_events_and_ledger_reconcile():
    df = _df(4000, seed=2)
    out = {}
    for engine in ENGINES:
        rec = _recorder(engine)
        c = _ctx(engine, df)
        with c.config.set({"serving.materialize.min_bytes": 1}):
            rec.clear()
            c.sql("SELECT a FROM t WHERE k = 2").compute()
            c.sql("SELECT b FROM t WHERE k = 2").compute()
            stores = rec.events(name="materialize.store")
            pinned = c.materialize.pinned_bytes()
            assert pinned > 0 and stores and stores[-1]["bytes"] == pinned
            assert c.ledger.snapshot()["materializedBytes"] == pinned
            got = c.sql("SELECT k FROM t WHERE k = 2").compute()
            hits = [e["tier"] for e in rec.events(name="materialize.hit")]
            c.materialize.invalidate_all()
            assert c.materialize.pinned_bytes() == 0
            assert c.ledger.snapshot()["materializedBytes"] == 0
            evicts = [e["reason"] for e in rec.events(
                name="materialize.evict")]
        out[engine] = (len(stores), hits, evicts, got["k"].tolist())
    assert out["port"] == out["ref"]
    assert out["port"][1] == ["stem"] and out["port"][2] == ["invalidated"]


# -------------------------------------------- invalidation hardening
def test_append_invalidates_exactly_dependents():
    """An append drops the cached results over its table and keeps the
    others hittable."""
    delta = pd.DataFrame({"a": [1000], "b": [1.0], "k": [0]})

    def scenario(s, engine):
        r1 = s.sql("SELECT SUM(a) AS s FROM t1")
        r2 = s.sql("SELECT SUM(a) AS s FROM t2")
        hits = s.c._result_cache.stats.hits
        s.append("t1", delta)
        again2 = s.sql("SELECT SUM(a) AS s FROM t2")
        again1 = s.sql("SELECT SUM(a) AS s FROM t1")
        return (s.c._result_cache.stats.hits - hits, r1["s"].tolist(),
                r2["s"].tolist(), again2["s"].tolist(),
                again1["s"].tolist())

    out = _both(scenario, {"t1": _df(100, seed=4), "t2": _df(100, seed=5)})
    got, want = out["port"][0], out["ref"][0]
    assert got == want
    assert got[0] == 1 and got[3] == got[2]
    assert got[4][0] == got[1][0] + 1000


def test_replace_invalidates_exactly_dependents():
    def scenario(s, engine):
        s.sql("SELECT COUNT(*) AS c FROM t1")
        r2 = s.sql("SELECT SUM(k) AS s FROM t2")
        hits = s.c._result_cache.stats.hits
        s.c.create_table("t1", _df(50, seed=8))  # a replace
        again2 = s.sql("SELECT SUM(k) AS s FROM t2")
        count = s.sql("SELECT COUNT(*) AS c FROM t1")
        return (s.c._result_cache.stats.hits - hits, r2["s"].tolist(),
                again2["s"].tolist(), count["c"].tolist())

    out = _both(scenario, {"t1": _df(100, seed=6), "t2": _df(100, seed=7)})
    assert out["port"][0] == out["ref"][0]
    hits, r2, again2, count = out["port"][0]
    assert hits == 1 and again2 == r2 and count == [50]


def test_append_refreshes_pinned_stem_without_rescan():
    """An append runs a pinned stem over the delta alone: only its one
    qualifying row joins the pinned table, and the next sibling scans it."""
    df = _df(4000, seed=9)
    delta = pd.DataFrame({"a": [50, 5], "b": [1.0, 2.0], "k": [0, 0]})

    def scenario(s, engine):
        s.sql("SELECT a FROM t WHERE a > 10")
        s.sql("SELECT b FROM t WHERE a > 10")
        before = s.c.materialize.rows()[0][3]
        executed = s.c.metrics.counter("query.executed")
        s.append("t", delta)
        after = s.c.materialize.rows()[0][3]
        got = s.sql("SELECT k FROM t WHERE a > 10")
        return before, after, len(got), \
            s.c.metrics.counter("query.executed") - executed

    out = _both(scenario, {"t": df}, **{"serving.materialize.min_bytes": 1})
    assert out["port"][0] == out["ref"][0]
    before, after, rows, executed = out["port"][0]
    full = pd.concat([df, delta], ignore_index=True)
    assert after == before + 1 == int((full.a > 10).sum())
    assert rows == after and executed == 1
    pc = out["port"][1]
    assert pc.metrics.counter("serving.materialize.refreshed") == 1
    assert pc.metrics.counter("serving.materialize.hits") == 1


# ------------------------------------------- incremental maintenance
def test_incremental_fold_matches_pandas(monkeypatch):
    """One bootstrap over the pre-append rows and one fold of the delta
    (each one `run_partition`, one segment-sum call), then an answer from
    the state with no run: integer sums, counts, MIN and MAX exact, the
    float sum within 1e-9 of the float64 oracle."""
    from dask_sql_tpu_torch.streaming.aggregate import StreamedAggregate

    calls = []
    run = StreamedAggregate.run_partition

    def counted(self, chunk, params=()):
        calls.append(chunk.num_rows)
        return run(self, chunk, params)

    monkeypatch.setattr(StreamedAggregate, "run_partition", counted)
    df = _df(500, seed=10)
    delta = _df(40, seed=11)
    q = ("SELECT k, SUM(a) AS s, COUNT(*) AS c, MIN(a) AS lo, MAX(a) AS hi, "
         "SUM(b) AS fb FROM t GROUP BY k")

    def scenario(s, engine):
        s.sql(q)
        s.append("t", delta)
        return s.sql(q)

    out = _both(scenario, {"t": df})
    (got, pc), (want, _) = out["port"], out["ref"]
    assert calls == [500, 40]
    assert pc.metrics.counter("serving.reuse.incremental.folds") == 1
    assert pc.metrics.counter("serving.reuse.incremental.hits") == 1
    _same(got, want, sort="k")
    full = pd.concat([df, delta], ignore_index=True)
    oracle = full.groupby("k", as_index=False).agg(
        s=("a", "sum"), c=("a", "count"), lo=("a", "min"), hi=("a", "max"),
        fb=("b", "sum"))
    _same(got, oracle, rel=ORACLE_REL, sort="k")


def test_incremental_state_survives_repeated_appends():
    df = _df(300, seed=12)
    deltas = [_df(20, seed=seed) for seed in (13, 14, 15)]
    q = "SELECT SUM(a) AS s FROM t"

    def scenario(s, engine):
        got = [s.sql(q)["s"].tolist()]
        for delta in deltas:
            s.append("t", delta)
            got.append(s.sql(q)["s"].tolist())
        return got

    out = _both(scenario, {"t": df})
    assert out["port"][0] == out["ref"][0]
    frames = [df]
    for delta, got in zip(deltas, out["port"][0][1:]):
        frames.append(delta)
        assert got == [pd.concat(frames)["a"].sum()]
    pc = out["port"][1]
    assert pc.metrics.counter("serving.reuse.incremental.hits") == 3
    assert pc.metrics.counter("serving.reuse.incremental.folds") == 3


def test_incremental_declines_a_delta_outside_its_radix():
    """The bootstrap plans its radix over the table as the first append
    left it; a later delta whose group key leaves those bounds would be
    clipped into a neighbouring group: the state drops, the next query
    runs in full, and the answer is right."""
    df = _df(300, seed=20)
    q = "SELECT k, SUM(a) AS s, COUNT(*) AS c FROM t GROUP BY k"

    def scenario(s, engine):
        s.sql(q)
        s.append("t", pd.DataFrame({"a": [7], "b": [0.5], "k": [4]}))
        s.sql(q)
        s.append("t", pd.DataFrame({"a": [7], "b": [0.5], "k": [9]}))
        return s.sql(q)

    out = _both(scenario, {"t": df})
    (got, pc), (want, _) = out["port"], out["ref"]
    assert pc.metrics.counter("serving.reuse.incremental.folds") == 1
    assert pc.metrics.counter("serving.reuse.incremental.declined") == 1
    assert pc.metrics.counter("serving.reuse.incremental.hits") == 1
    _same(got, want, sort="k")
    assert got.sort_values("k")["k"].tolist() == [0, 1, 2, 3, 4, 9]


def test_a_failed_fold_drops_the_state(monkeypatch):
    """A fold that raises is never the answer: the state drops
    (``declined``) and the query runs on its rung."""
    from dask_sql_tpu_torch.streaming.aggregate import StreamedAggregate

    df = _df(300, seed=21)
    c = _ctx("port", df)
    q = "SELECT k, SUM(a) AS s FROM t GROUP BY k"
    c.sql(q).compute()
    calls = []
    run = StreamedAggregate.run_partition

    def fail_on_fold(self, chunk, params=()):
        calls.append(chunk.num_rows)
        if len(calls) > 1:
            raise RuntimeError("fold failed")
        return run(self, chunk, params)

    monkeypatch.setattr(StreamedAggregate, "run_partition", fail_on_fold)
    c.append_rows("t", _df(10, seed=22))
    assert calls == [300, 10]
    assert c.metrics.counter("serving.reuse.incremental.declined") == 1
    got = c.sql(q).compute()
    assert c.metrics.counter("serving.reuse.incremental.hits") == 0
    full = pd.concat([df, _df(10, seed=22)])
    assert got.sort_values("k")["s"].tolist() == \
        full.groupby("k")["a"].sum().tolist()


# ------------------------------------------------------- append surface
def test_append_rows_api():
    def scenario(s, engine):
        n = s.append("t", pd.DataFrame({"a": [1, 2], "b": [0.5, 0.25],
                                        "k": [1, 1]}))
        return n, s.sql("SELECT COUNT(*) AS c FROM t")["c"].tolist()

    out = _both(scenario, {"t": _df(50, seed=16)})
    assert out["port"][0] == out["ref"][0] == (2, [52])
    with pytest.raises(KeyError):
        out["port"][1].append_rows("missing", _df(5))


def test_insert_into_sql():
    def scenario(s, engine):
        a = s.sql("INSERT INTO t VALUES (7, 0.5, 1), (8, 0.25, 2)")
        b = s.sql("INSERT INTO t SELECT a, b, k FROM t WHERE k = 2")
        return (a["Inserted"].tolist(), b["Inserted"].tolist(),
                s.c.metrics.counter("serving.reuse.append_rows"))

    out = _both(scenario, {"t": _df(50, seed=17)})
    assert out["port"][0] == out["ref"][0]
    inserted, more, appended = out["port"][0]
    assert inserted == ["2"] and appended == 2 + int(more[0]) >= 3
    pc = out["port"][1]
    with pytest.raises(RuntimeError, match="expects 3 columns"):
        pc.sql("INSERT INTO t VALUES (1)").compute()
    with pytest.raises(RuntimeError, match="not present"):
        pc.sql("INSERT INTO missing VALUES (1, 2.0, 3)").compute()


def test_show_materialized_sql():
    """The kinds, tables, rows, hits and epochs of the reference's rows
    (its fingerprints too: the plan reprs are the same); ``Bytes`` is each
    engine's own accounting and is held to its ledger instead."""
    df = _df(4000, seed=18)

    def scenario(s, engine):
        empty = s.sql("SHOW MATERIALIZED")
        s.sql("SELECT a FROM t WHERE b < 50.0")
        s.sql("SELECT k FROM t WHERE b < 50.0")
        s.sql("SELECT k, SUM(a) AS s FROM t GROUP BY k")
        s.append("t", _df(10, seed=19))
        rows = s.sql("SHOW MATERIALIZED")
        like = s.sql("SHOW MATERIALIZED LIKE 'stem'")
        stem_bytes = rows.loc[rows.Kind == "stem", "Bytes"].astype(int)
        assert stem_bytes.sum() == \
            s.c.ledger.snapshot()["materializedBytes"] > 0
        return (list(empty.columns), len(empty),
                rows.drop(columns=["Bytes"]).to_dict("list"),
                like["Kind"].tolist())

    out = _both(scenario, {"t": df}, **{"serving.materialize.min_bytes": 1})
    assert out["port"][0] == out["ref"][0]
    columns, n_empty, rows, like = out["port"][0]
    assert columns == ["Kind", "Fingerprint", "Table", "Rows", "Bytes",
                       "Hits", "Epoch"] and n_empty == 0
    assert set(rows["Kind"]) == {"stem", "incremental"}
    assert like == ["stem"]


# --------------------------------------------------- a warm Context
def test_warm_context_rungs_match_the_reference():
    """A Q1-family dashboard (three date literals, then a repeat that the
    result cache answers) and then a stem (``l_quantity < 10``) under three downstream
    shapes on one warm Context of each engine: the same rungs and reuse
    counters query by query, and the same rows.  The second stem shape
    pins the stem, and the third runs on the interpreted walk over it."""
    li = bench.gen_lineitem(20_000)
    stem = "FROM lineitem WHERE l_quantity < 10"
    queries = [bench.QUERY.replace("1998-09-02", d)
               for d in ("1998-09-02", "1998-06-01", "1997-01-01")]
    queries += [queries[0],
                f"SELECT l_returnflag, SUM(l_extendedprice) AS s {stem} "
                f"GROUP BY l_returnflag ORDER BY l_returnflag",
                f"SELECT AVG(l_discount) AS d {stem}",
                f"SELECT l_shipdate, l_extendedprice {stem} "
                f"ORDER BY l_extendedprice DESC, l_shipdate LIMIT 100"]

    def scenario(s, engine):
        options = {"sql.compile.segsum": "matmul"} if engine == "ref" else {}
        return [s.sql(q, config_options=options) for q in queries]

    out = _both(scenario, {"lineitem": li})
    (got, pc), (want, _) = out["port"], out["ref"]
    for g, w in zip(got, want):
        _same(g, w)
    fused = {"resilience.rung.compiled_aggregate": 1}
    assert out["moves"] == [
        fused, fused, fused, {}, fused,
        dict(fused, **{"serving.materialize.stored": 1}),
        {"serving.materialize.hits": 1}]
