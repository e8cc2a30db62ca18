"""The port's serving tier against the reference's (`tests/unit/
test_serving.py`): the metrics registry, the result cache, admission
control and the worker pool, the executor's cancellation checkpoints; the
family batcher's stacked run against solo runs; the thread-safe launch and
transfer counters; the estimated-bytes gate.

The runtime cases run the same body on the port's modules and the
reference's (``impl``).  The Context cases run one scenario on a fresh
port CPU Context and a fresh reference Context and compare answers and
counters.  Every wait is bounded, and every runtime shuts down in a
``finally``."""
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
import dask_sql_tpu.serving as ref_serving
import dask_sql_tpu_torch.serving as port_serving
from dask_sql_tpu import config as ref_config
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.ops.segsum import MATMUL_FLOAT_REL_ERR_BOUND

import bench

IMPLS = {"port": port_serving, "ref": ref_serving}



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are tiny: one torch thread runs them fastest on a
    machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _ref_config():
    """The reference's config is process-global: each test gives back
    what it found."""
    saved = ref_config.config.effective_items()
    yield
    ref_config.config.update(dict(saved))


@pytest.fixture(params=sorted(IMPLS))
def sv(request):
    return IMPLS[request.param]


def _runtime(sv, **kw):
    return sv.ServingRuntime(**kw)


# --------------------------------------------------------------- metrics
def test_histogram_percentiles(sv):
    h = sv.Histogram()
    for v in range(1, 101):
        h.observe(float(v))
    snap = h.snapshot()
    assert snap["count"] == 100 and snap["max"] == 100.0
    assert 45 <= snap["p50"] <= 55 and 90 <= snap["p95"] <= 100
    assert snap["avg"] == pytest.approx(50.5)


def test_registry_counters_and_rows(sv):
    m = sv.MetricsRegistry()
    m.inc("a.b", 2)
    m.observe("lat_ms", 5.0)
    m.gauge("depth", 3)
    snap = m.snapshot()
    assert snap["counters"]["a.b"] == 2 and snap["gauges"]["depth"] == 3
    rows = dict(m.rows())
    assert rows["a.b"] == "2" and "lat_ms.p99" in rows


def test_registry_trace_aggregation():
    from dask_sql_tpu_torch.tracing import NodeTrace, Tracer

    m = port_serving.MetricsRegistry()
    root = NodeTrace("Projection", "Projection: x", 2.0, 10,
                     [NodeTrace("TableScan", "TableScan: t", 1.0, 10)])
    m.observe_trace(root)
    snap = m.snapshot()
    assert snap["histograms"]["executor.node.Projection.ms"]["count"] == 1
    assert snap["counters"]["executor.node.TableScan.rows"] == 10
    t = Tracer()
    t.root = root
    t.publish(m)
    assert m.snapshot()["histograms"][
        "executor.node.Projection.ms"]["count"] == 2


# ----------------------------------------------------------- result cache
def test_result_cache_lru_by_bytes(sv):
    c = sv.ResultCache(max_bytes=100, max_entry_bytes=100, ttl_s=None)
    c.put("a", "va", nbytes=40)
    c.put("b", "vb", nbytes=40)
    assert c.get("a") == "va"  # a becomes the most recent
    c.put("c", "vc", nbytes=40)  # evicts b, the least recent
    assert c.get("b") is None
    assert c.get("a") == "va" and c.get("c") == "vc"
    assert c.stats.evictions == 1 and c.stats.bytes <= 100


def test_result_cache_per_entry_cap(sv):
    c = sv.ResultCache(max_bytes=1000, max_entry_bytes=50, ttl_s=None)
    assert not c.put("big", "x", nbytes=51)
    assert c.get("big") is None and c.stats.oversize_rejects == 1
    assert c.put("ok", "y", nbytes=50)


def test_result_cache_ttl(sv):
    now = [0.0]
    c = sv.ResultCache(max_bytes=100, max_entry_bytes=100, ttl_s=10.0,
                       clock=lambda: now[0])
    c.put("k", "v", nbytes=1)
    now[0] = 5.0
    assert c.get("k") == "v"
    now[0] = 16.0
    assert c.get("k") is None and c.stats.expirations == 1


def test_result_cache_replace_accounting(sv):
    c = sv.ResultCache(max_bytes=100, max_entry_bytes=100, ttl_s=None)
    c.put("k", "v1", nbytes=30)
    c.put("k", "v2", nbytes=60)
    assert c.stats.bytes == 60 and c.stats.entries == 1
    assert c.get("k") == "v2"


def test_table_nbytes_counts_the_references_buffers():
    """Buffer for buffer the reference's count: data, validity, the
    dictionaries of strings and DICT values, on a PLAIN and an encoded
    table."""
    from dask_sql_tpu.columnar.table import Table as RefTable
    from dask_sql_tpu_torch.columnar.table import Table

    small = pd.DataFrame({"i": np.arange(10, dtype=np.int64),
                          "s": ["abc", None] * 5,
                          "f": np.where(np.arange(10) % 3, 1.5, np.nan)})
    encoded = bench.gen_lineitem(4096)
    for df, encode in ((small, False), (encoded, True)):
        got = port_serving.table_nbytes(
            Table.from_pandas(df, "cpu", encode=encode))
        want = ref_serving.table_nbytes(RefTable.from_pandas(df, encode=encode))
        assert got == want >= 10 * 8


# ------------------------------------------- context-level result caching
def _frame():
    return pd.DataFrame({"a": [1, 2, 3], "b": [1.5, 2.5, 3.5]})


def _pair():
    rc, pc = dask_sql_tpu.Context(), Context(device="cpu")
    for c in (rc, pc):
        c.create_table("t", _frame())
    return rc, pc


CACHE_KEYS = ("query.cache.hit", "query.cache.miss", "query.cache.invalidated",
              "query.cache.oversize", "query.executed")


def _cache_counters(c) -> dict:
    return {k: c.metrics.counter(k) for k in CACHE_KEYS}


def _both(scenario):
    """Run ``scenario(context)`` on a fresh reference Context and a fresh
    port CPU Context: the same answers (as lists) and cache counters."""
    rc, pc = _pair()
    want, got = scenario(rc), scenario(pc)
    assert got == want
    assert _cache_counters(pc) == _cache_counters(rc)
    return pc


def _value(c, q, col="s", **kw):
    return c.sql(q, return_futures=False, **kw)[col].tolist()


def test_repeated_query_hits_result_cache():
    def scenario(c):
        q = "SELECT SUM(a) AS s FROM t"
        out = [_value(c, q), c.metrics.counter("query.cache.hit")]
        return out + [_value(c, q), c.metrics.counter("query.cache.hit")]

    pc = _both(scenario)
    assert pc.metrics.counter("query.cache.hit") == 1


def test_ddl_invalidates_result_cache():
    def scenario(c):
        q = "SELECT SUM(a) AS s FROM t"
        first = _value(c, q)
        c.create_table("t", pd.DataFrame({"a": [10, 20]}))  # a replace
        return [first, _value(c, q)]

    pc = _both(scenario)
    assert pc.metrics.counter("query.cache.hit") == 0


def test_sql_ddl_invalidates_result_cache():
    def scenario(c):
        c.sql("CREATE VIEW v AS SELECT a FROM t")
        r1 = _value(c, "SELECT SUM(a) AS s FROM v")
        c.sql("DROP VIEW v")
        c.sql("CREATE VIEW v AS SELECT b FROM t")
        return [r1, _value(c, "SELECT SUM(b) AS s FROM v")]

    _both(scenario)


def test_config_options_partition_result_cache():
    def scenario(c):
        q = "SELECT SUM(a) AS s FROM t"
        _value(c, q)
        _value(c, q, config_options={"sql.compile": False})
        hits = [c.metrics.counter("query.cache.hit")]
        _value(c, q, config_options={"sql.compile": False})
        return hits + [c.metrics.counter("query.cache.hit")]

    assert _both(scenario).metrics.counter("query.cache.hit") == 1


def test_result_cache_distinguishes_sort_null_order():
    def scenario(c):
        c.create_table("sn", pd.DataFrame({"a": [1.0, None, 3.0, None, 2.0]}))
        return [c.sql(q, return_futures=False)["a"].fillna(-1).tolist()
                for q in ("SELECT * FROM sn ORDER BY a",
                          "SELECT * FROM sn ORDER BY a NULLS FIRST")]

    rc, pc = _pair()
    got = scenario(pc)
    assert got == scenario(rc)
    assert got == [[1.0, 2.0, 3.0, -1, -1], [-1, -1, 1.0, 2.0, 3.0]]


def test_result_cache_disabled_by_config():
    def scenario(c):
        q = "SELECT SUM(a) AS s FROM t"
        opts = {"serving.cache.enabled": False}
        return [_value(c, q, config_options=opts),
                _value(c, q, config_options=opts)]

    assert _both(scenario).metrics.counter("query.cache.hit") == 0


def test_volatile_functions_never_cached():
    def scenario(c):
        for q in ("SELECT RAND() AS r FROM t",
                  "SELECT CURRENT_TIMESTAMP AS ts FROM t",
                  # a volatile call inside a subquery plan
                  "SELECT a FROM t WHERE a > (SELECT RAND() FROM t LIMIT 1)"):
            c.sql(q, return_futures=False)
            c.sql(q, return_futures=False)
        return []

    assert _both(scenario).metrics.counter("query.cache.hit") == 0


def test_udf_queries_never_cached():
    calls = []

    def sample(x):
        calls.append(1)
        return x

    def scenario(c):
        c.register_function(sample, "sample_udf", [("x", np.int64)],
                            np.int64)
        q = "SELECT sample_udf(a) AS v FROM t"
        return [_value(c, q, "v"), _value(c, q, "v")]

    pc = _both(scenario)
    assert pc.metrics.counter("query.cache.hit") == 0
    assert len(calls) == 4  # really run again, in both engines


def test_ddl_frees_cache_bytes():
    def scenario(c):
        q = "SELECT SUM(a) AS s FROM t"
        _value(c, q)
        out = [c._result_cache.stats.entries]
        # registering another table leaves the entry over t hittable
        c.create_table("t2", pd.DataFrame({"z": [1]}))
        out.append(c._result_cache.stats.entries)
        _value(c, q)
        # replacing the table it read frees the entry at once
        c.create_table("t", pd.DataFrame({"a": [7, 8]}))
        return out + [c._result_cache.stats.entries,
                      c._result_cache.stats.bytes]

    pc = _both(scenario)
    assert pc.metrics.counter("query.cache.hit") == 1


def test_insert_into_drops_the_cached_rows_of_its_table():
    """INSERT INTO rewrites the table in place (`append_rows`): a cached
    ``SELECT *`` that may alias its tensors is dropped before anyone reads
    it, and the repeat sees the new rows."""
    def scenario(c):
        q = "SELECT a, b FROM t"
        first = c.sql(q, return_futures=False)["a"].tolist()
        again = c.sql(q, return_futures=False)["a"].tolist()
        c.sql("INSERT INTO t VALUES (4, 4.5)")
        after = c.sql(q, return_futures=False)["a"].tolist()
        return [first, again, after, c._result_cache.stats.entries]

    pc = _both(scenario)
    assert pc.metrics.counter("query.cache.hit") == 1
    assert pc.metrics.counter("query.cache.invalidated") == 1


# ---------------------------------------------------------- SHOW METRICS
def test_show_metrics_statement():
    def scenario(c):
        q = "SELECT SUM(a) AS s FROM t"
        _value(c, q)
        _value(c, q)
        df = c.sql("SHOW METRICS", return_futures=False)
        rows = dict(zip(df["Metric"], df["Value"]))
        return [list(df.columns), rows["query.cache.hit"],
                sorted(k for k in rows if k.startswith("result_cache.")),
                {k: rows[k] for k in rows if k.startswith(
                    ("result_cache.", "serving.ledger.")) and k not in (
                    "result_cache.bytes", "serving.ledger.cache_bytes",
                    "serving.ledger.table_bytes")},
                "plan_cache.entries" in rows]

    _both(scenario)


def test_show_metrics_like_filter():
    def scenario(c):
        out = []
        for like in ("result_cache", "result_cache.%", "nope.%"):
            df = c.sql(f"SHOW METRICS LIKE '{like}'", return_futures=False)
            out.append(sorted(df["Metric"]))
        return out

    _both(scenario)


# ------------------------------------------------------------- admission
def test_queue_full_rejection(sv):
    rt = _runtime(sv, workers=1, bounds={"interactive": 1, "batch": 1})
    try:
        gate, started = threading.Event(), threading.Event()

        def blocker(t):
            started.set()
            return gate.wait(10)

        _, f1, _ = rt.submit(blocker)
        assert started.wait(10)
        _, f2, _ = rt.submit(lambda t: "queued")
        with pytest.raises(sv.QueueFullError) as ei:
            rt.submit(lambda t: "shed")
        assert ei.value.retry_after_s > 0
        assert ei.value.priority_class == "interactive"
        gate.set()
        assert f2.result(10) == "queued"
        assert rt.metrics.counter("serving.rejected") == 1
        assert rt.metrics.counter("serving.admitted") == 2
    finally:
        gate.set()
        rt.shutdown(wait=True)


def test_interactive_scheduled_before_batch(sv):
    rt = _runtime(sv, workers=1, bounds={"interactive": 8, "batch": 8})
    gate = threading.Event()
    try:
        order = []
        _, f0, _ = rt.submit(lambda t: gate.wait(10))
        _, fb, _ = rt.submit(lambda t: order.append("batch"),
                             priority_class="batch")
        _, fi, _ = rt.submit(lambda t: order.append("interactive"))
        gate.set()
        fb.result(10), fi.result(10)
        assert order == ["interactive", "batch"]
    finally:
        gate.set()
        rt.shutdown(wait=True)


def test_batch_running_cap_enforced(sv):
    rt = _runtime(sv, workers=2, bounds={"interactive": 8, "batch": 8},
                  batch_max_running=1)
    gate = threading.Event()
    try:
        started = []

        def blocker(name):
            def fn(t):
                started.append(name)
                gate.wait(10)
                return name
            return fn

        _, f1, _ = rt.submit(blocker("b1"), priority_class="batch")
        _, f2, _ = rt.submit(blocker("b2"), priority_class="batch")
        time.sleep(0.2)
        assert started == ["b1"]  # cap 1: the burst does not overshoot
        _, fi, _ = rt.submit(lambda t: "i1")  # the other worker stays free
        assert fi.result(10) == "i1"
        gate.set()
        assert f1.result(10) == "b1" and f2.result(10) == "b2"
    finally:
        gate.set()
        rt.shutdown(wait=True)


def test_batch_paused_sheds_instead_of_stranding(sv):
    rt = _runtime(sv, workers=2, bounds={"interactive": 8, "batch": 8},
                  batch_max_running=0)
    try:
        with pytest.raises(sv.QueueFullError):
            rt.submit(lambda t: "never", priority_class="batch")
        _, f, _ = rt.submit(lambda t: "ok")
        assert f.result(10) == "ok"
    finally:
        rt.shutdown(wait=True)


def test_unknown_class_defaults_to_interactive(sv):
    rt = _runtime(sv, workers=1)
    try:
        _, f, ticket = rt.submit(lambda t: "done", priority_class="realtime")
        assert ticket.priority_class == "interactive"
        assert f.result(10) == "done"
    finally:
        rt.shutdown(wait=True)


def test_deadline_cancels_at_checkpoint(sv):
    rt = _runtime(sv, workers=1)
    try:
        def ticking(t):
            for _ in range(200):
                time.sleep(0.01)
                t.checkpoint()
            return "never"

        _, f, _ = rt.submit(ticking, deadline_s=0.1)
        with pytest.raises(sv.DeadlineExceededError):
            f.result(10)
        assert rt.metrics.counter("serving.timeouts") == 1
    finally:
        rt.shutdown(wait=True)


def test_cooperative_cancel_mid_run(sv):
    rt = _runtime(sv, workers=1)
    try:
        started = threading.Event()

        def spin(t):
            started.set()
            for _ in range(1000):
                time.sleep(0.01)
                t.checkpoint()

        _, f, ticket = rt.submit(spin)
        assert started.wait(10)
        ticket.cancel()
        with pytest.raises(sv.QueryCancelledError):
            f.result(10)
        assert rt.metrics.counter("serving.cancelled") == 1
    finally:
        rt.shutdown(wait=True)


def test_expired_while_queued(sv):
    rt = _runtime(sv, workers=1)
    gate, started = threading.Event(), threading.Event()
    try:
        # the blocker runs before f2 is submitted: the scheduler orders a
        # query with a deadline first
        _, f1, _ = rt.submit(lambda t: (started.set(), gate.wait(10))[1])
        assert started.wait(5)
        _, f2, _ = rt.submit(lambda t: "x", deadline_s=0.05)
        time.sleep(0.15)
        gate.set()
        with pytest.raises(sv.DeadlineExceededError):
            f2.result(10)
    finally:
        gate.set()
        rt.shutdown(wait=True)


def test_shutdown_drains_inflight_and_fails_queued(sv):
    """The query in flight finishes, each queued future fails at once with
    a retryable ShutdownError, later submits are refused, and the
    admission counts drain to zero."""
    rt = _runtime(sv, workers=1, bounds={"interactive": 8, "batch": 8})
    gate, started = threading.Event(), threading.Event()

    def inflight(t):
        started.set()
        gate.wait(10)
        return "inflight-done"

    _, f1, _ = rt.submit(inflight)
    assert started.wait(10)
    _, f2, _ = rt.submit(lambda t: "queued-1")
    _, f3, _ = rt.submit(lambda t: "queued-2", priority_class="batch")
    release = threading.Timer(0.2, gate.set)
    release.start()
    try:
        rt.shutdown(wait=True, timeout=10)
    finally:
        release.cancel()
        gate.set()
    assert f1.result(10) == "inflight-done"
    for fut in (f2, f3):
        with pytest.raises(sv.ShutdownError) as ei:
            fut.result(1)
        assert ei.value.retryable
    with pytest.raises(sv.ShutdownError):
        rt.submit(lambda t: "too-late")
    assert rt.metrics.counter("serving.shutdown_shed") == 2
    snap = rt.admission.snapshot()
    assert snap["waiting"] == {"interactive": 0, "batch": 0}
    assert snap["running"] == {"interactive": 0, "batch": 0}
    assert not any(t.is_alive() for t in rt._threads)


def test_runtime_counters_and_events_are_the_references():
    """One scenario on both runtimes, one worker: a retried transient
    failure, a query cancelled and one expired while queued, a batch
    query, a queue-full shed: the same ``serving.*`` and
    ``resilience.retry.*`` counters, the same flight events."""
    from dask_sql_tpu.observability import flight as ref_flight
    from dask_sql_tpu.resilience import errors as ref_errors
    from dask_sql_tpu_torch.observability import flight
    from dask_sql_tpu_torch.resilience import errors

    seen = []
    for sv, rec, errs in ((ref_serving, ref_flight.RECORDER, ref_errors),
                          (port_serving, flight.RECORDER, errors)):
        rec.clear()
        rt = sv.ServingRuntime(workers=1, bounds={"interactive": 3,
                                                  "batch": 2})
        gate, started = threading.Event(), threading.Event()

        def flaky(t, errs=errs):
            raise errs.TransientExecutionError("transient device fault")

        try:
            rt.submit(lambda t: (started.set(), gate.wait(10))[1],
                      qid="block")
            assert started.wait(10)
            _, f_fail, _ = rt.submit(flaky, qid="flaky")
            _, f_cancel, ticket = rt.submit(lambda t: "x", qid="cancel")
            ticket.cancel()
            _, f_exp, _ = rt.submit(lambda t: "x", qid="expire",
                                    deadline_s=0.01)
            _, f_b, _ = rt.submit(lambda t: "b", qid="b1",
                                  priority_class="batch")
            with pytest.raises(sv.QueueFullError):
                rt.submit(lambda t: "shed", qid="shed")
            time.sleep(0.05)
            gate.set()
            outcomes = []
            for f in (f_fail, f_cancel, f_exp, f_b):
                try:
                    outcomes.append(f.result(10))
                except Exception as exc:  # noqa: BLE001 - compared below
                    outcomes.append(type(exc).__name__)
        finally:
            gate.set()
            rt.shutdown(wait=True)
        counters = {k: v for k, v in rt.metrics.snapshot()[
            "counters"].items() if k.startswith(("serving.", "resilience."))}
        events = [(e["event"], e.get("qid"), e.get("reason"), e.get("cls"))
                  for e in rec.events()]
        seen.append((outcomes, counters, events))
    assert seen[1] == seen[0]
    outcomes, counters, _ = seen[1]
    assert outcomes == ["TransientExecutionError", "QueryCancelledError",
                        "DeadlineExceededError", "b"]
    assert counters["resilience.retry.attempts"] == 2


def test_deadline_cancels_executor_mid_plan():
    """The executor's checkpoints observe the thread's serving ticket, in
    both engines, and the live table marks the query failed."""
    rc, pc = _pair()
    for c, mod in ((rc, ref_serving), (pc, port_serving)):
        ticket = mod.QueryTicket("q1", deadline=time.monotonic() - 1.0)
        with mod.runtime.ticket_scope(ticket):
            with pytest.raises(mod.DeadlineExceededError):
                c.sql("SELECT SUM(a) AS s FROM t ORDER BY s",
                      return_futures=False)
        assert mod.current_ticket() is None
    assert pc.metrics.counter("query.executed") == 0


# ------------------------------------------------------ the family batcher
def _q1(date: str, table: str = "lineitem") -> str:
    return bench.QUERY.replace("1998-09-02", date).replace(
        "FROM lineitem", f"FROM {table}")


DATES = ("1998-09-02", "1998-08-01", "1998-06-15", "1997-12-31")


@pytest.fixture(scope="module")
def lineitem():
    return bench.gen_lineitem(6_000, seed=3)


def _burst(c, rt_cls, sqls, **rt_kw):
    """Every query of `sqls` submitted at once to a runtime on `c` (planned
    first, so members meet at the executor); the answers in order."""
    rt = rt_cls(workers=len(sqls), metrics=c.metrics, **rt_kw)
    c.serving = rt
    try:
        for q in sqls:
            c.sql(q)
        futs = [rt.submit(lambda t, q=q: c.sql(q).execute())[1]
                for q in sqls]
        return [f.result(120) for f in futs]
    finally:
        rt.shutdown(wait=True)
        c.serving = None


BATCH_KEYS = ("serving.batch.launches", "serving.batch.queries",
              "serving.batch.solo", "families.hit",
              "resilience.rung.compiled_aggregate")


@pytest.mark.parametrize("segsum", ["auto", "scatter"])
def test_batched_members_equal_solo_runs_and_the_references_counters(
        lineitem, segsum):
    """Four members of Q1's family at once: one stacked run, each member
    the same bits as its own run alone, its keys and counts the
    reference's, its floats within `MATMUL_FLOAT_REL_ERR_BOUND` of a
    float64 oracle, as `chip_smoke.check_q1` holds Q1 (Q1's products of
    float32 columns are float32 in both engines, and the reference's
    scatter also sums them in float32); the reference's
    ``serving.batch.*`` counters, families.hit and rungs."""
    from chip_smoke import q1_oracle

    sqls = [_q1(d) for d in DATES]
    opts = {"serving.cache.enabled": False, "sql.compile.segsum": segsum}
    rc, pc = dask_sql_tpu.Context(), Context(device="cpu")
    rc.create_table("lineitem", lineitem)
    pc.create_table("lineitem", lineitem)
    ref_config.config.update(opts)
    pc.config.update(opts)
    kw = dict(batch_queries=len(sqls), batch_window_ms=5_000.0)
    got = _burst(pc, port_serving.ServingRuntime, sqls, **kw)
    want = _burst(rc, ref_serving.ServingRuntime, sqls, **kw)
    counters = {k: pc.metrics.counter(k) for k in BATCH_KEYS}
    assert counters == {k: rc.metrics.counter(k) for k in BATCH_KEYS}
    assert counters["serving.batch.launches"] == 1
    assert counters["serving.batch.queries"] == len(sqls)
    for date, q, table, ref_table in zip(DATES, sqls, got, want):
        solo = pc.sql(q).compute()
        batched = table.to_pandas()
        batched.columns = solo.columns
        pd.testing.assert_frame_equal(batched, solo, check_exact=True)
        ref = ref_table.to_pandas()
        assert batched.iloc[:, :2].values.tolist() == \
            ref.iloc[:, :2].values.tolist()
        assert batched["count_order"].tolist() == ref["count_order"].tolist()
        oracle = q1_oracle(lineitem, date)
        np.testing.assert_allclose(
            batched.iloc[:, 2:-1].to_numpy(np.float64),
            oracle.iloc[:, 2:-1].to_numpy(np.float64),
            rtol=MATMUL_FLOAT_REL_ERR_BOUND)


def test_batcher_is_refused_where_the_references_is():
    """The reference batches only its scatter segment sum; with
    ``sql.compile.segsum = matmul`` neither engine batches."""
    from dask_sql_tpu_torch.physical import compiled

    c = Context(device="cpu")
    c.create_table("lineitem", bench.gen_lineitem(500))
    for mode, want in (("auto", True), ("scatter", True), ("matmul", False),
                       ("pallas", False)):
        c.sql(_q1("1998-09-02"), config_options={
            "sql.compile.segsum": mode, "serving.cache.enabled": False}
        ).compute()
        pipe = next(reversed(compiled._cache.values()))
        assert pipe.batchable is want, mode


def test_stacked_segsum_equals_each_members_own_call():
    """`segsum_stacked`'s plain version gives each member the bits of its
    own call, whatever the other members hold; a CPU call counts no
    launch."""
    from dask_sql_tpu_torch.ops import segsum

    rng = np.random.default_rng(5)
    n, domain = 5_000, 12
    gid = torch.from_numpy(rng.integers(0, domain, n).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=n))
    members = []
    for _ in range(3):
        mask = torch.from_numpy(rng.random(n) < 0.7)
        members.append([(vals, mask), (mask, None),
                        (vals.to(torch.float32), mask)])
    launches = segsum.LAUNCHES["segsum"]
    stacked = segsum.segsum_stacked(gid, members, domain)
    for cols, out in zip(members, stacked):
        assert torch.equal(out, segsum.segsum_typed(gid, cols, domain))
    assert segsum.LAUNCHES["segsum"] == launches


# --------------------------------------------------- thread-safe counters
def test_launch_and_transfer_counts_lose_nothing_under_threads():
    """The serving workers count launches and transfers from many threads:
    a read-modify-write without the lock would lose some."""
    from dask_sql_tpu_torch import utils
    from dask_sql_tpu_torch.ops import segsum

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    d2h0 = utils.TRANSFER_STATS["d2h"]
    launches0 = segsum.LAUNCHES["segsum"]
    per, workers = 2_000, 16

    def work():
        for _ in range(per):
            utils.count_d2h()
            with segsum._LAUNCH_LOCK:
                segsum.LAUNCHES["segsum"] += 1

    threads = [threading.Thread(target=work) for _ in range(workers)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert utils.TRANSFER_STATS["d2h"] - d2h0 == per * workers
    assert segsum.LAUNCHES["segsum"] - launches0 == per * workers


# ------------------------------------------------ the estimated-bytes gate
def _gate_pair(rows: int):
    rc, pc = dask_sql_tpu.Context(), Context(device="cpu")
    df = pd.DataFrame({"k": np.arange(rows) % 7,
                       "v": np.arange(rows, dtype=np.float64)})
    for c in (rc, pc):
        c.create_table("g", df)
    return rc, pc


def test_gate_sheds_where_the_reference_sheds():
    """A plan whose provable floor exceeds the budget, and whose one chunk
    could not fit either: both engines shed it before any executor work,
    with the same counter and flight event."""
    from dask_sql_tpu.observability import flight as ref_flight
    from dask_sql_tpu_torch.observability import flight

    rc, pc = _gate_pair(64)
    q = "SELECT k, SUM(v) AS s FROM g GROUP BY k"
    opts = {"serving.admission.max_estimated_bytes": 16}
    with pytest.raises(ref_serving.admission.EstimatedBytesExceededError):
        rc.sql(q, config_options=opts, return_futures=False)
    with pytest.raises(port_serving.EstimatedBytesExceededError) as ei:
        pc.sql(q, config_options=opts, return_futures=False)
    assert ei.value.code == "ESTIMATED_BYTES_EXCEEDED"
    for c in (rc, pc):
        assert c.metrics.counter("serving.shed_estimated_bytes") == 1
        assert c.metrics.counter("query.executed") == 0
    assert [e["reason"] for e in flight.RECORDER.events(name="query.shed")
            ][-1:] == [e["reason"] for e in ref_flight.RECORDER.events(
                name="query.shed")][-1:] == ["estimated_bytes"]


def test_gate_refuses_what_the_reference_would_stream():
    """Where the reference routes an over-budget plan to its partitioned
    streaming instead of shedding it, so does the port (streaming/): the
    same answer, the same partitions, no shed."""
    rc, pc = _gate_pair(40_000)
    q = "SELECT k, SUM(v) AS s FROM g GROUP BY k ORDER BY k"
    est = rc.sql(f"EXPLAIN ESTIMATE {q}", return_futures=False)
    lo = int(est["ESTIMATE"][0].split("bytes_lo=")[1].split()[0])
    opts = {"serving.admission.max_estimated_bytes": lo // 2}
    want = rc.sql(q, config_options=opts, return_futures=False)
    got = pc.sql(q, config_options=opts, return_futures=False)
    assert len(want) == 7
    pd.testing.assert_frame_equal(got, want)
    for c in (rc, pc):
        assert c.metrics.counter("serving.stream.admitted") == 1
        assert c.metrics.counter("resilience.rung.streamed_aggregate") == 1
        assert c.metrics.counter("serving.shed_estimated_bytes") == 0
    assert pc.metrics.counter("serving.stream.partitions") == \
        rc.metrics.counter("serving.stream.partitions") > 1
