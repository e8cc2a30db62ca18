"""Query tracing and observability in the port (`observability/`,
`tracing.py`, `serving/metrics.py`), held against the reference on the
CPU.

The reference's cases of `tests/unit/test_observability.py` run here on
`Context(device="cpu")`, less the Presto wire, the checkpoint and the
result cache (ROADMAP.md Queue 1 items 8b and 8d): the lifecycle stages,
a plan-cache hit, tracing off, the compile span and metric (a pipeline
build on a cache miss; a family member that reuses its pipeline records
none), the Chrome export, per-thread activation, the node-trace format,
EXPLAIN ANALYZE (text and FORMAT JSON), the d2h stage, SHOW METRICS and
SHOW PROFILES on both parsers, the profile store, the Prometheus text,
the slow-query log and the trace store.  For `bench.QUERY`, the root
select and TPC-H Q3, the port's stage names equal the reference's less
``cache_lookup`` (its result cache), in the same order, and EXPLAIN
ANALYZE's node labels and rows equal the reference's (the ms aside: the
tolerance is exact for names, labels and rows, and no time is compared).
Both engines run on fresh Contexts fed the same statements, their stem
materialization on (`materialize/`).  On the card an enabled
tracer synchronizes each node's device before it reads the clock, and
nothing else does (a spy on `torch.cuda.synchronize`).  A deleted Context
leaves no table tensor behind in the pipeline caches.
"""
import gc
import json
import re
import threading
import time
import weakref

import numpy as np
import pandas as pd
import pytest
import torch

import bench
import dask_sql_tpu
from dask_sql_tpu.observability import render_prometheus as ref_prometheus
from dask_sql_tpu.serving.metrics import MetricsRegistry as RefRegistry
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.observability import (
    ProfileStore,
    QueryTrace,
    TraceStore,
    activate,
    current_trace,
    render_prometheus,
)
from dask_sql_tpu_torch.physical import compiled, compiled_join, compiled_select
from dask_sql_tpu_torch.planner.parser import ParsingException
from dask_sql_tpu_torch.resilience import faults
from dask_sql_tpu_torch.resilience.errors import QueryError
from dask_sql_tpu_torch.serving.metrics import MetricsRegistry
from dask_sql_tpu_torch.tracing import NodeTrace, Tracer
from tests.tpch import QUERIES, generate

SELECT_QUERY = ("SELECT l_returnflag, l_extendedprice * (1 - l_discount) "
                "AS rev FROM lineitem WHERE l_discount > 0.09 "
                "ORDER BY rev DESC LIMIT 100")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny: one thread runs them fastest on a
    machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx(rows=32, name="t"):
    c = Context(device="cpu")
    c.create_table(name, pd.DataFrame({
        "a": np.arange(rows, dtype=np.int64),
        "b": np.arange(rows, dtype=np.float64) * 1.5,
    }))
    return c


def _frames():
    tables = generate(2000)
    return {"lineitem": bench.gen_lineitem(4_000, seed=0),
            **{f"{n}3": tables[n] for n in ("customer", "orders",
                                             "lineitem")}}


def _q3() -> str:
    return re.sub(r"\b(customer|orders|lineitem)\b", r"\g<1>3", QUERIES[3])


CASES = {"q1": bench.QUERY, "select": SELECT_QUERY, "q3": _q3()}


@pytest.fixture(scope="module")
def frames():
    return _frames()


def _fresh(frames):
    rc, pc = dask_sql_tpu.Context(), Context(device="cpu")
    for name, frame in frames.items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    return rc, pc


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("case", list(CASES))
def test_stages_and_explain_analyze_match_reference(frames, case):
    """On fresh Contexts: the lifecycle stage names in order, the
    ``cache_lookup`` stage of the result cache included, sequential, then
    EXPLAIN ANALYZE's node labels and rows."""
    rc, pc = _fresh(frames)
    sql = CASES[case]
    got = pc.sql(sql).compute()
    want = rc.sql(sql).compute()
    assert len(got) == len(want) > 0
    stages = pc.last_trace.stage_spans()
    ref_names = [s.name for s in rc.last_trace.stage_spans()]
    assert "cache_lookup" in ref_names
    assert [s.name for s in stages] == ref_names
    for left, right in zip(stages, stages[1:]):
        assert left.t1 <= right.t0 + 1e-9, (left.name, right.name)

    def tree(c, **kw):
        rows = c.sql(f"EXPLAIN ANALYZE {sql}", **kw).compute()["PLAN"]
        return [re.sub(r"\[[0-9.]+ ms, ", "[", r) for r in rows
                if r.endswith(" rows]")]

    mine = tree(pc)
    assert mine == tree(rc)
    assert len(mine) >= 3


def test_prometheus_golden_is_the_references():
    """The golden of the reference's test, and the reference's renderer
    gives the same text for the same observations."""
    text = []
    for registry, render in ((MetricsRegistry(), render_prometheus),
                             (RefRegistry(), ref_prometheus)):
        registry.inc("query.executed", 3)
        registry.gauge("serving.depth", 2.5)
        for v in (1.0, 2.0, 4.0):
            registry.observe("serving.latency_ms", v)
        text.append(render(registry.snapshot()))
    assert text[0] == text[1] == (
        "# TYPE dsql_query_executed_total counter\n"
        "dsql_query_executed_total 3\n"
        "# TYPE dsql_query_cache_hit_rate gauge\n"
        "dsql_query_cache_hit_rate 0\n"
        "# TYPE dsql_serving_depth gauge\n"
        "dsql_serving_depth 2.5\n"
        "# TYPE dsql_serving_latency_ms summary\n"
        'dsql_serving_latency_ms{quantile="0.5"} 2\n'
        'dsql_serving_latency_ms{quantile="0.95"} 4\n'
        'dsql_serving_latency_ms{quantile="0.99"} 4\n'
        "dsql_serving_latency_ms_sum 7\n"
        "dsql_serving_latency_ms_count 3\n"
        "# TYPE dsql_serving_latency_ms_max gauge\n"
        "dsql_serving_latency_ms_max 4\n"
    )


# ------------------------------------------------------------ span model
def test_plan_cache_hit_skips_parse_span():
    c = _ctx()
    sql = "SELECT SUM(a) AS s FROM t"
    c.sql(sql, return_futures=False)
    c.sql(sql, return_futures=False)
    tr = c.last_trace
    assert not tr.has_span("parse")
    assert any(s.name == "plan_cache_hit" for s in tr.spans)


def test_trace_disabled_by_config():
    c = _ctx()
    c.config.update({"observability.trace.enabled": False})
    c.sql("SELECT a FROM t", return_futures=False)
    assert c.last_trace is None
    assert c.metrics.counter("query.executed") == 1


def test_compile_span_and_metric_recorded():
    c = Context(device="cpu")
    c.create_table("fresh_ct", pd.DataFrame({
        "zq_one": np.arange(40, dtype=np.int64),
        "zq_two": np.arange(40, dtype=np.float64),
    }))
    c.sql("SELECT zq_one FROM fresh_ct WHERE zq_one > 7",
          return_futures=False)
    tr = c.last_trace
    compiles = [s for s in tr.spans if s.name == "compile:compiled_select"]
    assert len(compiles) == 1, [s.name for s in tr.spans]
    assert compiles[0].parent == "execute"
    hist = c.metrics.snapshot()["histograms"]
    assert hist["resilience.compile_ms.compiled_select"]["count"] == 1
    prof = c.profiles.get(tr.fingerprint)
    assert prof is not None and prof["compile"]["compiled_select"][
        "count"] == 1
    # a warm run hits the pipeline: no compile recorded
    c.sql("SELECT zq_one FROM fresh_ct WHERE zq_one > 7",
          return_futures=False)
    assert not any(s.name.startswith("compile:")
                   for s in c.last_trace.spans)
    assert c.metrics.snapshot()["histograms"][
        "resilience.compile_ms.compiled_select"]["count"] == 1


def test_family_member_records_no_compile():
    """Q1 with another date literal reuses its family's pipeline
    (``families.hit``): the build was the only compile."""
    c = Context(device="cpu")
    c.create_table("lineitem", bench.gen_lineitem(2_000, seed=0))
    c.sql(bench.QUERY).compute()
    c.sql(bench.QUERY.replace("1998-09-02", "1998-08-01")).compute()
    assert c.metrics.counter("families.hit") == 1
    hist = c.metrics.snapshot()["histograms"]
    assert hist["resilience.compile_ms.compiled_aggregate"]["count"] == 1
    assert not any(s.name.startswith("compile:")
                   for s in c.last_trace.spans)
    rows = {(m, v) for _, _, m, v in c.profiles.rows()}
    assert ("compile.compiled_aggregate.count", "1") in rows
    assert ("hits", "2") in rows  # one family entry for both dates


def test_chrome_trace_export_shape():
    tr = QueryTrace(sql="SELECT 1", metrics=None, profiles=None)
    with tr.span("parse"):
        pass
    tr.event("plan_cache_hit")
    payload = tr.to_chrome_trace()
    assert payload["displayTimeUnit"] == "ms"
    phases = {e["ph"] for e in payload["traceEvents"]}
    assert {"M", "X", "i"} <= phases
    x = [e for e in payload["traceEvents"] if e["ph"] == "X"][0]
    assert x["name"] == "parse" and x["dur"] >= 0
    assert payload["otherData"]["sql"] == "SELECT 1"


def test_activation_is_scoped_per_thread():
    seen = {}

    def worker(i):
        tr = QueryTrace(sql=f"q{i}")
        with activate(tr):
            time.sleep(0.01)
            seen[i] = current_trace().sql

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert seen == {i: f"q{i}" for i in range(8)}
    assert current_trace() is None


def test_add_span_once_is_atomic():
    tr = QueryTrace(qid="q")
    results = []

    def add():
        results.append(tr.add_span_once("serialize", 0.0, 1.0))

    threads = [threading.Thread(target=add) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert results.count(True) == 1
    assert sum(1 for s in tr.spans if s.name == "serialize") == 1


def test_trace_store_lru_bound():
    store = TraceStore(keep=2)
    for i in range(4):
        store.put(f"q{i}", QueryTrace(qid=f"q{i}"))
    assert len(store) == 2
    assert store.get("q0") is None and store.get("q3") is not None


# ----------------------------------------------------------- node traces
def test_node_trace_format_unknown_rows_and_events():
    root = NodeTrace("Projection", "Projection: x", 2.0, -1, [
        NodeTrace("Resilience", "degraded: compiled_select [OOM]", 0.0, -1),
        NodeTrace("TableScan", "TableScan: t", 1.0, 10),
    ])
    text = root.format()
    assert "? rows" in text
    assert "-1 rows" not in text
    assert "!! degraded: compiled_select [OOM]" in text
    assert "0.00 ms" not in text
    assert "[1.00 ms, 10 rows]" in text


class _Rel:
    node_type = "TableScan"

    @staticmethod
    def _label():
        return "TableScan: t"


@pytest.mark.parametrize("device, syncs", [("cuda", 2), ("cpu", 0)])
def test_tracer_waits_for_the_card_at_each_node_end(monkeypatch, device,
                                                     syncs):
    """An enabled tracer on a CUDA device synchronizes it once a node,
    before the node's clock stops; on the CPU it never does."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    tracer = Tracer(torch.device(device))
    tracer.start()
    with tracer.node(_Rel()) as outer:
        with tracer.node(_Rel()) as inner:
            inner.rows = 3
        outer.rows = 3
    assert len(calls) == syncs
    assert tracer.root.children[0].rows == 3


def test_untraced_execution_never_synchronizes(monkeypatch):
    """The executor's tracer is off unless EXPLAIN ANALYZE or
    ``serving.metrics.node_traces`` asks: a query's node exits never
    reach `torch.cuda.synchronize`."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    c = _ctx()
    c.sql("SELECT a, SUM(b) AS s FROM t GROUP BY a", return_futures=False)
    assert calls == []


def test_node_traces_fold_into_the_registry():
    c = _ctx()
    c.sql("SELECT a, SUM(b) AS s FROM t GROUP BY a", return_futures=False,
          config_options={"serving.metrics.node_traces": True})
    snap = c.metrics.snapshot()
    assert snap["histograms"]["executor.node.Aggregate.ms"]["count"] == 1
    assert snap["counters"]["executor.node.Aggregate.rows"] == 32
    assert any(s.kind == "detail" and s.name == "Aggregate"
               for s in c.last_trace.spans)


# --------------------------------------------------------- EXPLAIN ANALYZE
def test_explain_analyze_lifecycle_header():
    c = _ctx()
    rows = list(c.sql("EXPLAIN ANALYZE SELECT a FROM t WHERE a > 5",
                      return_futures=False)["PLAN"])
    assert rows[0].startswith("-- query lifecycle")
    assert any(r.strip().startswith("parse") for r in rows)
    assert any(r.strip().startswith("bind") for r in rows)
    assert any(r.strip().startswith("execute") and r.endswith("(open)")
               for r in rows)
    assert any(r.lstrip().startswith("TableScan") and r.endswith("26 rows]")
               for r in rows)


def test_explain_analyze_marks_a_step_down():
    """Under ``compile:always`` the fused aggregate steps down: the node
    tree marks where, and the trace has the event."""
    c = Context(device="cpu")
    c.create_table("lineitem", bench.gen_lineitem(2_000, seed=0))
    faults.reset()
    try:
        rows = list(c.sql("EXPLAIN ANALYZE " + bench.QUERY, config_options={
            "resilience.inject": "compile:always"}).compute()["PLAN"])
    finally:
        faults.reset()
    assert any(r.strip() == "!! degraded: compiled_aggregate "
               "[INJECTED_COMPILE_ERROR]" for r in rows), rows
    assert any(s.name == "degraded:compiled_aggregate"
               for s in c.last_trace.spans)


@pytest.mark.parametrize("native", ["auto", "off"])
def test_explain_format_json_without_analyze_rejected(native):
    c = _ctx()
    with pytest.raises(ParsingException):
        c.sql("EXPLAIN FORMAT JSON SELECT a FROM t", return_futures=False,
              config_options={"sql.native.binder": native})


@pytest.mark.parametrize("native", ["auto", "off"])
def test_explain_analyze_format_json_both_parsers(native):
    c = _ctx()
    out = c.sql("EXPLAIN ANALYZE FORMAT JSON SELECT a FROM t WHERE a > 5",
                return_futures=False,
                config_options={"sql.native.binder": native})
    payload = json.loads(out["PLAN"][0])
    assert payload["displayTimeUnit"] == "ms"
    names = [e["name"] for e in payload["traceEvents"] if e.get("ph") == "X"]
    assert "parse" in names and "TableScan" in names


def test_explain_analyze_format_json_with_tracing_off():
    c = _ctx()
    c.config.update({"observability.trace.enabled": False})
    out = c.sql("EXPLAIN ANALYZE FORMAT JSON SELECT a FROM t",
                return_futures=False)
    payload = json.loads(out["PLAN"][0])
    names = [e["name"] for e in payload["traceEvents"] if e.get("ph") == "X"]
    assert "TableScan" in names and "parse" not in names


# ------------------------------------------------------------------ d2h
def test_repeated_compute_does_not_duplicate_d2h_stage():
    c = _ctx()
    frame = c.sql("SELECT a FROM t WHERE a > 4")
    frame.compute()
    frame.compute()
    tr = c.last_trace
    assert sum(1 for s in tr.spans if s.name == "d2h") == 1
    assert tr.finished
    assert c.metrics.snapshot()["histograms"]["query.d2h_ms"]["count"] == 2


def test_d2h_metric_records_with_tracing_disabled():
    c = _ctx(name="d2h_t")
    c.config.update({"observability.trace.enabled": False})
    c.sql("SELECT a FROM d2h_t", return_futures=False)
    assert "query.d2h_ms" in c.metrics.snapshot()["histograms"]


def test_compile_metrics_survive_tracing_disabled():
    c = Context(device="cpu")
    c.create_table("notrace_ct", pd.DataFrame({
        "nt_col": np.arange(48, dtype=np.int64)}))
    c.config.update({"observability.trace.enabled": False})
    c.sql("SELECT nt_col FROM notrace_ct WHERE nt_col > 11",
          return_futures=False)
    assert c.last_trace is None
    assert "resilience.compile_ms.compiled_select" in \
        c.metrics.snapshot()["histograms"]
    rows = c.profiles.rows()
    assert any(m == "compile.compiled_select.count" for _, _, m, _ in rows)
    assert any(m == "hits" for _, _, m, _ in rows)


# ---------------------------------------------------- SHOW METRICS/PROFILES
@pytest.mark.parametrize("native", ["auto", "off"])
def test_show_profiles_statement_both_parsers(native):
    c = _ctx()
    c.sql("SELECT SUM(a) AS s FROM t", return_futures=False)
    df = c.sql("SHOW PROFILES", return_futures=False,
               config_options={"sql.native.binder": native})
    assert list(df.columns) == ["Fingerprint", "Family", "Metric", "Value"]
    assert {"sql", "hits", "exec_ms.p50"} <= set(df["Metric"])


def test_show_profiles_like_filters_fingerprint_and_metric():
    c = _ctx()
    c.sql("SELECT COUNT(*) AS n FROM t", return_futures=False)
    fp = c.last_trace.fingerprint
    by_fp = c.sql(f"SHOW PROFILES LIKE '{fp[:8]}%'", return_futures=False)
    assert set(by_fp["Fingerprint"]) == {fp}
    by_metric = c.sql("SHOW PROFILES LIKE 'hits'", return_futures=False)
    assert set(by_metric["Metric"]) == {"hits", "cache_hits"}


@pytest.mark.parametrize("native", ["auto", "off"])
def test_show_metrics_both_parsers_and_like(native):
    c = _ctx()
    c.sql("SELECT SUM(a) AS s FROM t", return_futures=False)
    opts = {"sql.native.binder": native}
    df = c.sql("SHOW METRICS", return_futures=False, config_options=opts)
    assert list(df.columns) == ["Metric", "Value"]
    values = dict(zip(df["Metric"], df["Value"]))
    assert values["query.executed"] == "1"
    assert values["query.execute_ms.count"] == "1"
    assert values["resilience.breaker.keys"] == "0"
    assert list(df["Metric"]) == sorted(df["Metric"])
    like = c.sql("SHOW METRICS LIKE 'query.execute%'", return_futures=False,
                 config_options=opts)
    assert set(like["Metric"]) == {
        f"query.execute_ms.{s}" for s in ("avg", "count", "max", "p50",
                                          "p95", "p99")} | {"query.executed"}


def test_profile_store_rolling_window():
    store = ProfileStore(window=4, keep=2)
    for i in range(10):
        store.record_exec("fp1", sql="q", exec_ms=float(i))
    assert store.get("fp1")["exec_ms"] == [6.0, 7.0, 8.0, 9.0]
    store.record_exec("fp2", exec_ms=1.0)
    store.record_exec("fp3", exec_ms=1.0)  # keep=2 evicts LRU fp1
    assert store.get("fp1") is None and len(store) == 2


def test_profile_store_snapshot_load_round_trip():
    store = ProfileStore(window=8)
    store.record_exec("abc123", sql="SELECT 1", exec_ms=5.5,
                      result_bytes=128)
    store.record_compile("abc123", "compiled_select", 42.0)
    restored = ProfileStore(window=8)
    assert restored.load(json.loads(json.dumps(store.snapshot()))) == 1
    assert restored.get("abc123") == store.get("abc123")
    assert restored.rows() == store.rows()


def test_prometheus_extra_gauges_and_sanitization():
    reg = MetricsRegistry()
    reg.inc("executor.node.TableScan.rows", 7)
    text = render_prometheus(reg.snapshot(),
                             extra_gauges={"serving.queue_depth": 1})
    assert "dsql_executor_node_TableScan_rows_total 7" in text
    assert "dsql_serving_queue_depth 1" in text


# ------------------------------------------------------------ slow queries
def test_slow_query_log_threshold(tmp_path):
    log = tmp_path / "slow.jsonl"
    c = _ctx(name="slow_t")
    c.config.update({"observability.slow_query_ms": 0,
                     "observability.slow_query_path": str(log)})
    c.sql("SELECT a FROM slow_t WHERE a > 1", return_futures=False)
    lines = log.read_text().strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record["sql"].startswith("SELECT a FROM slow_t")
    assert {"parse", "execute", "d2h"} <= {s["name"] for s in record["spans"]}
    assert c.metrics.counter("observability.slow_query") == 1
    c.config.update({"observability.slow_query_ms": 1e12})
    c.sql("SELECT a FROM slow_t WHERE a > 2", return_futures=False)
    assert len(log.read_text().strip().splitlines()) == 1


def test_failed_query_trace_finished_and_slow_logged(tmp_path):
    log = tmp_path / "slow_fail.jsonl"
    c = _ctx(name="fail_t")
    faults.reset()
    c.config.update({"observability.slow_query_ms": 0,
                     "observability.slow_query_path": str(log),
                     "resilience.inject": "execute:always"})
    try:
        with pytest.raises(QueryError):
            c.sql("SELECT a FROM fail_t", return_futures=False)
    finally:
        faults.reset()
    tr = c.last_trace
    assert tr.finished
    execute = [s for s in tr.spans if s.name == "execute"]
    assert execute and execute[0].attrs.get("error")
    records = [json.loads(ln) for ln in log.read_text().strip().splitlines()]
    assert any(r["sql"].startswith("SELECT a FROM fail_t") for r in records)


def test_slow_query_config_options_gate_that_querys_failure(tmp_path):
    log = tmp_path / "slow_opt.jsonl"
    c = _ctx(name="opt_t")
    faults.reset()
    try:
        with pytest.raises(QueryError):
            c.sql("SELECT a FROM opt_t", return_futures=False,
                  config_options={
                      "observability.slow_query_ms": 0,
                      "observability.slow_query_path": str(log),
                      "resilience.inject": "execute:always",
                      "resilience.ladder.enabled": False,
                  })
    finally:
        faults.reset()
    assert log.exists() and log.read_text().strip()


# ------------------------------------------------------ card memory (A2)
def test_a_deleted_context_leaves_no_table_behind(frames):
    """The pipeline caches are module-level; a Context's entries leave
    with it (`compiled.pipeline_owner`), so after Q1, the root select and
    Q3 ran, deleting the Context frees its tables' tensors."""
    c = Context(device="cpu")
    for name, frame in frames.items():
        c.create_table(name, frame)
    for sql in CASES.values():
        c.sql(sql).compute()
        c.sql(sql).compute()  # the warm path hits its pipeline
    assert c.metrics.counter("families.hit") + c.metrics.snapshot()[
        "histograms"]["resilience.compile_ms.compiled_aggregate"]["count"] \
        >= 1
    builds = {name: h["count"] for name, h in
              c.metrics.snapshot()["histograms"].items()
              if name.startswith("resilience.compile_ms.")}
    assert builds == {f"resilience.compile_ms.{r}": 1 for r in (
        "compiled_aggregate", "compiled_select", "compiled_join_aggregate")}
    token = c._pipeline_owner
    caches = (compiled._cache, compiled_join._cache, compiled_select._cache)
    assert all(any(k[0] == token for k in cache) for cache in caches)
    refs = [weakref.ref(col.data) for dc in c.schema["root"].tables.values()
            for col in dc.table.columns.values()]
    del c
    gc.collect()
    assert all(r() is None for r in refs)
    assert not any(k[0] == token for cache in caches for k in cache)
