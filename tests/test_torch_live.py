"""The port's live serving plane against the reference's
(`tests/unit/test_live_observability.py`): the in-flight query table (SHOW
QUERIES, CANCEL QUERY), the card-byte ledger, the batcher's flow links,
the flight recorder, queue-wait attribution and the stores under
concurrent load.  Context cases run on a fresh port CPU Context and a
fresh reference Context.  (The wire endpoints are item 8d's, the streamed
partitions item 8c's and the self-lint rules item 8d's.)"""
import json
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu import config as ref_config
from dask_sql_tpu.observability import flight as ref_flight
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.observability import (
    ProfileStore,
    QueryTrace,
    TraceStore,
    activate,
    flight,
    merge_chrome_traces,
    render_prometheus,
)
from dask_sql_tpu_torch.serving import QueryCancelledError, ServingRuntime
from dask_sql_tpu_torch.serving.metrics import MetricsRegistry

import bench



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state():
    """Both flight recorders and the reference's config are process-wide:
    each test starts clean and gives back what it found."""
    saved = ref_config.config.effective_items()
    flight.RECORDER.clear()
    ref_flight.RECORDER.clear()
    yield
    ref_config.config.update(dict(saved))
    flight.RECORDER.clear()
    ref_flight.RECORDER.clear()


def _frame(rows=64):
    return pd.DataFrame({"a": np.arange(rows, dtype=np.int64),
                         "b": np.arange(rows, dtype=np.float64) * 1.5})


def _pair(rows=64, name="lt"):
    rc, pc = dask_sql_tpu.Context(), Context(device="cpu")
    for c in (rc, pc):
        c.create_table(name, _frame(rows))
    return rc, pc


#: fields whose values are timings or ids
VOLATILE_FIELDS = ("elapsed_ms",)


def _live_rows(c, qid):
    df = c.sql("SHOW QUERIES", return_futures=False)
    return [(f, v) for q, f, v in zip(df["Qid"], df["Field"], df["Value"])
            if q == qid and f not in VOLATILE_FIELDS]


# ------------------------------------------------------- in-flight table
def test_show_queries_lists_finished_query_with_rung_and_family():
    """The same rows as the reference's for the same query: state, class,
    stage, rung, family, measured bytes, sql; then the ledger block."""
    rc, pc = _pair()
    rows = []
    for c in (rc, pc):
        c.sql("SELECT SUM(a) AS s FROM lt", return_futures=False)
        rows.append(_live_rows(c, c.last_trace.qid))
        df = c.sql("SHOW QUERIES", return_futures=False)
        assert list(df.columns) == ["Qid", "Field", "Value"]
        ledger = {f for q, f in zip(df["Qid"], df["Field"]) if q == "(ledger)"}
        assert {"reservedBytes", "resultCacheBytes", "tableBytes",
                "headroomBytes", "driftBytes"} <= ledger
    fields = dict(rows[1])
    assert fields["state"] == "done" and fields["class"] == "interactive"
    assert fields["rung"] and fields["sql"].startswith("SELECT SUM(a)")
    want = [(f, v) for f, v in rows[0] if f != "family"]
    assert [(f, v) for f, v in rows[1] if f != "family"] == want


def test_show_queries_python_and_native_paths_agree():
    c = Context(device="cpu")
    c.create_table("lt", _frame())
    c.sql("SELECT a FROM lt WHERE a > 3", return_futures=False)
    native = c.sql("SHOW QUERIES", return_futures=False)
    python = c.sql("SHOW QUERIES", return_futures=False,
                   config_options={"sql.native.binder": "off"})
    assert list(native.columns) == list(python.columns)
    assert set(native["Qid"]) == set(python["Qid"])


def test_show_queries_like_filters_on_qid_and_field():
    c = Context(device="cpu")
    c.create_table("lt", _frame())
    c.sql("SELECT a FROM lt", return_futures=False)
    qid = c.last_trace.qid
    only_ledger = c.sql("SHOW QUERIES LIKE 'ledger'", return_futures=False)
    assert set(only_ledger["Qid"]) == {"(ledger)"}
    mine = c.sql(f"SHOW QUERIES LIKE '{qid[:12]}'", return_futures=False)
    assert set(mine["Qid"]) == {qid}


def test_cancel_query_unknown_qid_reports_false():
    rc, pc = _pair()
    for c, rec in ((rc, ref_flight.RECORDER), (pc, flight.RECORDER)):
        df = c.sql("CANCEL QUERY 'no-such-query'", return_futures=False)
        assert df.to_dict("list") == {"Qid": ["no-such-query"],
                                      "Cancelled": ["false"]}
        assert [(e["event"], e["qid"], e["ok"])
                for e in rec.events(name="query.cancel")] == [
            ("query.cancel", "no-such-query", False)]
        assert c.metrics.counter("serving.cancel_requested") == 1


def _slow(c, sleep_s=0.002):
    def crawl(a):
        time.sleep(sleep_s)
        return a

    c.create_table("slow_t", _frame(4000))
    c.register_function(crawl, "crawl", [("a", np.int64)], np.int64,
                        row_udf=True)


def test_cancel_query_statement_stops_running_query():
    """CANCEL QUERY stops a Context query mid-run through its live entry's
    ticket: the row function polls it before each row.  The state, the
    error and the flight event are the reference's."""
    for c in (dask_sql_tpu.Context(), Context(device="cpu")):
        _slow(c)
        errors = []

        def run():
            try:
                c.sql("SELECT crawl(a) AS x FROM slow_t", return_futures=False)
            except BaseException as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        t = threading.Thread(target=run)
        t.start()
        try:
            entry = None
            deadline = time.time() + 10.0
            while time.time() < deadline and entry is None:
                live = c.live_queries.live_entries()
                if live and live[0].state == "running":
                    entry = live[0]
                time.sleep(0.005)
            assert entry is not None, "the query never showed as running"
            df = c.sql(f"CANCEL QUERY '{entry.qid}'", return_futures=False)
            assert list(df["Cancelled"]) == ["true"]
        finally:
            t.join(20.0)
        assert not t.is_alive()
        assert errors and type(errors[0]).__name__ == "QueryCancelledError"
        assert c.live_queries.get(entry.qid).state == "cancelled"
    events = flight.RECORDER.events(name="query.cancel")
    assert [e["ok"] for e in events] == [True]
    assert isinstance(errors[0], QueryCancelledError)


def test_live_entry_records_stage_rung_and_measured_bytes():
    rc, pc = _pair()
    entries = []
    for c in (rc, pc):
        c.sql("SELECT SUM(b) AS s FROM lt", return_futures=False)
        entries.append(c.live_queries.entries()[-1])
    ref, mine = entries
    assert mine.state == "done" and mine.stage == "execute" and mine.rung
    assert (mine.stage, mine.rung, mine.measured_bytes) == (
        ref.stage, ref.rung, ref.measured_bytes)
    assert mine.measured_bytes > 0


# ------------------------------------------------------------- the ledger
def test_ledger_reconciles_and_sums_consistently():
    """The ledger's totals are the reference's on the same table and
    query: the budget, table bytes, cache bytes, headroom."""
    snaps = []
    lineitem = bench.gen_lineitem(4096, seed=1)
    for c in (dask_sql_tpu.Context(), Context(device="cpu")):
        c.create_table("lineitem", lineitem)
        opts = {"serving.admission.max_estimated_bytes": 1 << 30}
        if isinstance(c, Context):
            c.config.update(opts)
        else:
            ref_config.config.update(opts)
        snap = c.ledger.snapshot()
        assert snap["reservedBytes"] == 0 and snap["tableBytes"] > 0
        assert snap["headroomBytes"] == (snap["budgetBytes"]
                                         - snap["reservedBytes"]
                                         - snap["resultCacheBytes"]
                                         - snap["tableBytes"])
        c.sql(bench.QUERY, return_futures=False)
        after = c.ledger.snapshot()
        assert after["resultCacheBytes"] == c._result_cache.stats.bytes > 0
        snaps.append((snap, after))
    (ref0, ref1), (mine0, mine1) = snaps
    assert mine0 == ref0
    # the result tables' buffers differ in kind (the reference's group
    # keys come back as DICT codes), so the cache's bytes are compared
    # apart from the rest
    assert {k: v for k, v in mine1.items() if k not in (
        "resultCacheBytes", "headroomBytes")} == {
        k: v for k, v in ref1.items() if k not in (
            "resultCacheBytes", "headroomBytes")}


def test_ledger_gauges_match_scheduler_inflight_gauge():
    from dask_sql_tpu_torch.serving.scheduler import QueryCost

    c = Context(device="cpu")
    c.create_table("lt", _frame())
    runtime = ServingRuntime(workers=2, metrics=c.metrics,
                             scheduler_budget_bytes=1 << 20)
    c.serving = runtime
    release = threading.Event()
    try:
        runtime.submit(lambda t: release.wait(10.0),
                       cost=QueryCost(bytes_lo=12345))
        deadline = time.time() + 5.0
        while time.time() < deadline and c.ledger.reserved_bytes() != 12345:
            time.sleep(0.005)
        snap = c.ledger.publish(c.metrics)
        gauges = c.metrics.snapshot()["gauges"]
        assert snap["reservedBytes"] == 12345
        assert gauges["serving.ledger.reserved_bytes"] == 12345
        assert gauges["serving.scheduler.inflight_bytes"] == 12345
    finally:
        release.set()
        runtime.shutdown(wait=True)
        c.serving = None
    assert c.ledger.reserved_bytes() == 0


def test_prometheus_golden_ledger_gauges():
    """The exposition of the ledger's gauges, the reference's golden."""
    from dask_sql_tpu_torch.serving.cache import table_nbytes

    c = Context(device="cpu")
    c.create_table("ldg", _frame(32))
    c.config.update({"serving.admission.max_estimated_bytes": 1 << 20})
    t_bytes = sum(table_nbytes(dc.table)
                  for dc in c.schema["root"].tables.values())
    reg = MetricsRegistry()
    c.ledger.publish(reg)
    assert render_prometheus(reg.snapshot()) == (
        "# TYPE dsql_query_cache_hit_rate gauge\n"
        "dsql_query_cache_hit_rate 0\n"
        "# TYPE dsql_serving_ledger_budget_bytes gauge\n"
        f"dsql_serving_ledger_budget_bytes {1 << 20}\n"
        "# TYPE dsql_serving_ledger_cache_bytes gauge\n"
        "dsql_serving_ledger_cache_bytes 0\n"
        "# TYPE dsql_serving_ledger_headroom_bytes gauge\n"
        f"dsql_serving_ledger_headroom_bytes {(1 << 20) - t_bytes}\n"
        "# TYPE dsql_serving_ledger_inflight_measured_bytes gauge\n"
        "dsql_serving_ledger_inflight_measured_bytes 0\n"
        "# TYPE dsql_serving_ledger_materialized_bytes gauge\n"
        "dsql_serving_ledger_materialized_bytes 0\n"
        "# TYPE dsql_serving_ledger_model_bytes gauge\n"
        "dsql_serving_ledger_model_bytes 0\n"
        "# TYPE dsql_serving_ledger_reserve_drift_bytes gauge\n"
        "dsql_serving_ledger_reserve_drift_bytes 0\n"
        "# TYPE dsql_serving_ledger_reserved_bytes gauge\n"
        "dsql_serving_ledger_reserved_bytes 0\n"
        "# TYPE dsql_serving_ledger_table_bytes gauge\n"
        f"dsql_serving_ledger_table_bytes {t_bytes}\n")
    # a model committed by its first fused PREDICT: its params are the
    # model gauge, out of the headroom (a float32 weight and bias)
    c.sql("""CREATE MODEL lm WITH (model_class = 'LinearRegression',
             target_column = 'b') AS (SELECT a, b FROM ldg)""")
    c.sql("SELECT * FROM PREDICT(MODEL lm, SELECT a FROM ldg)").compute()
    reg = MetricsRegistry()
    c.ledger.publish(reg)
    text = render_prometheus(reg.snapshot())
    assert "dsql_serving_ledger_model_bytes 8\n" in text
    cached = c.ledger.snapshot()["resultCacheBytes"]
    assert "dsql_serving_ledger_headroom_bytes " \
        f"{(1 << 20) - t_bytes - cached - 8}\n" in text


# ------------------------------------------------- cross-query causality
def test_batch_member_and_leader_traces_carry_flow_links():
    from dask_sql_tpu_torch.families.batcher import FamilyBatcher

    batcher = FamilyBatcher(max_queries=4, window_ms=500.0,
                            busy=lambda: True)
    traces = [QueryTrace(sql="q0"), QueryTrace(sql="q1")]
    barrier = threading.Barrier(2)
    outs = [None, None]

    def worker(i):
        with activate(traces[i]):
            barrier.wait(5.0)
            outs[i] = batcher.run("key", (i,), lambda: [(i,)],
                                  lambda members: [[m] for m in members])

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert outs[0] is not None and outs[1] is not None
    names = {tr: [s.name for s in tr.spans] for tr in traces}
    leader = next(tr for tr in traces if "batch_launch" in names[tr])
    member = next(tr for tr in traces if tr is not leader)
    join = next(s for s in member.spans if s.name == "batch_join")
    launch = next(s for s in leader.spans if s.name == "batch_launch")
    assert join.attrs["flow_out"] == launch.attrs["flow_in"]
    assert leader.qid in member.links and member.qid in leader.links
    merged = merge_chrome_traces([member, leader])
    flows = [e for e in merged["traceEvents"] if e.get("cat") == "dsql.flow"]
    assert {e["id"] for e in flows if e["ph"] == "s"} & \
        {e["id"] for e in flows if e["ph"] == "f"}
    assert {e["pid"] for e in merged["traceEvents"]} == {1, 2}
    assert {"batch.lead", "batch.member"} <= {
        e["event"] for e in flight.RECORDER.events()}


def test_batcher_propagates_leader_failure_and_runs_solo_when_alone():
    """The reference's batcher cases: a leader's failure reaches every
    member; a lone query runs solo; ``max_queries`` 1 disables it."""
    from dask_sql_tpu_torch.families.batcher import FamilyBatcher

    batcher = FamilyBatcher(max_queries=4, window_ms=200.0)
    boom = RuntimeError("stacked launch died")
    outcomes = {}

    def member(i):
        def batched(members):
            raise boom
        try:
            outcomes[i] = batcher.run("key", (i,), lambda: f"solo-{i}",
                                      batched)
        except RuntimeError as e:
            outcomes[i] = e

    threads = [threading.Thread(target=member, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert all(outcomes[i] is boom for i in range(4))
    calls = []
    alone = FamilyBatcher(max_queries=4, window_ms=1.0, busy=lambda: False)
    assert alone.run("k", (1,), solo=lambda: calls.append("solo") or 42,
                     batched=lambda m: calls.append("b") or [0] * 4) == 42
    assert calls == ["solo"]
    off = FamilyBatcher(max_queries=1, window_ms=1000.0)
    assert off.run("k", (1,), solo=lambda: "s", batched=lambda m: ["b"]) == "s"


# -------------------------------------------------------- flight recorder
def test_flight_ring_is_bounded_and_filterable():
    rec = flight.FlightRecorder(capacity=32)
    for i in range(100):
        rec.record("query.admit", qid=f"q{i}")
    assert len(rec) == 32 and rec.recorded == 100
    assert [e["qid"] for e in rec.events(limit=5)] == [
        f"q{i}" for i in range(95, 100)]
    assert rec.events(qid="q99")[0]["qid"] == "q99"
    assert rec.events(name="query.shed") == []


def test_flight_vocabulary_is_the_references():
    assert flight.EVENT_NAMES == ref_flight.EVENT_NAMES
    assert flight.is_registered_event("breaker.trip")
    assert not flight.is_registered_event("query.admitt")


def test_every_recorded_event_is_registered():
    """The names at the port's ``flight.record`` call sites are all in the
    registered vocabulary (the reference checks its own with DSQL501)."""
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "dask_sql_tpu_torch"
    names = set()
    for path in root.rglob("*.py"):
        names.update(re.findall(r'flight\.record\(\s*"([^"]+)"',
                                path.read_text()))
    assert names and not {n for n in names
                          if not flight.is_registered_event(n)}


def test_flight_auto_flush_on_query_failure(tmp_path):
    """A failing query flushes the ring to the dump path once, with its
    qid and error code, marks its live entry failed and counts the dump,
    as the reference does."""
    from dask_sql_tpu.resilience import faults as ref_faults
    from dask_sql_tpu_torch.resilience import faults

    records = []
    for c, fts in ((dask_sql_tpu.Context(), ref_faults),
                   (Context(device="cpu"), faults)):
        dump = tmp_path / f"{type(c).__module__}.jsonl"
        c.create_table("lt", _frame())
        opts = {"observability.flight.dump_path": str(dump),
                "resilience.ladder.enabled": False}
        if isinstance(c, Context):
            c.config.update(opts)
        else:
            ref_config.config.update(opts)
        fts.reset()
        with pytest.raises(Exception):
            c.sql("SELECT a FROM lt", return_futures=False,
                  config_options={"resilience.inject": "execute:once"})
        fts.reset()
        lines = dump.read_text().strip().splitlines()
        assert len(lines) == 1
        record = json.loads(lines[0])
        assert record["qid"] and record["error"]
        assert c.live_queries.get(record["qid"]).state == "failed"
        assert c.metrics.counter("observability.flight.dumps") == 1
        records.append(record)
    assert records[1]["error"] == records[0]["error"]
    assert [e["event"] for e in records[1]["events"]] == [
        e["event"] for e in records[0]["events"]
        if e["event"] != "compile.start" and e["event"] != "compile.end"]


def test_ladder_and_breaker_flight_events_are_the_references():
    """An injected compile failure steps Q1 down the ladder and trips the
    breakers: the same ``ladder.degrade``, ``breaker.trip`` and
    ``query.finish`` events, in order, as the reference's."""
    lineitem = bench.gen_lineitem(2_000, seed=4)
    kept = ("ladder.degrade", "breaker.trip", "breaker.restore",
            "query.finish")
    seqs = []
    for c, rec in ((dask_sql_tpu.Context(), ref_flight.RECORDER),
                   (Context(device="cpu"), flight.RECORDER)):
        c.breaker.threshold = 1
        c.create_table("lineitem", lineitem)
        opts = {"resilience.inject": "compile:always",
                "serving.cache.enabled": False}
        c.sql(bench.QUERY, config_options=opts, return_futures=False)
        seqs.append([(e["event"], e.get("rung"), e.get("code"))
                     for e in rec.events() if e["event"] in kept])
    assert seqs[1] == seqs[0]
    assert ("breaker.trip", "compiled_aggregate",
            "INJECTED_COMPILE_ERROR") in seqs[1]


def test_breaker_restore_detected_on_half_open_success():
    from dask_sql_tpu_torch.resilience.retry import CircuitBreaker

    b = CircuitBreaker(threshold=1, cooldown_s=0.0)
    key = ("fp", "compiled_aggregate")
    assert b.record_failure(key) and b.is_open(key)
    assert b.record_success(key) is True
    b.record_failure(("fp2", "r"))
    assert b.record_success(("fp3", "r")) is False


def test_lock_order_violation_records_a_flight_event():
    """The lock sanitizer reports an inversion to the flight recorder, as
    the reference's does."""
    from dask_sql_tpu_torch.runtime import locks

    was = locks.enabled()
    locks.set_enabled(True)
    try:
        outer = locks.named_lock("serving.metrics")     # rank 90
        inner = locks.named_lock("serving.runtime.cv")  # rank 40
        with outer:
            with pytest.raises(locks.LockOrderError):
                inner.acquire()
    finally:
        locks.set_enabled(was)
    events = flight.RECORDER.events(name="lock.order_violation")
    assert events and events[-1]["holding"] == "serving.metrics"


def test_pipeline_build_records_compile_events():
    c = Context(device="cpu")
    c.create_table("lineitem", bench.gen_lineitem(500))
    c.sql(bench.QUERY, return_futures=False)
    got = [(e["event"], e["rung"]) for e in flight.RECORDER.events()
           if e["event"].startswith("compile.")]
    assert got == [("compile.start", "compiled_aggregate"),
                   ("compile.end", "compiled_aggregate")]
    end = flight.RECORDER.events(name="compile.end")[0]
    assert end["qid"] == c.last_trace.qid and end["ms"] >= 0


# ------------------------------------------------- queue-wait attribution
def test_scheduler_stamps_queue_wait_cause():
    from dask_sql_tpu_torch.serving.admission import QueryTicket
    from dask_sql_tpu_torch.serving.scheduler import PackingScheduler, \
        QueryCost

    sched = PackingScheduler(budget_bytes=100)
    t1, t2 = QueryTicket("big"), QueryTicket("small")
    sched.push_locked(t1, lambda: None, None, QueryCost(bytes_lo=80))
    sched.push_locked(t2, lambda: None, None, QueryCost(bytes_lo=50))
    assert sched.pop_locked(batch_ok=True)[0] is t1
    assert sched.pop_locked(batch_ok=True) is None  # byte-blocked
    sched.release_locked(t1)
    assert sched.pop_locked(batch_ok=True)[0] is t2
    assert t2.queue_reason == "byte_blocked"


def test_submit_registers_live_entry_and_queue_wait():
    """`Context.submit`: the live entry exists before a worker pops the
    query, the trace opens with a ``queue_wait`` stage, and the cost hint
    carries the plan's provable floor."""
    c = Context(device="cpu")
    c.create_table("lineitem", bench.gen_lineitem(2_000))
    c.sql(bench.QUERY)  # planned: its cost hint has the estimate
    rt = ServingRuntime(workers=1, metrics=c.metrics)
    c.serving = rt
    try:
        cost = c.cost_hint(bench.QUERY)
        assert cost.bytes_lo > 0 and cost.family
        qid, fut = c.submit(bench.QUERY)
        assert c.live_queries.get(qid) is not None
        assert len(fut.result(60)) == len(c.sql(bench.QUERY).compute())
    finally:
        rt.shutdown(wait=True)
        c.serving = None
    entry = c.live_queries.get(qid)
    assert entry.state == "done" and entry.reserved_bytes() == cost.bytes_lo
    assert [s.name for s in c.traces.get(qid).stage_spans()][0] == \
        "queue_wait"


# ------------------------------------ store bounds under concurrent load
def test_trace_store_bounds_with_eviction_racing_readers():
    store = TraceStore(keep=8)
    stop = threading.Event()
    failures = []

    def writer(tid):
        try:
            for i in range(300):
                tr = QueryTrace(sql=f"q{tid}-{i}")
                store.put(tr.qid, tr)
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            failures.append(exc)

    def reader():
        try:
            while not stop.is_set():
                store.get("nope")
                assert len(store) <= 8
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            failures.append(exc)

    writers = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in writers + readers:
        t.start()
    for t in writers:
        t.join(30.0)
    stop.set()
    for t in readers:
        t.join(10.0)
    assert not failures and len(store) <= 8
    assert not any(t.is_alive() for t in writers + readers)


def test_profile_store_bounds_with_eviction_racing_readers():
    store = ProfileStore(window=4, keep=6)
    stop = threading.Event()
    failures = []

    def writer(tid):
        try:
            for i in range(200):
                fp = f"fp-{tid}-{i % 10}"
                store.record_exec(fp, sql=f"SELECT {i}", exec_ms=float(i),
                                  result_bytes=i)
                store.record_compile(fp, "compiled_aggregate", float(i))
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            failures.append(exc)

    def reader():
        try:
            while not stop.is_set():
                store.rows()
                store.snapshot()
                assert len(store) <= 6
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            failures.append(exc)

    writers = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in writers + readers:
        t.start()
    for t in writers:
        t.join(30.0)
    stop.set()
    for t in readers:
        t.join(10.0)
    assert not failures and len(store) <= 6
    assert not any(t.is_alive() for t in writers + readers)
