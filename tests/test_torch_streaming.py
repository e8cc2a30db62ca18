"""Partitioned streaming in the port (`dask_sql_tpu_torch/streaming/`)
against the reference's (`tests/unit/test_streaming_partitioned.py`).

One seeded frame; the over-budget aggregate and select, the injected
mid-stream OOM and the gate's sheds run through a port Context and a
reference Context, each under its own ``_budget`` (both engines count the
same resident bytes), and must move the same ``serving.stream.*`` and
``resilience.partition.*`` counters and give the same answers: exact for
keys, counts, integer sums, MIN and MAX; float sums within 1e-9 of the
float64 oracle (a streamed float sum is grouped by partition, so it is
held to the oracle, not to the single run's bits).  The reference's
cases of its own internals (its chunk masks and warm-shape hints) are the
port's partition layout and its zero pipeline builds on a family's second
streamed run.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu.serving.cache import table_nbytes as ref_table_nbytes
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.resilience import faults
from dask_sql_tpu_torch.serving.admission import EstimatedBytesExceededError
from dask_sql_tpu_torch.serving.cache import table_nbytes
from dask_sql_tpu_torch.streaming import aggregate as stream_agg
from dask_sql_tpu_torch.streaming import select as stream_sel

N_ROWS = 40_000
AGG_Q = ("SELECT k, SUM(v) AS s, COUNT(*) AS n, AVG(v) AS a, "
         "MIN(v) AS mn, MAX(f) AS mx, SUM(f) AS sf FROM t "
         "GROUP BY k ORDER BY k")
SEL_Q = "SELECT k, v * 2 AS v2 FROM t WHERE f > 0.9"
NO_CACHE = {"serving.cache.enabled": False}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.reset()
    stream_agg.reset_cache()
    stream_sel.reset_cache()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def frame():
    rng = np.random.RandomState(7)
    return pd.DataFrame({
        "k": rng.randint(0, 5, N_ROWS).astype(np.int64),
        "v": rng.randint(0, 1000, N_ROWS).astype(np.int64),
        "f": rng.rand(N_ROWS),
    })


def _ctx(df, engine="port"):
    c = Context(device="cpu") if engine == "port" else dask_sql_tpu.Context()
    c.create_table("t", df)
    return c


def _budget(c, frac=3):
    """Between the whole scan's floor and one partition's: streams, never
    sheds."""
    nbytes = ref_table_nbytes if isinstance(c, dask_sql_tpu.Context) \
        else table_nbytes
    return nbytes(c.schema["root"].tables["t"].table) // frac


def _run(c, sql, **options):
    with c.config.set({**NO_CACHE, **options}):
        return c.sql(sql).compute()


def _stream_counters(c):
    return {k: v for k, v in c.metrics.snapshot()["counters"].items()
            if k.startswith(("serving.stream.", "resilience.partition.",
                             "resilience.rung.", "resilience.degraded",
                             "serving.shed"))}


def agg_oracle(df):
    g = df.groupby("k")
    return pd.DataFrame({
        "k": sorted(df.k.unique()),
        "s": g.v.sum().to_numpy(), "n": g.size().to_numpy(),
        "a": g.v.mean().to_numpy(), "mn": g.v.min().to_numpy(),
        "mx": g.f.max().to_numpy(), "sf": g.f.sum().to_numpy()})


def check_agg(got, want):
    for col in ("k", "s", "n", "mn", "mx"):
        assert got[col].tolist() == want[col].tolist(), col
    for col in ("a", "sf"):
        np.testing.assert_allclose(got[col], want[col], rtol=1e-9)


@pytest.fixture(scope="module")
def reference(frame):
    """The reference's streamed runs on the frame, once for the module:
    the aggregate, the select, and the aggregate with ``partition:at2``,
    each on a fresh Context (its counters after that one query)."""
    from dask_sql_tpu.resilience import faults as ref_faults

    out = {}
    for label, sql, extra in (
            ("agg", AGG_Q, {}),
            ("select", SEL_Q, {}),
            ("oom_at2", AGG_Q, {"resilience.inject": "partition:at2",
                                "serving.stream.min_chunk_rows": 512})):
        ref_faults.reset()
        c = _ctx(frame, "ref")
        got = _run(c, sql, **{"serving.admission.max_estimated_bytes":
                              _budget(c)}, **extra)
        out[label] = (got, _stream_counters(c))
    ref_faults.reset()
    return out


# -------------------------------------------------- acceptance: streamed run
def test_oversize_aggregate_streams_as_the_reference(frame, reference):
    c = _ctx(frame)
    unconstrained = _run(c, AGG_Q)
    before = _stream_counters(c)
    got = _run(c, AGG_Q, **{"serving.admission.max_estimated_bytes":
                            _budget(c)})
    want = agg_oracle(frame)
    check_agg(got, want)
    check_agg(unconstrained, want)
    moved = {k: v - before.get(k, 0) for k, v in _stream_counters(c).items()
             if v - before.get(k, 0)}
    ref_got, ref_counters = reference["agg"]
    assert moved == ref_counters
    assert moved["serving.stream.partitions"] > 1
    assert moved["serving.stream.rows"] == N_ROWS
    for col in ("k", "s", "n", "mn", "mx"):
        assert got[col].tolist() == ref_got[col].tolist()


def test_oversize_select_streams_in_global_row_order(frame, reference):
    c = _ctx(frame)
    expected = _run(c, SEL_Q)
    before = _stream_counters(c)
    got = _run(c, SEL_Q, **{"serving.admission.max_estimated_bytes":
                            _budget(c)})
    pd.testing.assert_frame_equal(got, expected)
    ref_got, ref_counters = reference["select"]
    pd.testing.assert_frame_equal(got, ref_got)
    moved = {k: v - before.get(k, 0) for k, v in _stream_counters(c).items()
             if v - before.get(k, 0)}
    assert moved == ref_counters
    assert moved["resilience.rung.streamed_select"] == 1


def test_midstream_oom_repartitions_and_resumes(frame, reference):
    c = _ctx(frame)
    got = _run(c, AGG_Q, **{"serving.admission.max_estimated_bytes":
                            _budget(c),
                            "resilience.inject": "partition:at2",
                            "serving.stream.min_chunk_rows": 512})
    check_agg(got, agg_oracle(frame))
    snap = _stream_counters(c)
    assert snap == reference["oom_at2"][1]
    assert snap["resilience.partition.oom"] == 1
    assert snap["serving.stream.repartitions"] == 1
    # resume, not restart: every row counted once
    assert snap["serving.stream.rows"] == N_ROWS
    assert snap.get("resilience.degraded", 0) == 0


def test_a_real_oom_in_a_partition_repartitions(frame, monkeypatch):
    """A ``torch.cuda.OutOfMemoryError`` raised inside a partition is
    classified as the injected fault is: the partition halves and the
    stream resumes without re-running a completed partition."""
    c = _ctx(frame)
    real = stream_agg.StreamedAggregate.run_partition
    calls = []

    def flaky(self, chunk, params=()):
        calls.append(chunk.num_rows)
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(self, chunk, params)

    monkeypatch.setattr(stream_agg.StreamedAggregate, "run_partition", flaky)
    got = _run(c, AGG_Q, **{"serving.admission.max_estimated_bytes":
                            _budget(c),
                            "serving.stream.min_chunk_rows": 512})
    check_agg(got, agg_oracle(frame))
    snap = _stream_counters(c)
    assert snap["resilience.partition.oom"] == 1
    assert snap["serving.stream.repartitions"] == 1
    assert snap["serving.stream.rows"] == N_ROWS
    assert calls[2] == calls[1] // 2  # the failed partition, halved
    assert sum(calls) - calls[1] == N_ROWS


def test_streamed_partitions_call_the_segment_sum_once_each(frame,
                                                            monkeypatch):
    """Each partition's counts and float sums are one `segsum_typed`
    call (the kernel on the card; its plain version here); two streamed
    runs give the same bits."""
    from dask_sql_tpu_torch.ops import segsum

    c = _ctx(frame)
    typed = segsum.segsum_typed
    calls = []

    def spy(gid, columns, domain):
        calls.append(len(columns))
        return typed(gid, columns, domain)

    monkeypatch.setattr(segsum, "segsum_typed", spy)
    opts = {"serving.admission.max_estimated_bytes": _budget(c),
            "sql.compile.segsum": "scatter"}  # the route stays auto
    first = _run(c, AGG_Q, **opts)
    parts = c.metrics.counter("serving.stream.partitions")
    assert len(calls) == parts > 1
    second = _run(c, AGG_Q, **opts)
    pd.testing.assert_frame_equal(first, second)


def test_streamed_string_group_keys_match():
    rng = np.random.RandomState(3)
    df = pd.DataFrame({
        "g": rng.choice(["aa", "bb", "cc", "dd"], N_ROWS),
        "v": rng.randint(0, 100, N_ROWS).astype(np.int64),
    })
    c = _ctx(df)
    q = "SELECT g, SUM(v) AS s, COUNT(*) AS n FROM t GROUP BY g ORDER BY g"
    expected = _run(c, q)
    got = _run(c, q, **{"serving.admission.max_estimated_bytes": _budget(c)})
    pd.testing.assert_frame_equal(got, expected)
    assert c.metrics.counter("serving.stream.partitions") > 1


# ------------------------------------------- admission x streaming interplay
@pytest.mark.parametrize("case", ["generous", "one_chunk_too_big",
                                  "stream_off", "compile_off", "select_off"])
def test_gate_outcomes_match_the_reference(frame, case):
    """Where the gate streams, runs whole or sheds, the same on both
    engines: a generous budget runs one launch; a budget no partition
    fits, streaming off, or the rungs' precondition off, shed."""
    out = {}
    for engine in ("port", "ref"):
        c = _ctx(frame, engine)
        sql = SEL_Q if case == "select_off" else AGG_Q
        opts = {"serving.admission.max_estimated_bytes": _budget(c)}
        opts.update({
            "generous": {"serving.admission.max_estimated_bytes": 1 << 40},
            "one_chunk_too_big": {
                "serving.admission.max_estimated_bytes": 1 << 10},
            "stream_off": {"serving.stream.enabled": False},
            "compile_off": {"sql.compile": False},
            "select_off": {"sql.compile.select": False},
        }[case])
        try:
            _run(c, sql, **opts)
            shed = False
        except Exception as e:  # both engines' gate error
            assert type(e).__name__ == "EstimatedBytesExceededError", e
            shed = True
        out[engine] = (shed, _stream_counters(c).get(
            "serving.stream.admitted", 0), c.metrics.counter(
                "serving.shed_estimated_bytes"))
    assert out["port"] == out["ref"]
    assert out["port"][0] == (case != "generous")


def test_construction_ineligible_routed_plan_resheds():
    """PLAIN int keys whose span overflows the radix gate: the routing
    walk cannot see it, the rung finds it when it builds and sheds with
    the gate's error rather than run the whole plan on a lower rung."""
    rng = np.random.RandomState(5)
    df = pd.DataFrame({
        "k": rng.choice([0, 1 << 23], N_ROWS).astype(np.int64),
        "v": rng.randint(0, 100, N_ROWS).astype(np.int64),
    })
    c = Context(device="cpu")
    c.config.update({"columnar.encoding": "off"})
    c.create_table("t", df)
    with pytest.raises(EstimatedBytesExceededError):
        _run(c, "SELECT k, SUM(v) AS s FROM t GROUP BY k",
             **{"serving.admission.max_estimated_bytes": _budget(c)})
    assert c.metrics.counter("serving.shed_estimated_bytes") == 1
    assert c.metrics.counter("serving.stream.partitions") == 0


def test_recovery_exhaustion_steps_down_and_charges_breaker(frame):
    c = _ctx(frame)
    opts = {"serving.admission.max_estimated_bytes": _budget(c),
            "resilience.inject": "partition:always",
            "serving.stream.min_chunk_rows": 4096}
    got = _run(c, AGG_Q, **opts)
    check_agg(got, agg_oracle(frame))
    assert c.metrics.counter("resilience.partition.exhausted") >= 1
    assert c.metrics.counter("resilience.degraded.streamed_aggregate") == 1
    for _ in range(2):
        _run(c, AGG_Q, **opts)
    assert c.metrics.counter("resilience.breaker.trip") >= 1
    _run(c, AGG_Q, **opts)
    assert c.metrics.counter("resilience.breaker.skip.streamed_aggregate") \
        >= 1


def test_at_k_fault_mode_fires_exactly_kth_arm():
    inj = faults.FaultInjector("partition:at3")
    assert [inj.arm("partition") for _ in range(4)] == \
        [False, False, True, False]
    assert inj.fired("partition") == 1


def test_deadline_checkpoint_between_partitions(frame):
    from dask_sql_tpu_torch.serving import runtime as rt
    from dask_sql_tpu_torch.serving.admission import (
        DeadlineExceededError,
        QueryTicket,
    )

    c = _ctx(frame)
    rt._tls.ticket = QueryTicket("q-stream", deadline=-1.0)
    try:
        with pytest.raises(DeadlineExceededError):
            _run(c, AGG_Q, **{"serving.admission.max_estimated_bytes":
                              _budget(c)})
    finally:
        rt._tls.ticket = None


def test_stream_verdict_is_per_execution_not_plan_state(frame):
    c = _ctx(frame)
    _run(c, AGG_Q, **{"serving.admission.max_estimated_bytes": _budget(c)})
    parts = c.metrics.counter("serving.stream.partitions")
    assert parts > 1
    _run(c, AGG_Q)
    assert c.metrics.counter("serving.stream.partitions") == parts
    from dask_sql_tpu_torch.planner import plan as p

    plan = c.sql(AGG_Q).plan
    assert all(not hasattr(n, "_dsql_stream") for n in p.walk_plan(plan))


def test_second_streamed_family_run_builds_nothing(frame):
    c = _ctx(frame)
    opts = {"serving.admission.max_estimated_bytes": _budget(c)}
    q1 = "SELECT k, SUM(v) AS s FROM t WHERE v > 10 GROUP BY k ORDER BY k"
    q2 = "SELECT k, SUM(v) AS s FROM t WHERE v > 500 GROUP BY k ORDER BY k"
    _run(c, q1, **opts)
    t1 = c.last_trace
    got = _run(c, q2, **opts)
    t2 = c.last_trace
    builds1 = [s.name for s in t1.spans if s.name.startswith("compile:")]
    builds2 = [s.name for s in t2.spans if s.name.startswith("compile:")]
    assert builds1.count("compile:streamed_aggregate") == 1
    assert builds2 == []
    assert c.metrics.counter("families.hit") >= 1
    pd.testing.assert_frame_equal(got, _run(c, q2))


# ----------------------------------------------------- scheduler integration
def test_cost_hint_carries_per_chunk_floor_for_streamed_family(frame):
    c = _ctx(frame)
    opts = {**NO_CACHE,
            "serving.admission.max_estimated_bytes": _budget(c)}
    c.sql(AGG_Q, config_options=opts).compute()
    cost = c.cost_hint(AGG_Q, opts)
    assert cost is not None and cost.chunk_bytes_lo is not None
    assert 0 < cost.chunk_bytes_lo < cost.bytes_lo
    assert cost.chunk_bytes_lo <= _budget(c)
    assert cost.reserve_bytes() == cost.chunk_bytes_lo
    c.sql(AGG_Q, config_options=NO_CACHE).compute()
    plain = c.cost_hint(AGG_Q, NO_CACHE)
    assert plain is not None and plain.chunk_bytes_lo is None
    assert plain.reserve_bytes() == plain.bytes_lo


def test_streamed_query_reconciles_its_per_chunk_share(frame):
    """Under the serving runtime, a streamed query's measured footprint
    charges the streamed table's per-partition share."""
    from dask_sql_tpu_torch.serving import ServingRuntime
    from dask_sql_tpu_torch.serving.scheduler import QueryCost

    c = _ctx(frame)
    budget = _budget(c)
    rt = ServingRuntime(workers=1, metrics=c.metrics,
                        scheduler_budget_bytes=1 << 30)
    try:
        _, fut, ticket = rt.submit(
            lambda t: c.sql(AGG_Q, config_options={
                **NO_CACHE, "serving.admission.max_estimated_bytes":
                    budget}).compute(),
            cost=QueryCost(bytes_lo=1024, chunk_bytes_lo=512))
        fut.result(60)
    finally:
        rt.shutdown(wait=True)
    parts = c.metrics.counter("serving.stream.partitions")
    whole = table_nbytes(c.schema["root"].tables["t"].table)
    assert 0 < ticket.measured_bytes < whole // parts + 4096


# ------------------------------------------------------------- decision unit
def test_stream_decision_matches_the_reference(frame):
    from dask_sql_tpu.streaming import stream_decision as ref_decision
    from dask_sql_tpu_torch.streaming import stream_decision

    decisions = {}
    for engine, decide in (("port", stream_decision), ("ref", ref_decision)):
        c = _ctx(frame, engine)
        plan = c.sql(AGG_Q).plan
        est = plan._dsql_estimate
        routed = decide(plan, est, c, c.config, _budget(c))
        assert routed is not None
        node, d = routed
        assert type(node).__name__ == "Aggregate"
        decisions[engine] = (d.kind, d.total_rows, d.chunk_rows,
                             d.partitions, d.chunk_bytes_lo, d.scan_bytes_lo)
        with c.config.set({"serving.stream.max_partitions": 1}):
            assert decide(plan, est, c, c.config, _budget(c)) is None
        c.create_table("u", pd.DataFrame(
            {"k": np.arange(5, dtype=np.int64)}))
        jq = ("SELECT t.k, SUM(t.v) AS s FROM t, u WHERE t.k = u.k "
              "GROUP BY t.k")
        jplan = c.sql(jq).plan
        assert decide(jplan, jplan._dsql_estimate, c, c.config,
                      _budget(c)) is None
    assert decisions["port"] == decisions["ref"]
    kind, total, chunk, parts, chunk_lo, _ = decisions["port"]
    assert kind == "aggregate" and parts > 1 and chunk * parts >= total


@pytest.mark.parametrize("inject,min_rows", [(None, 4096),
                                               ("partition:at2", 100)])
def test_partitions_cover_every_row_once(inject, min_rows):
    """The runner's row ranges: in order, every row once, the last one
    shorter (the reference's layout, `partition_layout(1000, 384)`); after
    a mid-stream OOM the rest in halved partitions from the first row no
    completed partition covered."""
    from dask_sql_tpu.streaming.partition import partition_layout
    from dask_sql_tpu_torch.streaming.plan import StreamDecision
    from dask_sql_tpu_torch.streaming.runner import drive_partitions

    c = Context(device="cpu")

    class _Ex:
        context = c
        config = c.config

    decision = StreamDecision("aggregate", "root", "t", total_rows=1000,
                              chunk_rows=384, partitions=3,
                              chunk_bytes_lo=0, scan_bytes_lo=0)
    ranges = []
    with c.config.set({"resilience.inject": inject,
                       "serving.stream.min_chunk_rows": min_rows}):
        n = drive_partitions(
            _Ex(), decision,
            lambda lo, rows: ranges.append((lo, min(lo + rows, 1000))),
            "streamed_aggregate")
    if inject is None:
        assert ranges == partition_layout(1000, 384) == \
            [(0, 384), (384, 768), (768, 1000)]
    else:  # the second launch failed before it ran: 192-row partitions
        assert ranges == [(0, 384), (384, 576), (576, 768), (768, 960),
                          (960, 1000)]
    assert n == len(ranges)
    covered = np.zeros(1000, dtype=int)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert c.metrics.counter("serving.stream.rows") == 1000
