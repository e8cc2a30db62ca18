"""The port's packing scheduler against the reference's
(`tests/unit/test_scheduler.py`): byte-budget packing by each query's
provable floor, deadline ordering, tenant quotas, the drain-based retry
hint and the family-mates probe of the batcher.  Each case runs the same
body on the port's modules and the reference's (``sv``); every wait is
bounded and every runtime shuts down in a ``finally``.  The cost-based
rung skip and the estimator's feedback run through both engines' Contexts
on one frame (``engine``), each case under scoped config, since the
reference's config is process-wide."""
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest

import dask_sql_tpu
import dask_sql_tpu.serving as ref_serving
import dask_sql_tpu_torch.serving as port_serving
from dask_sql_tpu_torch import Context

IMPLS = {"port": port_serving, "ref": ref_serving}


@pytest.fixture(params=sorted(IMPLS))
def sv(request):
    return IMPLS[request.param]


def _scheduler_module(sv):
    return sys.modules[sv.__name__ + ".scheduler"]


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


# ------------------------------------------------------------- token bucket
def test_token_bucket_refill_and_burst(sv):
    now = [0.0]
    b = sv.TokenBucket(rate=2.0, burst=3.0, clock=lambda: now[0])
    assert b.take() and b.take() and b.take()
    assert not b.take()  # the burst is spent
    now[0] = 0.5  # one token back at 2 a second
    assert b.take()
    assert not b.take()
    now[0] = 100.0
    for _ in range(3):  # the refill stops at the burst
        assert b.take()
    assert not b.take()


# ----------------------------------------------------------------- packing
def test_packing_admits_small_beside_big_fifo_would_block(sv):
    """A budget that fits one big and one small query runs them together,
    while the second big query waits: its floor cannot fit the rest."""
    rt = sv.ServingRuntime(workers=4, scheduler_budget_bytes=100)
    gate = threading.Event()
    try:
        started = []

        def blocker(name):
            def fn(_t):
                started.append(name)
                gate.wait(10)
                return name
            return fn

        _, f1, _ = rt.submit(blocker("big1"), cost=sv.QueryCost(bytes_lo=60))
        assert _wait_for(lambda: "big1" in started)
        _, f2, _ = rt.submit(blocker("big2"), cost=sv.QueryCost(bytes_lo=60))
        _, f3, _ = rt.submit(blocker("small"), cost=sv.QueryCost(bytes_lo=30))
        assert _wait_for(lambda: "small" in started)
        time.sleep(0.05)
        assert "big2" not in started
        assert rt.metrics.counter("serving.scheduler.packed") >= 1
        assert rt.metrics.counter("serving.scheduler.waited") >= 1
        assert rt.snapshot()["scheduler"]["reservedBytes"] == 90
        gate.set()
        assert f1.result(5) == "big1"
        assert f2.result(5) == "big2"  # once big1 released its bytes
        assert f3.result(5) == "small"
        assert rt.snapshot()["scheduler"]["reservedBytes"] == 0
    finally:
        gate.set()
        rt.shutdown(wait=True)


def test_lone_oversize_query_still_dispatches(sv):
    """With nothing in flight the head query dispatches even past the
    whole budget: shedding it is the admission gate's work."""
    rt = sv.ServingRuntime(workers=1, scheduler_budget_bytes=10)
    try:
        _, f, _ = rt.submit(lambda t: "ran", cost=sv.QueryCost(bytes_lo=1000))
        assert f.result(5) == "ran"
    finally:
        rt.shutdown(wait=True)


def test_midpack_failure_releases_reserved_bytes(sv):
    rt = sv.ServingRuntime(workers=2, scheduler_budget_bytes=100)
    try:
        def boom(_t):
            raise RuntimeError("induced mid-pack failure")

        _, f1, _ = rt.submit(boom, cost=sv.QueryCost(bytes_lo=80))
        with pytest.raises(RuntimeError):
            f1.result(5)
        assert _wait_for(
            lambda: rt.snapshot()["scheduler"]["reservedBytes"] == 0)
        _, f2, _ = rt.submit(lambda t: "ok", cost=sv.QueryCost(bytes_lo=80))
        assert f2.result(5) == "ok"
    finally:
        rt.shutdown(wait=True)


def test_fifo_mode_preserves_legacy_queues(sv):
    rt = sv.ServingRuntime(workers=1, scheduler_enabled=False)
    gate, started = threading.Event(), threading.Event()
    try:
        assert rt.scheduler is None
        order = []
        _, f0, _ = rt.submit(lambda t: (started.set(), gate.wait(10))[1])
        assert started.wait(5)
        # a query with a deadline does not jump ahead in FIFO mode
        _, fa, _ = rt.submit(lambda t: order.append("A"))
        _, fb, _ = rt.submit(lambda t: order.append("B"), deadline_s=30.0)
        gate.set()
        fa.result(5)
        fb.result(5)
        assert order == ["A", "B"]
        assert "scheduler" not in rt.snapshot()
    finally:
        gate.set()
        rt.shutdown(wait=True)


# ---------------------------------------------------------------- ordering
def test_deadline_aware_ordering(sv):
    rt = sv.ServingRuntime(workers=1)
    gate, started = threading.Event(), threading.Event()
    try:
        order = []
        _, f0, _ = rt.submit(lambda t: (started.set(), gate.wait(10))[1])
        assert started.wait(5)
        _, fa, _ = rt.submit(lambda t: order.append("no_deadline"))
        _, fb, _ = rt.submit(lambda t: order.append("tight"), deadline_s=5.0)
        _, fc, _ = rt.submit(lambda t: order.append("loose"), deadline_s=10.0)
        gate.set()
        for f in (fa, fb, fc):
            f.result(5)
        assert order == ["tight", "loose", "no_deadline"]
    finally:
        gate.set()
        rt.shutdown(wait=True)


def test_no_deadline_query_not_starved_past_fair_horizon(sv):
    now = [1000.0]
    sched = sv.PackingScheduler(fair_horizon_s=30.0, clock=lambda: now[0])
    starved = sv.QueryTicket("starved")
    sched.push_locked(starved, lambda t: None, None, sv.QueryCost())
    later = sv.QueryTicket("later", deadline=starved.admitted_at + 300.0)
    sched.push_locked(later, lambda t: None, None, sv.QueryCost())
    ticket, _, _ = sched.pop_locked(batch_ok=True)
    assert ticket.qid == "starved"


def test_byte_blocked_query_becomes_barrier_past_horizon(sv):
    now = [0.0]
    sched = sv.PackingScheduler(budget_bytes=100, fair_horizon_s=30.0,
                                clock=lambda: now[0])
    small_running = sv.QueryTicket("r0")
    sched.push_locked(small_running, lambda t: None, None,
                      sv.QueryCost(bytes_lo=30))
    assert sched.pop_locked(batch_ok=True)[0].qid == "r0"
    big = sv.QueryTicket("big")
    sched.push_locked(big, lambda t: None, None, sv.QueryCost(bytes_lo=80))
    small = sv.QueryTicket("small")
    sched.push_locked(small, lambda t: None, None, sv.QueryCost(bytes_lo=30))
    assert sched.pop_locked(batch_ok=True)[0].qid == "small"
    sched.release_locked(small)
    now[0] = 31.0  # big has waited past the horizon
    small2 = sv.QueryTicket("small2")
    sched.push_locked(small2, lambda t: None, None, sv.QueryCost(bytes_lo=30))
    assert sched.pop_locked(batch_ok=True) is None  # nothing passes it
    sched.release_locked(small_running)
    assert sched.pop_locked(batch_ok=True)[0].qid == "big"


def test_dead_items_consume_no_quota_tokens(sv):
    m = sv.MetricsRegistry()
    sched = sv.PackingScheduler(tenant_rate=0.001, tenant_burst=2.0,
                                metrics=m)
    for i in range(2):
        t = sv.QueryTicket(f"dead{i}")
        t.cancel()
        sched.push_locked(t, lambda t: None, None, sv.QueryCost(tenant="a"))
        popped = sched.pop_locked(batch_ok=True)
        assert popped[0].qid == f"dead{i}"
        sched.release_locked(popped[0])
    live = [sv.QueryTicket(f"live{i}") for i in range(2)]
    for t in live:
        sched.push_locked(t, lambda t: None, None, sv.QueryCost(tenant="a"))
    assert sched.pop_locked(batch_ok=True)[0].qid == "live0"
    assert sched._buckets["a"].tokens < 2.0
    assert m.counter("serving.scheduler.packed") == 0


def test_explain_estimate_does_not_create_profile_entries():
    """Estimating a family never run creates no zero-hit profile entry, in
    either engine."""
    df = pd.DataFrame({"k": np.arange(4000, dtype=np.int64) % 7,
                       "v": np.arange(4000, dtype=np.float64)})
    for c in (dask_sql_tpu.Context(), Context(device="cpu")):
        c.create_table("t", df)
        c.sql("EXPLAIN ESTIMATE SELECT k FROM t WHERE v < 10",
              return_futures=False)
        snap = c.profiles.snapshot()["profiles"]
        assert snap and all(e["hits"] >= 1 for e in snap.values())


def test_tenant_bucket_map_is_bounded(sv):
    cap = _scheduler_module(sv)._TENANT_BUCKET_CAP
    sched = sv.PackingScheduler(tenant_rate=1.0, tenant_burst=1.0)
    for i in range(cap + 200):
        t = sv.QueryTicket(f"q{i}")
        sched.push_locked(t, lambda t: None, None,
                          sv.QueryCost(tenant=f"tenant{i}"))
        popped = sched.pop_locked(batch_ok=True)
        assert popped is not None
        sched.release_locked(popped[0])
    assert len(sched._buckets) <= cap


def test_interactive_still_outranks_batch(sv):
    rt = sv.ServingRuntime(workers=1)
    gate, started = threading.Event(), threading.Event()
    try:
        order = []
        _, f0, _ = rt.submit(lambda t: (started.set(), gate.wait(10))[1])
        assert started.wait(5)
        _, fb, _ = rt.submit(lambda t: order.append("batch"),
                             priority_class="batch")
        _, fi, _ = rt.submit(lambda t: order.append("interactive"))
        gate.set()
        fb.result(5)
        fi.result(5)
        assert order == ["interactive", "batch"]
    finally:
        gate.set()
        rt.shutdown(wait=True)


# ------------------------------------------------------------ tenant quotas
def test_tenant_quota_starvation_regression(sv):
    """Eight workers and a greedy tenant flooding the queue: once its
    burst is spent, the victim's queries run before the greedy backlog,
    and every greedy query still succeeds."""
    rt = sv.ServingRuntime(workers=8, tenant_rate=0.001, tenant_burst=2)
    gate = threading.Event()
    try:
        order = []
        blockers = []
        startcount = threading.Semaphore(0)
        for _ in range(8):  # every worker busy
            def hold(_t):
                startcount.release()
                gate.wait(10)
            blockers.append(rt.submit(hold)[1])
        for _ in range(8):
            assert startcount.acquire(timeout=10)
        greedy = [rt.submit(lambda t, i=i: order.append(f"greedy{i}"),
                            cost=sv.QueryCost(tenant="greedy"))[1]
                  for i in range(6)]
        victims = [rt.submit(lambda t, i=i: order.append(f"victim{i}"),
                             cost=sv.QueryCost(tenant="victim"))[1]
                   for i in range(2)]
        gate.set()
        for f in victims + greedy + blockers:
            f.result(10)
        assert sum(1 for name in order[:4] if name.startswith("victim")) \
            == 2, order
        assert sorted(n for n in order if n.startswith("greedy")) == \
            [f"greedy{i}" for i in range(6)]
        assert rt.metrics.counter("serving.scheduler.quota_throttled") >= 1
    finally:
        gate.set()
        rt.shutdown(wait=True)


def test_quota_work_conserving_when_alone(sv):
    rt = sv.ServingRuntime(workers=1, tenant_rate=0.001, tenant_burst=1)
    try:
        futs = [rt.submit(lambda t, i=i: i,
                          cost=sv.QueryCost(tenant="greedy"))[1]
                for i in range(4)]
        assert [f.result(5) for f in futs] == [0, 1, 2, 3]
    finally:
        rt.shutdown(wait=True)


# -------------------------------------------------------- drain retry hint
def test_retry_after_from_predicted_drain(sv):
    rt = sv.ServingRuntime(workers=1, bounds={"interactive": 1, "batch": 1},
                           retry_after_s=1.0)
    gate, started = threading.Event(), threading.Event()
    try:
        _, f1, _ = rt.submit(lambda t: (started.set(), gate.wait(10))[1],
                             cost=sv.QueryCost(pred_exec_ms=40_000.0))
        assert started.wait(5)
        _, f2, _ = rt.submit(lambda t: "queued",
                             cost=sv.QueryCost(pred_exec_ms=40_000.0))
        with pytest.raises(sv.QueueFullError) as ei:
            rt.submit(lambda t: "shed")
        assert 10.0 < ei.value.retry_after_s <= 60.0
        gate.set()
        f1.result(5)
        f2.result(5)
    finally:
        gate.set()
        rt.shutdown(wait=True)


def test_retry_after_cap_comes_from_the_config():
    """``serving.retry_after.cap_s`` bounds the hint of a runtime built
    from a Context's config (the reference reads its process config)."""
    c = Context(device="cpu")
    c.config.update({"serving.retry_after.cap_s": 5.0, "serving.workers": 1,
                     "serving.queue.interactive": 1})
    rt = port_serving.ServingRuntime.from_config(c.config)
    gate, started = threading.Event(), threading.Event()
    try:
        rt.submit(lambda t: (started.set(), gate.wait(10))[1],
                  cost=port_serving.QueryCost(pred_exec_ms=40_000.0))
        assert started.wait(5)
        rt.submit(lambda t: "queued",
                  cost=port_serving.QueryCost(pred_exec_ms=40_000.0))
        with pytest.raises(port_serving.QueueFullError) as ei:
            rt.submit(lambda t: "shed")
        assert ei.value.retry_after_s == 5.0
    finally:
        gate.set()
        rt.shutdown(wait=True)


def test_family_mates_visible_to_batcher_probe(sv):
    sched = sv.PackingScheduler(budget_bytes=None)
    t1, t2 = sv.QueryTicket("q1"), sv.QueryTicket("q2")
    sched.push_locked(t1, lambda t: None, None, sv.QueryCost(family="fam_a"))
    sched.push_locked(t2, lambda t: None, None, sv.QueryCost(family="fam_a"))
    assert sched.family_mates_locked("fam_a") == 2
    sched.pop_locked(batch_ok=True)  # q1 runs
    assert sched.family_mates_locked("fam_a", exclude_qid="q1") == 1
    assert sched.family_mates_locked("fam_b") == 0


# ------------------------------------------------- cost-based rung selection
ENGINES = ("port", "ref")
COST_FRAME = pd.DataFrame({
    "k": np.arange(4000, dtype=np.int64) % 7,
    "v": np.arange(4000, dtype=np.float64),
})
NO_CACHE = {"serving.cache.enabled": False}


@pytest.fixture(params=ENGINES)
def engine(request):
    return request.param


def _cost_ctx(engine):
    c = Context(device="cpu") if engine == "port" else dask_sql_tpu.Context()
    c.create_table("t", COST_FRAME)
    return c


def _counters(c):
    return c.metrics.snapshot()["counters"]


def test_cost_based_rung_skip_no_degradation(engine):
    """A family with cheap observed history and a build prior that can
    never amortize skips its compiled rungs: counted as
    ``serving.scheduler.cost_rung_skip``, no degradation, and the answer
    of the interpreted rung."""
    c = _cost_ctx(engine)
    q = "SELECT k, SUM(v) AS s, COUNT(*) AS n FROM t GROUP BY k"
    with c.config.set(NO_CACHE):
        fam = c.sql(q).plan._dsql_family
        for _ in range(2):
            c.profiles.record_exec(fam.fingerprint, sql=q, exec_ms=1.0,
                                   family=fam.fingerprint)
        for rung in ("compiled_aggregate", "compiled_join_aggregate",
                     "compiled_select"):
            c.metrics.observe(f"resilience.compile_ms.{rung}", 60_000.0)
        got = c.sql(q).compute().sort_values("k").reset_index(drop=True)
    snap = _counters(c)
    assert snap.get("serving.scheduler.cost_rung_skip", 0) >= 1
    assert snap.get(
        "serving.scheduler.cost_rung_skip.compiled_aggregate", 0) == 1
    assert snap.get("resilience.degraded", 0) == 0
    assert snap.get("resilience.rung.compiled_aggregate", 0) == 0
    v, k = COST_FRAME["v"].to_numpy(), COST_FRAME["k"].to_numpy()
    np.testing.assert_allclose(got["s"], [v[k == i].sum() for i in range(7)],
                               rtol=1e-9)
    assert list(got["n"]) == [int((k == i).sum()) for i in range(7)]


def test_cost_skip_never_fires_cold_or_after_compile(engine):
    """A first-seen family always builds; a family whose rung built is
    never skipped on it."""
    c = _cost_ctx(engine)
    q = "SELECT k, SUM(v) AS s FROM t GROUP BY k"
    with c.config.set(NO_CACHE):
        for rung in ("compiled_aggregate", "compiled_select"):
            c.metrics.observe(f"resilience.compile_ms.{rung}", 60_000.0)
        c.sql(q).compute()
        snap = _counters(c)
        assert snap.get("serving.scheduler.cost_rung_skip", 0) == 0
        assert snap.get("resilience.rung.compiled_aggregate", 0) == 1
        c.sql(q).compute()
    snap = _counters(c)
    assert snap.get(
        "serving.scheduler.cost_rung_skip.compiled_aggregate", 0) == 0
    assert snap.get("resilience.rung.compiled_aggregate", 0) == 2


def test_cost_skip_off_switch(engine):
    c = _cost_ctx(engine)
    q = "SELECT k, SUM(v) AS s FROM t GROUP BY k"
    with c.config.set({**NO_CACHE, "resilience.ladder.cost_based": False}):
        fam = c.sql(q).plan._dsql_family
        c.profiles.record_exec(fam.fingerprint, sql=q, exec_ms=0.5,
                               family=fam.fingerprint)
        c.metrics.observe("resilience.compile_ms.compiled_aggregate",
                          60_000.0)
        c.sql(q).compute()
    snap = _counters(c)
    assert snap.get("serving.scheduler.cost_rung_skip", 0) == 0
    assert snap.get("resilience.rung.compiled_aggregate", 0) == 1


@pytest.mark.parametrize("hits,exec_ms,prior,skip", [
    (1, 1.0, 60_000.0, True),
    (2, 100.0, 60_000.0, True),
    (200, 100.0, 60_000.0, False),   # popularity amortizes the build
    (3, 10.0, 100.0, False),         # 100 <= 4 x 3 x 10
    (3, 1e-9, 0.02, True),           # exec floors at 1e-3 ms
])
def test_cost_skip_decides_as_the_reference(hits, exec_ms, prior, skip):
    """Given the same profile entries and compile priors, the port's
    `cost_skip` makes the reference's decision."""
    from dask_sql_tpu.resilience import ladder as ref_ladder
    from dask_sql_tpu_torch.resilience import ladder as port_ladder

    q = "SELECT k, SUM(v) AS s FROM t GROUP BY k"
    got = {}
    for eng, lad in (("port", port_ladder), ("ref", ref_ladder)):
        c = _cost_ctx(eng)
        with c.config.set(NO_CACHE):
            plan = c.sql(q).plan
            fp = plan._dsql_family.fingerprint
            for _ in range(hits):
                c.profiles.record_exec(fp, sql=q, exec_ms=exec_ms, family=fp)
            c.metrics.observe("resilience.compile_ms.compiled_aggregate",
                              prior)

            class _Ex:
                context = c
                config = c.config
                _resilience_fp = fp

            got[eng] = lad.cost_skip(_Ex(), "compiled_aggregate", plan)
    assert got == {"port": skip, "ref": skip}


# -------------------------------------------------------- estimator feedback
def _estimators(engine):
    if engine == "port":
        from dask_sql_tpu_torch.analysis import estimator
    else:
        from dask_sql_tpu.analysis import estimator
    return estimator


def test_feedback_priors_never_cross_provable_floors(engine):
    """Feedback tightens upper bounds only: lo is the same with feedback on
    or off, hi never drops below lo, across margins; the port's
    ``peak_bytes.hi`` never drops below ``lo`` plus the fused charge."""
    estimator = _estimators(engine)
    c = _cost_ctx(engine)
    q = "SELECT v FROM t WHERE v < 50"
    with c.config.set(NO_CACHE):
        for _ in range(3):
            c.sql(q).compute()
        plan = c.sql(q).plan
        with c.config.set({"analysis.estimate.feedback": False}):
            base = estimator.estimate_plan(plan, context=c)
        prof = c.profiles.get(plan._dsql_family.fingerprint)
        assert prof is not None and len(prof["rows"]) >= 2
        for margin in (1.0, 1.5, 2.0, 10.0):
            with c.config.set({"analysis.estimate.feedback.margin": margin}):
                fb = estimator.apply_feedback(base, prof, c.config)
            assert fb.peak_bytes.lo == base.peak_bytes.lo
            assert fb.rows.lo == base.rows.lo
            assert fb.result_bytes.lo == base.result_bytes.lo
            assert fb.peak_bytes.hi >= fb.peak_bytes.lo
            assert fb.rows.hi >= fb.rows.lo
            assert fb.result_bytes.hi >= fb.result_bytes.lo
            assert fb.rows.hi <= base.rows.hi
            assert fb.rows.hi == min(base.rows.hi, int(margin * 50))
            if engine == "port":
                assert fb.peak_bytes.hi >= \
                    base.peak_bytes.lo + base.scratch_hi
        # the port's feedback rows are the reference's on the same history
        assert fb.feedback


def test_feedback_rows_match_the_reference():
    """Both engines tighten rows and result bytes alike on the same
    observed history; the port's peak ``hi`` keeps the fused charge."""
    out = {}
    q = "SELECT v FROM t WHERE v < 50"
    for eng in ENGINES:
        estimator = _estimators(eng)
        c = _cost_ctx(eng)
        with c.config.set(NO_CACHE):
            for _ in range(2):
                c.sql(q).compute()
            plan = c.sql(q).plan
            with c.config.set({"analysis.estimate.feedback": False}):
                base = estimator.estimate_plan(plan, context=c)
            fb = estimator.apply_feedback(
                base, c.profiles.get(plan._dsql_family.fingerprint),
                c.config, c.metrics)
        out[eng] = ((fb.rows.lo, fb.rows.hi), fb.result_bytes.lo,
                    fb.peak_bytes.lo,
                    fb.feedback, c.metrics.counter(
                        "analysis.estimate.feedback"))
    assert out["port"] == out["ref"]


def test_feedback_tightens_only_with_enough_observations(engine):
    estimator = _estimators(engine)
    c = _cost_ctx(engine)
    q = "SELECT v FROM t WHERE v < 50"
    with c.config.set(NO_CACHE):
        c.sql(q).compute()  # one observation < min_obs (2)
        plan = c.sql(q).plan
        prof = c.profiles.get(plan._dsql_family.fingerprint)
        with c.config.set({"analysis.estimate.feedback": False}):
            base = estimator.estimate_plan(plan, context=c)
        fb = estimator.apply_feedback(base, prof, c.config)
    assert fb.feedback is False and fb.rows.hi == base.rows.hi


def test_feedback_reaches_the_gate_estimate_of_a_cached_plan():
    """A plan-cached query's estimate takes feedback once its family has
    history (`Context._plan_estimate`), and EXPLAIN ESTIMATE's bounds of
    the port stay the static ones."""
    c = _cost_ctx("port")
    q = "SELECT v FROM t WHERE v < 50"
    with c.config.set(NO_CACHE):
        for _ in range(3):
            c.sql(q).compute()
        plan = c.sql(q).plan
        est = c._plan_estimate(plan)
    assert est.feedback and est.rows.hi == 100
    assert c.metrics.counter("analysis.estimate.feedback") >= 1
    assert not any("feedback" in r for r in
                   c.sql("EXPLAIN ESTIMATE " + q).compute().iloc[:, 0])


def test_show_profiles_estimated_vs_observed_rows(engine):
    c = _cost_ctx(engine)
    q = "SELECT v FROM t WHERE v < 50"
    with c.config.set(NO_CACHE):
        for _ in range(2):
            c.sql(q).compute()
        df = c.sql("SHOW PROFILES LIKE 'rows.%'").compute()
    by_metric = {m: v for _, (_, _, m, v) in df.iterrows()}
    assert {"rows.est_hi", "rows.observed.last", "rows.observed.max"} \
        <= set(by_metric)
    assert int(by_metric["rows.observed.last"]) == 50
    assert int(by_metric["rows.est_hi"]) >= 50
