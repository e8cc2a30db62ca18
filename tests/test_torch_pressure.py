"""The pressure controller in the port (`resilience/pressure.py`) against
the reference's (`tests/unit/test_pressure.py`).

Bands, transitions, the reclaim walk, reclaim-before-degrade and the
CRITICAL admission route run through a port Context and a reference
Context on one seeded frame, under scoped config (the reference's config
is process-wide), and must give the same bands, counters and flight
events.  The reclaim walks the result cache, then the pinned stems
(`materialize/`), then the idle committed model params (`inference/`).
"""
import time

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu.observability import flight as ref_flight
from dask_sql_tpu.resilience import faults as ref_faults
from dask_sql_tpu.serving.cache import table_nbytes as ref_table_nbytes
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.observability import flight
from dask_sql_tpu_torch.resilience import faults, watchdog
from dask_sql_tpu_torch.serving.cache import table_nbytes

N_ROWS = 40_000
AGG_Q = ("SELECT k, SUM(v) AS s, COUNT(*) AS n, AVG(v) AS a, "
         "MIN(v) AS mn, MAX(f) AS mx FROM t GROUP BY k ORDER BY k")
ENGINES = ("port", "ref")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.reset()
    ref_faults.reset()
    yield
    watchdog.release_hangs()
    faults.reset()
    ref_faults.reset()


def _df(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "a": rng.integers(0, 100, n).astype(np.int64),
        "b": rng.random(n) * 100.0,
        "k": rng.integers(0, 5, n).astype(np.int64),
    })


def _stream_df(n=N_ROWS):
    rng = np.random.RandomState(7)
    return pd.DataFrame({
        "k": rng.randint(0, 5, n).astype(np.int64),
        "v": rng.randint(0, 1000, n).astype(np.int64),
        "f": rng.rand(n),
    })


def _ctx(engine, df):
    c = Context(device="cpu") if engine == "port" else dask_sql_tpu.Context()
    c.create_table("t", df)
    return c


def _flight(engine):
    return flight if engine == "port" else ref_flight


def _used_bytes(c):
    snap = c.ledger.snapshot()
    return (snap["reservedBytes"] + snap["resultCacheBytes"]
            + snap["tableBytes"] + snap["modelBytes"]
            + snap["materializedBytes"])


def _table_budget(c, frac=3):
    nbytes = ref_table_nbytes if isinstance(c, dask_sql_tpu.Context) \
        else table_nbytes
    return nbytes(c.schema["root"].tables["t"].table) // frac


def _sql(c, sql, **options):
    with c.config.set(options):
        return c.sql(sql).compute()


# ------------------------------------------------------------------ bands
def test_bands_classify_against_device_budget():
    """The same bands, gauge, transitions and flight events in both."""
    out = {}
    for engine in ENGINES:
        c = _ctx(engine, _df())
        assert c.pressure.band() == "green"
        used = _used_bytes(c)
        assert used > 0
        rec = _flight(engine).RECORDER
        rec.clear()
        seen = []
        for budget in (int(used / 0.85), int(used / 0.92), used // 2,
                       used * 10):
            with c.config.set({"serving.scheduler.device_budget_bytes":
                               budget}):
                seen.append(c.pressure.band())
                seen.append(c.metrics.snapshot()["gauges"][
                    "resilience.pressure.band"])
                snap = c.pressure.snapshot()
        assert snap["band"] == "green" and snap["enabled"]
        assert snap["budgetBytes"] == used * 10
        out[engine] = (seen, c.metrics.counter(
            "resilience.pressure.transitions"),
            [e["band"] for e in rec.events(name="pressure.band")])
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["yellow", 1, "red", 2, "critical", 3,
                              "green", 0]
    assert out["port"][1] == 4


@pytest.mark.parametrize("engine", ENGINES)
def test_band_ignores_admission_fallback_budget(engine):
    c = _ctx(engine, _df())
    with c.config.set({"serving.admission.max_estimated_bytes": 10}):
        assert c.pressure.budget_bytes() is None
        assert c.pressure.band() == "green"
        with pytest.raises(Exception) as ei:
            c.sql("SELECT SUM(a) AS s FROM t").compute()
    assert type(ei.value).__name__ == "EstimatedBytesExceededError"
    assert c.metrics.counter("resilience.pressure.critical_shed") == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_pressure_disabled_is_inert(engine):
    c = _ctx(engine, _df())
    with c.config.set({"resilience.pressure.enabled": False,
                       "serving.scheduler.device_budget_bytes": 1}):
        assert c.pressure.band() == "green"
        assert c.pressure.reclaim(None, reason="oom") == 0
        assert len(c.sql("SELECT SUM(a) AS s FROM t").compute()) == 1


# -------------------------------------------- YELLOW suspends speculation
def test_yellow_defers_background_recompiles():
    from dask_sql_tpu_torch.serving.background import BackgroundCompiler

    c = Context(device="cpu")
    bg = BackgroundCompiler(metrics=c.metrics, suspended=lambda: True)
    assert bg.submit("family", lambda: None) is False
    assert c.metrics.counter("resilience.pressure.suspended") == 1
    assert c.metrics.counter("serving.bg_compile.submitted") == 0
    ok = BackgroundCompiler(metrics=c.metrics, suspended=lambda: False)
    try:
        assert ok.submit("family", lambda: None) is True
        assert ok.wait_idle(10.0)
    finally:
        ok.cancel()
        ok.join(5.0)


def test_yellow_pauses_warmup_and_resumes():
    c = _ctx("port", _df(500, seed=2))
    c.sql("SELECT SUM(a) AS s FROM t").compute()  # profile it
    used = _used_bytes(c)
    # the warm thread reads the Context's base config
    c.config.update({"serving.warmup.top_n": 4,
                     "serving.scheduler.device_budget_bytes":
                         int(used / 0.85)})
    mgr = c.maybe_start_warmup()
    assert mgr is not None
    try:
        deadline = time.monotonic() + 5.0
        while (time.monotonic() < deadline and
               c.metrics.counter("resilience.pressure.suspended") == 0):
            time.sleep(0.01)
        assert c.metrics.counter("resilience.pressure.suspended") >= 1
        assert mgr.warmed == 0 and not mgr.ready
        c.config.update({"serving.scheduler.device_budget_bytes": None})
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and not mgr.ready:
            time.sleep(0.02)
        assert mgr.ready and mgr.warmed >= 1
    finally:
        mgr.cancel()
        mgr.join(10.0)


# ------------------------------------------------------- RED-band reclaim
def test_red_reclaim_walks_tiers_in_priority_order():
    """A small target comes from the cold result cache alone, the pinned
    stem and the committed model untouched; an OOM reclaim drains the
    cache, then the stem tier (materialize/), then the model tier
    (inference/: the params of a model idle for
    ``resilience.pressure.model_idle_s``).  The same tiers, bytes freed in
    order and counters in both engines."""
    out = {}
    for engine in ENGINES:
        c = _ctx(engine, _df(4000, seed=3))
        rec = _flight(engine).RECORDER
        c.sql("""CREATE MODEL lm WITH (model_class = 'LinearRegression',
                 target_column = 'b') AS (SELECT a, b FROM t)""")
        # the fused PREDICT commits the params; uncached, so no result or
        # stem of it joins the tiers below
        _sql(c, "SELECT * FROM PREDICT(MODEL lm, SELECT a FROM t)",
             **{"serving.cache.enabled": False})
        with c.config.set({"serving.materialize.min_bytes": 1}):
            c.sql("SELECT a FROM t WHERE a > 3").compute()
            c.sql("SELECT b FROM t WHERE a > 3").compute()
            snap = c.ledger.snapshot()
            assert snap["modelBytes"] > 0
            assert snap["resultCacheBytes"] > 0
            assert snap["materializedBytes"] > 0
            assert snap["materializedBytes"] == c.materialize.pinned_bytes()
            rec.clear()
            freed = c.pressure.reclaim(1, reason="band")
            assert freed > 0
            after = c.ledger.snapshot()
            assert after["materializedBytes"] == snap["materializedBytes"]
            assert after["resultCacheBytes"] < snap["resultCacheBytes"]
            ev = rec.events(name="pressure.reclaim")[-1]
            assert ev["cache_bytes"] == freed
            assert ev["stem_bytes"] == 0 and ev["model_bytes"] == 0
            assert after["modelBytes"] == snap["modelBytes"]
        with c.config.set({"resilience.pressure.model_idle_s": 0.0}):
            c.pressure.reclaim(None, reason="oom")
        drained = c.ledger.snapshot()
        assert drained["resultCacheBytes"] == 0
        assert drained["materializedBytes"] == 0
        assert drained["modelBytes"] == 0
        ev2 = rec.events(name="pressure.reclaim")[-1]
        assert ev2["reason"] == "oom"
        assert ev2["stem_bytes"] == snap["materializedBytes"]
        assert ev2["model_bytes"] == snap["modelBytes"]
        assert rec.events(name="materialize.evict")
        assert c.metrics.counter("resilience.pressure.reclaims") == 2
        assert c.metrics.counter("resilience.pressure.reclaimed_bytes") \
            == snap["resultCacheBytes"] + snap["materializedBytes"] \
            + snap["modelBytes"]
        out[engine] = (ev2["model_bytes"], c.metrics.counter(
            "serving.materialize.evicted"), c.metrics.counter(
            "serving.materialize.stored"))
    # the model's param bytes: a float32 weight and bias
    assert out["port"] == out["ref"] == (8, 1, 1)


def test_yellow_suspends_then_resumes_materialization():
    """Under YELLOW a stem that earned its pin waits (a speculative pin),
    its hit count kept; back in GREEN the next sibling pins it.  The same
    counters in both engines."""
    out = {}
    for engine in ENGINES:
        c = _ctx(engine, _df(4000, seed=1))
        with c.config.set({"serving.materialize.min_bytes": 1}):
            used = _used_bytes(c)
            with c.config.set({"serving.scheduler.device_budget_bytes":
                               int(used / 0.82)}):
                assert c.pressure.band() == "yellow"
                c.sql("SELECT a FROM t WHERE a > 96").compute()
                c.sql("SELECT b FROM t WHERE a > 96").compute()
                stored = c.metrics.counter("serving.materialize.stored")
                suspended = c.metrics.counter(
                    "resilience.pressure.suspended")
            with c.config.set({"serving.scheduler.device_budget_bytes":
                               used * 20}):
                assert c.pressure.band() == "green"
                c.sql("SELECT k FROM t WHERE a > 96").compute()
        out[engine] = (stored, suspended >= 1,
                       c.metrics.counter("serving.materialize.stored"))
    assert out["port"] == out["ref"] == (0, True, 1)


def test_red_band_evaluate_reclaims_to_the_yellow_floor():
    c = _ctx("port", _df(4000, seed=3))
    for q in ("SELECT a FROM t WHERE a > 3", "SELECT b FROM t WHERE a > 3"):
        c.sql(q).compute()
    used = _used_bytes(c)
    cache = c.ledger.snapshot()["resultCacheBytes"]
    # headroom of 8% (RED); dropping the cache lifts it past 25%
    budget = int(used / 0.92)
    assert (budget - used + cache) > 0.25 * budget
    with c.config.set({"serving.scheduler.device_budget_bytes": budget}):
        assert c.pressure.evaluate() in ("yellow", "green")
    assert c.ledger.snapshot()["resultCacheBytes"] < cache


# ------------------------------------------- reclaim-before-degrade (OOM)
def test_reclaimable_oom_retries_same_rung_without_degrading():
    """A forced OOM with reclaimable cached bytes retries the SAME rung
    after one reclaim: no degradation, the breaker untouched; the same
    counters in both engines."""
    out = {}
    for engine in ENGINES:
        df = _df(500, seed=4)
        clean = _sql(_ctx(engine, df), "SELECT SUM(b) AS s FROM t")
        c = _ctx(engine, df)
        c.sql("SELECT SUM(a) AS s FROM t").compute()  # a cached result
        assert c.ledger.snapshot()["resultCacheBytes"] > 0
        _flight(engine).RECORDER.clear()
        hurt = _sql(c, "SELECT SUM(b) AS s FROM t",
                    **{"resilience.inject": "oom:once"})
        np.testing.assert_allclose(hurt["s"], clean["s"], rtol=1e-12)
        ev = _flight(engine).RECORDER.events(name="pressure.reclaim")[-1]
        assert ev["reason"] == "oom" and ev["freed"] > 0
        out[engine] = {k: c.metrics.counter(k) for k in (
            "resilience.degraded", "resilience.pressure.rung_retry",
            "resilience.pressure.rung_retry_ok")}
        out[engine]["breaker_keys"] = c.breaker.snapshot()["keys"]
    assert out["port"] == out["ref"] == {
        "resilience.degraded": 0, "resilience.pressure.rung_retry": 1,
        "resilience.pressure.rung_retry_ok": 1, "breaker_keys": 0}


@pytest.mark.parametrize("engine", ENGINES)
def test_unreclaimable_oom_degrades_exactly_as_before(engine):
    df = _df(500, seed=5)
    c = _ctx(engine, df)
    out = _sql(c, "SELECT SUM(a) AS s FROM t",
               **{"resilience.inject": "oom:once",
                  "serving.cache.enabled": False})
    assert int(out["s"][0]) == int(df["a"].sum())
    assert c.metrics.counter("resilience.degraded") == 1
    assert c.metrics.counter("resilience.pressure.rung_retry") == 0
    assert c.metrics.counter("resilience.pressure.rung_retry_ok") == 0


def test_interpreted_walk_retries_after_a_reclaim_on_a_card_context():
    """On a card Context nothing is below the interpreted walk: a
    reclaimable OOM there re-runs the walk once on the same device
    instead of leaving the query."""
    import dask_sql_tpu_torch.context as port_context

    df = _df(500, seed=6)
    c = _ctx("port", df)
    c.sql("SELECT SUM(a) AS s FROM t").compute()  # a cached result
    real = c.device
    c.device = port_context.torch.device("cuda")  # reads as the card
    try:
        got = _sql(c, "SELECT SUM(b) AS s FROM t",
                   **{"resilience.inject": "exec_oom:once",
                      "sql.compile": False})
    finally:
        c.device = real
    np.testing.assert_allclose(got["s"], [df["b"].sum()], rtol=1e-12)
    assert c.metrics.counter("resilience.pressure.rung_retry_ok") == 1
    assert c.metrics.counter("resilience.degraded") == 0
    assert c.metrics.counter("resilience.rung.cpu") == 0


# --------------------------------- streamed per-partition launch watchdog
def test_wedged_midstream_launch_degrades_between_chunks():
    """A watched partition launch wedged on its second partition
    (``compile_hang:at2``) raises a degradable STREAM_LAUNCH_TIMEOUT; the
    ladder steps the rung down and the query still answers."""
    df = _stream_df()
    c = _ctx("port", df)
    opts = {"serving.cache.enabled": False,
            "serving.admission.max_estimated_bytes": _table_budget(c),
            "serving.stream.min_chunk_rows": 512}
    clean = _sql(c, AGG_Q, **opts)
    assert c.metrics.counter("resilience.rung.streamed_aggregate") == 1
    hurt = _sql(c, AGG_Q, **opts, **{
        "serving.stream.launch_timeout_ms": 100.0,
        "resilience.inject": "compile_hang:at2",
        "resilience.inject.hang_s": 5.0})
    pd.testing.assert_frame_equal(hurt, clean)
    assert c.metrics.counter("resilience.watchdog.timeout") == 1
    assert c.metrics.counter("resilience.degraded.streamed_aggregate") == 1
    assert c.metrics.counter("resilience.rung.streamed_aggregate") == 1
    assert watchdog.join_abandoned(5.0) == 0


def test_watched_launches_wait_for_their_own_event(monkeypatch):
    """A watched launch waits for a CUDA event recorded after its own
    work, never for the whole card (`runner.waited`)."""
    from dask_sql_tpu_torch.streaming import runner

    calls = []
    synced = []

    class FakeEvent:
        def record(self):
            calls.append("record")

        def synchronize(self):
            calls.append("wait")

    monkeypatch.setattr(runner.torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(runner.torch.cuda, "synchronize",
                        lambda *a: synced.append(a))
    run = runner.waited(lambda lo, n: calls.append(("launch", lo, n)),
                        torch.device("cuda"))
    run(8, 4)
    assert calls == [("launch", 8, 4), "record", "wait"] and not synced
    calls.clear()
    runner.waited(lambda lo, n: calls.append("launch"),
                  torch.device("cpu"))(0, 1)
    assert calls == ["launch"]


# ------------------------------------ CANCEL racing a mid-stream OOM
def test_cancel_racing_midstream_oom_releases_reservation_once():
    from dask_sql_tpu_torch.serving import ServingRuntime
    from dask_sql_tpu_torch.serving.admission import QueryCancelledError
    from dask_sql_tpu_torch.serving.scheduler import QueryCost

    c = _ctx("port", _stream_df())
    budget = _table_budget(c)
    # the worker reads the Context's base config; every launch waits
    # 0.1 s under a generous deadline, so the cancel has time to land
    c.config.update({
        "serving.admission.max_estimated_bytes": budget,
        "serving.stream.min_chunk_rows": 512,
        "serving.stream.launch_timeout_ms": 10_000.0,
        "resilience.inject": "partition:at2,compile_hang:always",
        "resilience.inject.hang_s": 0.1,
        "serving.cache.enabled": False})
    rt = ServingRuntime(workers=1, metrics=c.metrics,
                        scheduler_budget_bytes=budget * 10)
    c.serving = rt
    try:
        _, fut, ticket = rt.submit(lambda t: c.sql(AGG_Q).compute(),
                                   cost=QueryCost(bytes_lo=4096))
        deadline = time.monotonic() + 30.0
        while (time.monotonic() < deadline and
               c.metrics.counter("serving.stream.repartitions") == 0):
            time.sleep(0.005)
        assert c.metrics.counter("serving.stream.repartitions") >= 1
        ticket.cancel()
        with pytest.raises(QueryCancelledError):
            fut.result(30)
    finally:
        rt.shutdown(wait=True)
        c.serving = None
    snap = c.ledger.snapshot()
    assert snap["reservedBytes"] == 0
    assert snap["inflightMeasuredBytes"] == 0


# --------------------------------------------------- CRITICAL admission
def test_critical_forces_new_admissions_onto_streamed_rung():
    out = {}
    df = _stream_df()
    for engine in ENGINES:
        clean = _sql(_ctx(engine, df), AGG_Q)
        c = _ctx(engine, df)
        got = _sql(c, AGG_Q, **{"serving.scheduler.device_budget_bytes":
                                _table_budget(c)})
        for col in ("k", "s", "n", "mn", "mx"):
            assert got[col].tolist() == clean[col].tolist()
        np.testing.assert_allclose(got["a"], clean["a"], rtol=1e-12)
        out[engine] = {k: c.metrics.counter(k) for k in (
            "resilience.pressure.critical_streamed",
            "serving.stream.admitted", "serving.stream.partitions",
            "resilience.pressure.critical_shed")}
    assert out["port"] == out["ref"]
    assert out["port"]["resilience.pressure.critical_streamed"] == 1
    assert out["port"]["serving.stream.partitions"] > 1


def test_critical_sheds_unstreamable_with_capped_retry_after():
    from dask_sql_tpu_torch.resilience.pressure import PressureShedError

    c = _ctx("port", _stream_df())
    with pytest.raises(PressureShedError) as ei:
        _sql(c, AGG_Q, **{"serving.scheduler.device_budget_bytes":
                          _table_budget(c), "serving.stream.enabled": False})
    assert ei.value.retryable
    assert ei.value.payload()["code"] == "PRESSURE_SHED"
    assert 0.0 < ei.value.retry_after_s <= 60.0
    assert c.metrics.counter("resilience.pressure.critical_shed") == 1
    shed = flight.RECORDER.events(name="query.shed")[-1]
    assert shed["reason"] == "pressure"
