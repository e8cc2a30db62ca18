"""Cold starts in the port against the reference's
(`tests/unit/test_coldstart.py`, less its HTTP health cases): the compile
cache, the profile-driven warm-up, the compile watchdog, the background
recompiler and the breaker verdicts that ride a checkpoint.

The port's compile cache keeps the `_build.py` libraries (the CUDA kernels
and the native planner), so its cases build a tiny C source with ``g++``
through the cache's own `lookup`/`stored` protocol rather than the
planner's sources.  Every injected hang waits on an event that the
module's teardown sets (`watchdog.release_hangs`), so no abandoned thread
outlives its test.
"""
import os
import subprocess
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu.serving.warmup import WarmupManager as RefWarmup
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.resilience import faults, watchdog
from dask_sql_tpu_torch.serving import compile_cache

AGG_QUERY = "SELECT g, SUM(x) AS s FROM t GROUP BY g ORDER BY g"
NO_CACHE = {"serving.cache.enabled": False}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    # the native planner loads at the process's first plan, from the
    # package's build directory, before any test points the cache elsewhere
    Context(device="cpu").sql("SELECT 1 AS one")
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.reset()
    yield
    watchdog.join_abandoned(5.0)
    faults.reset()


def _frame(n=200):
    return pd.DataFrame({"g": ["a", "b"] * (n // 2),
                         "x": np.arange(n, dtype=np.float64)})


def _ctx(n=200, options=None):
    c = Context(device="cpu")
    c.config.update({**NO_CACHE, **(options or {})})
    c.create_table("t", _frame(n))
    return c


def _builds(trace):
    return [s for s in trace.spans if s.name.startswith("compile:")]


def _expected(n=200):
    return _frame(n).groupby("g")["x"].sum().sort_index().tolist()


# ---------------------------------------------------------------------------
# the compile cache
# ---------------------------------------------------------------------------
TINY_SOURCE = "int dsql_tiny(void) { return 42; }\n"


def _tiny_build(cache_dir):
    """Find or build ``libtiny.so`` under the cache: (path, built)."""
    from pathlib import Path

    target = compile_cache.cache_dir(Path("/nonexistent")) / "libtiny.so"
    assert target.parent == cache_dir
    if compile_cache.lookup(target):
        return target, False
    src = cache_dir / "tiny.c"
    src.write_text(TINY_SOURCE)
    tmp = target.with_suffix(".tmp")
    subprocess.run(["g++", "-x", "c", "-O2", "-fPIC", "-shared", "-o",
                    str(tmp), str(src)], check=True)
    os.replace(tmp, target)
    compile_cache.stored(target)
    return target, True


@pytest.fixture
def cache_path(tmp_path):
    path = tmp_path / "compile-cache"
    yield path
    compile_cache.disable()


def test_compile_cache_finds_what_an_earlier_process_built(cache_path):
    """A library built under ``serving.compile_cache.path`` is found by a
    later Context (a hit); the first was a compiler run (a miss); both
    counted in each Context's metrics."""
    import ctypes

    c1 = _ctx(options={"serving.compile_cache.path": str(cache_path)})
    c1.sql("SELECT 1 AS one")  # a path set on a Context applies at sql
    assert compile_cache.enabled_path() == str(cache_path)
    path, built = _tiny_build(cache_path)
    assert built and c1.metrics.counter("resilience.compile_cache.miss") == 1
    c2 = _ctx(options={"serving.compile_cache.path": str(cache_path)})
    c2.sql("SELECT 1 AS one")
    path2, built2 = _tiny_build(cache_path)
    assert path2 == path and not built2
    assert c2.metrics.counter("resilience.compile_cache.hit") == 1
    assert ctypes.CDLL(str(path2)).dsql_tiny() == 42
    # the kernel and planner libraries are named under the same directory
    from dask_sql_tpu_torch import _build

    assert _build.library_path("segsum").parent == cache_path
    assert _build.native_library_path().parent == cache_path


def test_torn_cache_entry_degrades_to_rebuild(cache_path):
    """A torn library is no hit and no error: it is removed and rebuilt."""
    import ctypes

    c = _ctx(options={"serving.compile_cache.path": str(cache_path)})
    c.sql("SELECT 1 AS one")
    path, _ = _tiny_build(cache_path)
    whole = path.read_bytes()
    path.write_bytes(whole[: len(whole) // 2])  # cut short
    assert not compile_cache.intact(path)
    torn = compile_cache.stats()["torn"]
    _, built = _tiny_build(cache_path)
    assert built and compile_cache.stats()["torn"] == torn + 1
    assert c.metrics.counter("resilience.compile_cache.hit") == 0
    assert ctypes.CDLL(str(path)).dsql_tiny() == 42
    path.write_bytes(b"torn-write\x00garbage")
    assert not compile_cache.intact(path)


def test_compile_cache_is_one_path_a_process(cache_path, tmp_path):
    assert compile_cache.enable(str(cache_path))
    assert compile_cache.enable(str(cache_path))
    assert not compile_cache.enable(str(tmp_path / "other"))
    assert compile_cache.enabled_path() == str(cache_path)


# ---------------------------------------------------------------------------
# profile-driven warm-up
# ---------------------------------------------------------------------------
def test_restart_warmup_first_query_has_no_foreground_build(tmp_path):
    c1 = _ctx()
    expected = c1.sql(AGG_QUERY).compute()
    assert _builds(c1.last_trace), "a cold run builds"
    loc = str(tmp_path / "snaps")
    c1.save_state(loc)
    c2 = Context(device="cpu")
    c2.config.update(NO_CACHE)
    c2.load_state(loc)
    warm = c2.warmup
    assert warm is not None
    warm.join(60)
    assert warm.ready and warm.warmed >= 1 and warm.failed == 0
    assert c2.metrics.counter("serving.warmup.warmed") >= 1
    out = c2.sql(AGG_QUERY).compute()
    assert out["s"].tolist() == expected["s"].tolist()
    assert _builds(c2.last_trace) == []


def test_warmup_counts_unreplayable_profiles():
    c1 = _ctx()
    c1.sql(AGG_QUERY).compute()
    c2 = Context(device="cpu")  # no table t
    c2.profiles.load(c1.profiles.snapshot())
    warm = c2.maybe_start_warmup()
    assert warm is not None
    warm.join(60)
    assert warm.ready and warm.failed == 1 and warm.warmed == 0
    assert c2.metrics.counter("serving.warmup.failed") == 1


def test_profiles_record_full_sql_beyond_trace_display_cap():
    c = _ctx()
    pad = " + 0.0" * 120
    long_query = f"SELECT g, SUM(x{pad}) AS s FROM t GROUP BY g ORDER BY g"
    assert len(long_query) > 500
    c.sql(long_query).compute()
    cands = c.profiles.warm_candidates(5)
    assert cands and cands[0][1] == long_query


def test_warmup_skips_truncated_sql():
    from dask_sql_tpu_torch.observability.profiles import (
        _SQL_KEEP,
        ProfileStore,
    )

    store = ProfileStore()
    store.record_exec("fp_long", sql="SELECT 1 FROM t WHERE " +
                      "x > 0 AND " * (_SQL_KEEP // 8) + "1=1")
    store.record_exec("fp_ok", sql="SELECT COUNT(*) FROM t")
    assert [fp for fp, _ in store.warm_candidates(10)] == ["fp_ok"]
    store2 = ProfileStore()
    store2.load(store.snapshot())
    assert [fp for fp, _ in store2.warm_candidates(10)] == ["fp_ok"]
    legacy = {"version": 1, "profiles": {
        "fp_maybe_cut": {"sql": "SELECT x FROM t WHERE " + "y" * 178,
                         "hits": 9},
        "fp_short": {"sql": "SELECT COUNT(*) FROM t", "hits": 1},
    }}
    store3 = ProfileStore()
    store3.load(legacy)
    assert [fp for fp, _ in store3.warm_candidates(10)] == ["fp_short"]


@pytest.mark.parametrize("sql", [
    "SELECT g, SUM(x) FROM t GROUP BY g",
    "  WITH q AS (SELECT 1 AS a) SELECT * FROM q",
    "CREATE TABLE boom AS SELECT 1 AS a",
    "DROP TABLE t",
    "CREATE TABLE s AS SELECT 1 AS a; SELECT * FROM s",
    "SELECT 1 AS a; DROP TABLE t",
    "not even sql (",
])
def test_warmup_replays_only_what_the_reference_replays(sql):
    from dask_sql_tpu_torch.serving.warmup import WarmupManager

    assert WarmupManager._replayable(sql) == RefWarmup._replayable(sql)


def test_interrupted_warmup_never_corrupts_and_rewarms(tmp_path):
    c1 = _ctx()
    expected = c1.sql(AGG_QUERY).compute()
    loc = str(tmp_path / "snaps")
    c1.save_state(loc)
    c2 = Context(device="cpu")
    c2.config.update({**NO_CACHE, "serving.warmup.throttle_s": 30.0})
    c2.load_state(loc)
    warm = c2.warmup
    warm.cancel()
    warm.join(60)
    assert warm.ready
    assert c2.sql(AGG_QUERY).compute()["s"].tolist() == \
        expected["s"].tolist()
    c3 = Context(device="cpu")
    c3.config.update(NO_CACHE)
    c3.load_state(loc)
    c3.warmup.join(60)
    assert c3.warmup.ready and c3.warmup.warmed >= 1


def test_warmup_with_injected_compile_fault_stays_consistent(tmp_path):
    c1 = _ctx()
    expected = c1.sql(AGG_QUERY).compute()
    loc = str(tmp_path / "snaps")
    c1.save_state(loc)
    c2 = Context(device="cpu")
    c2.config.update({**NO_CACHE, "resilience.inject": "compile:once"})
    c2.load_state(loc)
    c2.warmup.join(60)
    assert c2.warmup.ready
    c2.config.update({"resilience.inject": None})
    assert c2.sql(AGG_QUERY).compute()["s"].tolist() == \
        expected["s"].tolist()
    assert c2.metrics.counter("resilience.degraded") >= 1


# ---------------------------------------------------------------------------
# compile watchdog
# ---------------------------------------------------------------------------
def test_watchdog_degrades_hung_build():
    """A hung pipeline build degrades through the ladder within the
    deadline: the query answers, the watchdog counts, the breaker is
    charged for the family's rung."""
    from dask_sql_tpu_torch.resilience.retry import CircuitBreaker

    c = _ctx(options={"resilience.breaker.threshold": 1})
    c.breaker = CircuitBreaker.from_config(c.config)  # read at construction
    t0 = time.monotonic()
    with c.config.set({"resilience.inject": "compile_hang:once",
                       "resilience.inject.hang_s": 8.0,
                       "resilience.compile_timeout_ms": 100}):
        out = c.sql(AGG_QUERY).compute()
    assert time.monotonic() - t0 < 8.0
    assert out["s"].tolist() == _expected()
    snap = c.metrics.snapshot()["counters"]
    assert snap.get("resilience.watchdog.timeout", 0) == 1
    assert snap.get("resilience.watchdog.abandoned", 0) == 1
    assert snap.get("resilience.degraded.compiled_aggregate", 0) == 1
    assert snap.get("resilience.breaker.trip", 0) >= 1
    assert c.breaker.is_open((c.last_trace.fingerprint, "compiled_aggregate"))
    assert watchdog.join_abandoned(5.0) == 0


def test_an_abandoned_build_releases_its_waiters():
    """Queries waiting on a single-flight build the watchdog abandons
    build under their own once it is abandoned, and answer."""
    from dask_sql_tpu_torch.physical import compiled

    c = _ctx()
    c.config.update({"resilience.compile_timeout_ms": 200})
    started = threading.Event()
    gate = threading.Event()
    real = compiled.CompiledAggregate.__init__
    calls = []

    def slow_init(self, *a, **k):
        calls.append(threading.current_thread().name)
        if len(calls) == 1:
            started.set()
            gate.wait(10)  # the first build hangs past its deadline
        return real(self, *a, **k)

    compiled.CompiledAggregate.__init__ = slow_init
    results = {}
    try:
        def run(name):
            results[name] = c.sql(AGG_QUERY).compute()["s"].tolist()

        first = threading.Thread(target=run, args=("first",))
        first.start()
        assert started.wait(10)
        second = threading.Thread(target=run, args=("second",))
        second.start()
        first.join(20)
        second.join(20)
    finally:
        gate.set()
        compiled.CompiledAggregate.__init__ = real
    assert results == {"first": _expected(), "second": _expected()}
    assert c.metrics.counter("resilience.watchdog.timeout") == 1
    assert len(calls) == 2  # the waiter built under its own


def test_watchdog_pins_the_callers_device_and_stream(monkeypatch):
    """The helper thread enters the caller's CUDA device and current
    stream (torch keeps both per thread)."""
    entered = []

    class FakeCuda:
        @staticmethod
        def is_available():
            return True

        @staticmethod
        def is_initialized():
            return True

        @staticmethod
        def current_device():
            return 3

        @staticmethod
        def current_stream(device):
            return f"stream-of-{device}"

        class device:
            def __init__(self, d):
                self.d = d

            def __enter__(self):
                entered.append(("device", self.d))

            def __exit__(self, *a):
                return False

        class stream:
            def __init__(self, s):
                self.s = s

            def __enter__(self):
                entered.append(("stream", self.s, threading.current_thread()
                                .name.startswith("dsql-compile-watchdog")))

            def __exit__(self, *a):
                return False

    monkeypatch.setattr(torch, "cuda", FakeCuda)
    assert watchdog.watched_call("x", lambda: 7, deadline_ms=5000) == 7
    assert entered == [("device", 3), ("stream", "stream-of-3", True)]


def test_watchdog_off_by_default():
    c = Context(device="cpu")
    assert watchdog.timeout_ms(c.config) is None
    with c.config.set({"resilience.compile_timeout_ms": "250"}):
        assert watchdog.timeout_ms(c.config) == 250.0
    with c.config.set({"resilience.compile_timeout_ms": "bogus"}):
        assert watchdog.timeout_ms(c.config) is None


def test_watched_call_propagates_result_and_errors():
    from dask_sql_tpu_torch.resilience.errors import (
        CompileError,
        CompileTimeoutError,
        classify,
    )

    assert watchdog.watched_call("x", lambda: 41 + 1, deadline_ms=5000) == 42
    with pytest.raises(ValueError):
        watchdog.watched_call(
            "x", lambda: (_ for _ in ()).throw(ValueError("boom")),
            deadline_ms=5000)
    gate = threading.Event()
    with pytest.raises(CompileTimeoutError) as ei:
        watchdog.watched_call("x", lambda: gate.wait(5), deadline_ms=50)
    gate.set()
    err = ei.value
    assert isinstance(err, CompileError)
    assert err.degradable and not err.retryable
    assert classify(err) is err and err.code == "COMPILE_TIMEOUT"


# ---------------------------------------------------------------------------
# background recompile
# ---------------------------------------------------------------------------
def test_grown_table_rebuilds_in_background():
    c = _ctx(200, {"serving.bg_compile.enabled": True})
    r1 = c.sql(AGG_QUERY).compute()
    assert c.metrics.counter("resilience.rung.compiled_aggregate") == 1
    c.create_table("t", _frame(1000))  # a new table under the name
    r2 = c.sql(AGG_QUERY).compute()
    assert c.metrics.counter("serving.bg_compile.deferred") == 1
    assert c.metrics.counter("resilience.degraded") == 0
    assert c.metrics.counter("resilience.rung.compiled_aggregate") == 1
    assert r2["s"].tolist() == _expected(1000) != r1["s"].tolist()
    assert c.background_compiler().wait_idle(60)
    assert c.metrics.counter("serving.bg_compile.completed") == 1
    r3 = c.sql(AGG_QUERY).compute()
    assert c.metrics.counter("resilience.rung.compiled_aggregate") == 2
    assert r3["s"].tolist() == r2["s"].tolist()
    c.background_compiler().cancel()


def test_plain_cache_eviction_is_not_misread_as_growth():
    from dask_sql_tpu_torch.physical import compiled

    c = _ctx(200, {"serving.bg_compile.enabled": True})
    c.sql(AGG_QUERY).compute()
    owner = compiled.pipeline_owner(c)
    with compiled._cache_lock:
        for key in [k for k in compiled._cache if k[0] == owner]:
            del compiled._cache[key]
    c.sql(AGG_QUERY).compute()
    assert c.metrics.counter("serving.bg_compile.deferred") == 0
    assert c.metrics.counter("resilience.rung.compiled_aggregate") == 2


def test_bg_compiler_bounded_queue_and_dedup():
    from dask_sql_tpu_torch.serving.background import BackgroundCompiler
    from dask_sql_tpu_torch.serving.metrics import MetricsRegistry

    metrics = MetricsRegistry()
    bg = BackgroundCompiler(metrics=metrics, max_pending=1)
    gate = threading.Event()
    assert bg.submit("a", gate.wait)
    assert not bg.submit("a", gate.wait)
    bg.submit("b", lambda: None)
    while bg.submit("c", lambda: None):
        pass
    assert metrics.counter("serving.bg_compile.dropped") >= 1
    gate.set()
    assert bg.wait_idle(30)
    bg.cancel()
    bg.join(10)


# ---------------------------------------------------------------------------
# the runtime drains its background workers
# ---------------------------------------------------------------------------
def test_runtime_shutdown_joins_background_workers():
    from dask_sql_tpu_torch.serving.runtime import ServingRuntime

    c = _ctx(options={"serving.warmup.throttle_s": 30.0})
    c.sql(AGG_QUERY).compute()
    runtime = ServingRuntime(workers=1)
    c.serving = runtime
    warm = c.maybe_start_warmup()
    assert warm is not None and not warm.ready
    c.config.update({"serving.bg_compile.enabled": True})
    assert c.background_compiler() is not None
    t0 = time.monotonic()
    runtime.shutdown(wait=True, timeout=10.0)
    assert time.monotonic() - t0 < 10.0
    warm.join(0.1)
    assert not warm._thread.is_alive() and warm.ready


def test_runtime_shutdown_survives_worker_cancel_error():
    from dask_sql_tpu_torch.serving.runtime import ServingRuntime

    class Broken:
        def cancel(self):
            raise RuntimeError("teardown bug")

        def join(self, timeout=None):
            pass

    class Tracked:
        cancelled = joined = False

        def cancel(self):
            self.cancelled = True

        def join(self, timeout=None):
            self.joined = True

    runtime = ServingRuntime(workers=1)
    tracked = Tracked()
    runtime.register_background(Broken())
    runtime.register_background(tracked)
    runtime.shutdown(wait=True, timeout=5.0)
    assert tracked.cancelled and tracked.joined
    late = Tracked()
    runtime.register_background(late)
    assert late.cancelled


# ---------------------------------------------------------------------------
# checkpointed breaker verdicts
# ---------------------------------------------------------------------------
def test_breaker_verdicts_survive_restart(tmp_path):
    c1 = _ctx(options={"serving.warmup.enabled": False})
    c1.sql(AGG_QUERY).compute()
    key = ("fp-bad", "compiled_aggregate")
    for _ in range(3):
        c1.breaker.record_failure(key)
    assert c1.breaker.is_open(key)
    loc = str(tmp_path / "snaps")
    c1.save_state(loc)
    c2 = Context(device="cpu")
    c2.config.update({"serving.warmup.enabled": False})
    c2.load_state(loc)
    assert c2.breaker.is_open(key)
    assert c2.metrics.counter("resilience.breaker.restored") == 1
    assert c2.breaker.snapshot()["keys"] == 1


def test_breaker_restore_respects_ttl():
    from dask_sql_tpu.resilience.retry import CircuitBreaker as RefBreaker
    from dask_sql_tpu_torch.resilience.retry import CircuitBreaker

    b1 = CircuitBreaker(threshold=1)
    b1.record_failure(("fp", "rung"))
    snap = b1.snapshot_state()
    assert len(snap["open"]) == 1
    for cls in (CircuitBreaker, RefBreaker):  # either engine loads it
        fresh = cls(threshold=1)
        assert fresh.load_state(snap, ttl_s=300.0) == 1
        assert fresh.is_open(("fp", "rung"))
    stale = dict(snap, saved_at=time.time() - 1000.0)
    assert CircuitBreaker(threshold=1).load_state(stale, ttl_s=300.0) == 0
    junk = {"saved_at": time.time(), "open": [{"bogus": 1}, None]}
    assert CircuitBreaker().load_state(junk, ttl_s=300.0) == 0


def test_reference_snapshot_warms_a_port_context(tmp_path):
    """The reference's profiles ride its snapshot into a port Context,
    whose warm-up replays them on the port."""
    r = dask_sql_tpu.Context()
    r.create_table("t", _frame())
    with r.config.set(NO_CACHE):
        want = r.sql(AGG_QUERY, return_futures=False)
    loc = str(tmp_path / "ref")
    r.save_state(loc)
    c = Context(device="cpu")
    c.config.update(NO_CACHE)
    c.load_state(loc)
    assert c.warmup is not None
    c.warmup.join(60)
    assert c.warmup.ready and c.warmup.warmed == 1
    out = c.sql(AGG_QUERY).compute()
    assert out["s"].tolist() == want["s"].tolist()
    assert _builds(c.last_trace) == []
