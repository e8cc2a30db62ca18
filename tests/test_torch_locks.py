"""The port's runtime lock sanitizer (`dask_sql_tpu_torch/runtime/
locks.py`, a copy of the reference's), held to the reference's cases
(`tests/unit/test_locks.py`): deliberate inversions raise a structured
LockOrderError with both witness stacks BEFORE the acquire blocks, correct
orders stay silent, and violations feed the ``analysis.locks.*`` metrics.
The reference's flight event of a violation waits for the port's flight
recorder (ROADMAP.md Queue 1 item 8b), so its check is left out.
"""
import threading

import pytest

from dask_sql_tpu_torch.runtime import locks
from dask_sql_tpu_torch.runtime.locks import (
    DECLARED_RANKS,
    LockOrderError,
    NamedLock,
    named_condition,
    named_lock,
)


@pytest.fixture(autouse=True)
def fresh_sanitizer():
    """Clean order graph/registry per test (production NamedLocks keep
    working — registration only matters at creation time), sanitizer
    forced ON, and the attached metrics registry restored afterwards."""
    saved_metrics = locks._metrics
    locks.reset()
    locks.set_enabled(True)
    yield
    locks.reset()
    locks.set_enabled(True)
    locks.attach_metrics(saved_metrics)


def in_thread(fn):
    """Run fn on a fresh thread (its own held-stack) and re-raise."""
    box = {}

    def runner():
        try:
            fn()
        except BaseException as exc:  # dsql: allow-broad-except — test harness relay
            box["exc"] = exc

    t = threading.Thread(target=runner)
    t.start()
    t.join(10)
    assert not t.is_alive(), "sanitized acquire deadlocked instead of raising"
    if "exc" in box:
        raise box["exc"]


# ------------------------------------------------------------ cycle check
def test_deliberate_inversion_raises_with_both_witness_stacks():
    a = NamedLock("t.cyc.a")
    b = NamedLock("t.cyc.b")

    # record the a -> b edge on another thread (full witness stack kept)
    def forward():
        with a:
            with b:
                pass

    in_thread(forward)

    with b:
        with pytest.raises(LockOrderError) as exc_info:
            a.acquire()
    err = exc_info.value
    assert err.kind == "cycle"
    assert err.holding == "t.cyc.b"
    assert err.acquiring == "t.cyc.a"
    # both witnesses: this thread's stack AND the recorded reverse edge
    assert "-- this thread" in err.witness
    assert "-- recorded edge 't.cyc.a' -> 't.cyc.b'" in err.witness
    assert "forward" in err.witness  # the first witness's frames survive

    # the check ran BEFORE the acquire: nothing was taken, b releases fine
    assert not a.locked()


def test_longer_cycle_through_intermediate_lock():
    a, b, c = NamedLock("t.tri.a"), NamedLock("t.tri.b"), NamedLock("t.tri.c")
    in_thread(lambda: _nest(a, b))
    in_thread(lambda: _nest(b, c))
    with c:
        with pytest.raises(LockOrderError) as exc_info:
            a.acquire()
    assert exc_info.value.kind == "cycle"
    # the witness walks the recorded a -> b -> c chain
    assert "'t.tri.a' -> 't.tri.b'" in exc_info.value.witness
    assert "'t.tri.b' -> 't.tri.c'" in exc_info.value.witness


def _nest(outer, inner):
    with outer:
        with inner:
            pass


def test_consistent_order_is_silent_and_recorded():
    a = NamedLock("t.ok.a")
    b = NamedLock("t.ok.b")
    for _ in range(3):
        _nest(a, b)
    in_thread(lambda: _nest(a, b))
    snap = locks.snapshot()
    edges = {(e["from"], e["to"]): e["count"] for e in snap["edges"]}
    assert edges[("t.ok.a", "t.ok.b")] == 4
    assert snap["violations"] == 0


# ------------------------------------------------------------- rank check
def test_rank_inversion_raises():
    outer = NamedLock("t.rank.outer", rank=10)
    inner = NamedLock("t.rank.inner", rank=20)
    with inner:
        with pytest.raises(LockOrderError) as exc_info:
            outer.acquire()
    err = exc_info.value
    assert err.kind == "rank"
    assert err.holding == "t.rank.inner"
    assert err.acquiring == "t.rank.outer"
    assert "rank inversion" in str(err)


def test_declared_rank_order_is_clean():
    # walking the production rank table outer -> inner never trips
    chain = [NamedLock(f"t.chain.{name}", rank=rank)
             for name, rank in sorted(DECLARED_RANKS.items(),
                                      key=lambda kv: kv[1])]
    for lk in chain:
        lk.acquire()
    for lk in reversed(chain):
        lk.release()
    assert locks.violation_count() == 0


def test_named_lock_resolves_rank_from_declared_table():
    lk = named_lock("fleet.router.apply")
    assert lk.rank == DECLARED_RANKS["fleet.router.apply"]
    assert named_lock("t.not.declared").rank is None


def test_rank_conflict_on_reregistration_raises():
    NamedLock("t.conflict", rank=10)
    with pytest.raises(ValueError, match="re-registered with rank"):
        NamedLock("t.conflict", rank=20)
    # same rank is fine (two instances of one lock class)
    NamedLock("t.conflict", rank=10)


# --------------------------------------------------- same-lock re-acquire
def test_plain_lock_self_reacquire_raises_instead_of_hanging():
    lk = NamedLock("t.self")
    with lk:
        with pytest.raises(LockOrderError) as exc_info:
            lk.acquire()
        assert exc_info.value.kind == "self-deadlock"
        assert "re-acquired" in str(exc_info.value)
    # single release (the re-acquire never took it); usable again
    with lk:
        pass


def test_reentrant_lock_nests():
    lk = NamedLock("t.rlock", reentrant=True)
    with lk:
        with lk:
            with lk:
                pass
    assert locks.violation_count() == 0
    # fully released: another thread can take it
    in_thread(lambda: _nest(lk, NamedLock("t.rlock.peer")))


def test_nonblocking_probe_of_held_lock_returns_false():
    # threading.Condition._is_owned falls back to acquire(False) on the
    # lock its own thread holds — must report False, never raise
    lk = NamedLock("t.probe")
    with lk:
        assert lk.acquire(blocking=False) is False
    assert lk.acquire(blocking=False) is True
    lk.release()


def test_same_name_instances_do_not_false_positive():
    # two replicas' state locks share one name; router-ordered nesting
    # across instances must not look like a self-edge or cycle
    r1 = NamedLock("t.replica.state")
    r2 = NamedLock("t.replica.state")
    with r1:
        with r2:
            pass
    with r2:
        with r1:
            pass
    assert locks.violation_count() == 0


# ----------------------------------------------------- condition variable
def test_named_condition_wait_notify_across_threads():
    cv = named_condition("t.cv")
    state = {"ready": False}

    def producer():
        with cv:
            state["ready"] = True
            cv.notify_all()

    with cv:
        threading.Thread(target=producer).start()
        assert cv.wait_for(lambda: state["ready"], timeout=10)
    assert locks.violation_count() == 0


# ------------------------------------------------------------- reporting
def test_violation_feeds_metrics_and_tally():
    from dask_sql_tpu_torch.serving.metrics import MetricsRegistry

    registry = MetricsRegistry()
    locks.attach_metrics(registry)
    before_count = locks.violation_count()

    a = NamedLock("t.rep.a")
    b = NamedLock("t.rep.b")
    in_thread(lambda: _nest(a, b))
    with b:
        with pytest.raises(LockOrderError):
            a.acquire()

    assert locks.violation_count() == before_count + 1
    assert registry.counter("analysis.locks.order_violation") == 1

    detail = locks.violations()[-1]
    assert detail["kind"] == "cycle"
    assert detail["holding"] == "t.rep.b"
    assert detail["acquiring"] == "t.rep.a"
    assert "-- this thread" in detail["witness"]


def test_snapshot_reports_locks_edges_and_enabled():
    a = NamedLock("t.snap.a", rank=1)
    b = NamedLock("t.snap.b", rank=2)
    _nest(a, b)
    snap = locks.snapshot()
    assert snap["enabled"] is True
    assert snap["locks"]["t.snap.a"] == 1
    assert snap["locks"]["t.snap.b"] == 2
    assert {"from": "t.snap.a", "to": "t.snap.b", "count": 1} in snap["edges"]


# -------------------------------------------------------------- disabled
def test_disabled_sanitizer_is_a_passthrough():
    locks.set_enabled(False)
    try:
        a = NamedLock("t.off.a", rank=20)
        b = NamedLock("t.off.b", rank=10)
        with a:  # rank 20 held...
            with b:  # ...acquiring rank 10: would raise if enabled
                pass
        assert locks.violation_count() == 0
        assert locks.snapshot()["edges"] == []
    finally:
        locks.set_enabled(True)


def test_stress_consistent_order_across_threads():
    # 8 threads hammering a 3-deep consistent order: zero violations and
    # no deadlock (the suite-wide sanitizer gates the real modules the
    # same way; this isolates the wrapper's own thread-safety)
    a = NamedLock("t.stress.a", rank=1)
    b = NamedLock("t.stress.b", rank=2)
    c = NamedLock("t.stress.c", rank=3)
    errors = []

    def worker():
        try:
            for _ in range(200):
                with a:
                    with b:
                        with c:
                            pass
                with b:
                    with c:
                        pass
        except BaseException as exc:  # dsql: allow-broad-except — test harness relay
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors
    assert locks.violation_count() == 0
    edges = {(e["from"], e["to"]) for e in locks.snapshot()["edges"]}
    assert ("t.stress.a", "t.stress.b") in edges
    assert ("t.stress.b", "t.stress.c") in edges
