"""Runtime lock sanitizer: named, ranked locks with lockdep-style
acquisition-order tracking (the runtime tier).  Copied from
`dask_sql_tpu/runtime/locks.py`.

The static tier (analysis/concurrency.py, rules DSQL601-603) proves lock
ordering over the AST; this module proves the same invariant over the
*executed* schedule, the way the kernel's lockdep does: every sanitized
lock carries a stable NAME (a class of locks, not an instance — all
replicas' state locks share "fleet.replica.state") and an optional RANK,
each thread keeps a stack of the sanitized locks it holds, and every
blocking acquisition

- checks the declared ranks: taking a lock whose rank is LOWER than a
  lock already held is an inversion (`LockOrderError(kind="rank")`);
- checks the process-global order graph: if the name being acquired can
  already reach the innermost held name, the new edge would close a
  cycle (`LockOrderError(kind="cycle")`) — the error carries BOTH
  witness stacks: this thread's acquisition stack and the recorded
  stack of the first thread that took the edge the other way round;
- records the edge (innermost held -> acquired) with the first witness
  stack, so later reversals can be reported with evidence.

The check runs BEFORE the blocking acquire, so a deliberate inversion in
a test raises instead of deadlocking.  Violations also increment
``analysis.locks.order_violation`` (when a metrics registry is attached)
and record a ``lock.order_violation`` flight event, which the chaos
campaigns (resilience/chaos.py) assert stays at zero.

Deliberate non-checks, each load-bearing:

- **disabled by default** (config ``analysis.lock_sanitizer``; the test
  suite turns it on in tests/conftest.py) — when disabled a NamedLock is
  a plain pass-through with no per-acquire bookkeeping;
- **non-blocking acquires skip the checks** (they cannot deadlock, and
  ``threading.Condition``'s ``_is_owned`` fallback probes
  ``acquire(False)`` on a lock the thread already holds — that probe
  must return False, not raise); they still push/pop the held stack so
  nesting seen *through* them stays visible;
- **same-name pairs are skipped** in the edge/cycle logic: two replicas'
  "fleet.replica.state" locks are distinct objects whose nesting is
  ordered by the router, and a name-level self-edge would be a false
  positive.  Re-acquiring the SAME OBJECT is still caught: a reentrant
  NamedLock bumps its hold depth, a plain one raises
  ``LockOrderError(kind="self-deadlock")`` instead of hanging;
- **violation reporting is recursion-guarded**: flight/metrics use
  NamedLocks themselves, so while the sanitizer is reporting (or
  checking) the per-thread ``in_sanitizer`` flag makes inner acquires
  skip their own checks.

Declared rank order (lower = acquired first = outer; the full table with
the justification per edge lives in docs/analysis.md "Lock ranks"):

====  ==========================  ==========================================
rank  name                        owner
====  ==========================  ==========================================
 10   fleet.router.apply          fleet/router.py write fan-out + promote
 20   fleet.router.state          fleet/router.py membership/epochs
 30   fleet.replica.state         fleet/replica.py lifecycle state
 32   fleet.replica.write         fleet/replica.py write fence + apply
 40   serving.runtime.cv          serving/runtime.py scheduler condition
 45   serving.admission           serving/admission.py ledger
 50   families.batcher            families/batcher.py rendezvous
 55   context.plan_cache          context.py plan/catalog caches
 70   inference.registry          inference/registry.py publish lock
 90   serving.metrics             serving/metrics.py counters (leaf)
 95   observability.flight        observability/flight.py ring (leaf)
====  ==========================  ==========================================
"""
from __future__ import annotations

import sys
import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

#: The canonical rank table (outer/first-acquired = low).  ``named_lock``
#: and ``named_condition`` resolve ranks here so every call site shares
#: one source of truth; docs/analysis.md mirrors this table.
DECLARED_RANKS: Dict[str, int] = {
    "fleet.router.apply": 10,
    "fleet.router.state": 20,
    "fleet.replica.state": 30,
    "fleet.replica.write": 32,
    "serving.runtime.cv": 40,
    "serving.admission": 45,
    "families.batcher": 50,
    "context.plan_cache": 55,
    "inference.registry": 70,
    "serving.metrics": 90,
    "observability.flight": 95,
}

_MAX_VIOLATIONS_KEPT = 100
_STACK_LIMIT = 24


class LockOrderError(RuntimeError):
    """A lock-order violation caught before the acquire blocked.

    Attributes: ``kind`` ("rank" | "cycle" | "self-deadlock"),
    ``holding`` / ``acquiring`` (lock names), and ``witness`` — the
    formatted evidence: this thread's acquisition stack plus, for
    cycles, the recorded stack of the edge taken the other way.
    """

    def __init__(self, message: str, *, kind: str, holding: str,
                 acquiring: str, witness: str):
        super().__init__(message + "\n" + witness)
        self.kind = kind
        self.holding = holding
        self.acquiring = acquiring
        self.witness = witness


# ---------------------------------------------------------------------------
# module state
# ---------------------------------------------------------------------------
#: raw lock guarding the order graph / registry — deliberately NOT a
#: NamedLock (the sanitizer cannot sanitize itself) and never held while
#: calling out of this module
_state_lock = threading.Lock()
_ranks: Dict[str, Optional[int]] = {}
#: order graph: holder name -> acquired name -> first-witness record
_graph: Dict[str, Dict[str, Dict[str, Any]]] = {}
_violations: List[Dict[str, Any]] = []
_violation_total = 0
_enabled = False
_metrics = None
_tls = threading.local()


def set_enabled(flag: bool) -> None:
    """Turn the sanitizer on/off process-wide (config
    ``analysis.lock_sanitizer``; Context only ever turns it ON so one
    opted-in context cannot be disarmed by a later default one)."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def attach_metrics(metrics) -> None:
    """Point violation counters at a MetricsRegistry (Context wires its
    own in __init__); last attach wins, which is what tests want."""
    global _metrics
    _metrics = metrics
    try:
        _metrics.gauge("analysis.locks.registered", float(len(_ranks)))
    except Exception:  # dsql: allow-broad-except — advisory gauge only
        pass


def violation_count() -> int:
    """Monotonic count of violations since process start (or `reset`) —
    the chaos campaigns snapshot this before/after a storm."""
    return _violation_total


def violations() -> List[Dict[str, Any]]:
    with _state_lock:
        return list(_violations)


def snapshot() -> Dict[str, Any]:
    """Debug/readout view: registered names+ranks, observed edges, and
    the violation tally."""
    with _state_lock:
        edges = [
            {"from": a, "to": b, "count": rec["count"]}
            for a, nbrs in sorted(_graph.items())
            for b, rec in sorted(nbrs.items())
        ]
        return {
            "enabled": _enabled,
            "locks": dict(sorted(_ranks.items())),
            "edges": edges,
            "violations": _violation_total,
        }


def reset() -> None:
    """Clear the order graph, registry, and violation tally (tests)."""
    global _violation_total
    with _state_lock:
        _ranks.clear()
        _graph.clear()
        _violations.clear()
        _violation_total = 0


def _held_stack() -> List[List[Any]]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _in_sanitizer() -> bool:
    return getattr(_tls, "in_sanitizer", False)


def _register(name: str, rank: Optional[int]) -> None:
    with _state_lock:
        prev = _ranks.get(name, None)
        if name in _ranks and prev is not None and rank is not None \
                and prev != rank:
            raise ValueError(
                f"lock name {name!r} re-registered with rank {rank} "
                f"(already declared rank {prev}); ranks are per-NAME, "
                f"fix the DECLARED_RANKS table")
        if name not in _ranks or (prev is None and rank is not None):
            _ranks[name] = rank
    if _metrics is not None:
        try:
            _metrics.gauge("analysis.locks.registered", float(len(_ranks)))
        except Exception:  # dsql: allow-broad-except — advisory gauge only
            pass


def _caller_site() -> str:
    """file:line of the frame that called acquire (cheap single-frame
    capture for held-stack entries; full stacks only on first-seen edges
    and violations)."""
    f = sys._getframe(1)
    this = __file__
    while f is not None and f.f_code.co_filename == this:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno} in {f.f_code.co_name}"


def _format_stack() -> str:
    frames = traceback.format_stack(limit=_STACK_LIMIT)
    # drop the sanitizer's own frames from the tail for readable evidence
    return "".join(fr for fr in frames if __file__ not in fr) or \
        "".join(frames)


def _reachable(src: str, dst: str) -> bool:
    """True when dst is reachable from src in the order graph (caller
    holds _state_lock)."""
    seen = {src}
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        for nxt in _graph.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return False


def _cycle_path(src: str, dst: str) -> List[Tuple[str, str]]:
    """One witness path src -> ... -> dst as a list of edges (caller
    holds _state_lock); [] when none."""
    parent: Dict[str, str] = {}
    frontier = [src]
    seen = {src}
    while frontier:
        node = frontier.pop(0)
        if node == dst:
            path: List[Tuple[str, str]] = []
            while node != src:
                path.append((parent[node], node))
                node = parent[node]
            path.reverse()
            return path
        for nxt in _graph.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                parent[nxt] = node
                frontier.append(nxt)
    return []


def _report(kind: str, holding: str, acquiring: str, witness: str,
            message: str) -> LockOrderError:
    """Record a violation (tally, bounded detail list, metric, flight
    event) and build the structured error for the caller to raise."""
    global _violation_total
    detail = {
        "kind": kind,
        "holding": holding,
        "acquiring": acquiring,
        "thread": threading.current_thread().name,
        "witness": witness,
    }
    with _state_lock:
        _violation_total += 1
        _violations.append(detail)
        del _violations[:-_MAX_VIOLATIONS_KEPT]
    if _metrics is not None:
        try:
            _metrics.inc("analysis.locks.order_violation")
        except Exception:  # dsql: allow-broad-except — reporting must not mask the violation
            pass
    try:
        from ..observability import flight

        flight.record("lock.order_violation", kind=kind, holding=holding,
                      acquiring=acquiring,
                      thread=threading.current_thread().name)
    except Exception:  # dsql: allow-broad-except — reporting must not mask the violation
        pass
    return LockOrderError(message, kind=kind, holding=holding,
                          acquiring=acquiring, witness=witness)


class NamedLock:
    """A ``threading.Lock``/``RLock`` wrapper registered with the
    sanitizer under a stable name (a lock *class*, lockdep-style) and an
    optional rank.  Context-manager protocol, ``acquire(blocking,
    timeout)`` and ``release()`` match the stdlib locks, so it drops in
    anywhere a raw lock lived — including as the underlying lock of a
    ``threading.Condition`` (see `named_condition`)."""

    __slots__ = ("name", "rank", "_inner", "_reentrant")

    def __init__(self, name: str, rank: Optional[int] = None,
                 reentrant: bool = False):
        self.name = name
        self.rank = rank
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        _register(name, rank)

    def __repr__(self) -> str:
        kind = "RLock" if self._reentrant else "Lock"
        return f"<NamedLock {self.name!r} rank={self.rank} {kind}>"

    # ------------------------------------------------------------- acquire
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _enabled:
            return self._inner.acquire(blocking, timeout)
        try:
            held = _tls.stack
        except AttributeError:
            held = _tls.stack = []
        if not held:
            # fast path: nothing held, nothing to check (a metrics/flight
            # leaf taken at top level — the overwhelmingly common case)
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                held.append([self, 1, None])
            return ok
        entry = None
        for e in held:
            if e[0] is self:
                entry = e
                break
        if entry is not None:
            if self._reentrant:
                ok = self._inner.acquire(blocking, timeout)
                if ok:
                    entry[1] += 1
                return ok
            if blocking and not _in_sanitizer():
                _tls.in_sanitizer = True
                try:
                    raise self._self_deadlock(entry)
                finally:
                    _tls.in_sanitizer = False
            # non-blocking probe of a lock this thread holds (Condition's
            # _is_owned fallback): report False, never raise
            return self._inner.acquire(False)
        if blocking and not getattr(_tls, "in_sanitizer", False):
            _tls.in_sanitizer = True
            try:
                self._check(held)
            finally:
                _tls.in_sanitizer = False
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held.append([self, 1, _caller_site()])
        return ok

    def _self_deadlock(self, entry) -> LockOrderError:
        witness = (f"first acquired at: {entry[2] or '<outermost>'}\n"
                   f"re-acquired at:\n{_format_stack()}")
        return _report(
            "self-deadlock", self.name, self.name, witness,
            f"thread {threading.current_thread().name!r} re-acquired "
            f"non-reentrant lock {self.name!r} it already holds")

    def _check(self, held) -> None:
        """Rank + cycle check against the held stack; raises
        LockOrderError BEFORE the blocking acquire on violation.  Called
        with the in_sanitizer flag set (so flight/metrics NamedLocks
        used while reporting skip their own checks)."""
        # one pass: filter same-name siblings (cross-instance fan-out),
        # rank-check each survivor, remember the innermost as `top`
        my_rank = self.rank
        top_entry = None
        for e in held:
            h = e[0]
            if h.name == self.name:
                continue
            top_entry = e
            if my_rank is not None and h.rank is not None \
                    and my_rank < h.rank:
                witness = (
                    f"held {h.name!r} (rank {h.rank}) acquired at: "
                    f"{e[2] or '<outermost>'}\n"
                    f"acquiring {self.name!r} (rank {my_rank}) "
                    f"at:\n{_format_stack()}")
                raise _report(
                    "rank", h.name, self.name, witness,
                    f"rank inversion: acquiring {self.name!r} "
                    f"(rank {my_rank}) while holding {h.name!r} "
                    f"(rank {h.rank}); declared order is "
                    f"low-rank-first")
        if top_entry is None:
            return  # only same-name siblings held
        top = top_entry[0]
        # optimistic lock-free fast path: this exact edge is already
        # recorded AND the acquiring name has no outgoing edges (so no
        # path back to any holder can exist) — bump the advisory count
        # without touching _state_lock.  GIL-atomic dict reads make the
        # probe safe; a NEW edge that could close a cycle always goes
        # through the locked slow path below and is checked there.
        if not _graph.get(self.name):
            nbrs = _graph.get(top.name)
            rec = nbrs.get(self.name) if nbrs is not None else None
            if rec is not None:
                rec["count"] += 1  # racy under-count is fine: advisory
                return
        stack_txt = None
        with _state_lock:
            cycle = _cycle_path(self.name, top.name) if _graph.get(
                self.name) else []
            if not cycle:
                rec = _graph.setdefault(top.name, {}).get(self.name)
                if rec is None:
                    need_stack = True
                else:
                    rec["count"] += 1
                    need_stack = False
        if cycle:
            with _state_lock:
                other = "\n".join(
                    f"-- recorded edge {a!r} -> {b!r} (thread "
                    f"{_graph[a][b]['thread']}):\n{_graph[a][b]['stack']}"
                    for a, b in cycle)
            witness = (
                f"-- this thread ({threading.current_thread().name}) "
                f"holds {top.name!r} and is acquiring {self.name!r}:\n"
                f"{_format_stack()}\n{other}")
            raise _report(
                "cycle", top.name, self.name, witness,
                f"lock-order cycle: {self.name!r} -> ... -> {top.name!r} "
                f"already recorded, and this thread is taking "
                f"{top.name!r} -> {self.name!r}")
        if need_stack:
            stack_txt = _format_stack()
            with _state_lock:
                _graph.setdefault(top.name, {}).setdefault(
                    self.name, {
                        "stack": stack_txt,
                        "thread": threading.current_thread().name,
                        "count": 1,
                    })

    # ------------------------------------------------------------- release
    def release(self) -> None:
        if _enabled:
            held = getattr(_tls, "stack", None)
            if held:
                for i in range(len(held) - 1, -1, -1):
                    if held[i][0] is self:
                        held[i][1] -= 1
                        if held[i][1] <= 0:
                            del held[i]
                        break
        self._inner.release()

    def locked(self) -> bool:
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else False

    def __enter__(self) -> "NamedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()


def named_lock(name: str, reentrant: bool = False) -> NamedLock:
    """A NamedLock with its rank resolved from `DECLARED_RANKS` — the
    constructor every production call site uses, so ranks have one
    source of truth."""
    return NamedLock(name, rank=DECLARED_RANKS.get(name),
                     reentrant=reentrant)


def named_condition(name: str) -> "threading.Condition":
    """A ``threading.Condition`` whose underlying lock is a sanitized
    NamedLock (rank from `DECLARED_RANKS`).  Condition's ``_is_owned``
    fallback probes ``acquire(False)`` — non-blocking acquires skip the
    sanitizer checks, so the probe behaves exactly as on a raw lock."""
    return threading.Condition(named_lock(name))
