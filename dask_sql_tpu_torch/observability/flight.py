"""Flight recorder: an always-on bounded ring of structured engine events.
(A copy of `dask_sql_tpu/observability/flight.py`.)

Every engine decision that changes what runs (admits, sheds, packs, quota
throttles, ladder step downs, breaker trips and restores, pipeline builds,
batch launches, cancellations, lock-order violations) appends one event
to a process-global bounded ring.  On a query failure the ring is
flushed as one JSONL record to ``observability.flight.dump_path`` when
that is set; the ring in memory stays readable either way.  Event names
are a registered vocabulary (`EVENT_NAMES`): a misspelt name would split
a timeline.

The recorder is process-global (`RECORDER`) because the layers that emit
events (scheduler, breaker, ladder) do not all hold a Context; events
carry the qid where one is known.  Recording is a deque append under a
lock.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque

from ..runtime import locks
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

#: Registered event-name vocabulary, the reference's whole set (the
#: self-lint's rule DSQL501 checks call sites against it): add a name here
#: when introducing an event.
EVENT_NAMES = frozenset({
    # query lifecycle (serving runtime / server / TpuFrame)
    "query.admit",
    "query.shed",
    "query.finish",
    "query.fail",
    "query.cancel",
    # packing scheduler (serving/scheduler.py)
    "sched.pack",
    "sched.quota_throttle",
    # degradation ladder + breaker (resilience/)
    "ladder.degrade",
    "breaker.trip",
    "breaker.restore",
    # streamed partitioned execution (streaming/runner.py)
    "stream.repartition",
    "stream.exhausted",
    # pipeline builds (observability/spans.py timed_build)
    "compile.start",
    "compile.end",
    # family batching (families/batcher.py)
    "batch.lead",
    "batch.member",
    # background work (serving/background.py, serving/warmup.py)
    "bg.recompile",
    "warmup.replay",
    # model lowering + zero-recompile weight swaps (inference/registry.py)
    "model.lower",
    "model.swap",
    # semantic reuse: materialized stems + incremental refresh (materialize/)
    "materialize.store",
    "materialize.hit",
    "materialize.evict",
    "materialize.refresh",
    # coordinated HBM pressure response (resilience/pressure.py)
    "pressure.band",
    "pressure.reclaim",
    # chaos campaign harness (resilience/chaos.py)
    "chaos.arm",
    # runtime lock sanitizer (runtime/locks.py): a rank inversion or
    # order-graph cycle caught before the acquire blocked
    "lock.order_violation",
    # fleet tier (fleet/): routing, failover, promotion, drain, kill
    "fleet.route",
    "fleet.failover",
    "fleet.promote",
    "fleet.drain",
    "replica.kill",
})

#: prefixes legitimizing dynamic event families (none today)
EVENT_NAME_PREFIXES: tuple = ()


def is_registered_event(name: str, prefix_only: bool = False) -> bool:
    """True when ``name`` is covered by the registered vocabulary."""
    if name in EVENT_NAMES:
        return True
    if any(name.startswith(p) for p in EVENT_NAME_PREFIXES):
        return True
    return prefix_only and any(p.startswith(name)
                               for p in EVENT_NAME_PREFIXES)


class FlightRecorder:
    """Bounded ring of ``{ts, event, qid?, **attrs}`` dicts."""

    def __init__(self, capacity: int = 4096):
        # leaf rank: nothing is acquired while the ring lock is held, so
        # any thread may record from under any other sanitized lock
        self._lock = locks.named_lock("observability.flight")
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(16, int(capacity)))
        self.recorded = 0

    def record(self, event: str, qid: Optional[str] = None,
               ts: Optional[float] = None, **attrs) -> None:
        rec: Dict[str, Any] = {
            "ts": time.time() if ts is None else float(ts),
            "event": event,
        }
        if qid is not None:
            rec["qid"] = qid
        for k, v in attrs.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1

    def events(self, limit: Optional[int] = None,
               name: Optional[str] = None,
               qid: Optional[str] = None) -> List[Dict[str, Any]]:
        """Oldest-first dump, optionally filtered; ``limit`` keeps the
        newest N after filtering."""
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [e for e in out if e["event"] == name]
        if qid is not None:
            out = [e for e in out if e.get("qid") == qid]
        if limit is not None and limit >= 0:
            out = out[-int(limit):]
        return out

    def resize(self, capacity: int) -> None:
        with self._lock:
            if self._ring.maxlen != max(16, int(capacity)):
                self._ring = deque(self._ring,
                                   maxlen=max(16, int(capacity)))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


#: THE process flight recorder — always on
RECORDER = FlightRecorder()


def record(event: str, qid: Optional[str] = None,
           ts: Optional[float] = None, **attrs) -> None:
    """Append one event to the process recorder (module-level convenience:
    ``from ..observability import flight; flight.record("query.admit",
    qid=qid)``).  ``event`` must be in the registered vocabulary (checked by
    the tests, not at run time)."""
    RECORDER.record(event, qid=qid, ts=ts, **attrs)


#: serializes failure dumps so concurrent failing queries cannot
#: interleave JSONL lines mid-record
_dump_lock = threading.Lock()

#: characters allowed verbatim in a {qid} path substitution; anything
#: else (slashes, spaces, NULs from a hostile client qid) becomes "_"
_QID_SAFE = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.-")


def expand_dump_path(path: str, qid: Optional[str] = None) -> str:
    """Expand ``{pid}`` / ``{qid}`` placeholders in the configured dump
    path.  Multiple replicas sharing one dump directory each write their
    own file (``flight-{pid}.jsonl``) instead of interleaving appends to
    a single JSONL — the ``_dump_lock`` below serializes writers within a
    process, but nothing serializes processes."""
    import os

    if "{pid}" in path:
        path = path.replace("{pid}", str(os.getpid()))
    if "{qid}" in path:
        safe = "".join(ch if ch in _QID_SAFE else "_"
                       for ch in (qid or "unknown"))
        path = path.replace("{qid}", safe or "unknown")
    return path


def flush_on_failure(qid: Optional[str], error_code: Optional[str],
                     config, metrics=None) -> bool:
    """Auto-flush hook run on any query failure: records the failure event
    and, when ``observability.flight.dump_path`` is configured, appends one
    JSONL record carrying the failure plus the entire current ring — the
    postmortem context of every engine decision leading up to it."""
    record("query.fail", qid=qid, code=error_code)
    path = None if config is None else config.get(
        "observability.flight.dump_path")
    if not path:
        return False
    path = expand_dump_path(path, qid=qid)
    rec = {
        "ts": time.time(),
        "qid": qid,
        "error": error_code,
        "events": RECORDER.events(),
    }
    try:
        with _dump_lock, open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        logger.warning("flight-recorder dump to %r failed", path,
                       exc_info=True)
        return False
    if metrics is not None:
        metrics.inc("observability.flight.dumps")
    return True
