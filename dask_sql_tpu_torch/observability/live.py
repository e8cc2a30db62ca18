"""In-flight query table: the live state of every admitted query.
(A copy of `dask_sql_tpu/observability/live.py`.)

`QueryRegistry` holds one `LiveQuery` per admitted query, updated in place
by the layers that know each fact: the serving front end or
`TorchFrame.execute` registers the entry (qid, sql, tenant, class,
ticket, trace); `observability.stage(...)` stamps the lifecycle stage;
the degradation ladder stamps the rung that answered; the family batcher
stamps the batch role and size; the scheduler's `QueryCost` rides the
ticket, so reserved bytes and the deadline remaining read off it; the
streamed rungs' runner (streaming/runner.py) fills the partitions' and
rows' progress.

Surfaced as ``SHOW QUERIES``; ``CANCEL QUERY '<qid>'`` resolves the
entry's `QueryTicket` and cancels it cooperatively (the executor's
checkpoints between plan nodes do the stopping).

Thread model: one writer thread per query (the executing worker) plus
concurrent readers (SHOW QUERIES).  Field updates are single-attribute
stores of scalars, and the registry's dict is guarded by its own lock.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

#: terminal states; everything else is live
_TERMINAL = ("done", "failed", "cancelled")


class LiveQuery:
    """Mutable live-state record of one admitted query."""

    __slots__ = (
        "qid", "sql", "tenant", "priority_class", "ticket", "trace",
        "submitted_wall", "submitted_perf", "state", "stage", "rung",
        "family", "fingerprint", "batch_role", "batch_size",
        "stream_partitions_total", "stream_partitions_done",
        "stream_rows_total", "stream_rows_done", "stream_chunk_rows",
        "measured_bytes", "error_code", "finished_perf",
    )

    def __init__(self, qid: str, sql: Optional[str] = None, ticket=None,
                 trace=None, tenant: str = "",
                 priority_class: str = "interactive"):
        self.qid = qid
        self.sql = (sql or "").strip()[:500]
        self.tenant = tenant
        self.priority_class = priority_class
        self.ticket = ticket
        self.trace = trace
        self.submitted_wall = time.time()
        self.submitted_perf = time.perf_counter()
        self.state = "queued"
        self.stage: Optional[str] = None
        self.rung: Optional[str] = None
        self.family: Optional[str] = None
        self.fingerprint: Optional[str] = None
        self.batch_role: Optional[str] = None  # "leader" / "member"
        self.batch_size: Optional[int] = None
        self.stream_partitions_total: Optional[int] = None
        self.stream_partitions_done: Optional[int] = None
        self.stream_rows_total: Optional[int] = None
        self.stream_rows_done: Optional[int] = None
        self.stream_chunk_rows: Optional[int] = None
        self.measured_bytes: Optional[int] = None
        self.error_code: Optional[str] = None
        self.finished_perf: Optional[float] = None

    # ------------------------------------------------------------- derived
    def reserved_bytes(self) -> Optional[int]:
        """What the packing scheduler reserved for this query (the cost's
        provable floor — per-chunk for streamed plans), None when it
        submitted without a cost hint."""
        cost = getattr(self.ticket, "cost", None)
        if cost is None:
            return None
        try:
            return int(cost.reserve_bytes())
        except (TypeError, ValueError, AttributeError):
            return None

    def deadline_remaining_ms(self) -> Optional[int]:
        remaining = None
        if self.ticket is not None:
            remaining = self.ticket.remaining_s()
        return None if remaining is None else int(remaining * 1000)

    def elapsed_ms(self) -> int:
        end = self.finished_perf if self.finished_perf is not None \
            else time.perf_counter()
        return int((end - self.submitted_perf) * 1000)

    def cancelled_flag(self) -> bool:
        return bool(self.ticket is not None and self.ticket.cancelled)

    # -------------------------------------------------------------- export
    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready snapshot for ``GET /v1/queries``."""
        out: Dict[str, Any] = {
            "qid": self.qid,
            "state": self.state,
            "class": self.priority_class,
            "tenant": self.tenant or None,
            "stage": self.stage,
            "rung": self.rung,
            "family": self.family,
            "fingerprint": self.fingerprint,
            "batchRole": self.batch_role,
            "batchSize": self.batch_size,
            "reservedBytes": self.reserved_bytes(),
            "measuredBytes": self.measured_bytes,
            "deadlineRemainingMs": self.deadline_remaining_ms(),
            "elapsedMs": self.elapsed_ms(),
            "cancelRequested": self.cancelled_flag(),
            "errorCode": self.error_code,
            "submitted": self.submitted_wall,
            "sql": self.sql,
        }
        if self.stream_partitions_total is not None:
            out["stream"] = {
                "partitionsDone": self.stream_partitions_done or 0,
                "partitionsTotal": self.stream_partitions_total,
                "rowsDone": self.stream_rows_done or 0,
                "rowsTotal": self.stream_rows_total,
                "chunkRows": self.stream_chunk_rows,
            }
        return out

    def fields(self) -> List[Tuple[str, str]]:
        """The populated (field, value) pairs — one ``SHOW QUERIES`` row
        each, in a stable, operator-meaningful order."""
        out: List[Tuple[str, str]] = [
            ("state", self.state),
            ("class", self.priority_class),
        ]
        if self.tenant:
            out.append(("tenant", self.tenant))
        if self.stage:
            out.append(("stage", self.stage))
        if self.rung:
            out.append(("rung", self.rung))
        if self.family:
            out.append(("family", self.family))
        if self.batch_role:
            out.append(("batch", f"{self.batch_role} x{self.batch_size}"
                        if self.batch_size else self.batch_role))
        if self.stream_partitions_total is not None:
            out.append(("stream.partitions",
                        f"{self.stream_partitions_done or 0}"
                        f"/{self.stream_partitions_total}"))
            if self.stream_rows_total is not None:
                out.append(("stream.rows",
                            f"{self.stream_rows_done or 0}"
                            f"/{self.stream_rows_total}"))
            if self.stream_chunk_rows is not None:
                out.append(("stream.chunk_rows",
                            str(self.stream_chunk_rows)))
        reserved = self.reserved_bytes()
        if reserved is not None:
            out.append(("reserved_bytes", str(reserved)))
        if self.measured_bytes is not None:
            out.append(("measured_bytes", str(self.measured_bytes)))
        deadline = self.deadline_remaining_ms()
        if deadline is not None:
            out.append(("deadline_remaining_ms", str(deadline)))
        out.append(("elapsed_ms", str(self.elapsed_ms())))
        if self.cancelled_flag():
            out.append(("cancel_requested", "true"))
        if self.error_code:
            out.append(("error", self.error_code))
        if self.sql:
            out.append(("sql", self.sql))
        return out


class QueryRegistry:
    """qid -> LiveQuery table: every in-flight query plus a bounded tail of
    recently finished ones (so a just-completed query is still inspectable
    in the poll that observes its completion)."""

    def __init__(self, keep_finished: int = 64):
        self.keep_finished = max(0, int(keep_finished))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, LiveQuery]" = OrderedDict()
        self._finished: List[str] = []

    # ------------------------------------------------------------ lifecycle
    def begin(self, qid: str, sql: Optional[str] = None, ticket=None,
              trace=None, tenant: str = "",
              priority_class: str = "interactive") -> LiveQuery:
        entry = LiveQuery(qid, sql=sql, ticket=ticket, trace=trace,
                          tenant=tenant, priority_class=priority_class)
        with self._lock:
            self._entries[qid] = entry
        return entry

    def start(self, qid: str) -> None:
        entry = self.get(qid)
        if entry is not None and entry.state == "queued":
            entry.state = "running"

    def finish(self, qid: str, state: str = "done",
               error_code: Optional[str] = None) -> None:
        """Mark terminal (idempotent: the first terminal state wins) and
        evict the oldest finished entries past the bound."""
        with self._lock:
            entry = self._entries.get(qid)
            if entry is None or entry.state in _TERMINAL:
                return
            entry.state = state if state in _TERMINAL else "done"
            entry.error_code = error_code
            entry.finished_perf = time.perf_counter()
            self._finished.append(qid)
            while len(self._finished) > self.keep_finished:
                self._entries.pop(self._finished.pop(0), None)
        if entry.state == "done":
            # failures/cancels record their own richer events (query.fail
            # via the flush hook, query.cancel at the request site)
            from . import flight

            flight.record("query.finish", qid=qid,
                          elapsed_ms=entry.elapsed_ms())

    def discard(self, qid: str) -> None:
        """Remove an entry that was never admitted (a shed submit): a
        rejected query must not occupy the live table."""
        with self._lock:
            self._entries.pop(qid, None)

    # ------------------------------------------------------------- queries
    def get(self, qid: str) -> Optional[LiveQuery]:
        with self._lock:
            return self._entries.get(qid)

    def cancel(self, qid: str) -> bool:
        """Cooperative cancel: flag the entry's ticket so the executor's
        next checkpoint (per plan node; between streamed launches) raises.
        True when a live entry with a ticket was flagged."""
        entry = self.get(qid)
        if entry is None or entry.state in _TERMINAL:
            return False
        if entry.ticket is None:
            return False
        entry.ticket.cancel()
        return True

    def live_entries(self) -> List[LiveQuery]:
        with self._lock:
            return [e for e in self._entries.values()
                    if e.state not in _TERMINAL]

    def entries(self) -> List[LiveQuery]:
        with self._lock:
            return list(self._entries.values())

    def inflight_measured_bytes(self) -> int:
        """Sum of the MEASURED footprints live queries have reported so far
        — the ledger's measured-vs-reserved reconciliation input."""
        return sum(e.measured_bytes or 0 for e in self.live_entries())

    def rows(self) -> List[Tuple[str, str, str]]:
        """(Qid, Field, Value) triples — the ``SHOW QUERIES`` result shape
        (live queries first, newest-finished tail after)."""
        entries = self.entries()
        entries.sort(key=lambda e: (e.state in _TERMINAL, e.submitted_perf))
        out: List[Tuple[str, str, str]] = []
        for e in entries:
            out.extend((e.qid, f, v) for f, v in e.fields())
        return out

    def snapshot(self) -> List[Dict[str, Any]]:
        entries = self.entries()
        entries.sort(key=lambda e: (e.state in _TERMINAL, e.submitted_perf))
        return [e.as_dict() for e in entries]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ---------------------------------------------------------------------------
# activation scope: the entry of the query running on this thread
# ---------------------------------------------------------------------------
_current: "contextvars.ContextVar[Optional[LiveQuery]]" = \
    contextvars.ContextVar("dsql_live_query", default=None)


def current_live() -> Optional[LiveQuery]:
    return _current.get()


@contextlib.contextmanager
def activate(entry: Optional[LiveQuery]):
    token = _current.set(entry)
    try:
        yield entry
    finally:
        _current.reset(token)


def update(**fields) -> None:
    """Set fields on the current thread's live entry; no-op without one —
    instrumented engine layers (ladder, batcher, streaming loop) call this
    unconditionally."""
    entry = _current.get()
    if entry is None:
        return
    for name, value in fields.items():
        setattr(entry, name, value)
