"""Admission control: bounded per-class queues, deadlines, load shedding.
(A copy of `dask_sql_tpu/serving/admission.py`: the estimated-bytes gate
routes an over-budget plan to partitioned streaming (streaming/), and in
the pressure controller's CRITICAL band streams or sheds new admissions.)

Two concurrency classes: ``interactive`` (dashboards, point lookups:
scheduled first) and ``batch`` (reports, ETL: capped so it can never
starve interactive traffic).  Each class has a bounded *waiting* queue; a
submit past the bound is rejected at once with a structured retry-after
error (`QueueFullError`) instead of queueing unbounded work.

Deadlines propagate as a `QueryTicket` that the executor polls at
cooperative checkpoints (`physical/executor.py` checks the current ticket
before the one-kernel fast path and before every plan node): a query past
its deadline or cancelled raises out of the next checkpoint.  Work already
queued on the card by the node that was running still runs.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from ..runtime import locks

from ..resilience.errors import (
    INSUFFICIENT_RESOURCES,
    CancelledError,
    DeadlineError,
    QueryError,
    ResourceExhaustedError,
)

#: scheduling order — lower runs first
CLASSES = ("interactive", "batch")

RETRY_AFTER_CAP_KEY = "serving.retry_after.cap_s"


def retry_after_cap(config=None) -> float:
    """The ceiling every Retry-After hint is clamped to
    (``serving.retry_after.cap_s``, default 60 s): a pathological backlog
    estimate must never tell clients to go away for an hour.  The port has
    no process-wide config, so without ``config`` the default holds."""
    if config is None:
        return 60.0
    try:
        cap = float(config.get(RETRY_AFTER_CAP_KEY, 60.0))
    except (TypeError, ValueError):
        return 60.0
    return cap if cap > 0 else 60.0


class QueueFullError(QueryError):
    """Load shed: the class queue is at its bound; retry after a delay.
    Taxonomy: retryable (the hint says when), INSUFFICIENT_RESOURCES."""

    code = "QUERY_QUEUE_FULL"
    error_type = INSUFFICIENT_RESOURCES
    retryable = True

    def __init__(self, priority_class: str, bound: int, retry_after_s: float):
        super().__init__(
            f"admission queue for class {priority_class!r} is full "
            f"({bound} waiting); retry after {retry_after_s:.1f}s")
        self.priority_class = priority_class
        self.bound = bound
        self.retry_after_s = retry_after_s


class EstimatedBytesExceededError(ResourceExhaustedError):
    """Pre-compile OOM gate: the static estimator's PROVABLE lower bound on
    peak device bytes exceeds the admission budget, so executing could only
    OOM — the query is shed before any compilation or device work.

    Taxonomy: non-retryable (the proof holds until the catalog or the
    query changes) and non-degradable (lower rungs share the same device;
    at serving scale, shedding beats a doomed attempt-and-degrade)."""

    code = "ESTIMATED_BYTES_EXCEEDED"
    error_type = INSUFFICIENT_RESOURCES
    retryable = False
    degradable = False

    def __init__(self, estimated_bytes_lo: int, budget_bytes: int):
        super().__init__(
            f"estimated peak device bytes >= {estimated_bytes_lo} "
            f"provably exceed the admission budget of {budget_bytes} bytes "
            f"(serving.admission.max_estimated_bytes); query shed before "
            f"compilation")
        self.estimated_bytes_lo = int(estimated_bytes_lo)
        self.budget_bytes = int(budget_bytes)

    def payload(self) -> dict:
        # clients/load balancers see the proof (estimator lower bound vs
        # budget) on the wire instead of a bare message
        out = super().payload()
        out["estimatedBytesLow"] = self.estimated_bytes_lo
        out["budgetBytes"] = self.budget_bytes
        return out


def check_estimated_bytes(estimate, config, metrics=None, plan=None,
                          context=None):
    """The ``serving.admission.max_estimated_bytes`` gate, the reference's:
    when the estimate's *lower* bound on peak device bytes exceeds the
    budget, route the plan to partitioned streaming where it can run in
    partitions (`streaming.stream_decision`: returns ``(streamable node,
    StreamDecision)``, which the caller hands to ITS executor), and shed
    with `EstimatedBytesExceededError` only when even one partition
    provably cannot fit.  Returns None when the query is simply admitted.
    Called by ``TorchFrame.execute`` after the result-cache lookup and
    before any executor work; only the lower bound, which is provable,
    decides.

    It is also the per-query step of the pressure controller
    (resilience/pressure.py): ``pressure.evaluate()`` reclaims in the RED
    band, and in the CRITICAL band even an under-budget plan is routed to
    the streamed rungs, sized to the device budget, where it can be, and
    shed with a retryable, drain-predicted `PressureShedError` where it
    cannot."""
    from ..config import parse_byte_budget

    budget = None if config is None else parse_byte_budget(
        config.get("serving.admission.max_estimated_bytes"))
    pressure = getattr(context, "pressure", None) if context is not None \
        else None
    critical = pressure is not None and pressure.evaluate() == "critical"
    if (budget is None and not critical) or estimate is None:
        return None
    lo = int(estimate.peak_bytes.lo)
    over = budget is not None and lo > budget
    if not over and not critical:
        return None
    from ..observability import flight, trace_event
    from .runtime import current_ticket

    stream_budget = budget
    if stream_budget is None and pressure is not None:
        stream_budget = pressure.budget_bytes()
    if plan is not None and context is not None \
            and stream_budget is not None:
        from ..streaming import stream_decision

        routed = stream_decision(plan, estimate, context, config,
                                 stream_budget)
        if routed is not None:
            _, decision = routed
            if metrics is not None:
                metrics.inc("serving.stream.admitted")
                if critical and not over:
                    metrics.inc("resilience.pressure.critical_streamed")
            trace_event("admit:streamed", bytes_lo=lo,
                        budget=stream_budget, critical=critical,
                        partitions=decision.partitions,
                        chunk_bytes_lo=decision.chunk_bytes_lo)
            return routed
    ticket = current_ticket()
    if not over:
        # CRITICAL with no streamed rung to run on: shed with a
        # drain-predicted retry hint
        from ..resilience.pressure import PressureShedError

        retry = 1.0 if config is None else float(
            config.get("serving.retry_after_s", 1.0) or 1.0)
        runtime = getattr(context, "serving", None)
        drain = runtime._predicted_drain_s() if runtime is not None else None
        if drain is not None and drain > retry:
            retry = drain
        retry = min(retry_after_cap(config), retry)
        if metrics is not None:
            metrics.inc("resilience.pressure.critical_shed")
        trace_event("shed:pressure", bytes_lo=lo, retry_after_s=retry)
        flight.record("query.shed",
                      qid=ticket.qid if ticket is not None else None,
                      reason="pressure", bytes_lo=lo)
        raise PressureShedError(
            f"device memory pressure is CRITICAL and the plan has no "
            f"streamed rung; retry after {retry:.1f}s",
            retry_after_s=retry)
    if metrics is not None:
        metrics.inc("serving.shed_estimated_bytes")
    trace_event("shed:estimated_bytes", bytes_lo=lo, budget=budget)
    flight.record("query.shed",
                  qid=ticket.qid if ticket is not None else None,
                  reason="estimated_bytes", bytes_lo=lo, budget=budget)
    raise EstimatedBytesExceededError(lo, budget)


class DeadlineExceededError(DeadlineError):
    """The query ran past its deadline and was cancelled at a checkpoint."""


class QueryCancelledError(CancelledError):
    """The client cancelled the query; raised at the next checkpoint."""


class QueryTicket:
    """Per-admitted-query token: class, deadline, cooperative cancel flag.

    `checkpoint()` is the only method hot code calls — it is lock-free
    (reads a bool + the clock) so the executor can afford one per plan node.
    """

    __slots__ = ("qid", "priority_class", "deadline", "admitted_at",
                 "started_at", "_cancelled", "cost", "measured_bytes",
                 "queue_reason")

    def __init__(self, qid: str, priority_class: str = "interactive",
                 deadline: Optional[float] = None):
        self.qid = qid
        self.priority_class = priority_class
        #: absolute monotonic deadline (None = unbounded)
        self.deadline = deadline
        self.admitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self._cancelled = False
        #: why this query waited in the queue, stamped at dispatch by the
        #: packing scheduler (``byte_blocked`` / ``quota_throttled``) or
        #: defaulted to ``workers_busy`` — the queue_wait span's cause
        #: attribution the slow-query log surfaces
        self.queue_reason: Optional[str] = None
        #: the packing scheduler's `QueryCost` (serving/scheduler.py) when
        #: the submit carried one — rides the ticket so the executing
        #: thread (family batcher, metrics) can see its own cost view
        self.cost = None
        #: MEASURED footprint bytes of the finished execution (result +
        #: scanned-table resident bytes, `serving/cache.table_nbytes`
        #: accounting), recorded by TorchFrame.execute so the packing
        #: scheduler can reconcile its reservation on release
        #: (``serving.scheduler.reserve_drift``)
        self.measured_bytes = None

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    def remaining_s(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def checkpoint(self) -> None:
        """Raise if this query should stop; called from executor hot paths."""
        if self._cancelled:
            raise QueryCancelledError(f"query {self.qid} cancelled")
        if self.expired():
            raise DeadlineExceededError(
                f"query {self.qid} exceeded its deadline")


class AdmissionController:
    """Bounded admission per concurrency class.

    Tracks waiting/running counts; `admit` either returns a ticket or
    sheds load with `QueueFullError`.  The retry-after hint scales with the
    observed average latency and current backlog so shed clients spread out
    instead of synchronizing their retries.
    """

    def __init__(self, bounds: Dict[str, int], workers: int,
                 retry_after_s: float = 1.0, metrics=None,
                 retry_cap_s: float = 60.0):
        self.bounds = {c: int(bounds.get(c, 32)) for c in CLASSES}
        self.workers = max(1, int(workers))
        self.retry_after_s = float(retry_after_s)
        #: ``serving.retry_after.cap_s`` (`retry_after_cap`)
        self.retry_cap_s = float(retry_cap_s)
        self.metrics = metrics
        # rank 45: taken from under the runtime's cv (rank 40) on the
        # shed path; only leaf work (counter math, metrics) happens here
        self._lock = locks.named_lock("serving.admission")
        self.waiting = {c: 0 for c in CLASSES}
        self.running = {c: 0 for c in CLASSES}
        self._latency_sum = 0.0
        self._latency_n = 0

    # ------------------------------------------------------------ lifecycle
    def admit(self, qid: str, priority_class: str = "interactive",
              deadline_s: Optional[float] = None) -> QueryTicket:
        if priority_class not in self.bounds:
            # unknown class names (typo'd header, future class) fall back to
            # the documented default rather than silently demoting to batch
            priority_class = "interactive"
        with self._lock:
            bound = self.bounds[priority_class]
            if self.waiting[priority_class] >= bound:
                retry = self._retry_after_locked(priority_class)
                if self.metrics is not None:
                    self.metrics.inc("serving.rejected")
                    self.metrics.inc(f"serving.rejected.{priority_class}")
                raise QueueFullError(priority_class, bound, retry)
            self.waiting[priority_class] += 1
            if self.metrics is not None:
                self.metrics.inc("serving.admitted")
                self.metrics.inc(f"serving.admitted.{priority_class}")
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        return QueryTicket(qid, priority_class, deadline)

    def on_start(self, ticket: QueryTicket) -> None:
        ticket.started_at = time.monotonic()
        with self._lock:
            self.waiting[ticket.priority_class] -= 1
            self.running[ticket.priority_class] += 1
        if self.metrics is not None:
            self.metrics.observe(
                "serving.queue_wait_ms",
                (ticket.started_at - ticket.admitted_at) * 1000.0)

    def on_finish(self, ticket: QueryTicket, started: bool = True) -> None:
        now = time.monotonic()
        with self._lock:
            if started:
                self.running[ticket.priority_class] -= 1
                self._latency_sum += now - ticket.admitted_at
                self._latency_n += 1
            else:
                # never ran (cancelled / expired while queued)
                self.waiting[ticket.priority_class] -= 1

    # ------------------------------------------------------------- queries
    def depth(self, priority_class: Optional[str] = None) -> int:
        with self._lock:
            if priority_class is not None:
                return self.waiting[priority_class]
            return sum(self.waiting.values())

    def _retry_after_locked(self, priority_class: str) -> float:
        avg = self._latency_sum / self._latency_n if self._latency_n else 0.0
        backlog = sum(self.waiting.values()) + sum(self.running.values())
        est = avg * backlog / self.workers if avg else self.retry_after_s
        return min(self.retry_cap_s, max(self.retry_after_s, est))

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "bounds": dict(self.bounds),
                "waiting": dict(self.waiting),
                "running": dict(self.running),
                "avgLatencyMillis": int(
                    self._latency_sum / self._latency_n * 1000)
                if self._latency_n else 0,
            }
