"""ServingRuntime: the worker pool queries run on.
(A copy of `dask_sql_tpu/serving/runtime.py`: the warm-up pass and the
background recompiler register with it, and its shutdown drains them.)

Class-aware scheduling over the admission controller:

- ``interactive`` work is always popped first;
- ``batch`` work runs only while fewer than ``batch_max_running`` batch
  queries are in flight, so a burst of reports cannot occupy every worker;
- a submit past the class queue bound raises `QueueFullError` *in the
  submitting thread*;
- each admitted query carries a `QueryTicket`; while the query runs, the
  ticket is installed in a thread-local that `physical/executor.py` polls
  at its checkpoints, so deadline expiry and cancels take effect between
  plan nodes instead of after the fact.

Every worker launches on PyTorch's default stream of the card, so the
card runs one query's kernels after another's in the order they were
queued; the host work of one query (planning, decode, the transfer's wait)
overlaps the card's work for another.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, Optional, Tuple

from ..resilience.errors import ShutdownError
from ..runtime import locks
from ..resilience.retry import BackoffPolicy, retry_call
from .admission import (
    CLASSES,
    AdmissionController,
    DeadlineExceededError,
    QueryCancelledError,
    QueryTicket,
)
from .metrics import MetricsRegistry
from .scheduler import PackingScheduler, QueryCost

logger = logging.getLogger(__name__)

_tls = threading.local()


def _resolve(fut: Future, result=None, exc: Optional[BaseException] = None,
             ) -> bool:
    """Set a future's outcome, tolerating a future someone else already
    resolved — the bounded-drain deadline (shutdown) and a replica kill
    (fleet/replica.py) both fail in-flight futures from OUTSIDE the worker
    thread, and the worker's own completion must then be a no-op instead
    of an InvalidStateError crash.  Returns False when the future was
    already resolved."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except InvalidStateError:
        return False


def current_ticket() -> Optional[QueryTicket]:
    """The ticket of the query running on this thread, if any — the
    executor's cancellation checkpoints poll this."""
    return getattr(_tls, "ticket", None)


@contextlib.contextmanager
def ticket_scope(ticket: QueryTicket):
    """Install ``ticket`` as this thread's current ticket for the dynamic
    extent.  The serving workers install tickets directly; this scope is
    for executions OUTSIDE the worker pool (the Context API path), so
    ``CANCEL QUERY`` on their live-registry entry reaches the executor's
    cooperative checkpoints too."""
    prev = getattr(_tls, "ticket", None)
    _tls.ticket = ticket
    try:
        yield ticket
    finally:
        _tls.ticket = prev


class ServingRuntime:
    def __init__(self, workers: int = 8,
                 bounds: Optional[Dict[str, int]] = None,
                 batch_max_running: Optional[int] = None,
                 retry_after_s: float = 1.0,
                 default_deadline_s: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 retry_policy: Optional[BackoffPolicy] = None,
                 batch_queries: int = 8,
                 batch_window_ms: float = 2.0,
                 scheduler_enabled: bool = True,
                 scheduler_budget_bytes: Optional[int] = None,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: float = 4.0,
                 fair_horizon_s: float = 30.0,
                 drain_timeout_s: float = 30.0,
                 retry_cap_s: float = 60.0):
        self.workers = max(1, int(workers))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        #: backoff policy for taxonomy-retryable failures (resilience/retry.py)
        self.retry_policy = retry_policy if retry_policy is not None \
            else BackoffPolicy()
        self.admission = AdmissionController(
            bounds or {"interactive": 32, "batch": 64}, self.workers,
            retry_after_s=retry_after_s, metrics=self.metrics,
            retry_cap_s=retry_cap_s)
        from ..families.batcher import FamilyBatcher

        #: family batcher (families/batcher.py): concurrently admitted
        #: same-family queries coalesce into one stacked kernel launch.
        #: The busy probe gates the leader's rendezvous window on OTHER
        #: queries actually being in flight, so idle traffic pays nothing.
        self.batcher = FamilyBatcher(
            max_queries=batch_queries, window_ms=batch_window_ms,
            metrics=self.metrics, busy=self._others_in_flight,
            mates=self._family_mates)
        # 0 is a legitimate setting (pause batch entirely), so only None
        # falls back to the workers-1 default
        self.batch_max_running = int(batch_max_running) \
            if batch_max_running is not None else max(1, self.workers - 1)
        self.default_deadline_s = default_deadline_s
        self._queues: Dict[str, deque] = {c: deque() for c in CLASSES}
        #: the packing scheduler (serving/scheduler.py) replaces the FIFO
        #: deques when enabled; its state is guarded by `_cv`, never a lock
        #: of its own.  Disabled (`serving.scheduler.enabled=false`) the
        #: deques above keep today's FIFO behavior byte-for-byte.
        self.scheduler: Optional[PackingScheduler] = PackingScheduler(
            budget_bytes=scheduler_budget_bytes,
            tenant_rate=tenant_rate, tenant_burst=tenant_burst,
            fair_horizon_s=fair_horizon_s,
            metrics=self.metrics) if scheduler_enabled else None
        # rank 40: held while calling admission.on_finish (rank 45) on
        # the shed path, so cv-before-admission is the declared order
        self._cv = locks.named_condition("serving.runtime.cv")
        #: batch queries popped-but-not-finished, owned by _cv (admission's
        #: running counter is updated later under its own lock, so checking
        #: it from _pop_locked would let a burst overshoot the cap)
        self._batch_in_flight = 0
        #: bound on shutdown(wait=True)'s drain: past it, still-running
        #: queries are cancelled and their futures failed with a retryable
        #: ShutdownError instead of the drain hanging forever
        self.drain_timeout_s = max(0.0, float(drain_timeout_s))
        #: in-flight (popped, running) work: qid -> (ticket, future),
        #: owned by _cv — what the bounded drain fails at its deadline and
        #: a replica kill (fleet/replica.py) fails immediately
        self._inflight: Dict[str, Tuple[QueryTicket, Future]] = {}
        self._shutdown = False
        #: the warm-up pass and the background recompiler
        #: (`register_background`), cancelled and joined at shutdown
        self._background: list = []
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"dsql-serving-{i}")
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()

    @classmethod
    def from_config(cls, config, metrics=None) -> "ServingRuntime":
        """Build from the ``serving.*`` keys (see config.py docstrings)."""
        from ..config import parse_byte_budget

        # the packer's budget: its own key when set, else the admission
        # gate's byte budget (one budget is the common deployment; a
        # separate scheduler budget exists for packing tighter or looser
        # than the shed threshold)
        budget = parse_byte_budget(
            config.get("serving.scheduler.device_budget_bytes"))
        if budget is None:
            budget = parse_byte_budget(
                config.get("serving.admission.max_estimated_bytes"))
        rate = config.get("serving.tenant.rate_qps")
        from .admission import retry_after_cap

        return cls(
            retry_cap_s=retry_after_cap(config),
            workers=int(config.get("serving.workers", 8)),
            bounds={
                "interactive": int(config.get("serving.queue.interactive", 32)),
                "batch": int(config.get("serving.queue.batch", 64)),
            },
            batch_max_running=config.get("serving.batch.max_running"),
            retry_after_s=float(config.get("serving.retry_after_s", 1.0)),
            default_deadline_s=config.get("serving.deadline_s"),
            metrics=metrics,
            retry_policy=BackoffPolicy.from_config(config),
            batch_queries=int(config.get("serving.batch.max_queries", 8) or 1),
            batch_window_ms=float(
                config.get("serving.batch.window_ms", 2.0) or 0.0),
            scheduler_enabled=bool(
                config.get("serving.scheduler.enabled", True)),
            scheduler_budget_bytes=budget,
            tenant_rate=None if rate is None else float(rate),
            tenant_burst=float(config.get("serving.tenant.burst", 4.0)),
            fair_horizon_s=float(
                config.get("serving.scheduler.fair_horizon_s", 30.0)),
            drain_timeout_s=float(
                config.get("serving.shutdown.drain_timeout_s", 30.0)),
        )

    def _others_in_flight(self) -> bool:
        """True when any OTHER query is admitted right now (running on a
        worker or still waiting in a class queue) — the only situation
        where a batch leader's rendezvous window can pay off.  Waiting
        queries count: a burst submits faster than workers wake, so an
        early leader would otherwise see running == 1 and skip the window
        its own batch-mates are about to fill."""
        with self.admission._lock:
            return (sum(self.admission.running.values())
                    + sum(self.admission.waiting.values())) > 1

    def _family_mates(self) -> int:
        """How many OTHER admitted queries share the calling thread's plan
        family — the packer's co-scheduling knowledge, handed to the family
        batcher so a leader whose batch-mates were packed alongside it
        waits the rendezvous window with certainty instead of relying on
        the in-flight heuristic.  0 when the scheduler is off or the
        current query submitted without a family cost hint."""
        if self.scheduler is None:
            return 0
        ticket = current_ticket()
        cost = getattr(ticket, "cost", None) if ticket is not None else None
        if cost is None or not cost.family:
            return 0
        with self._cv:
            return self.scheduler.family_mates_locked(
                cost.family, exclude_qid=ticket.qid)

    # -------------------------------------------------------------- submit
    def submit(self, fn: Callable[[QueryTicket], object],
               qid: Optional[str] = None,
               priority_class: str = "interactive",
               deadline_s: Optional[float] = None,
               cost: Optional[QueryCost] = None,
               ) -> Tuple[str, Future, QueryTicket]:
        """Admit and enqueue `fn(ticket)`; raises `QueueFullError` when the
        class queue is at its bound (load shedding, never blocks).

        ``cost`` is the packing scheduler's view of the query (provable
        peak-byte floor, predicted exec, tenant, family); None degrades to
        the zero cost — FIFO-equivalent treatment, no reservation."""
        if self._shutdown:
            raise ShutdownError("serving runtime is shut down")
        from .admission import QueueFullError

        from ..observability import flight

        if priority_class == "batch" and self.batch_max_running == 0:
            # batch is paused: shed immediately instead of admitting work
            # that no worker would ever pop (client would hang in QUEUED)
            self.metrics.inc("serving.rejected")
            self.metrics.inc("serving.rejected.batch")
            flight.record("query.shed", qid=qid, reason="batch_paused")
            raise QueueFullError("batch", 0, self.admission.retry_after_s)
        qid = qid or str(uuid.uuid4())
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        try:
            ticket = self.admission.admit(qid, priority_class, deadline_s)
        except QueueFullError as e:
            flight.record("query.shed", qid=qid, reason="queue_full",
                          cls=priority_class)
            drain = self._predicted_drain_s()
            if drain is not None and drain > e.retry_after_s:
                # the scheduler predicts the drain from running queries'
                # remaining predicted exec + the queued backlog — a better
                # hint than the admission controller's latency average
                raise QueueFullError(e.priority_class, e.bound,
                                     min(self.admission.retry_cap_s,
                                         drain)) from None
            raise
        try:
            ticket.cost = cost
            flight.record("query.admit", qid=qid, cls=priority_class,
                          tenant=(cost.tenant or None) if cost is not None
                          else None)
            fut: Future = Future()
            with self._cv:
                if self._shutdown:
                    # lost the race with a concurrent shutdown(): enqueueing
                    # now would strand the future (the drain already ran)
                    raise ShutdownError("serving runtime is shut down")
                if self.scheduler is not None:
                    self.scheduler.push_locked(ticket, fn, fut, cost)
                else:
                    self._queues[ticket.priority_class].append(
                        (ticket, fn, fut))
                self._cv.notify()
        except BaseException:
            # admitted but never reached the queue (push_locked validation,
            # the shutdown race, even a flight-recorder failure): undo the
            # admission charge exactly once, or depth/byte accounting leaks
            # until restart
            self.admission.on_finish(ticket, started=False)
            raise
        return qid, fut, ticket

    def _predicted_drain_s(self) -> Optional[float]:
        if self.scheduler is None:
            return None
        with self._cv:
            return self.scheduler.predicted_drain_s(self.workers)

    # -------------------------------------------------------------- workers
    def _pop_locked(self):
        if self.scheduler is not None:
            item = self.scheduler.pop_locked(
                batch_ok=self._batch_in_flight < self.batch_max_running)
            if item is not None and item[0].priority_class == "batch":
                self._batch_in_flight += 1
            return item
        q = self._queues["interactive"]
        if q:
            return q.popleft()
        q = self._queues["batch"]
        if q and self._batch_in_flight < self.batch_max_running:
            self._batch_in_flight += 1
            return q.popleft()
        return None

    def _worker(self):
        while True:
            with self._cv:
                # conditional pop: a None result acquires nothing; a
                # non-None item's reservation is released by the
                # try/finally below — path-correlated, which the CFG
                # proof cannot see
                # dsql: allow-unpaired-effect — released by _release below
                item = self._pop_locked()
                while item is None and not self._shutdown:
                    self._cv.wait()
                    # dsql: allow-unpaired-effect — same conditional pop
                    item = self._pop_locked()
                if item is None:  # shutdown with a drained queue
                    return
            ticket, fn, fut = item
            try:
                self._run_one(ticket, fn, fut)
            finally:
                # the batch slot and the packer's byte reservation are
                # freed on EVERY outcome — including a bug between pop and
                # execution, which previously leaked the reservation and
                # killed the worker thread
                self._release(ticket)

    def _run_one(self, ticket: QueryTicket, fn, fut: Future) -> None:
        """Run one popped item to a terminal state: admission accounting,
        cancellation/expiry checks, taxonomy-aware retry, future
        resolution.  The caller owns the scheduler reservation and calls
        `_release` whatever happens here."""
        if not fut.set_running_or_notify_cancel():
            # cancelled while queued through Future.cancel()
            self.admission.on_finish(ticket, started=False)
            self.metrics.inc("serving.cancelled")
            return
        if ticket.cancelled or ticket.expired():
            self.admission.on_finish(ticket, started=False)
            if ticket.cancelled:
                self.metrics.inc("serving.cancelled")
                _resolve(fut, exc=QueryCancelledError(
                    f"query {ticket.qid} cancelled"))
            else:
                self.metrics.inc("serving.timeouts")
                _resolve(fut, exc=DeadlineExceededError(
                    f"query {ticket.qid} expired while queued"))
            return
        if ticket.queue_reason is None:
            # the scheduler stamps byte_blocked/quota_throttled at
            # dispatch; anything else waited only for a free worker
            ticket.queue_reason = "workers_busy"
        self.admission.on_start(ticket)
        with self._cv:
            self._inflight[ticket.qid] = (ticket, fut)
        _tls.ticket = ticket
        try:
            # taxonomy-retryable failures (transient device/runtime
            # errors) are retried here with backoff, bounded by the
            # ticket's deadline; everything else surfaces on first throw
            result = retry_call(lambda: fn(ticket), self.retry_policy,
                                ticket=ticket, metrics=self.metrics)
        except QueryCancelledError as e:
            self.metrics.inc("serving.cancelled")
            _resolve(fut, exc=e)
        except DeadlineExceededError as e:
            self.metrics.inc("serving.timeouts")
            _resolve(fut, exc=e)
        except BaseException as e:  # dsql: allow-broad-except — surfaced via Future
            self.metrics.inc("serving.failed")
            _resolve(fut, exc=e)
        else:
            self.metrics.inc("serving.completed")
            _resolve(fut, result=result)
        finally:
            _tls.ticket = None
            with self._cv:
                self._inflight.pop(ticket.qid, None)
            self.admission.on_finish(ticket)
            if ticket.started_at is not None:
                self.metrics.observe(
                    "serving.latency_ms",
                    (time.monotonic() - ticket.admitted_at) * 1000.0)

    def _release(self, ticket: QueryTicket):
        """Return a popped item's scheduling slot: frees the batch
        running-cap (and the packer's byte reservation — on EVERY outcome,
        including a mid-pack failure) and wakes workers blocked on it."""
        with self._cv:
            if ticket.priority_class == "batch":
                self._batch_in_flight -= 1
            if self.scheduler is not None:
                # reconcile the reservation with the measured footprint
                # the executing thread recorded (None when it never ran)
                self.scheduler.release_locked(
                    ticket, getattr(ticket, "measured_bytes", None))
            self._cv.notify_all()

    # ------------------------------------------------------------ lifecycle
    def fail_inflight(self, exc_factory) -> int:
        """Fail every in-flight (popped, running) query's future NOW with
        ``exc_factory(ticket)`` and cancel its ticket — the replica-kill
        path (fleet/replica.py): a killed process resolves nothing, so the
        router must see its dispatched futures fail immediately instead of
        waiting out a result timeout.  The worker threads still unwind
        their (now-orphaned) executions; their own completion attempts
        no-op through `_resolve`.  Returns how many futures were failed."""
        with self._cv:
            inflight = list(self._inflight.values())
        failed = 0
        for ticket, fut in inflight:
            ticket.cancel()
            if _resolve(fut, exc=exc_factory(ticket)):
                failed += 1
        return failed

    def register_background(self, worker) -> None:
        """Track a background worker (with ``cancel()`` and
        ``join(timeout)``) so shutdown() drains it with the queues; one
        registered after shutdown is cancelled at once."""
        with self._cv:
            if not self._shutdown:
                self._background.append(worker)
                return
        try:
            worker.cancel()
        except Exception:  # dsql: allow-broad-except — a worker's teardown bug
            # must not propagate
            logger.warning("background worker cancel failed", exc_info=True)

    def shutdown(self, wait: bool = False, timeout: float = 5.0) -> None:
        """Stop accepting work and drain deterministically.

        Queued-but-not-started queries fail immediately with a structured
        (retryable) `ShutdownError` instead of hanging on futures no worker
        will ever pop.  Registered background workers (the warm-up pass,
        the background recompiler) are cancelled too; ``wait=True`` joins
        the worker threads and the background threads.

        The ``wait=True`` drain is BOUNDED by ``drain_timeout_s``
        (``serving.shutdown.drain_timeout_s``): an in-flight query that
        has not finished by the deadline — a stuck row-UDF, a wedged
        device call — has its ticket cancelled and its future failed with
        a retryable `ShutdownError`, so the drain (and every client
        blocked on a drained future) terminates instead of hanging
        forever on work that will never yield."""
        drained = []
        with self._cv:
            self._shutdown = True
            background = list(self._background)
            for cls in CLASSES:
                q = self._queues[cls]
                while q:
                    drained.append(q.popleft())
            if self.scheduler is not None:
                drained.extend(self.scheduler.drain_all_locked())
            self._cv.notify_all()
        for ticket, _fn, fut in drained:
            self.admission.on_finish(ticket, started=False)
            self.metrics.inc("serving.shutdown_shed")
            if fut.set_running_or_notify_cancel():
                fut.set_exception(ShutdownError(
                    f"query {ticket.qid} shed: serving runtime shutting down"))
        for worker in background:
            try:
                worker.cancel()
            except Exception:  # dsql: allow-broad-except — one worker's
                # teardown bug must not block
                logger.warning("background worker cancel failed",
                               exc_info=True)
        if wait:
            deadline = time.monotonic() + self.drain_timeout_s
            for t in self._threads:
                t.join(max(0.0, deadline - time.monotonic()))
            expired = [t for t in self._threads if t.is_alive()]
            if expired:
                # deadline: cancel the stuck queries cooperatively AND
                # fail their futures — the cancel reaches well-behaved
                # work at its next checkpoint, the future resolution
                # unblocks clients from work that never checkpoints
                n = self.fail_inflight(lambda ticket: ShutdownError(
                    f"query {ticket.qid} shed: drain timeout "
                    f"({self.drain_timeout_s:g}s) expired at shutdown"))
                if n:
                    self.metrics.inc("serving.shutdown_shed", n)
                    logger.warning(
                        "shutdown drain timed out after %gs; failed %d "
                        "in-flight futures with retryable ShutdownError",
                        self.drain_timeout_s, n)
            for worker in background:
                worker.join(timeout)

    def snapshot(self) -> Dict[str, object]:
        adm = self.admission.snapshot()
        with self._cv:
            if self.scheduler is not None:
                queues = {c: self.scheduler.depth_locked(c) for c in CLASSES}
                sched = self.scheduler.snapshot_locked()
            else:
                queues = {c: len(self._queues[c]) for c in CLASSES}
                sched = None
        out = {
            "workers": self.workers,
            "batchMaxRunning": self.batch_max_running,
            "queues": queues,
            "admission": adm,
            "familyBatcher": self.batcher.snapshot(),
        }
        if sched is not None:
            out["scheduler"] = sched
        return out
