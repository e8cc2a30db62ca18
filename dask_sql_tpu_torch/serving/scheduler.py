"""Estimator-driven packing scheduler: device-byte-budget packing,
deadline-aware ordering and per-tenant token-bucket quotas.
(A copy of `dask_sql_tpu/serving/scheduler.py`.)

- Each plan family's ``peak_bytes`` interval (analysis/estimator.py)
  gives a provable floor per query, ``lo``: the scheduler packs
  concurrently admitted queries against the card's byte budget
  (``serving.scheduler.device_budget_bytes``), reserving each dispatched
  query's floor and dispatching any query whose floor fits the remainder.
  A query waits only while its floor provably cannot fit; with nothing in
  flight the head query always dispatches (liveness).  ``hi`` is never
  read here.
- Per-family observed exec profiles (observability/profiles.py) give a
  predicted exec ms, used for the drain prediction of the retry-after
  hint.
- Per-tenant token buckets (``serving.tenant.rate_qps`` /
  ``serving.tenant.burst``) bound a greedy tenant's share while other
  tenants have runnable work (work-conserving: quotas reorder, they never
  fail queries).

Locking: the scheduler owns no lock.  Every mutating method is named
``*_locked`` or documented as called under the owning runtime's condition
variable (`ServingRuntime._cv`, sanitizer name "serving.runtime.cv", rank
40 in runtime/locks.py).

``serving.scheduler.enabled = false`` removes this module from the pop
path: the runtime keeps plain FIFO class deques.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .admission import CLASSES, QueryTicket

#: bound on the per-tenant bucket map: the tenant name is a CLIENT-supplied
#: header, so an adversarial (or request-id-misconfigured) client could
#: otherwise grow the dict by one bucket per request for the process
#: lifetime.  At the cap, idle full buckets are pruned first; an evicted
#: active tenant simply restarts with a fresh full bucket (bounded memory
#: beats perfect burst accounting for a hostile key space).
_TENANT_BUCKET_CAP = 1024


@dataclass
class QueryCost:
    """Submit-time cost descriptor of one query — the scheduler's only view
    of the estimator/profile layers, so front-ends that know nothing (a cold
    SQL text, a direct runtime user) submit the zero cost and degrade to
    FIFO-equivalent treatment.

    ``bytes_lo`` is the PROVABLE floor on peak device bytes (the estimate's
    lower bound): it is what the packer reserves, because only it can never
    over-release.  ``pred_exec_ms`` is a prediction (profile feedback
    sharpens it) used for ordering and drain hints only — a wrong
    prediction degrades latency, never safety."""

    bytes_lo: int = 0
    pred_exec_ms: Optional[float] = None
    #: literal-stripped family fingerprint (families/) when known: lets the
    #: packer count same-family batch-mates it co-scheduled, which the
    #: family batcher's rendezvous window consults
    family: Optional[str] = None
    tenant: str = ""
    #: streamed partitioned execution (streaming/): the provable PER-CHUNK
    #: floor.  When set, the packer reserves THIS instead of ``bytes_lo`` —
    #: a streaming batch scan only ever holds one chunk's working set, so
    #: interactive queries keep packing beside it instead of waiting out
    #: the whole-table floor
    chunk_bytes_lo: Optional[int] = None

    def reserve_bytes(self) -> int:
        """What the packer actually reserves for this query."""
        return int(self.chunk_bytes_lo if self.chunk_bytes_lo is not None
                   else self.bytes_lo)


class TokenBucket:
    """Classic token bucket; ``clock`` injectable for deterministic tests."""

    __slots__ = ("rate", "burst", "tokens", "_last", "_clock")

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._clock = clock
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now

    def peek(self) -> bool:
        self._refill()
        return self.tokens >= 1.0

    def take(self) -> bool:
        self._refill()
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclass
class _Item:
    """One queued query; ``seq`` is the FIFO tiebreak within (class,
    deadline) so equal-deadline queries keep submission order."""

    seq: int
    ticket: QueryTicket
    fn: Any
    fut: Any
    cost: QueryCost
    #: byte-budget pass-overs, for the waited counter's once-per-episode
    #: accounting (a 100-pop wait is one wait, not 100)
    waited: bool = False
    throttled: bool = False
    #: when this item first failed the byte-fit check; past fair_horizon_s
    #: it becomes a head-of-line BARRIER (nothing may pack in behind it),
    #: so a stream of small queries cannot starve a big one forever
    blocked_since: float = 0.0


@dataclass
class _Running:
    cost: QueryCost
    started: float
    reserved: int


class PackingScheduler:
    """Byte-budget packing + deadline ordering + tenant quotas.

    Replaces the two FIFO deques when ``serving.scheduler.enabled``.  All
    methods are called under the owning runtime's ``_cv`` lock (see module
    docstring); the runtime still owns worker wakeups, the batch running
    cap, and admission bounds — this class only decides *which* queued
    query a freed worker dispatches next and *whether* it fits."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: float = 4.0,
                 fair_horizon_s: float = 30.0,
                 metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        #: device byte budget packed against (None = packing inactive: the
        #: scheduler still orders by class/deadline/quota, FIFO otherwise)
        self.budget_bytes = budget_bytes
        self.tenant_rate = tenant_rate
        self.tenant_burst = float(tenant_burst)
        #: anti-starvation bound for deadline ordering: a query with no
        #: deadline sorts as if its deadline were admission + this horizon,
        #: so a sustained stream of deadline-bearing queries can delay it
        #: at most ~this long (pure inf ordering would starve it forever)
        self.fair_horizon_s = float(fair_horizon_s)
        self.metrics = metrics
        self._clock = clock
        self._seq = 0
        self._queued: Dict[str, List[_Item]] = {c: [] for c in CLASSES}
        self._running: Dict[str, _Running] = {}  # qid -> record
        self.reserved_bytes = 0
        self._buckets: Dict[str, TokenBucket] = {}
        #: rolling mean of observed pred_exec_ms, the drain-time stand-in
        #: for queries submitted with no prediction
        self._pred_sum = 0.0
        self._pred_n = 0

    # ------------------------------------------------------------ queueing
    def push_locked(self, ticket: QueryTicket, fn, fut,
                    cost: Optional[QueryCost]) -> None:
        self._seq += 1
        item = _Item(self._seq, ticket, fn, fut, cost or QueryCost())
        self._queued[ticket.priority_class].append(item)
        self._gauges()

    def pop_locked(self, batch_ok: bool
                   ) -> Optional[Tuple[QueryTicket, Any, Any]]:
        """Choose the next dispatchable query for a freed worker, or None.

        Sweep 1 considers only tenants holding quota tokens; sweep 2 admits
        the rest (work-conserving: quotas bound a tenant's share only while
        other tenants have runnable work).  Within a sweep: classes in
        priority order, then earliest deadline, then FIFO.  A candidate
        whose provable floor cannot fit the remaining budget is passed over
        (``serving.scheduler.waited``) — unless nothing is in flight, in
        which case the head candidate always dispatches so a lone big query
        can never deadlock behind its own reservation.  A candidate
        byte-blocked for longer than ``fair_horizon_s`` becomes a BARRIER:
        nothing dispatches past it, so in-flight work drains until it fits
        (otherwise a rotating stream of small queries keeps the budget
        partially reserved and starves a big one forever)."""
        now = self._clock()
        throttled: List[_Item] = []
        chosen: Optional[_Item] = None
        barrier = False
        ordered = {cls: sorted(self._queued[cls], key=self._order_key)
                   for cls in CLASSES}
        for require_tokens in (True, False):
            for cls in CLASSES:
                if cls == "batch" and not batch_ok:
                    continue
                for item in ordered[cls]:
                    if item.ticket.cancelled or item.ticket.expired():
                        # dispatch immediately: the worker finalizes these
                        # without running them, freeing admission state fast
                        chosen = item
                        break
                    if require_tokens and not self._has_tokens(item):
                        throttled.append(item)
                        continue
                    if not self._fits(item):
                        if not item.waited:
                            item.waited = True
                            item.blocked_since = now
                            self._inc("serving.scheduler.waited")
                        elif now - item.blocked_since > self.fair_horizon_s:
                            barrier = True
                            break
                        continue
                    chosen = item
                    break
                if chosen is not None or barrier:
                    break
            if chosen is not None or barrier:
                break
        if chosen is None:
            return None
        # a token-less tenant made way for the chosen query: that is the
        # quota actually biting (counted once per item per episode)
        from ..observability import flight

        for item in throttled:
            if item is not chosen and not item.throttled:
                item.throttled = True
                self._inc("serving.scheduler.quota_throttled")
                flight.record("sched.quota_throttle", qid=item.ticket.qid,
                              tenant=item.cost.tenant or None)
        self._dispatch(chosen)
        return chosen.ticket, chosen.fn, chosen.fut

    def _order_key(self, item: _Item) -> Tuple[float, int]:
        # earliest effective deadline first, then FIFO.  The effective
        # deadline of a deadline-free query is admission + fair_horizon_s:
        # real deadlines tighter than the horizon still outrank it, but it
        # cannot be passed over indefinitely
        synthetic = item.ticket.admitted_at + self.fair_horizon_s
        d = item.ticket.deadline
        return (min(d, synthetic) if d is not None else synthetic, item.seq)

    def _has_tokens(self, item: _Item) -> bool:
        if self.tenant_rate is None:
            return True
        bucket = self._buckets.get(item.cost.tenant)
        if bucket is None:
            if len(self._buckets) >= _TENANT_BUCKET_CAP:
                self._prune_buckets_locked()
            bucket = self._buckets[item.cost.tenant] = TokenBucket(
                self.tenant_rate, self.tenant_burst, self._clock)
        return bucket.peek()

    def _prune_buckets_locked(self) -> None:
        """Bound the client-keyed bucket map: drop idle-refilled buckets of
        tenants with no admitted work; if every bucket is active, evict the
        oldest entries outright (they restart full)."""
        live = {item.cost.tenant
                for q in self._queued.values() for item in q}
        live.update(rec.cost.tenant for rec in self._running.values())
        for tenant in [t for t, b in self._buckets.items()
                       if t not in live and b.peek()
                       and b.tokens >= b.burst]:
            del self._buckets[tenant]
        while len(self._buckets) >= _TENANT_BUCKET_CAP:
            self._buckets.pop(next(iter(self._buckets)))

    def _fits(self, item: _Item) -> bool:
        if self.budget_bytes is None:
            return True
        if not self._running:
            # liveness: with nothing in flight the head query always runs.
            # (A floor that exceeds the WHOLE budget is the admission
            # gate's problem — it sheds; the scheduler must not also
            # deadlock it.)
            return True
        return self.reserved_bytes + item.cost.reserve_bytes() \
            <= self.budget_bytes

    def _dispatch(self, item: _Item) -> None:
        self._queued[item.ticket.priority_class].remove(item)
        # a cancelled/expired item is only handed out so the worker can
        # finalize it: it runs nothing, so it must not consume a quota
        # token, reserve budget, or pollute the packed/drain statistics
        dead = item.ticket.cancelled or item.ticket.expired()
        reserve = 0 if dead or self.budget_bytes is None \
            else item.cost.reserve_bytes()
        # queue-wait attribution for the slow-query log: why did this
        # query sit in the queue?  byte-blocked and quota-throttled beat
        # plain workers-busy (the runtime defaults the rest)
        if item.throttled:
            item.ticket.queue_reason = "quota_throttled"
        elif item.waited:
            item.ticket.queue_reason = "byte_blocked"
        if not dead:
            if self._running:
                self._inc("serving.scheduler.packed")
                from ..observability import flight

                flight.record("sched.pack", qid=item.ticket.qid,
                              reserved=reserve,
                              inflight=len(self._running))
            if self.tenant_rate is not None:
                bucket = self._buckets.get(item.cost.tenant)
                if bucket is not None:
                    bucket.take()
            if item.cost.pred_exec_ms is not None:
                self._pred_sum += float(item.cost.pred_exec_ms)
                self._pred_n += 1
        self.reserved_bytes += reserve
        self._running[item.ticket.qid] = _Running(
            item.cost, self._clock(), reserve)
        self._gauges()

    def release_locked(self, ticket: QueryTicket,
                       measured_bytes: Optional[int] = None) -> None:
        """Return a dispatched query's reservation — called from the
        runtime's `_release` on EVERY outcome (success, failure, deadline,
        cancel, mid-pack fault), so reserved bytes can never leak.

        ``measured_bytes`` is the execution's MEASURED footprint when the
        executing thread recorded one (TorchFrame.execute writes
        ``ticket.measured_bytes`` from `serving/cache.table_nbytes`-style
        accounting): the packer reconciles it against what it reserved and
        surfaces the signed drift as ``serving.scheduler.reserve_drift``
        (measured - reserved, bytes) — the estimator-calibration signal
        behind packing against measured rather than estimated bytes."""
        rec = self._running.pop(ticket.qid, None)
        if rec is not None:
            self.reserved_bytes -= rec.reserved
            if measured_bytes is not None and rec.reserved > 0 \
                    and self.metrics is not None:
                self.metrics.observe("serving.scheduler.reserve_drift",
                                     float(int(measured_bytes)
                                           - rec.reserved))
        self._gauges()

    # ------------------------------------------------------------- queries
    def depth_locked(self, cls: Optional[str] = None) -> int:
        if cls is not None:
            return len(self._queued[cls])
        return sum(len(q) for q in self._queued.values())

    def drain_all_locked(self) -> List[Tuple[QueryTicket, Any, Any]]:
        """Shutdown: hand every queued item back (the runtime fails them
        with the structured ShutdownError, same as the FIFO path)."""
        out = []
        for cls in CLASSES:
            for item in self._queued[cls]:
                out.append((item.ticket, item.fn, item.fut))
            self._queued[cls] = []
        self._gauges()
        return out

    def family_mates_locked(self, family: Optional[str],
                            exclude_qid: Optional[str] = None) -> int:
        """How many OTHER queries of ``family`` are currently admitted
        (queued or running).  The family batcher's leader consults this:
        a positive count means the packer co-scheduled batch-mates that
        are worth waiting the rendezvous window for."""
        if not family:
            return 0
        n = 0
        for q in self._queued.values():
            n += sum(1 for item in q if item.cost.family == family)
        for qid, rec in self._running.items():
            if rec.cost.family == family and qid != exclude_qid:
                n += 1
        return n

    def predicted_drain_s(self, workers: int) -> float:
        """Predicted seconds until the current load drains: remaining
        predicted exec of running queries plus the queued backlog's
        predictions, spread over the workers.  Queries with no prediction
        use the rolling mean of the predictions seen so far (0 when none:
        an unknown workload earns no inflated hint)."""
        now = self._clock()
        default = self._pred_sum / self._pred_n if self._pred_n else 0.0
        total_ms = 0.0
        for rec in self._running.values():
            pred = rec.cost.pred_exec_ms if rec.cost.pred_exec_ms is not None \
                else default
            total_ms += max(0.0, pred - (now - rec.started) * 1000.0)
        for q in self._queued.values():
            for item in q:
                pred = item.cost.pred_exec_ms \
                    if item.cost.pred_exec_ms is not None else default
                total_ms += pred
        return total_ms / 1000.0 / max(1, int(workers))

    def snapshot_locked(self) -> Dict[str, Any]:
        return {
            "budgetBytes": self.budget_bytes,
            "reservedBytes": self.reserved_bytes,
            "running": len(self._running),
            "queued": {c: len(self._queued[c]) for c in CLASSES},
            "tenants": sorted(self._buckets),
        }

    # ------------------------------------------------------------- metrics
    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    def _gauges(self) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge("serving.scheduler.inflight_bytes",
                           self.reserved_bytes)
        self.metrics.gauge("serving.scheduler.running", len(self._running))
        for cls in CLASSES:
            self.metrics.gauge(f"serving.scheduler.queue_depth.{cls}",
                               len(self._queued[cls]))
