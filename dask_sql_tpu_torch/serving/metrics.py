"""Metrics registry: counters, gauges, and latency histograms for the
serving runtime.  Copied from `dask_sql_tpu/serving/metrics.py`.

Role parity: the reference points users at the dask dashboard for this;
an inference-serving stack needs its own registry (admissions, rejections,
timeouts, cache hit rate, queue-depth and latency percentiles) that both
``SHOW METRICS`` and the server's ``/v1/metrics`` endpoint can snapshot.
Aggregation from the per-node `Tracer` happens through `observe_trace`.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..runtime import locks


# ---------------------------------------------------------------------------
# documented metric registry
# ---------------------------------------------------------------------------
#: Every exact metric name the engine emits via ``metrics.inc`` /
#: ``metrics.observe``.  This is the registry self-lint rule DSQL401
#: checks string-literal metric names against — an undocumented name in
#: code is name drift (a typo'd counter silently splits a time series) and
#: fails CI.  Add the name here (with the emitting site) when introducing
#: a metric; docs/serving.md and docs/analysis.md describe the families.
DOCUMENTED_METRICS = frozenset({
    # runtime/locks.py — lock sanitizer
    "analysis.locks.order_violation",
    "analysis.locks.registered",
    # analysis/ — plan verifier + cost/memory estimator
    "analysis.verify.runs",
    "analysis.plan_error",
    "analysis.verifier_internal",
    "analysis.explain_lint",
    "analysis.explain_estimate",
    "analysis.rung_skip",
    "analysis.estimate.runs",
    "analysis.estimate.bytes_lo",
    "analysis.estimate.bytes_hi",
    "analysis.estimate.rows_hi",
    "analysis.estimate.rung_proof",
    "analysis.estimate.internal_error",
    "analysis.estimate.feedback",
    # columnar/ — compressed column encodings (encodings.py, docs/columnar.md)
    "columnar.encoding.encoded_columns",
    "columnar.encoding.encoded_bytes",
    "columnar.encoding.decoded_bytes",
    "columnar.encoding.codespace_pred",
    "columnar.encoding.late_rows",
    "columnar.encoding.decode",
    # inference/ — model lowering + fused PREDICT (docs/ml.md)
    "inference.model.registered",
    "inference.model.lowered",
    "inference.model.declined",
    "inference.model.swap",
    "inference.predict.compiled",
    "inference.predict.host",
    # context.py — the planner that made each plan (native or Python)
    "planner.native.plan",
    "planner.native.bind",
    "planner.python.bind",
    # physical/compiled.py, compiled_join.py — the port's fused pipelines:
    # runs of the join pipeline and chains each pipeline declined
    "compiled_aggregate.declined",
    "compiled_join.run",
    "compiled_join.declined",
    # families/ — parameterized plan families + inter-query batching
    "families.parameterized",
    "families.hit",
    "families.estimate.hit",
    "families.internal_error",
    "serving.batch.launches",
    "serving.batch.queries",
    "serving.batch.solo",
    "serving.batch.size",
    # parallel/ + spmd/ — sharded storage, SPMD rungs, collectives engine.
    # The parallel.dist.* names are the registry-visible counters of the
    # dist_* kernel launches that historically lived only in the module
    # STATS dict (predating the registry); parallel.spmd.* cover the
    # sharded compiled rungs and the auto-shard registration policy.
    "parallel.auto_shard.tables",
    "parallel.spmd.launches",
    "parallel.spmd.rows",
    "parallel.dist.agg_kernel",
    "parallel.dist.sort_kernel",
    "parallel.dist.join_kernel",
    "parallel.dist.broadcast_join",
    # a sharded table read as its global rows by an operator with no
    # sharded path (physical/rel/base.py gather_global)
    "parallel.dist.gather",
    # observability/ — lifecycle tracing + slow-query log + flight recorder
    "observability.slow_query",
    "observability.flight.dumps",
    # observability/ — HBM ledger gauges (ledger.py, published on every
    # /v1/metrics scrape and SHOW METRICS)
    "serving.ledger.budget_bytes",
    "serving.ledger.reserved_bytes",
    "serving.ledger.inflight_measured_bytes",
    "serving.ledger.cache_bytes",
    "serving.ledger.table_bytes",
    "serving.ledger.headroom_bytes",
    "serving.ledger.model_bytes",
    "serving.ledger.materialized_bytes",
    "serving.ledger.reserve_drift_bytes",
    # observability/ — live query table (live.py, CANCEL QUERY)
    "serving.cancel_requested",
    # planner
    "planner.optimize.fallback",
    # query lifecycle (Context / TpuFrame)
    "query.executed",
    "query.execute_ms",
    "query.d2h_ms",
    "query.serialize_ms",
    "query.plan_cache.hit",
    "query.plan_cache.miss",
    "query.cache.hit",
    "query.cache.miss",
    "query.cache.oversize",
    "query.cache.evicted",
    "query.cache.estimate_skip",
    "query.cache.invalidated",
    # resilience/ — ladder, breaker, retry, watchdog, persistent cache
    "resilience.compile_cache.enabled",
    "resilience.compile_cache.hit",
    "resilience.compile_cache.miss",
    "resilience.watchdog.timeout",
    "resilience.watchdog.abandoned",
    "resilience.breaker.restored",
    "resilience.degraded",
    "resilience.degraded.interpreted",
    "resilience.rung.cpu",
    "resilience.fallback",
    "resilience.fallback.dist_aggregate",
    "resilience.fallback.dist_sort",
    "resilience.breaker.skip",
    "resilience.breaker.trip",
    "resilience.retry.attempts",
    "resilience.retry.recovered",
    "resilience.retry.deadline_abort",
    "resilience.retry.backoff_ms",
    # resilience/ + streaming/ — mid-stream partition fault handling
    # (streaming/runner.py, docs/resilience.md "Partition faults")
    "resilience.partition.oom",
    "resilience.partition.exhausted",
    # serving/ — admission, runtime
    "serving.admitted",
    "serving.rejected",
    "serving.rejected.batch",
    "serving.cancelled",
    "serving.completed",
    "serving.failed",
    "serving.timeouts",
    "serving.shutdown_shed",
    "serving.shed_estimated_bytes",
    "serving.latency_ms",
    "serving.queue_wait_ms",
    # serving/ — packing scheduler (scheduler.py, docs/serving.md
    # "Scheduling and multi-tenancy")
    "serving.scheduler.packed",
    "serving.scheduler.waited",
    "serving.scheduler.quota_throttled",
    "serving.scheduler.cost_rung_skip",
    "serving.scheduler.inflight_bytes",
    "serving.scheduler.running",
    "serving.scheduler.reserve_drift",
    # serving/ + streaming/ — streamed partitioned execution
    # (streaming/, docs/serving.md "Streaming execution")
    "serving.stream.admitted",
    "serving.stream.queries",
    "serving.stream.partitions",
    "serving.stream.repartitions",
    "serving.stream.rows",
    "serving.stream.chunk_rows",
    # liveness gauges: advancing = healthy long stream, stalled = hang
    "serving.stream.partitions_done",
    "serving.stream.rows_done",
    # serving/ — zero-cold-start: pre-warm + background recompile
    "serving.warmup.started",
    "serving.warmup.warmed",
    "serving.warmup.failed",
    "serving.warmup.skipped",
    "serving.warmup.cancelled",
    "serving.warmup.ms",
    "serving.bg_compile.submitted",
    "serving.bg_compile.completed",
    "serving.bg_compile.failed",
    "serving.bg_compile.dropped",
    "serving.bg_compile.deferred",
    "serving.bg_compile.ms",
    # serving/ + materialize/ — semantic reuse: sub-plan materialization,
    # subsumption answering, incremental maintenance (materialize/,
    # docs/serving.md "Semantic reuse and materialization")
    "serving.materialize.stored",
    "serving.materialize.hits",
    "serving.materialize.evicted",
    "serving.materialize.refreshed",
    "serving.materialize.declined",
    "serving.reuse.subsumption.hits",
    "serving.reuse.subsumption.declined",
    "serving.reuse.incremental.hits",
    "serving.reuse.incremental.folds",
    "serving.reuse.incremental.declined",
    "serving.reuse.append_rows",
    # resilience/pressure.py — coordinated HBM pressure response: band
    # gauge + transitions, YELLOW speculative-work suspensions, RED
    # cross-tier reclaim, OOM reclaim-then-retry on the SAME rung,
    # CRITICAL forced-stream/shed outcomes (docs/resilience.md
    # "Pressure hierarchy")
    "resilience.pressure.band",
    "resilience.pressure.transitions",
    "resilience.pressure.suspended",
    "resilience.pressure.reclaims",
    "resilience.pressure.reclaimed_bytes",
    "resilience.pressure.rung_retry",
    "resilience.pressure.rung_retry_ok",
    "resilience.pressure.critical_streamed",
    "resilience.pressure.critical_shed",
    # resilience/chaos.py — seeded randomized fault campaigns under
    # concurrent mixed load (bench.py --chaos, docs/resilience.md
    # "Chaos harness")
    "chaos.campaigns",
    "chaos.rounds",
    "chaos.queries",
    "chaos.violations",
    # fleet/ — router fronting N replicas: health-gated cost-aware
    # routing, mid-query failover, warm-standby promotion, graceful
    # drain, epoch-fenced write fan-out (docs/fleet.md)
    "fleet.replicas",
    "fleet.route",
    "fleet.route.spill",
    "fleet.failover",
    "fleet.promote",
    "fleet.drain",
    "fleet.kill",
    "fleet.write.applied",
    "fleet.write.fenced",
    "fleet.write.replayed",
    "fleet.write.poisoned",
    "fleet.write.unroutable",
    "fleet.sync",
})

#: Prefixes legitimizing *dynamic* metric families (f-string names keyed by
#: rung / rule / class / node type).  DSQL401 checks an f-string's static
#: prefix against these.
DOCUMENTED_METRIC_PREFIXES = (
    "analysis.findings.",       # per verifier rule id
    "analysis.rung_skip.",      # per pre-skipped ladder rung
    "resilience.degraded.",     # per degraded rung
    "resilience.rung.",         # per rung that answered
    "resilience.breaker.skip.",  # per breaker-skipped rung
    "resilience.compile_ms.",   # per-rung compile wall time (observability/spans.py)
    "serving.admitted.",        # per admission class
    "serving.rejected.",        # per admission class
    "serving.scheduler.queue_depth.",    # per admission class (gauge)
    "serving.scheduler.cost_rung_skip.",  # per cost-skipped ladder rung
    "executor.node.",           # per plan-node type (Tracer aggregation)
    "fleet.routed.",            # per-replica routed-query counter (fleet/router.py)
)


def is_documented_metric(name: str, prefix_only: bool = False) -> bool:
    """True when ``name`` is covered by the documented registry.

    ``prefix_only`` means ``name`` is the static *prefix* of an f-string
    (the dynamic tail is unknown), so it also matches a documented family
    prefix it truncates (``f"resilience.rung.{r}"`` → ``"resilience.rung."``
    matching itself, or a shorter static run).  An exact literal gets no
    such slack — ``metrics.inc("analysis.findings")`` missing its per-rule
    suffix is exactly the drift DSQL401 exists to catch."""
    if name in DOCUMENTED_METRICS:
        return True
    if any(name.startswith(p) for p in DOCUMENTED_METRIC_PREFIXES):
        return True
    return prefix_only and any(p.startswith(name)
                               for p in DOCUMENTED_METRIC_PREFIXES)


def nearest_rank(data_sorted: List[float], q: float) -> float:
    """Nearest-rank percentile over pre-sorted data — THE quantile formula
    of the engine, shared by the serving histograms and the per-fingerprint
    profile store so SHOW METRICS and SHOW PROFILES can never report
    different p50s for the same samples."""
    if not data_sorted:
        return 0.0
    n = len(data_sorted)
    return data_sorted[min(n - 1, int(q * (n - 1) + 0.5))]


class Histogram:
    """Bounded-reservoir histogram: O(1) observe, percentile on snapshot.

    The reservoir keeps the most recent `window` observations — serving
    percentiles should reflect *current* traffic, not the process lifetime —
    while count/total stay exact cumulative aggregates."""

    __slots__ = ("window", "count", "total", "vmax", "_ring")

    def __init__(self, window: int = 2048):
        self.window = window
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0
        self._ring: "deque[float]" = deque(maxlen=window)

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value > self.vmax:
            self.vmax = value
        self._ring.append(value)

    def percentiles(self, qs: Iterable[float] = (0.5, 0.95, 0.99)) -> List[float]:
        data = sorted(self._ring)
        return [nearest_rank(data, q) for q in qs]

    def snapshot(self) -> Dict[str, Any]:
        p50, p95, p99 = self.percentiles()
        return {
            "count": self.count,
            "sum": round(self.total, 3),
            "avg": round(self.total / self.count, 3) if self.count else 0.0,
            "p50": round(p50, 3),
            "p95": round(p95, 3),
            "p99": round(p99, 3),
            "max": round(self.vmax, 3),
        }


class MetricsRegistry:
    """Thread-safe named counters / gauges / histograms.

    Flat dotted names (``query.cache.hit``, ``serving.rejected``); the
    snapshot is JSON-ready for ``/v1/metrics`` and row-flattened for
    ``SHOW METRICS``."""

    def __init__(self):
        # leaf rank (90): counters are bumped from under every other
        # subsystem's lock, and nothing is acquired while this is held
        self._lock = locks.named_lock("serving.metrics")
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------------- writes
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = Histogram()
            hist.observe(value)

    def observe_trace(self, root) -> None:
        """Fold one executor `NodeTrace` tree into per-node-type wall-time
        histograms (``executor.node.<type>.ms``) and row counters."""
        if root is None:
            return
        stack = [root]
        while stack:
            t = stack.pop()
            self.observe(f"executor.node.{t.node_type}.ms", t.wall_ms)
            if t.rows >= 0:
                self.inc(f"executor.node.{t.node_type}.rows", t.rows)
            stack.extend(t.children)

    # -------------------------------------------------------------- reads
    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def hist_percentile(self, name: str, q: float = 0.5) -> Optional[float]:
        """One percentile of a histogram's rolling reservoir, or None when
        the histogram has no samples — the cost-based rung selector reads
        the per-rung compile-cost prior (``resilience.compile_ms.<rung>``)
        through this."""
        with self._lock:
            hist = self._hists.get(name)
            if hist is None or not hist._ring:
                return None
            return hist.percentiles([q])[0]

    def hit_rate(self, hit: str, miss: str) -> float:
        with self._lock:
            h = self._counters.get(hit, 0)
            m = self._counters.get(miss, 0)
        return h / (h + m) if (h + m) else 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot() for k, h in self._hists.items()},
            }
        out["cacheHitRate"] = round(
            self.hit_rate("query.cache.hit", "query.cache.miss"), 4)
        return out

    def rows(self) -> List[Tuple[str, str]]:
        """Flatten the snapshot to (metric, value) string pairs, sorted by
        name — the ``SHOW METRICS`` result shape."""
        snap = self.snapshot()
        rows: List[Tuple[str, str]] = []
        for name, v in snap["counters"].items():
            rows.append((name, str(v)))
        for name, v in snap["gauges"].items():
            rows.append((name, _fmt(v)))
        for name, h in snap["histograms"].items():
            for stat in ("count", "avg", "p50", "p95", "p99", "max"):
                rows.append((f"{name}.{stat}", _fmt(h[stat])))
        rows.append(("query.cache.hit_rate", _fmt(snap["cacheHitRate"])))
        return sorted(rows)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def _fmt(v) -> str:
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)
