"""Per-context configuration of the PyTorch port.

Counterpart of `dask_sql_tpu/config.py`, with only the keys this port reads
and the reference's defaults.  Each `Context` owns one `Config`; `set()`
pushes a scoped overlay (per-query options of `Context.sql`).
`DOCUMENTED_KEYS` is the registry the self-lint's DSQL703 checks every
literal ``config.get`` against (analysis/configkeys.py); under
``analysis.strict_config`` a dynamic read of an unregistered key warns once
per key.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

DEFAULTS: Dict[str, Any] = {
    "sql.identifier.case_sensitive": True,
    # the native C++ planner (planner/native_bridge.py): auto | on | off
    "sql.native.binder": "auto",
    "sql.optimize": True,
    "sql.predicate_pushdown": True,
    "sql.dynamic_partition_pruning": True,
    "sql.optimizer.verbose": False,
    "sql.optimizer.fact_dimension_ratio": 0.7,
    "sql.optimizer.max_fact_tables": 2,
    "sql.optimizer.preserve_user_order": True,
    "sql.optimizer.filter_selectivity": 1.0,
    "sql.sort.topk-nelem-limit": 1000000,
    "sql.compile": True,  # the fused aggregate and join->aggregate pipelines
    "sql.compile.join_pipeline": True,  # the scan->joins->aggregate pipeline
    "sql.compile.select": True,  # one-kernel root select chains
    # fused PREDICT (inference/, physical/compiled_predict.py): a registered
    # model's tensor program inside the compiled select's gather program
    # (the compiled_predict ladder rung).  Off = every PREDICT takes the
    # host tier (pull to pandas, model.predict on numpy, upload again).
    "sql.compile.predict": True,
    # segment-sum mode: auto | scatter | matmul | pallas (the last two pick
    # the hand-written kernel, ops/segsum.py choose_segsum_impl)
    "sql.compile.segsum": "auto",
    # the out-of-core aggregate over a lazy parquet table
    # (physical/streaming.py): batches of at most this many rows
    "sql.streaming.enabled": True,
    "sql.streaming.batch_rows": 2_000_000,
    # a join with a sharded input (parallel/dist_plan.py): None = auto
    # (broadcast a small side well under the big one), True = always
    # broadcast, False = always hash-shuffle, a number = row threshold
    "sql.join.broadcast": None,
    # reserved, as in the reference: buckets of a shuffle (None = shards)
    "sql.shuffle.num_buckets": None,  # dsql: allow-config-key — parity key, reserved
    # the collectives engine over sharded inputs: auto | on | off
    "sql.distributed.aggregate": "auto",
    "sql.distributed.join": "auto",
    "sql.distributed.sort": "auto",  # the range-partition sort
    # sharded storage (spmd/storage.py): "on" shards every loaded
    # registration of at least min_rows rows over the default mesh of its
    # device kind when that mesh has two or more shards; an explicit
    # create_table(distributed=False) opts a table out
    "parallel.auto_shard": "off",
    "parallel.auto_shard.min_rows": 32768,
    # the sharded compiled rungs (spmd/): above their one-device
    # counterparts whenever the scanned table is sharded; "off" keeps the
    # one-device rungs and the collectives engine
    "parallel.spmd": "auto",
    "parallel.spmd.select": True,  # spmd_select, root select chains
    "parallel.spmd.aggregate": True,  # spmd_aggregate, scan-chain aggregates
    "parallel.spmd.join_aggregate": True,  # spmd_join_aggregate
    # build sides up to this many rows broadcast to every shard; a larger
    # one declines to the hash-shuffle engine
    "parallel.spmd.broadcast_rows": 1 << 20,
    # plan families (families/): literals lift into runtime parameters and
    # the compiled pipelines' caches key on the parameterized expressions
    "families.enabled": True,
    # static plan verification (analysis/verifier.py): "on" cross-checks
    # every bound plan (error findings raise PlanError at bind time, doomed
    # compiled rungs are skipped by the ladder), "strict" raises on warn
    # findings too, "off" verifies nothing
    "analysis.verify": "on",
    # static cost and memory estimation (analysis/estimator.py) of every
    # freshly planned query: "on" | "off" (EXPLAIN ESTIMATE works either way)
    "analysis.estimate": "on",
    # device byte budget of the estimator's rung proofs: an aggregate whose
    # packed-matrix lower bound exceeds it skips its compiled rungs.  None
    # disables the proof
    "analysis.estimate.device_budget_bytes": None,
    # profile feedback (estimator.apply_feedback): tighten an estimate's
    # upper bounds from the family's observed history, never below its
    # lower bounds nor, for peak_bytes.hi, below the fused programs' peak
    "analysis.estimate.feedback": True,
    "analysis.estimate.feedback.margin": 2.0,  # safety multiple over the observed max
    "analysis.estimate.feedback.min_obs": 2,  # observed executions before feedback applies
    # the degradation ladder (resilience/ladder.py): off runs each rung bare,
    # so a degradable failure propagates instead of stepping down
    "resilience.ladder.enabled": True,
    # the last rung, on a CPU Context: re-run the plan with the compiled
    # rungs off after a degradable failure of the interpreted walk
    "resilience.ladder.cpu_fallback": True,
    # the per-(plan family, rung) circuit breaker of the ladder
    "resilience.breaker.enabled": True,
    "resilience.breaker.threshold": 3,  # consecutive failures that trip it
    "resilience.breaker.cooldown_s": 30.0,  # seconds to a half-open trial
    # max age of checkpointed breaker verdicts restored on load_state
    # (0 = never restore)
    "resilience.breaker.persist_ttl_s": 300.0,
    # cost-based rung selection (resilience/ladder.py cost_skip): skip a
    # compiled rung whose predicted build cost (the p50 of its
    # resilience.compile_ms history) exceeds amortize_factor x the family's
    # hits x its observed exec_ms p50; a choice, not a degradation
    "resilience.ladder.cost_based": True,
    "resilience.ladder.cost.amortize_factor": 4.0,
    # watchdog deadline on a pipeline build, ms (None = off): expiry
    # degrades the rung (resilience/watchdog.py)
    "resilience.compile_timeout_ms": None,
    # the pressure controller (resilience/pressure.py): bands of the
    # ledger's headroom against serving.scheduler.device_budget_bytes only
    # (no device budget = GREEN always); YELLOW suspends speculative work,
    # RED reclaims cold bytes, CRITICAL streams or sheds new admissions;
    # enabled also gates the ladder's reclaim-before-degrade retry
    "resilience.pressure.enabled": True,
    "resilience.pressure.yellow_frac": 0.25,  # headroom <= frac*budget enters YELLOW
    "resilience.pressure.red_frac": 0.10,  # headroom <= frac*budget enters RED
    "resilience.pressure.critical_frac": 0.05,  # headroom <= frac*budget enters CRITICAL
    "resilience.pressure.model_idle_s": 120.0,  # idle model params reclaimable
    # fault injection (resilience/faults.py), e.g. "compile:0.5,oom:once"
    "resilience.inject": None,
    "resilience.inject.seed": 0,  # PRNG seed of the probabilistic modes
    "resilience.inject.hang_s": 30.0,  # the hang of the compile_hang site, seconds
    # bounded retry of taxonomy-retryable failures at the serving worker
    # (resilience/retry.py BackoffPolicy)
    "resilience.retry.max_attempts": 3,  # total tries (1 = no retry)
    "resilience.retry.base_s": 0.05,  # first backoff delay, seconds
    "resilience.retry.multiplier": 2.0,  # exponential backoff factor
    "resilience.retry.max_s": 2.0,  # backoff ceiling, seconds
    "resilience.retry.jitter": 0.5,  # +-fraction of jitter on each delay
    # the family batcher (families/batcher.py) under a ServingRuntime:
    # concurrently admitted members of one plan family answer with one
    # stacked run; max_queries <= 1 disables it, and window_ms is how long
    # a leader waits for followers while other queries are in flight
    "serving.batch.max_queries": 8,
    "serving.batch.window_ms": 2.0,
    # the serving runtime (serving/runtime.py), read when it is built
    "serving.workers": 8,  # worker threads
    "serving.queue.interactive": 32,  # waiting interactive queries before shedding
    "serving.queue.batch": 64,  # waiting batch queries before shedding
    "serving.batch.max_running": None,  # concurrent batch cap (None = workers-1; 0 pauses batch)
    "serving.deadline_s": None,  # default per-query deadline, seconds (None = unbounded)
    "serving.retry_after_s": 1.0,  # floor of the retry-after hint on a shed
    "serving.retry_after.cap_s": 60.0,  # ceiling of every retry-after hint
    # the estimated-bytes gate (serving/admission.py): shed a query whose
    # provable peak device bytes (the estimate's lower bound) exceed this
    # budget, before any executor work.  None disables the gate
    "serving.admission.max_estimated_bytes": None,
    # partitioned streaming (streaming/): a provably over-budget scan of one
    # registered table runs as row partitions with partial aggregate
    # states combined in order, and a mid-stream OOM halves the partition
    # and resumes from the last completed one
    "serving.stream.enabled": True,
    # explicit partition size in rows (0/None = derived from the estimate)
    "serving.stream.chunk_rows": None,
    # the repartition floor: below it a mid-stream OOM degrades the rung
    "serving.stream.min_chunk_rows": 4096,
    # a plan needing more partitions than this is shed
    "serving.stream.max_partitions": 256,
    # per-partition launch deadline, ms (None/0 = off): the launch waits
    # for its own CUDA event under the watchdog
    "serving.stream.launch_timeout_ms": None,
    # cold starts: where the built kernel and planner libraries are kept
    # and found (None = the package's _build/), the profile-driven warm-up
    # and the background recompiler
    "serving.compile_cache.path": None,
    "serving.compile_cache.min_compile_time_s": 0.0,  # the reference's floor; every library build is kept
    "serving.warmup.enabled": True,  # warm the top profiled fingerprints after load_state
    "serving.warmup.top_n": 8,  # how many hot fingerprints the warm-up replays
    "serving.warmup.throttle_s": 0.0,  # pause between warm statements
    "serving.bg_compile.enabled": False,  # rebuild grown or replaced families off the query's path
    "serving.bg_compile.max_pending": 8,  # bounded background queue (past it: foreground)
    # the packing scheduler (serving/scheduler.py): queries packed against
    # the device byte budget by their provable floors, deadline first,
    # with per-tenant quotas; enabled=false keeps plain FIFO class queues
    "serving.scheduler.enabled": True,
    # the budget the packer reserves against; None falls back to
    # serving.admission.max_estimated_bytes (none at all = no packing)
    "serving.scheduler.device_budget_bytes": None,
    # a deadline-free query sorts as if its deadline were its admission
    # plus this many seconds
    "serving.scheduler.fair_horizon_s": 30.0,
    "serving.tenant.rate_qps": None,  # per-tenant token refill, queries/s (None = off)
    "serving.tenant.burst": 4.0,  # token-bucket capacity per tenant
    # shutdown(wait=True) cancels and fails queries still running after
    # this many seconds
    "serving.shutdown.drain_timeout_s": 30.0,
    # the result cache (serving/cache.py) of repeated identical queries
    "serving.cache.enabled": True,
    "serving.cache.max_bytes": 256 << 20,  # total resident bytes before LRU eviction
    "serving.cache.max_entry_bytes": 64 << 20,  # per-entry cap
    "serving.cache.ttl_s": 300.0,  # entry time-to-live, seconds (None = no TTL)
    # semantic reuse (materialize/): stem materialization, subsumption
    # answering over cached results, incremental maintenance on append
    "serving.materialize.enabled": True,  # pin hot scan->filter stems as device-resident tables
    "serving.materialize.min_hits": 2,  # stem family hit count before pinning (profile-driven)
    "serving.materialize.max_bytes": 128 << 20,  # total pinned bytes before LRU eviction
    "serving.materialize.min_bytes": 1024,  # floor: stems cheaper than this are not worth pinning
    "serving.reuse.subsumption": True,  # answer tighter-literal families by re-filtering cached results
    "serving.reuse.incremental": True,  # fold INSERT/append deltas through stored combine states
    # per-plan-node tracing of every execution, folded into the metrics
    # registry (``executor.node.*``; on the card each node then waits for
    # its device work, tracing.py)
    "serving.metrics.node_traces": False,
    # query-lifecycle tracing (observability/): a span trace per query
    # (EXPLAIN ANALYZE's header, `Context.last_trace`)
    "observability.trace.enabled": True,
    "observability.trace.keep": 256,  # finished traces kept (LRU)
    # slow-query log threshold, ms (None = off; 0 logs every query)
    "observability.slow_query_ms": None,
    # JSONL sink of the slow-query log (None = the python logger)
    "observability.slow_query_path": None,
    # rolling samples kept per fingerprint (exec, compile, bytes)
    "observability.profiles.window": 64,
    "observability.profiles.keep": 512,  # fingerprints kept (LRU)
    # finished queries kept in the SHOW QUERIES table
    "observability.live.keep": 64,
    "observability.flight.capacity": 4096,  # flight-recorder ring size (events)
    # JSONL sink the ring is flushed to on any query failure (None = the
    # ring in memory only)
    "observability.flight.dump_path": None,
    # load-time column encodings (columnar/encodings.py): auto | off
    "columnar.encoding": "auto",
    "columnar.encoding.min_rows": 1024,
    "columnar.encoding.dict": True,
    "columnar.encoding.for": True,
    "columnar.encoding.rle": True,
    "columnar.encoding.dict_max_card": 1 << 15,
    # the runtime lock sanitizer (runtime/locks.py): rank and order-graph
    # checks on every blocking acquire of a NamedLock.  Off by default
    # (bookkeeping on hot locks); a Context whose config turns it on arms
    # the process-wide sanitizer (it never disarms it)
    "analysis.lock_sanitizer": False,
    # warn (once per key) when config.get reads a key absent from
    # DOCUMENTED_KEYS; read by Config._note_unregistered in THIS module,
    # which the dead-key scan excludes
    "analysis.strict_config": False,  # dsql: allow-config-key — read here
}


class KeySpec(NamedTuple):
    """Registry row of one documented config key: its default and the
    value types a reader may hand to it (copied from
    `dask_sql_tpu/config.py`).  DSQL703 (analysis/configkeys.py) checks
    every literal ``config.get`` site against the registry: a typo'd key
    silently reads its fallback default forever."""
    default: Any
    types: Tuple[type, ...]


#: value types of keys whose default is None (the default alone cannot
#: imply them); byte budgets accept strings ("64MB") via parse_byte_budget
_NULLABLE_KEY_TYPES: Dict[str, Tuple[type, ...]] = {
    "sql.join.broadcast": (bool, int, float),
    "sql.shuffle.num_buckets": (int,),
    "analysis.estimate.device_budget_bytes": (int, str),
    "serving.batch.max_running": (int,),
    "serving.deadline_s": (float, int),
    "serving.admission.max_estimated_bytes": (int, str),
    "serving.stream.chunk_rows": (int,),
    "serving.stream.launch_timeout_ms": (float, int),
    "serving.compile_cache.path": (str,),
    "serving.scheduler.device_budget_bytes": (int, str),
    "serving.tenant.rate_qps": (float, int),
    "observability.slow_query_ms": (float, int),
    "observability.slow_query_path": (str,),
    "observability.flight.dump_path": (str,),
    "resilience.compile_timeout_ms": (float, int),
    "resilience.inject": (str,),
}


def _types_of(key: str, default: Any) -> Tuple[type, ...]:
    if default is None:
        return _NULLABLE_KEY_TYPES.get(key, (object,))
    if isinstance(default, bool):
        return (bool,)
    if isinstance(default, int):
        return (int,)
    if isinstance(default, float):
        return (float, int)
    return (type(default),)


#: every key a ``config.get("<literal>")`` site may read, built from
#: DEFAULTS so the comments above stay the one source of truth
DOCUMENTED_KEYS: Dict[str, KeySpec] = {
    key: KeySpec(default, _types_of(key, default))
    for key, default in DEFAULTS.items()
}


def is_documented_key(key: str) -> bool:
    return key in DOCUMENTED_KEYS


#: keys already warned about under analysis.strict_config: once per key
#: per process; a plain set on purpose (a racing double add only repeats
#: one log line)
_warned_unregistered: set = set()


class Config:
    """Base values + thread-local scoped overlays."""

    def __init__(self):
        self._values: Dict[str, Any] = dict(DEFAULTS)
        self._local = threading.local()

    def get(self, key: str, default: Any = None) -> Any:
        if key not in DOCUMENTED_KEYS:
            self._note_unregistered(key)
        for frame in reversed(getattr(self._local, "stack", None) or ()):
            if key in frame:
                return frame[key]
        return self._values.get(key, default)

    def _note_unregistered(self, key: str) -> None:
        """The runtime twin of DSQL703 for keys the static pass cannot see
        (computed names): under ``analysis.strict_config``, warn once per
        key.  The strict key itself is documented, so the ``get`` below
        ends after one level."""
        if key in _warned_unregistered:
            return
        if not self.get("analysis.strict_config", False):
            return
        _warned_unregistered.add(key)
        logging.getLogger(__name__).warning(
            "config.get(%r): key is not in config.DOCUMENTED_KEYS; "
            "register it with a default and type (analysis.strict_config)",
            key)

    def update(self, options: Optional[Dict[str, Any]]) -> None:
        self._values.update(options or {})

    def effective_items(self):
        """Sorted (key, value) pairs of the config this thread sees: base
        values merged with any active overlays (a plan-cache key part)."""
        merged = dict(self._values)
        for frame in getattr(self._local, "stack", None) or ():
            merged.update(frame)
        return tuple(sorted(merged.items()))

    @contextlib.contextmanager
    def set(self, options: Optional[Dict[str, Any]] = None):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(dict(options or {}))
        try:
            yield self
        finally:
            stack.pop()


def parse_byte_budget(value: Any) -> Optional[int]:
    """A byte-budget config value as ``int`` bytes, or None (disabled).
    ``None``, ``""``, ``0``, ``"0"``, ``"none"``, ``"off"``, ``"false"``
    (any case) and non-positive numbers disable; binary suffixes
    (``"64MB"``, ``"2gib"``) are accepted; a malformed value disables with
    a logged warning rather than raising.  Copied from
    `dask_sql_tpu/config.py`."""
    if value is None:
        return None
    if isinstance(value, str):
        value = value.strip().lower()
        if value in ("", "0", "none", "off", "false"):
            return None
        scale = 1
        for suffix, mult in (("kib", 1 << 10), ("mib", 1 << 20),
                             ("gib", 1 << 30), ("tib", 1 << 40),
                             ("kb", 1 << 10), ("mb", 1 << 20),
                             ("gb", 1 << 30), ("tb", 1 << 40)):
            if value.endswith(suffix):
                value, scale = value[:-len(suffix)].strip(), mult
                break
        try:
            value = float(value) * scale
        except ValueError:
            logging.getLogger(__name__).warning(
                "unparseable byte budget %r; treating as disabled", value)
            return None
    try:
        n = int(value)
    except (TypeError, ValueError):
        logging.getLogger(__name__).warning(
            "unparseable byte budget %r; treating as disabled", value)
        return None
    return n if n > 0 else None
