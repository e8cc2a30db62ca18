"""The Context of the PyTorch port: register frames, run SQL, get pandas back.

Counterpart of `dask_sql_tpu/context.py`, lean: the catalog (tables,
views, schemas, registered functions and aggregations, and their
mutations: drop, rename, append), `sql` with one or several statements per
call, `explain`, and a lazy frame whose `compute()` returns pandas.
Tables live on the context's device, which is the CUDA card unless the
caller asks for the CPU.  Plans come as the reference makes them: the
native C++ planner (parse, bind, the structural rule loop and join
reordering; `planner/native_bridge.py`), with the Python parser and binder
as its fallback, then the rest of the optimizer (dynamic partition
pruning), then plan-family parameterization (`families/`).  A plan cache
keyed by the SQL text, the catalog's versions and the config lets a
repeated single statement skip all of that.  The statements (DDL, SHOW,
INSERT INTO, ANALYZE) run as they are planned (`physical/rel/custom/`).
Each `sql` call records a lifecycle trace (`observability/`: the stages
parse, bind, optimize, parameterize, verify, estimate, execute and d2h,
kept in `traces` and `last_trace`), every execution feeds the metrics
registry (`metrics`, `serving/metrics.py`) and the per-fingerprint
profiles (`profiles`), which SHOW METRICS and SHOW PROFILES read.  Each
execution is an entry of the in-flight query table (`live_queries`: SHOW
QUERIES, CANCEL QUERY), looks in the result cache first, passes the
estimated-bytes gate (which routes an over-budget plan to partitioned
streaming, `streaming/`, and consults the pressure controller,
`pressure`), and feeds the card-byte ledger (`ledger`); a
`serving.ServingRuntime` attached as `serving` runs queries on its worker
pool.  Semantic reuse (`materialize`, materialize/) answers above the
result cache: an incremental aggregate state folded forward by appends, a
cached result that provably subsumes a tighter literal, and a pinned
scan->filter stem that later plans scan instead of the base table.
`save_state`/`load_state` checkpoint the catalog (checkpoint.py), and a
load warms the hottest profiled statements (`warmup`).
"""
from __future__ import annotations

import contextlib
import logging
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import observability
from .columnar.dtypes import SqlType, np_to_sql
from .columnar.table import Table, normalize_device
from .config import Config
from .datacontainer import (
    FunctionDescription,
    SchemaContainer,
    Statistics,
)
from .planner import plan as plan_nodes
from .planner.binder import Binder
from .planner.catalog import Catalog, CatalogTable
from .planner.expressions import Field
from .planner.parser import parse_sql
from .runtime import locks as runtime_locks
from .serving.cache import ResultCache
from .serving.metrics import MetricsRegistry

logger = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """The device of a Context: ``None`` means the CUDA card, which must be
    present; the CPU only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dask_sql_tpu_torch runs on a CUDA device, and none is available; "
            "pass device='cpu' to run on the CPU")
    return normalize_device(dev)


class TorchFrame:
    """Lazy query result: holds the plan; executes on `.compute()`
    (counterpart of the reference's `TpuFrame`)."""

    def __init__(self, context: "Context", plan, field_names: List[str],
                 config_options: Optional[Dict[str, Any]] = None):
        self._context = context
        self._plan = plan
        self._field_names = field_names
        self._result: Optional[Table] = None
        self._config_options = dict(config_options or {})
        #: the lifecycle trace active when this frame was planned
        #: (observability/spans.py): a lazy execute or compute activates it
        #: again, so plan-time and run-time spans land on one trace
        self._trace: Optional[observability.QueryTrace] = None
        #: the full statement text, for the fingerprint's profile
        self._sql: Optional[str] = None

    @property
    def columns(self) -> List[str]:
        return list(self._field_names)

    @property
    def plan(self):
        """The optimized logical plan this frame executes."""
        return self._plan

    def execute(self) -> Table:
        """Run the plan to a Table (cached).  Every failure leaves here as
        a taxonomy `QueryError` (``code``, ``retryable``, ``degradable``;
        `resilience/ladder.py` `wrap_boundary`), but for the port's
        `NotImplementedError` naming a later slice.  The run is the
        ``execute`` stage of the query's trace; it counts
        ``query.executed``, observes ``query.execute_ms`` and records the
        fingerprint's profile, with tracing on or off.

        Before it, as in the reference: the query's entry in the in-flight
        table (`Context.live_queries`: the serving front end's, or one of
        its own with a cancellable ticket), the ``cache_lookup`` stage
        (a hit in `Context._result_cache` answers without executing), and
        the estimated-bytes gate (`serving/admission.py`), whose routing to
        partitioned streaming is this execution's
        (`Executor.stream_decisions`).  After it: the
        measured footprint on the serving ticket (the scheduler's
        reserve drift) and the result into the cache, tagged with the
        tables it read.  Between the cache and the gate the semantic
        reuse tiers (`Context.materialize`) may answer, and their answer
        goes into the cache; a plan the gate did not route to streaming
        runs a copy that scans a pinned stem where one is pinned; after
        the run the manager observes the plan (stem hits, subsumption
        candidates, incremental registrations)."""
        if self._result is None:
            from .physical.executor import Executor
            from .resilience.ladder import plan_fingerprint, wrap_boundary
            from .serving.admission import (
                QueryCancelledError,
                QueryTicket,
                check_estimated_bytes,
            )
            from .serving.cache import table_nbytes
            from .serving.runtime import current_ticket, ticket_scope

            ctx = self._context
            tr = self._trace
            # a parameterized plan's family fingerprint keys its profile,
            # so `l_shipdate <= DATE '1998-09-02'` and another date are one
            family = getattr(self._plan, "_dsql_family", None)
            family_fp = family.fingerprint if family is not None else None
            fp = family_fp or plan_fingerprint(self._plan)
            sql_text = self._sql or (tr.sql if tr is not None else None)

            def _finish_on_error(exc_type, exc, tb):
                # a failing query's lifecycle ends here, so it reaches the
                # slow-query check too
                if exc is not None and tr is not None:
                    tr.finish(ctx.config, ctx.metrics)
                return False

            with contextlib.ExitStack() as stack:
                # entered before the finish hook, so the hook still sees
                # this query's config overrides (a per-query slow_query_ms)
                stack.enter_context(ctx.config.set(self._config_options))
                stack.push(_finish_on_error)
                if tr is not None:
                    if observability.current_trace() is not tr:
                        stack.enter_context(observability.activate(tr))
                    tr.fingerprint = fp
                # compile histograms and profiles record through the sink
                # with tracing off too
                stack.enter_context(observability.compile_sink(
                    ctx.metrics, ctx.profiles, fp, sql_text,
                    family=family_fp))
                # the in-flight table: a serving front end registered the
                # entry at submit (found through its ticket); a direct call
                # registers its own, with a ticket installed for the
                # executor's checkpoints, so CANCEL QUERY reaches it too
                live_ticket = current_ticket()
                entry = None
                if live_ticket is not None:
                    entry = ctx.live_queries.get(live_ticket.qid)
                owned_entry = entry is None
                if owned_entry:
                    live_qid = tr.qid if tr is not None else None
                    if live_ticket is None:
                        live_qid = live_qid or uuid.uuid4().hex[:16]
                        live_ticket = QueryTicket(live_qid)
                        stack.enter_context(ticket_scope(live_ticket))
                    # dsql: allow-unpaired-effect — _finish_live ExitStack
                    entry = ctx.live_queries.begin(
                        live_qid or live_ticket.qid, sql=sql_text,
                        ticket=live_ticket, trace=tr,
                        priority_class=live_ticket.priority_class)

                def _finish_live(exc_type, exc, tb):
                    if exc is None:
                        if owned_entry:
                            ctx.live_queries.finish(entry.qid, "done")
                        return False
                    if not owned_entry:
                        # the serving front end owns the terminal outcome
                        # (the worker may retry this attempt)
                        return False
                    code = getattr(exc, "code", None) or exc_type.__name__
                    state = "cancelled" if isinstance(
                        exc, QueryCancelledError) else "failed"
                    ctx.live_queries.finish(entry.qid, state, code)
                    if state == "failed":
                        # a cancel recorded query.cancel where it was asked
                        # for, and dumps no failure postmortem
                        observability.flight.flush_on_failure(
                            entry.qid, code, ctx.config, ctx.metrics)
                    return False

                # pushed after the trace hook so it runs first on unwind
                # (the entry is terminal before the slow-query check), and
                # right after the begin, so no exception leaves the row open
                stack.push(_finish_live)
                ctx.live_queries.start(entry.qid)
                entry.family = family_fp
                entry.fingerprint = fp
                stack.enter_context(observability.live.activate(entry))
                with observability.stage("cache_lookup"):
                    key = ctx._result_cache_key(self._plan,
                                                self._config_options)
                    hit = ctx._result_cache.get(key) if key is not None \
                        else None
                if hit is not None:
                    if tr is not None:
                        tr.event("result_cache_hit")
                    ctx.profiles.record_exec(fp, sql=sql_text,
                                             cache_hit=True,
                                             family=family_fp)
                    self._result = hit
                    return self._result
                # semantic reuse (materialize/): an incremental aggregate
                # state or a cached result that provably subsumes this
                # query answers without a scan or a build
                reuse = ctx.materialize.try_reuse(self._plan, family, key)
                if reuse is not None:
                    served, tier = reuse
                    if tr is not None:
                        tr.event(f"semantic_reuse:{tier}")
                    ctx.profiles.record_exec(fp, sql=sql_text,
                                             cache_hit=True,
                                             family=family_fp)
                    if key is not None:
                        # an exact repeat of this query now hits the cache
                        ctx._result_cache.put(
                            key, served,
                            deps=ctx._plan_table_deps(self._plan))
                    self._result = served
                    return self._result
                estimate = ctx._plan_estimate(self._plan)
                routed = None
                if estimate is not None:
                    # sheds a provably over-budget query before any
                    # executor work, or routes it to partitioned streaming
                    routed = check_estimated_bytes(
                        estimate, ctx.config, ctx.metrics, plan=self._plan,
                        context=ctx)
                    # a result whose provable bytes exceed the per-entry
                    # cap is never cacheable: skip the insert
                    if key is not None and estimate.result_bytes.lo > \
                            ctx._result_cache.max_entry_bytes:
                        ctx.metrics.inc("query.cache.estimate_skip")
                        key = None
                trace = bool(ctx.config.get("serving.metrics.node_traces",
                                            False))
                executor = Executor(ctx, trace=trace)
                if routed is not None:
                    # the streaming verdict is THIS execution's, keyed by
                    # the streamable node: a concurrent run of the same
                    # cached plan under another budget never sees it
                    node, decision = routed
                    executor.stream_decisions[id(node)] = decision
                exec_plan = self._plan
                if routed is None:
                    # a pinned stem (materialize/manager.py): run a copy
                    # that scans it on the interpreted walk.  A streamed
                    # run keeps the original plan, whose node its routing
                    # is keyed on
                    rewritten = ctx.materialize.try_stem_rewrite(self._plan)
                    if rewritten is not None:
                        exec_plan, stem_overrides = rewritten
                        executor.table_overrides.update(stem_overrides)
                        if tr is not None:
                            tr.event("materialized_stem_scan")
                t0 = time.perf_counter()
                with observability.stage("execute"):
                    self._result = wrap_boundary(
                        lambda: executor.execute_root(exec_plan))
                exec_ms = (time.perf_counter() - t0) * 1000.0
                ctx.metrics.observe("query.execute_ms", exec_ms)
                ctx.metrics.inc("query.executed")
                if trace:
                    executor.tracer.publish(ctx.metrics)
                    if tr is not None:
                        tr.attach_node_tree(executor.tracer.root)
                result_bytes = table_nbytes(self._result)
                ctx.profiles.record_exec(
                    fp, sql=sql_text, exec_ms=exec_ms,
                    result_bytes=result_bytes, family=family_fp,
                    rows=self._result.num_rows)
                ticket = current_ticket()
                if ticket is not None:
                    # the measured footprint (result plus the scanned
                    # tables' resident bytes) the scheduler reconciles its
                    # reservation with (serving.scheduler.reserve_drift)
                    ticket.measured_bytes = result_bytes \
                        + ctx._measured_scan_bytes(
                            self._plan,
                            routed[1] if routed is not None else None)
                    entry.measured_bytes = ticket.measured_bytes
                est = getattr(self._plan, "_dsql_estimate", None)
                if est is not None:
                    # the estimated side of SHOW PROFILES' rows, recorded
                    # now that the entry exists
                    ctx.profiles.record_estimate(fp, est.rows.hi,
                                                 family=family_fp)
                deps = ctx._plan_table_deps(self._plan)
                if key is not None:
                    # tagged with the tables it read: an append or a DDL
                    # drops exactly the entries reading them
                    ctx._result_cache.put(
                        key, self._result, nbytes=result_bytes, deps=deps)
                # stem hits (a pin at the threshold), the subsumption
                # candidate, the incremental registration
                ctx.materialize.observe(self._plan, family, key, deps,
                                        self._result)
        return self._result

    def compute(self):
        """Materialize to a pandas DataFrame with the SQL output names.
        The transfer is observed as ``query.d2h_ms`` on every call, and is
        the trace's ``d2h`` stage (once), which ends its lifecycle."""
        table = self.execute()
        config = self._context.config
        t0 = time.perf_counter()
        with config.set(self._config_options):
            df = table.to_pandas(config)
        t1 = time.perf_counter()
        self._context.metrics.observe("query.d2h_ms", (t1 - t0) * 1e3)
        tr = self._trace
        if tr is not None:
            # add-once: a repeated compute() must not add stages to a
            # finished (possibly already slow-logged) trace
            tr.add_span_once("d2h", t0, t1, rows=table.num_rows,
                             cols=len(self._field_names))
            with config.set(self._config_options):
                tr.finish(config, self._context.metrics)
        df.columns = self._disambiguated_names()
        return df

    def _disambiguated_names(self) -> List[str]:
        seen: Dict[str, int] = {}
        out = []
        for n in self._field_names:
            if n in seen:
                seen[n] += 1
                out.append(f"{n}{seen[n]}")
            else:
                seen[n] = 0
                out.append(n)
        return out

    def persist(self) -> "TorchFrame":
        """Execute now and keep the result Table (on the context's device
        for a card query); later calls reuse it."""
        self.execute()
        return self

    def head(self, n: int = 5):
        """The first ``n`` rows as pandas (the whole result is computed)."""
        return self.compute().head(n)

    def __len__(self) -> int:
        """The result's row count, read off the executed Table: no pull
        beyond the execution's own."""
        return self.execute().num_rows

    def explain_str(self) -> str:
        """The optimized plan this frame executes, as text."""
        return self._plan.explain()


class Context:
    DEFAULT_SCHEMA_NAME = "root"
    _PLAN_CACHE_CAP = 128

    def __init__(self, device=None,
                 config_options: Optional[Dict[str, Any]] = None):
        """A Context on ``device`` (the CUDA card when None).
        ``config_options`` are base values of its `config`, set before any
        of them is read (the reference's Context reads the process-wide
        config at this point)."""
        self.device = resolve_device(device)
        self.schema_name = self.DEFAULT_SCHEMA_NAME
        self.schema: Dict[str, SchemaContainer] = {
            self.DEFAULT_SCHEMA_NAME: SchemaContainer(self.DEFAULT_SCHEMA_NAME)
        }
        self.config = Config()
        self.config.update(config_options)
        #: the Presto server `run_server` started, which `stop_server` stops
        self.server = None
        #: counters, gauges and histograms of this Context (SHOW METRICS)
        self.metrics = MetricsRegistry()
        # arm the process-wide lock sanitizer when this Context's config
        # asks for it (one way: a later default Context does not disarm
        # it), and point its violation counters at this registry
        if self.config.get("analysis.lock_sanitizer", False):
            runtime_locks.set_enabled(True)
        runtime_locks.attach_metrics(self.metrics)
        #: per-fingerprint rolling profiles (compile, exec, bytes) behind
        #: SHOW PROFILES
        self.profiles = observability.ProfileStore(
            window=int(self.config.get("observability.profiles.window", 64)),
            keep=int(self.config.get("observability.profiles.keep", 512)))
        #: finished lifecycle traces, qid -> QueryTrace
        self.traces = observability.TraceStore(
            int(self.config.get("observability.trace.keep", 256)))
        #: the most recently started lifecycle trace
        self.last_trace: Optional[observability.QueryTrace] = None
        from .resilience.retry import CircuitBreaker

        #: per-(plan family, ladder rung) circuit breaker: a query shape
        #: that keeps failing a compiled rung skips straight to the rung
        #: that answers it (resilience/ladder.py)
        self.breaker = CircuitBreaker.from_config(self.config)
        #: (family, catalog, config) -> the family's `PlanEstimate`
        #: (`_run_estimator`), cleared when a table changes
        self._family_estimates: Dict[Tuple, Any] = {}
        #: plan-cache key -> optimized plan (LRU, `_PLAN_CACHE_CAP` entries)
        self._plan_cache: "OrderedDict[Tuple, Any]" = OrderedDict()
        #: (catalog key, native catalog bytes) of the last native plan
        self._catalog_buf_cache: Optional[Tuple[Tuple, Optional[bytes]]] = None
        #: schema -> view name -> the view's plan (CREATE VIEW)
        self._views: Dict[str, Dict[str, Any]] = {self.DEFAULT_SCHEMA_NAME: {}}
        #: (schema, table) -> delta epoch, bumped by every append, create,
        #: drop and rename of the name (`table_epoch`)
        self._table_epochs: Dict[Tuple[str, str], int] = {}
        #: bumped when a view or function is defined or dropped: plans bound
        #: against the old definition must not be reused
        self._catalog_serial = 0
        #: guards `_plan_cache`: the serving workers plan on one Context
        #: from several threads
        self._plan_lock = runtime_locks.named_lock("context.plan_cache")
        #: result Tables of repeated queries (serving/cache.py), keyed by
        #: `_result_cache_key` and dropped when a table they read changes
        self._result_cache = ResultCache(
            max_bytes=int(self.config.get("serving.cache.max_bytes",
                                          256 << 20)),
            max_entry_bytes=int(self.config.get(
                "serving.cache.max_entry_bytes", 64 << 20)),
            ttl_s=self.config.get("serving.cache.ttl_s", 300.0),
            metrics=self.metrics)
        #: the `ServingRuntime` a caller attached (SHOW METRICS shows its
        #: queues, and the family batcher reads it)
        self.serving = None
        #: the in-flight query table (observability/live.py) behind
        #: SHOW QUERIES and the target of CANCEL QUERY
        self.live_queries = observability.QueryRegistry(
            keep_finished=int(self.config.get("observability.live.keep",
                                              64)))
        #: card-byte accounting (observability/ledger.py)
        self.ledger = observability.DeviceLedger(self)
        from .resilience.pressure import PressureController

        #: the pressure controller (resilience/pressure.py): bands the
        #: ledger's headroom against the device budget, suspends
        #: speculative work at YELLOW, reclaims at RED, streams or sheds
        #: new admissions at CRITICAL
        self.pressure = PressureController(self)
        from .materialize import MaterializationManager

        #: semantic reuse (materialize/): pinned stems, subsumption over
        #: cached results, incremental aggregate states
        self.materialize = MaterializationManager(self)
        #: the active warm-up pass (serving/warmup.py) after load_state
        self.warmup = None
        #: the background recompiler (serving/background.py), made on
        #: first use under _plan_lock: read it with background_compiler()
        self._bg_compiler = None
        #: plan family -> the table identity its pipeline was built over
        #: (physical/compiled.py remember_family): a miss of a known family
        #: over another table is the background recompile's trigger
        self._compiled_families: Dict[Tuple, Tuple] = {}
        #: (schema, table) -> ((uid, delta epoch), resident bytes), for
        #: `_measured_scan_bytes`
        self._scan_bytes: Dict[Tuple[str, str], Tuple[Tuple, int]] = {}
        observability.flight.RECORDER.resize(
            int(self.config.get("observability.flight.capacity", 4096)))

    # ------------------------------------------------------------ state
    def save_state(self, location: str) -> dict:
        """Snapshot every schema (checkpoint.py: tables as parquet, the
        profiles, the open breaker verdicts) so a new process can
        `load_state` it; returns the manifest."""
        from . import checkpoint

        return checkpoint.save_state(self, location)

    def load_state(self, location: str) -> dict:
        """Load a `save_state` snapshot (the port's or the reference's)
        into this Context, then start the profile-driven warm-up."""
        from . import checkpoint

        manifest = checkpoint.load_state(self, location)
        self.maybe_start_warmup()
        return manifest

    def maybe_start_warmup(self):
        """Start a background warm-up over the hottest profiled
        fingerprints (serving/warmup.py) when configured and there is
        anything to warm; a pass in flight is returned as it is, a
        finished one replaced.  Returns the `WarmupManager` or None."""
        if not self.config.get("serving.warmup.enabled", True):
            return None
        top_n = int(self.config.get("serving.warmup.top_n", 8) or 0)
        if top_n <= 0 or not len(self.profiles):
            return None
        if self.warmup is not None and not self.warmup.ready:
            return self.warmup
        from .serving.warmup import WarmupManager

        manager = WarmupManager(
            self, top_n=top_n,
            throttle_s=float(self.config.get(
                "serving.warmup.throttle_s", 0.0) or 0.0))
        self.warmup = manager
        self._register_background(manager)
        return manager.start()

    def background_compiler(self):
        """The background recompiler (serving/background.py), or None with
        ``serving.bg_compile.enabled`` off; made on first use."""
        if not self.config.get("serving.bg_compile.enabled", False):
            return None
        with self._plan_lock:
            bg = self._bg_compiler
            if bg is not None:
                return bg
            from .serving.background import BackgroundCompiler

            bg = self._bg_compiler = BackgroundCompiler.from_config(
                self.config, metrics=self.metrics,
                suspended=self.pressure.suspend_speculative)
        self._register_background(bg)
        return bg

    def _register_background(self, worker) -> None:
        """Hand a background worker to the attached serving runtime, whose
        shutdown cancels and joins it."""
        if self.serving is not None:
            self.serving.register_background(worker)

    # ------------------------------------------------------------ tables
    def create_table(self, table_name: str, input_table: Any,
                     format: Optional[str] = None, persist: bool = False,
                     schema_name: Optional[str] = None,
                     statistics: Optional[Statistics] = None,
                     distributed: Optional[bool] = None, **kwargs) -> None:
        """Register a pandas frame, an Arrow table, a dict of columns, a
        port Table, a Hive cursor, an Intake catalog, a SQLAlchemy
        connection or a location (a parquet, CSV or JSON file, a glob or a
        directory; a published dataset with ``format="memory"``) on this
        device (`input_utils`), replacing any table or view of that name.
        A parquet location stays on disk unless ``persist``: its fields and
        row count come from the footers, and each query reads the columns
        and row groups it needs.  Loading picks each column's compressed
        encoding (``columnar.encoding*`` keys); the encoded columns are
        counted in ``metrics.counter("columnar.encoding.encoded_columns")`` and the
        resident bytes, encoded and as they would be decoded, recorded
        under ``columnar.encoding.encoded_bytes`` / ``decoded_bytes``.  The
        row count becomes the table's statistics unless ``statistics`` is
        given (an empty table carries none, as in the reference); the
        location is kept in the schema's ``filepaths``.  ``kwargs`` go to
        the reader (``pandas.read_csv``'s options for a CSV).

        ``distributed=True`` (or a true SQL literal from ``CREATE TABLE
        ... WITH (distributed = ...)``) shards the rows over the default
        mesh of the Context's device kind (`parallel.mesh.default_mesh`;
        a lazy parquet location loads first); an explicit False opts this
        table out of the ``parallel.auto_shard`` policy, and None leaves
        the policy in charge (`spmd/storage.py`)."""
        from .datacontainer import DataContainer, LazyParquetContainer
        from .input_utils import InputUtil
        from .spmd.storage import maybe_auto_shard, truthy_option

        schema_name = schema_name or self.schema_name
        if schema_name not in self.schema:
            raise KeyError(f"Schema {schema_name} not found")
        dc = InputUtil.to_dc(input_table, table_name, self.device,
                             format=format, persist=_truthy(persist),
                             config=self.config, **kwargs)
        if truthy_option(distributed):
            from .parallel.distribute import shard_table
            from .parallel.mesh import default_mesh

            mesh = default_mesh(self.device.type)
            if isinstance(dc, LazyParquetContainer):
                dc = DataContainer(shard_table(dc.table, mesh))
            else:
                dc.table = shard_table(dc.table, mesh)
        elif distributed is None:
            dc = maybe_auto_shard(dc, self.config, self.metrics)
        container = self.schema[schema_name]
        container.tables[table_name] = dc
        # a lazy table answers from its footers: reading `dc.table` would
        # load it, and its scans are PLAIN, so it counts no encodings
        lazy = isinstance(dc, LazyParquetContainer)
        table = None if lazy else dc.table
        if statistics is None:
            rows = (dc.statistics or {}).get("num-rows") if lazy \
                else table.num_rows
            statistics = Statistics(float(rows)) if rows else None
        if statistics is not None:
            container.statistics[table_name] = statistics
        else:
            container.statistics.pop(table_name, None)
        if getattr(dc, "filepath", None):
            container.filepaths[table_name] = dc.filepath
        else:
            container.filepaths.pop(table_name, None)
        if table is not None and table.has_encoded_columns():
            from .columnar.encodings import Encoding, scan_bytes

            n_enc = sum(1 for c in table.columns.values()
                        if c.encoding is not Encoding.PLAIN)
            enc_b, dec_b = scan_bytes(table)
            self.metrics.inc("columnar.encoding.encoded_columns", n_enc)
            self.metrics.observe("columnar.encoding.encoded_bytes", enc_b)
            self.metrics.observe("columnar.encoding.decoded_bytes", dec_b)
        self._bump_table_epoch(schema_name, table_name)
        if self._views.setdefault(schema_name, {}).pop(table_name,
                                                       None) is not None:
            # a view replaced by a table: results over other views may
            # read this name through their plans
            self._catalog_serial += 1
            self._on_catalog_change()
        else:
            self._on_catalog_change(tables={(schema_name, table_name)})

    def drop_table(self, table_name: str,
                   schema_name: Optional[str] = None) -> None:
        """Drop a table or a view."""
        schema_name = schema_name or self.schema_name
        self.schema[schema_name].tables.pop(table_name, None)
        self.schema[schema_name].statistics.pop(table_name, None)
        self.schema[schema_name].filepaths.pop(table_name, None)
        self._bump_table_epoch(schema_name, table_name)
        if self._views.get(schema_name, {}).pop(table_name, None) is not None:
            self._catalog_serial += 1
            self._on_catalog_change()
        else:
            self._on_catalog_change(tables={(schema_name, table_name)})

    def alter_table(self, old_name: str, new_name: str,
                    schema_name: Optional[str] = None) -> None:
        schema_name = schema_name or self.schema_name
        tables = self.schema[schema_name].tables
        if old_name in tables:
            tables[new_name] = tables.pop(old_name)
        for by_name in (self.schema[schema_name].statistics,
                        self.schema[schema_name].filepaths):
            if old_name in by_name:
                by_name[new_name] = by_name.pop(old_name)
        self._bump_table_epoch(schema_name, old_name)
        self._bump_table_epoch(schema_name, new_name)
        self._on_catalog_change(tables={(schema_name, old_name),
                                        (schema_name, new_name)})

    def append_rows(self, table_name: str, rows: Any,
                    schema_name: Optional[str] = None) -> int:
        """Append rows to a registered table in place: the engine behind
        ``INSERT INTO``.  The container and its uid stay; the table's delta
        epoch bumps (`table_epoch`), which the plan cache and the compiled
        pipelines' caches key on, so nothing planned or built over the old
        rows is reused.  ``rows`` is anything `create_table` takes, with
        columns matching the table's by position.  The concatenation
        decodes the table's encoded columns and merges string
        dictionaries (`columnar/concat.py`), as the reference's does.  A
        lazy parquet table cannot grow in place: it is loaded and replaced
        by an in-memory table of the rows and the appended ones, with a new
        uid, as in the reference.  Pinned stems over the table refresh
        over the delta alone and incremental aggregate states fold it
        (`materialize.on_append`).  Returns the number of rows
        appended."""
        from .datacontainer import DataContainer, LazyParquetContainer
        from .input_utils import InputUtil

        schema_name = schema_name or self.schema_name
        container = self.schema.get(schema_name)
        dc = container.tables.get(table_name) if container else None
        if dc is None:
            raise KeyError(f"Table {schema_name}.{table_name} not found")
        delta = InputUtil.to_dc(rows, table_name, self.device,
                                config=self.config).table
        appended = int(delta.num_rows)
        self.metrics.inc("serving.reuse.append_rows", appended)
        tkey = (schema_name, table_name)
        from .parallel.dist_plan import table_is_sharded

        if isinstance(dc, LazyParquetContainer) \
                or table_is_sharded(dc.table):
            # a replace, as in the reference: a file-backed or sharded
            # table has no in-place concat, so the rows and the appended
            # ones register anew on one device with a new uid, and every
            # reuse tier fails closed
            dc = DataContainer(Table.concat([dc.table.unsharded(), delta]))
            container.tables[table_name] = dc
            container.filepaths.pop(table_name, None)
            container.statistics[table_name] = Statistics(
                float(dc.table.num_rows))
            self._bump_table_epoch(schema_name, table_name)
            self._on_catalog_change(tables={tkey})
            return appended
        old_rows = int(dc.table.num_rows)
        dc.table = Table.concat([dc.table, delta])
        container.statistics[table_name] = Statistics(float(dc.table.num_rows))
        epoch = self._bump_table_epoch(schema_name, table_name)
        # the table was rewritten in place: a cached result that read it
        # (and may alias its tensors) drops now; the reuse state refreshes
        # instead: pinned stems run over the delta alone, incremental
        # states fold it
        n = self._result_cache.invalidate_tables({tkey})
        if n:
            self.metrics.inc("query.cache.invalidated", n)
        self._family_estimates.clear()
        self.materialize.on_append(schema_name, table_name, dc, old_rows,
                                   epoch)
        return appended

    def table_epoch(self, schema_name: str, table_name: str) -> int:
        """The (schema, table) delta epoch: 0 until the first append,
        create, drop or rename of the name."""
        return self._table_epochs.get((schema_name, table_name), 0)

    def _bump_table_epoch(self, schema_name: str, table_name: str) -> int:
        tkey = (schema_name, table_name)
        epoch = self._table_epochs.get(tkey, 0) + 1
        self._table_epochs[tkey] = epoch
        self._family_estimates.clear()
        return epoch

    def _on_catalog_change(self, tables=None) -> None:
        """Drop the cached results and the reuse state (pinned stems,
        subsumption candidates, incremental states) a catalog change makes
        stale: with ``tables`` (a set of (schema, table) names) exactly
        those that read them (``query.cache.invalidated``), else all of
        them (a view, function or schema change, whose reach no table
        names)."""
        if tables:
            n = self._result_cache.invalidate_tables(tables)
            n += self.materialize.invalidate_tables(tables)
            if n:
                self.metrics.inc("query.cache.invalidated", n)
        else:
            self._result_cache.invalidate_all()
            self.materialize.invalidate_all()
        self._family_estimates.clear()

    # ------------------------------------------------------------ schemas
    def create_schema(self, schema_name: str) -> None:
        self.schema[schema_name] = SchemaContainer(schema_name)
        self._views.setdefault(schema_name, {})
        self._on_catalog_change()

    def drop_schema(self, schema_name: str) -> None:
        if schema_name == self.schema_name:
            self.schema_name = self.DEFAULT_SCHEMA_NAME
        self.schema.pop(schema_name, None)
        if self._views.pop(schema_name, None):
            self._catalog_serial += 1
        self._on_catalog_change()

    def alter_schema(self, old_name: str, new_name: str) -> None:
        if old_name in self.schema:
            container = self.schema.pop(old_name)
            container.name = new_name
            self.schema[new_name] = container
            self._views[new_name] = self._views.pop(old_name, {})
            if self.schema_name == old_name:
                self.schema_name = new_name
            self._on_catalog_change()

    # ------------------------------------------------------------ functions
    def register_function(self, f: Callable, name: str,
                          parameters: List[Tuple[str, Any]], return_type: Any,
                          replace: bool = False,
                          schema_name: Optional[str] = None,
                          row_udf: bool = False) -> None:
        """Register a scalar function.  A tensor function (the default)
        takes its arguments as torch tensors on this context's device (the
        codes for a string) and returns a tensor or anything
        `torch.as_tensor` takes; a row function (``row_udf=True``) takes
        each row as a pandas Series of its parameters, on the host."""
        self._register_callable(f, name, parameters, return_type, False,
                                replace, schema_name, row_udf)

    def register_aggregation(self, f: Callable, name: str,
                             parameters: List[Tuple[str, Any]],
                             return_type: Any, replace: bool = False,
                             schema_name: Optional[str] = None) -> None:
        """Register an aggregation: `f` takes a pandas GroupBy of the
        argument column and returns one value a group, on the host, as in
        the reference."""
        self._register_callable(f, name, parameters, return_type, True,
                                replace, schema_name, False)

    def _register_callable(self, f, name, parameters, return_type,
                           aggregation, replace, schema_name, row_udf):
        """A name holds a list of overloads: a new signature adds one, the
        same signature raises unless `replace`, which drops every overload
        of the name first."""
        schema_name = schema_name or self.schema_name
        schema = self.schema[schema_name]
        params = [(pname, _to_sql_type(ptype))
                  for pname, ptype in (parameters or [])]
        fd = FunctionDescription(name, f, params, _to_sql_type(return_type),
                                 aggregation, row_udf)
        lower = name.lower()
        existing = schema.function_lists.get(lower)
        if existing and not replace:
            for other in existing:
                if [t for _, t in other.parameters] == [t for _, t in params]:
                    raise ValueError(
                        f"Function {name} with signature already registered; "
                        f"use replace=True")
            existing.append(fd)
        else:
            schema.function_lists[lower] = [fd]
        schema.functions[lower] = fd
        self._catalog_serial += 1
        self._on_catalog_change()

    def register_model(self, model_name: str, model: Any,
                       training_columns: List[str],
                       schema_name: Optional[str] = None) -> None:
        """Register a fitted model under ``model_name`` with the columns it
        was trained on (as the reference's `register_model`)."""
        schema_name = schema_name or self.schema_name
        self.schema[schema_name].models[model_name] = (
            model, list(training_columns))
        self.metrics.inc("inference.model.registered")
        # the lowered-program cache is NOT invalidated here: it detects the
        # replaced object lazily (identity mismatch -> re-lower), and the
        # stale entry is what lets inference/registry.py recognize a
        # same-shape retrain as a model.swap
        self._catalog_serial += 1
        self._on_catalog_change()

    def get_model(self, schema_name: str, model_name: str):
        """``(model, training_columns)`` of a registered model."""
        models = self.schema[schema_name].models
        if model_name not in models:
            raise KeyError(
                f"A model with the name {model_name} is not present.")
        return models[model_name]

    def lookup_function(self, name: str, arg_types: Optional[List[SqlType]] = None
                        ) -> Optional[FunctionDescription]:
        """The registered function of `name` in the current schema.  With
        the call's argument types, the overload the binder picked: the
        latest one whose parameter types are those, else whose arity is
        theirs.  (The reference calls the latest registration of the name
        whatever the call, so an overload of another arity raises there.)"""
        schema = self.schema[self.schema_name]
        if arg_types is not None:
            overloads = list(reversed(schema.function_lists.get(
                name.lower(), [])))
            for fd in overloads:
                if [t for _, t in fd.parameters] == list(arg_types):
                    return fd
            for fd in overloads:
                if len(fd.parameters) == len(arg_types):
                    return fd
        return schema.functions.get(name.lower()) or schema.functions.get(name)

    # ------------------------------------------------------------ queries
    def sql(self, sql: str, return_futures: bool = True,
            config_options: Optional[Dict[str, Any]] = None):
        """Plan and run SQL: one statement, or several separated by
        semicolons, each planned just before it runs (a later statement
        may read what an earlier one created).  A query runs lazily
        (`.compute()`) or, with ``return_futures=False``, now to pandas; a
        statement (DDL, INSERT INTO, SHOW, ...) runs at once.  The frame of
        the last statement comes back, or None when it has no result.  A
        single statement's plan is kept in the plan cache."""
        if not isinstance(sql, str):
            raise ValueError("sql must be a string")
        with contextlib.ExitStack() as scope:
            scope.enter_context(self.config.set(config_options))
            if self.config.get("serving.compile_cache.path"):
                # the compile cache: the kernel and planner libraries are
                # kept and found there from this statement on
                from .serving import compile_cache

                compile_cache.maybe_enable(self.config, self.metrics)
            # the lifecycle trace of this call: an outer scope's active
            # trace is reused, else this call opens (and owns) one
            tr = None
            owned = False
            if self._trace_enabled():
                tr = observability.current_trace()
                if tr is None:
                    tr = observability.QueryTrace(
                        sql=sql, metrics=self.metrics, profiles=self.profiles)
                    self.traces.put(tr.qid, tr)
                    owned = True
                    scope.enter_context(observability.activate(tr))
                self.last_trace = tr

            def _finish_owned_on_error(exc_type, exc, tb):
                # a parse, bind or verify failure ends the lifecycle of a
                # trace this call opened
                if exc is not None and owned and tr is not None:
                    tr.finish(self.config, self.metrics)
                return False

            scope.push(_finish_owned_on_error)
            key = self._plan_cache_key(sql, config_options)
            plans = None
            if key is not None:
                with self._plan_lock:
                    plans = self._plan_cache.get(key)
                    if plans is not None:
                        self._plan_cache.move_to_end(key)
            result = None
            if plans is not None:
                self.metrics.inc("query.plan_cache.hit")
                if tr is not None:
                    tr.event("plan_cache_hit")
                for plan in plans:
                    result = self._run_plan(plan, config_options)
            else:
                self.metrics.inc("query.plan_cache.miss")
                with observability.stage("parse"):
                    statements = parse_sql(sql)
                plans = []
                for stmt in statements:
                    plan = self._get_ral(
                        stmt, sql_text=sql if len(statements) == 1 else None)
                    plans.append(plan)
                    result = self._run_plan(plan, config_options)
                # a script's later plans were bound against the catalog in
                # the middle of the script: only one statement is cached
                if key is not None and len(plans) == 1:
                    with self._plan_lock:
                        self._plan_cache[key] = plans
                        while len(self._plan_cache) > self._PLAN_CACHE_CAP:
                            self._plan_cache.popitem(last=False)
            if result is None:
                # no result frame (DDL): the lifecycle ends here
                if owned and tr is not None:
                    tr.finish(self.config, self.metrics)
                return None
            result._trace = tr
            result._sql = sql
            if return_futures:
                return result
            return result.compute()

    def _run_plan(self, plan, config_options=None) -> Optional[TorchFrame]:
        """A query's lazy frame; a statement runs now, and its frame holds
        its result (None when it has none).  PREDICT is a query: it runs
        through `Executor.execute_root` and the fused rung."""
        if isinstance(plan, plan_nodes.CustomNode) and not isinstance(
                plan, plan_nodes.PredictModelNode):
            from .physical.executor import Executor

            with self.config.set(config_options):
                table = Executor(self).execute(plan)
            if not table.columns:
                return None
            frame = TorchFrame(self, plan, list(table.column_names),
                               config_options)
            frame._result = table
            return frame
        return TorchFrame(self, plan, [f.name for f in plan.schema],
                          config_options)

    def explain(self, sql: str,
                config_options: Optional[Dict[str, Any]] = None) -> str:
        """The optimized plan of a statement as text."""
        with self.config.set(config_options):
            statements = parse_sql(sql)
            plan = self._get_ral(
                statements[0], sql_text=sql if len(statements) == 1 else None)
        if isinstance(plan, plan_nodes.Explain):
            plan = plan.input
        return plan.explain()

    def visualize(self, sql: str, filename: str = "mydask.png") -> None:
        """Render the optimized plan tree of ``sql`` to a PNG (matplotlib);
        without a renderer, write the plan as text to ``filename`` + ".txt"
        (a name ending in ".txt" is kept).  Copied from the reference."""
        statements = parse_sql(sql)
        plan = self._get_ral(
            statements[0], sql_text=sql if len(statements) == 1 else None)
        if isinstance(plan, plan_nodes.Explain):
            plan = plan.input
        try:
            self._render_plan_png(plan, filename)
        except Exception:  # dsql: allow-broad-except — no matplotlib /
            # headless issues: text fallback below renders instead
            logger.warning("plan image rendering unavailable; writing text",
                           exc_info=True)
            path = filename if filename.endswith(".txt") else filename + ".txt"
            with open(path, "w") as f:
                f.write(plan.explain())

    @staticmethod
    def _render_plan_png(plan, filename: str) -> None:
        """Lay the plan tree out top-down and draw labeled boxes and edges."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # depth-first layout: x = leaf order, y = -depth
        positions: Dict[int, Tuple[float, float]] = {}
        labels: Dict[int, str] = {}
        edges: List[Tuple[int, int]] = []
        next_x = [0.0]

        def walk(node, depth):
            kids = node.inputs()
            xs = []
            for kid in kids:
                walk(kid, depth + 1)
                edges.append((id(node), id(kid)))
                xs.append(positions[id(kid)][0])
            x = sum(xs) / len(xs) if xs else next_x[0]
            if not xs:
                next_x[0] += 1.0
            positions[id(node)] = (x, -float(depth))
            label = node._label()
            labels[id(node)] = label if len(label) <= 42 else label[:39] + "..."

        walk(plan, 0)
        depth = -min(y for _, y in positions.values()) + 1
        width = max(x for x, _ in positions.values()) + 1
        fig, ax = plt.subplots(
            figsize=(max(6, 3.2 * width), max(3, 1.1 * depth)))
        for a, b in edges:
            (x1, y1), (x2, y2) = positions[a], positions[b]
            ax.plot([x1, x2], [y1, y2], "-", color="#888888", zorder=1)
        for nid, (x, y) in positions.items():
            ax.text(x, y, labels[nid], ha="center", va="center", fontsize=8,
                    zorder=2, bbox=dict(boxstyle="round,pad=0.35",
                                        facecolor="#eef3fb",
                                        edgecolor="#4a6fa5"))
        ax.set_axis_off()
        fig.tight_layout()
        fig.savefig(filename, dpi=120)
        plt.close(fig)

    def cost_hint(self, sql: str, config_options=None):
        """The packing scheduler's `QueryCost` of a statement already in the
        plan cache: its estimate's provable floor ``peak_bytes.lo``, the
        family's predicted exec ms (SHOW PROFILES' p50) and its family.
        None for a text not planned yet: submit never plans, and the
        scheduler treats such a query as costing nothing.  A plan the gate
        would stream under this submit's config reserves its per-partition
        floor (``chunk_bytes_lo``)."""
        from .resilience.ladder import plan_fingerprint
        from .serving.scheduler import QueryCost

        with self.config.set(dict(config_options or {})):
            key = self._plan_cache_key(sql, config_options)
        if key is None:
            return None
        with self._plan_lock:
            plans = self._plan_cache.get(key)
        if not plans or len(plans) != 1:
            return None
        plan = plans[0]
        est = getattr(plan, "_dsql_estimate", None)
        fam = getattr(plan, "_dsql_family", None)
        fam_fp = fam.fingerprint if fam is not None else None
        chunk = None
        if est is not None:
            chunk = self._stream_chunk_hint(plan, est, config_options)
        return QueryCost(
            bytes_lo=int(est.peak_bytes.lo) if est is not None else 0,
            pred_exec_ms=self.profiles.predicted_exec_ms(
                fam_fp or plan_fingerprint(plan)),
            family=fam_fp, chunk_bytes_lo=chunk)

    def _stream_chunk_hint(self, plan, est, config_options):
        """The per-partition floor a streamed execution of `plan` would
        reserve under this submit's config, or None (a single run): the
        gate's routing (`streaming.stream_decision`), read only."""
        from .config import parse_byte_budget
        from .streaming import stream_decision

        with self.config.set(dict(config_options or {})):
            budget = parse_byte_budget(
                self.config.get("serving.admission.max_estimated_bytes"))
            if budget is None or int(est.peak_bytes.lo) <= budget:
                return None
            routed = stream_decision(plan, est, self, self.config, budget)
        return int(routed[1].chunk_bytes_lo) if routed is not None else None

    def submit(self, sql: str, priority_class: str = "interactive",
               deadline_s: Optional[float] = None, tenant: str = "",
               config_options: Optional[Dict[str, Any]] = None):
        """Run `sql` on the attached serving runtime (`serving`, a
        `ServingRuntime`) as the reference's server front end runs a
        request, less the HTTP: its cost hint (`cost_hint`), a lifecycle
        trace opened now (so the queue wait is a stage) and a live entry
        begun before the runtime can pop it, then ``runtime.submit`` of
        ``sql(...).compute()``.  Returns ``(qid, future)``; the future's
        result is the pandas frame.  Raises `QueueFullError` (nothing
        registered) when the class queue is full."""
        from .serving.admission import CLASSES, QueryCancelledError
        from .serving.scheduler import QueryCost

        runtime = self.serving
        if runtime is None:
            raise RuntimeError("Context.submit needs a ServingRuntime "
                               "attached as Context.serving")
        qid = uuid.uuid4().hex
        cost = self.cost_hint(sql, config_options)
        if tenant:
            cost = cost or QueryCost()
            cost.tenant = tenant
        trace = None
        if self._trace_enabled():
            trace = observability.QueryTrace(sql=sql, qid=qid,
                                              metrics=self.metrics,
                                              profiles=self.profiles)

        def run(ticket):
            if trace is None:
                return self.sql(sql, config_options=config_options).compute()
            if not any(sp.name == "queue_wait" for sp in trace.spans):
                # once: a retried attempt waited in no queue
                trace.add_span("queue_wait", trace.created_perf,
                               time.perf_counter(), cause=ticket.queue_reason)
            with observability.activate(trace):
                return self.sql(sql, config_options=config_options).compute()

        def finish(f):
            # the terminal outcome, after any retries of the worker
            state, code = "done", None
            exc = None if f.cancelled() else f.exception()
            if f.cancelled() or isinstance(exc, QueryCancelledError):
                state, code = "cancelled", getattr(exc, "code", None)
            elif exc is not None:
                state = "failed"
                code = getattr(exc, "code", None) or type(exc).__name__
            self.live_queries.finish(qid, state, code)
            if state == "failed":
                observability.flight.flush_on_failure(
                    qid, code, self.config, self.metrics)
            if trace is not None:
                trace.finish(self.config, self.metrics)

        # discarded if never admitted, else finished by the future's done
        # dsql: allow-unpaired-effect — callback `finish`
        live = self.live_queries.begin(
            qid, sql=sql, trace=trace, tenant=tenant,
            priority_class=priority_class if priority_class in CLASSES
            else "interactive")
        try:
            _, fut, ticket = runtime.submit(
                run, qid=qid, priority_class=priority_class,
                deadline_s=deadline_s, cost=cost)
        except BaseException:
            # never admitted: a shed query leaves no row behind
            self.live_queries.discard(qid)
            raise
        # the callback first: no later step can leave the row open
        fut.add_done_callback(finish)
        live.ticket = ticket
        if trace is not None:
            self.traces.put(qid, trace)
        return qid, fut

    # ------------------------------------------------------------ front ends
    def run_server(self, **kwargs):
        """Serve this Context over the Presto wire protocol
        (`server/app.py` `run_server`, the same arguments; blocking unless
        ``blocking=False``).  The server is kept as `server`, so
        `stop_server` stops it; the reference never keeps it, so its
        `stop_server` stops nothing."""
        from .server.app import run_server as _run

        return _run(context=self, on_start=self._keep_server, **kwargs)

    def _keep_server(self, server) -> None:
        self.server = server

    def stop_server(self) -> None:
        """Shut down the server `run_server` started and close its port."""
        if self.server is not None:
            self.server.shutdown()
        self.server = None

    def ipython_magic(self, auto_include: bool = False) -> None:
        """Register the ``%%sql`` line and cell magic bound to this Context
        (`integrations/ipython.py`)."""
        from .integrations.ipython import ipython_integration

        ipython_integration(self, auto_include=auto_include)

    def fqn(self, parts) -> Tuple[str, str]:
        """The fully-qualified (schema, table) of a name's parts."""
        return self._table_schema_name(list(parts))

    def cancel_query(self, qid: str) -> bool:
        """Cooperatively cancel an in-flight query by qid: the engine behind
        ``CANCEL QUERY '<qid>'``.  Flags the live entry's ticket; the
        executor raises at its next checkpoint, and a queued serving
        ticket is skipped by the worker that pops it.  False for an
        unknown or finished qid."""
        ok = self.live_queries.cancel(qid)
        self.metrics.inc("serving.cancel_requested")
        observability.flight.record("query.cancel", qid=qid, ok=ok)
        return ok

    def _result_cache_key(self, plan, config_options) -> Optional[Tuple]:
        """Result-cache key: (the plan's family repr and parameter values,
        or its repr; the versions of the tables it reads: uid, rows, delta
        epoch; the config), or None when the result must not be cached:
        caching off, a statement, EXPLAIN ANALYZE (it must run), an
        unseeded TABLESAMPLE, a lazy parquet scan (its files can change on
        disk), a volatile call or a user function anywhere in the plan, an
        unhashable config.  As the reference's."""
        from .datacontainer import LazyParquetContainer

        if not self.config.get("serving.cache.enabled", True):
            return None
        if isinstance(plan, plan_nodes.CustomNode):
            return None
        if isinstance(plan, plan_nodes.Explain) and plan.analyze:
            return None
        table_parts: List[Tuple] = []
        stack = [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, plan_nodes.Sample) and node.seed is None:
                return None
            if isinstance(node, plan_nodes.TableScan):
                dc = self.schema.get(node.schema_name, SchemaContainer(
                    node.schema_name)).tables.get(node.table_name)
                if isinstance(dc, LazyParquetContainer):
                    return None
                if dc is None:
                    view = self._views.get(node.schema_name, {}).get(
                        node.table_name)
                    if view is not None:
                        # the view's own tables version the key
                        stack.append(view)
                table_parts.append(
                    (node.schema_name, node.table_name,
                     None if dc is None else dc.uid,
                     None if dc is None else int(dc.table.num_rows),
                     self.table_epoch(node.schema_name, node.table_name)))
            nested, uncacheable = _scan_node_exprs(node)
            if uncacheable:
                return None
            stack.extend(nested)
            stack.extend(node.inputs())
        try:
            family = getattr(plan, "_dsql_family", None)
            if family is not None:
                parts: List[Any] = ["result", family.family_repr,
                                    family.key_values, self.schema_name]
            else:
                parts = ["result", repr(plan), (), self.schema_name]
            parts.extend(sorted(set(table_parts)))
            parts.append(self.config.effective_items())
            if config_options:
                parts.append(tuple(sorted(config_options.items())))
            key = tuple(parts)
            hash(key)
            return key
        except TypeError:  # an unhashable config value: not cacheable
            return None

    def _plan_table_deps(self, plan) -> frozenset:
        """Every (schema, table) name a plan reads, subquery plans and
        views included: the tags of its result-cache entry."""
        deps = set()
        stack = [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, plan_nodes.TableScan):
                deps.add((node.schema_name, node.table_name))
                if node.table_name not in self.schema.get(
                        node.schema_name,
                        SchemaContainer(node.schema_name)).tables:
                    view = self._views.get(node.schema_name, {}).get(
                        node.table_name)
                    if view is not None:
                        stack.append(view)
            nested, _ = _scan_node_exprs(node)
            stack.extend(nested)
            stack.extend(node.inputs())
        return frozenset(deps)

    def _measured_scan_bytes(self, plan, stream_decision=None) -> int:
        """Resident bytes of the registered tables `plan` scans
        (`serving.cache.table_nbytes`), the scan side of the measured
        footprint the scheduler reconciles its reservation with; a lazy
        parquet table counts nothing, and the table of a streamed
        execution (``stream_decision``) its per-partition share, as its
        reservation was the per-partition floor.  A table's count is kept until its
        uid or delta epoch changes: it walks the host dictionaries, which
        takes tens of ms over a table of a million strings, and every
        query reports it."""
        from .datacontainer import LazyParquetContainer
        from .serving.cache import table_nbytes

        total = 0
        seen = set()
        for node in plan_nodes.walk_plan(plan):
            if not isinstance(node, plan_nodes.TableScan):
                continue
            key = (node.schema_name, node.table_name)
            if key in seen:
                continue
            seen.add(key)
            container = self.schema.get(node.schema_name)
            dc = container.tables.get(node.table_name) \
                if container is not None else None
            if dc is None or isinstance(dc, LazyParquetContainer):
                continue
            version = (dc.uid, self.table_epoch(*key))
            got = self._scan_bytes.get(key)
            if got is None or got[0] != version:
                got = self._scan_bytes[key] = (version, table_nbytes(dc.table))
            nbytes = got[1]
            if stream_decision is not None \
                    and stream_decision.partitions > 1 \
                    and (stream_decision.schema_name,
                         stream_decision.table_name) == key:
                nbytes = -(-nbytes // stream_decision.partitions)
            total += nbytes
        return total

    def _feedback_estimate(self, plan, est, fam):
        """Tighten one fresh or family-memoized estimate's upper bounds
        from the family's observed history (`estimator.apply_feedback`:
        never below the lower bounds, and ``peak_bytes.hi`` never below
        the fused programs' charge) and attach it to the plan.  The
        memoized estimate is never changed, so each later member applies
        feedback against its own, fresher history.  A failure keeps the
        static estimate."""
        if est is None:
            return None
        try:
            from .analysis import estimator
            from .resilience.ladder import plan_fingerprint

            fam_fp = fam.fingerprint if fam is not None else None
            fp = fam_fp or plan_fingerprint(plan)
            # the static rows bound beside the observed ones (SHOW PROFILES)
            self.profiles.record_estimate(fp, est.rows.hi, family=fam_fp)
            out = estimator.apply_feedback(est, self.profiles.get(fp),
                                           self.config, self.metrics)
            plan._dsql_estimate = out
            return out
        except Exception:  # dsql: allow-broad-except — advisory: the static
            # estimate stays in force
            self.metrics.inc("analysis.estimate.internal_error")
            logger.debug("estimate feedback failed; static estimate kept",
                         exc_info=True)
            return est

    def _plan_estimate(self, plan):
        """The estimate riding a plan (made when it was planned), or a
        fresh one when the estimated-bytes gate is configured and the plan
        was never estimated; None otherwise.  A plan-cached query's
        estimate takes the profiles' feedback once history exists
        (`_feedback_estimate`)."""
        from .config import parse_byte_budget

        est = getattr(plan, "_dsql_estimate", None)
        if est is not None:
            if not est.feedback:
                est = self._feedback_estimate(
                    plan, est, getattr(plan, "_dsql_family", None))
            return est
        if parse_byte_budget(self.config.get(
                "serving.admission.max_estimated_bytes")) is None \
                or not self._estimate_enabled() \
                or isinstance(plan, plan_nodes.CustomNode) \
                or _renders_only(plan):
            return None
        return self._run_estimator(plan)

    def _plan_cache_key(self, sql: str, config_options) -> Optional[Tuple]:
        """Cache key of a SQL text against the current catalog and config,
        or None when a config value is unhashable.  DPP reads the dimension
        side at plan time, so its inputs are pinned by the table uids and
        delta epochs."""
        try:
            parts: List[Any] = [sql, self.schema_name]
            parts.extend(self._catalog_signature())
            parts.append(self._catalog_serial)
            parts.append(self.config.effective_items())
            if config_options:
                parts.append(tuple(sorted(config_options.items())))
            key = tuple(parts)
            hash(key)
            return key
        except TypeError:
            return None

    def _catalog_signature(self) -> List[Any]:
        """Versioned identity of the catalog: per schema, its tables' uids
        and delta epochs (registering a table again gives it a new uid, an
        append a new epoch), its statistics' row counts, and its view and
        function names."""
        parts: List[Any] = []
        for schema_name in sorted(self.schema):
            container = self.schema[schema_name]
            parts.append(schema_name)
            parts.append(tuple(sorted(
                (name, dc.uid, self.table_epoch(schema_name, name))
                for name, dc in container.tables.items())))
            parts.append(tuple(sorted(
                (name, s.row_count) for name, s in container.statistics.items()
                if s is not None)))
            parts.append(tuple(sorted(self._views.get(schema_name, {}))))
            parts.append(tuple(sorted(container.function_lists)))
        return parts

    def _get_ral(self, stmt, sql_text: Optional[str] = None):
        """AST -> bound plan -> optimized plan, as the reference's
        `_get_ral`.  With ``sql.native.binder`` ``auto`` (the default) or
        ``on`` and the statement's text at hand, the native planner runs
        parse, bind, the structural rule loop and join reordering in one
        call (``planner.native.plan``), or parse and bind alone when
        ``sql.optimize`` is off or the planner declines
        (``planner.native.bind``); ``on`` raises where ``auto`` falls back
        on a native parser rejection.  The Python binder answers otherwise
        (``planner.python.bind``).  An optimizer failure falls back to the
        unoptimized plan (``planner.optimize.fallback``).  Last, with
        ``families.enabled``, the plan's literals lift into its family
        (``families.parameterized`` counts plans with parameters)."""
        catalog = self._prepare_catalog()
        case_sensitive = bool(self.config.get("sql.identifier.case_sensitive", True))
        catalog.case_sensitive = case_sensitive
        plan = None
        core_optimized = False
        native_mode = str(self.config.get("sql.native.binder", "auto")).lower()
        want_opt = bool(self.config.get("sql.optimize", True))
        with observability.stage("bind") as bind_attrs:
            if sql_text is not None and native_mode in ("auto", "on", "true"):
                from .planner.native_bridge import native_bind, native_plan

                cat_buf = self._encoded_catalog(catalog)
                strict = native_mode != "auto"
                if want_opt:
                    plan = native_plan(
                        sql_text, catalog, cat_buf=cat_buf,
                        predicate_pushdown=bool(
                            self.config.get("sql.predicate_pushdown", True)),
                        strict=strict,
                        fact_dimension_ratio=float(self.config.get(
                            "sql.optimizer.fact_dimension_ratio", 0.7)),
                        max_fact_tables=int(self.config.get(
                            "sql.optimizer.max_fact_tables", 2)),
                        preserve_user_order=bool(self.config.get(
                            "sql.optimizer.preserve_user_order", True)),
                        filter_selectivity=float(self.config.get(
                            "sql.optimizer.filter_selectivity", 1.0)))
                    core_optimized = plan is not None
                    if core_optimized:
                        self.metrics.inc("planner.native.plan")
                if plan is None:
                    plan = native_bind(sql_text, catalog, cat_buf=cat_buf,
                                       strict=strict)
                    if plan is not None:
                        self.metrics.inc("planner.native.bind")
            bind_attrs["native"] = plan is not None
            if plan is None:
                plan = Binder(catalog, case_sensitive=case_sensitive
                              ).bind_statement(stmt)
                self.metrics.inc("planner.python.bind")
        if want_opt:
            from .planner.optimizer.driver import optimize_core, optimize_post
            from .resilience.errors import QueryError

            try:
                with observability.stage("optimize",
                                         core_native=core_optimized):
                    if not core_optimized:
                        plan = optimize_core(plan, self.config, catalog)
                    plan = optimize_post(plan, self.config, catalog,
                                         context=self,
                                         skip_reorder=core_optimized)
            except QueryError:
                raise
            except Exception:
                self.metrics.inc("planner.optimize.fallback")
                logger.warning("Optimization failed; using unoptimized plan",
                               exc_info=True)
        if not isinstance(plan, plan_nodes.CustomNode):
            from . import families

            if families.enabled(self.config):
                with observability.stage("parameterize") as fam_attrs:
                    info = families.family_of(plan, self.config,
                                              metrics=self.metrics)
                    if info is not None:
                        fam_attrs["family"] = info.fingerprint
                        fam_attrs["params"] = info.n_params
                        if info.n_params:
                            self.metrics.inc("families.parameterized")
        # plain EXPLAIN (LINT, ESTIMATE) never executes its input, so only
        # executing plans pay the verification and the estimate here
        wants_verify = not _renders_only(plan)
        verify_mode = str(self.config.get("analysis.verify", "on")).lower()
        if wants_verify and verify_mode not in ("off", "false", "0", "none"):
            from . import analysis

            # error findings raise PlanError now; doomed compiled rungs are
            # marked on the plan, and the ladder skips them
            with observability.stage("verify", mode=verify_mode):
                analysis.verify_and_apply(plan, self,
                                          strict=(verify_mode == "strict"))
        if wants_verify and not isinstance(plan, plan_nodes.CustomNode) \
                and self._estimate_enabled():
            with observability.stage("estimate") as est_attrs:
                est = self._run_estimator(plan)
                if est is not None:
                    est_attrs["rows_hi"] = est.rows.hi
                    est_attrs["bytes_lo"] = est.peak_bytes.lo
        return plan

    def _estimate_enabled(self) -> bool:
        mode = str(self.config.get("analysis.estimate", "on")).lower()
        return mode not in ("off", "false", "0", "none")

    def _trace_enabled(self) -> bool:
        mode = str(self.config.get("observability.trace.enabled",
                                   True)).lower()
        return mode not in ("off", "false", "0", "none")

    def _run_estimator(self, plan):
        """`estimate_and_apply`, guarded: estimation is advisory, so a
        failure of the estimator never blocks a query
        (``analysis.estimate.internal_error``).  A family's estimate holds
        for every member (its intervals never read literal values), so
        later members reuse it (``families.estimate.hit``), unless device
        budget proofs are armed: those mark the concrete plan's nodes."""
        from .analysis import estimator

        try:
            fam = getattr(plan, "_dsql_family", None)
            key = None
            if fam is not None and estimator.device_budget_bytes(
                    self.config) is None:
                try:
                    key = (fam.fingerprint, tuple(self._catalog_signature()),
                           self._catalog_serial,
                           self.config.effective_items())
                    hash(key)
                except TypeError:
                    key = None
            if key is not None:
                cached = self._family_estimates.get(key)
                if cached is not None:
                    plan._dsql_estimate = cached
                    self.metrics.inc("families.estimate.hit")
                    return self._feedback_estimate(plan, cached, fam)
            est = estimator.estimate_and_apply(plan, self)
            if key is not None and est is not None:
                if len(self._family_estimates) >= 512:
                    self._family_estimates.clear()
                self._family_estimates[key] = est
            return self._feedback_estimate(plan, est, fam)
        except Exception:  # dsql: allow-broad-except — advisory: the query
            # runs unestimated
            self.metrics.inc("analysis.estimate.internal_error")
            logger.debug("plan estimation failed; query runs ungated",
                         exc_info=True)
            return None

    def _encoded_catalog(self, catalog: Catalog) -> Optional[bytes]:
        """Catalog bytes for the native planner, kept until a table, view
        or function changes (keyed by the table uids, the statistics' row
        counts, which the native join reorder reads, and the view and
        function serial)."""
        key = (self._catalog_serial, catalog.case_sensitive,
               catalog.current_schema, tuple(
                   (sname, tname, dc.uid,
                    getattr(cont.statistics.get(tname), "row_count", None))
                   for sname, cont in sorted(self.schema.items())
                   for tname, dc in sorted(cont.tables.items())))
        cached = self._catalog_buf_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        from .planner.native_bridge import encode_catalog

        try:
            buf = encode_catalog(catalog)
        except KeyError:
            buf = None
        self._catalog_buf_cache = (key, buf)
        return buf

    def _prepare_catalog(self) -> Catalog:
        """The planner's view of the schemas: tables with their fields and
        statistics, views with their plans, and registered functions."""
        catalog = Catalog(self.schema_name)
        catalog.current_schema = self.schema_name
        for schema_name, container in self.schema.items():
            catalog.add_schema(schema_name)
            cschema = catalog.schemas[schema_name]
            for table_name, dc in container.tables.items():
                stats = container.statistics.get(table_name)
                cschema.tables[table_name] = CatalogTable(
                    table_name, schema_name, _catalog_fields(dc),
                    Statistics(stats.row_count if stats else None),
                    container.filepaths.get(table_name))
            for view_name, view_plan in self._views.get(schema_name,
                                                        {}).items():
                ct = CatalogTable(view_name, schema_name, list(view_plan.schema))
                ct.view_plan = view_plan
                cschema.tables[view_name] = ct
            for fname, fds in container.function_lists.items():
                cschema.functions[fname] = list(fds)
        return catalog

    def _register_view(self, name: str, plan, schema_name: str) -> None:
        self._views.setdefault(schema_name, {})[name] = plan
        self._catalog_serial += 1
        self._on_catalog_change()

    def _table_schema_name(self, parts: List[str]) -> Tuple[str, str]:
        if len(parts) >= 2:
            return parts[-2], parts[-1]
        return self.schema_name, parts[0]

    def _table_fields(self, schema_name: str, table_name: str):
        dc = self.schema[schema_name].tables.get(table_name)
        if dc is not None:
            return [Field(f.name, f.sql_type, True)
                    for f in _catalog_fields(dc)]
        view = self._views.get(schema_name, {}).get(table_name)
        if view is not None:
            return list(view.schema)
        raise KeyError(f"Table {table_name} not found")

    def get_table_data(self, schema_name: str, table_name: str) -> Table:
        """A table's data, or a view's result (its plan runs now)."""
        dc = self.schema[schema_name].tables.get(table_name)
        if dc is not None:
            return dc.table
        view = self._views.get(schema_name, {}).get(table_name)
        if view is not None:
            from .physical.executor import Executor

            return Executor(self).execute(view)
        raise KeyError(f"Table {schema_name}.{table_name} not found")


#: ops whose value changes between runs of the same plan: a result that
#: calls one is never cached
_VOLATILE_OPS = frozenset(
    {"rand", "rand_integer", "current_timestamp", "current_date"})


def _scan_node_exprs(node) -> Tuple[List[Any], bool]:
    """The expressions of one plan node: (subquery plans to walk next,
    uncacheable), uncacheable where a volatile call or a user function is
    found (copied from the reference's function of the same name)."""
    import dataclasses

    from .planner.expressions import (
        ExistsExpr,
        Expr,
        InSubqueryExpr,
        ScalarFunc,
        ScalarSubqueryExpr,
        SortKey,
        UdfExpr,
    )
    from .planner.expressions import walk as expr_walk

    def exprs_of(v):
        if isinstance(v, Expr):
            yield v
        elif isinstance(v, SortKey):
            yield v.expr
        elif isinstance(v, (list, tuple)):
            for item in v:
                yield from exprs_of(item)

    nested: List[Any] = []
    if not dataclasses.is_dataclass(node):
        return nested, False
    for f in dataclasses.fields(node):
        for e in exprs_of(getattr(node, f.name, None)):
            for x in expr_walk(e):
                if isinstance(x, ScalarFunc) and x.op in _VOLATILE_OPS:
                    return nested, True
                if isinstance(x, UdfExpr):
                    return nested, True
                if isinstance(x, (ScalarSubqueryExpr, InSubqueryExpr,
                                  ExistsExpr)) and x.plan is not None:
                    nested.append(x.plan)
    return nested, False


def _renders_only(plan) -> bool:
    """A plain EXPLAIN (its text, LINT or ESTIMATE): it never runs its
    input."""
    return isinstance(plan, plan_nodes.Explain) and not plan.analyze


def _catalog_fields(dc) -> List[Field]:
    """A registered table's fields, nullable where a column has a validity
    mask or floats; a lazy parquet table's from its footers (reading its
    `table` would load it)."""
    from .datacontainer import LazyParquetContainer

    if isinstance(dc, LazyParquetContainer):
        return list(dc.fields)
    return [Field(name, col.sql_type, col.validity is not None or
                  col.sql_type in (SqlType.FLOAT, SqlType.DOUBLE))
            for name, col in dc.table.columns.items()]


def _truthy(value) -> bool:
    """A create_table option that may come as a SQL WITH literal: a bool,
    a number or a string (``'false'`` is False)."""
    if isinstance(value, str):
        return value.strip().lower() in ("true", "1", "on", "yes")
    return bool(value)


def _to_sql_type(t) -> SqlType:
    """A SQL type from a SqlType, its name, a numpy dtype or a Python
    scalar type."""
    if isinstance(t, SqlType):
        return t
    if isinstance(t, str):
        from .columnar.dtypes import parse_sql_type

        return parse_sql_type(t)
    try:
        return np_to_sql(np.dtype(t))
    except (TypeError, ValueError, KeyError):
        pass  # not a numpy dtype spec: the Python scalar types below
    mapping = {int: SqlType.BIGINT, float: SqlType.DOUBLE, str: SqlType.VARCHAR,
               bool: SqlType.BOOLEAN}
    if t in mapping:
        return mapping[t]
    raise NotImplementedError(f"Cannot map {t!r} to a SQL type")
