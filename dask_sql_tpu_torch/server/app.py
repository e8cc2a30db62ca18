"""Presto-wire-protocol HTTP server.

Copied from `dask_sql_tpu/server/app.py` onto the port's serving runtime
(`serving/runtime.py`) and Context: every statement runs on the Context's
device, which `run_server` makes the CUDA card unless it is handed a
Context; only the finished pandas frame is serialized on the host.
`main` takes ``--device`` (``cuda`` unless a caller names the CPU).

Role parity: reference server/app.py — POST /v1/statement (app.py:69-100),
async status polling GET /v1/statement/{id} (app.py:44-66), cancellation
DELETE /v1/cancel/{id} (app.py:28-41), /v1/empty, plus JDBC metadata tables
(server/presto_jdbc.py).  Built on the stdlib ThreadingHTTPServer (this image
ships no fastapi/uvicorn).

Queries no longer run on a bare thread pool: submission goes through the
serving runtime (serving/) — bounded per-class admission queues with load
shedding (a submit past the bound returns a structured 429 + Retry-After
through the wire protocol instead of queueing unbounded work), per-query
deadlines that cancel cooperatively at executor checkpoints, and a metrics
registry surfaced at /v1/metrics and via ``SHOW METRICS``.  Clients pick a
concurrency class with the ``X-Dsql-Class: interactive|batch`` header, a
deadline with ``X-Dsql-Deadline-Ms``, and a tenant (for the packing
scheduler's token-bucket quotas, serving/scheduler.py) with
``X-Dsql-Tenant``.
"""
from __future__ import annotations

import json
import logging
import math
import threading
import time
import uuid
from collections import deque
from concurrent.futures import CancelledError
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs

from .. import observability
from ..serving.admission import (
    QueryCancelledError,
    QueryTicket,
    QueueFullError,
)
from ..resilience.errors import ShutdownError
from ..serving.runtime import ServingRuntime
from . import responses

logger = logging.getLogger(__name__)


@dataclass
class _QueryEntry:
    """Lifecycle of one submitted statement, for the stats/metrics surfaces."""

    future: Any
    submitted: float
    ticket: Optional[QueryTicket] = None
    started: Optional[float] = None
    plan_done: Optional[float] = None
    finished: Optional[float] = None
    error: bool = False
    #: the query's lifecycle trace (observability/spans.py), when tracing
    #: is enabled — the status handler appends the serialize span to it
    trace: Optional[observability.QueryTrace] = None

    def live_state(self) -> str:
        """QUEUED/RUNNING only — terminal states must come from the Future
        (a timestamped entry can be FINISHED before the Future resolves)."""
        return "QUEUED" if self.started is None else "RUNNING"

    def queued_ms(self) -> int:
        end = self.started if self.started is not None else time.monotonic()
        return int((end - self.submitted) * 1000)

    def elapsed_ms(self) -> int:
        end = self.finished if self.finished is not None else time.monotonic()
        return int((end - self.submitted) * 1000)


class _QueryRegistry:
    """Per-query lifecycle over the serving runtime.

    The runtime (serving/runtime.py) owns scheduling: class-aware bounded
    admission, the worker pool, deadline/cancel tickets.  This registry owns
    the HTTP-facing bookkeeping — qid -> entry lookup for status polls,
    queued/running gauges, completed-latency aggregates — the analogue of
    the reference's app.future_list (reference server/app.py:20)."""

    #: terminal entries retained for late status polls before eviction
    KEEP_TERMINAL = 512

    def __init__(self, context=None, config=None):
        if config is None:
            from ..config import Config

            config = context.config if context is not None else Config()
        metrics = context.metrics if context is not None else None
        self.runtime = ServingRuntime.from_config(config, metrics=metrics)
        self.metrics_registry = self.runtime.metrics
        self.context = context
        if context is not None:
            # SHOW METRICS surfaces the admission/queue state of the runtime
            context.serving = self.runtime
            # background workers that predate the server (a load_state
            # before run_server started a warm-up) join the drain set, and
            # server boot kicks the warm-up for a context with hot profiles
            # (/v1/health reports warming until the pass completes)
            for worker in (context.warmup, context._bg_compiler):
                if worker is not None:
                    self.runtime.register_background(worker)
            context.maybe_start_warmup()
        self.entries: Dict[str, _QueryEntry] = {}
        self.lock = threading.Lock()
        self.max_workers = self.runtime.workers
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.rejected = 0
        self.n_queued = 0  # gauges, so /v1/metrics never scans the registry
        self.n_running = 0
        self.latency_samples = 0
        self.total_latency_s = 0.0
        self.total_queued_s = 0.0
        self._terminal: "deque[str]" = deque()

    def submit(self, fn, priority_class: str = "interactive",
               deadline_s: Optional[float] = None,
               sql: Optional[str] = None,
               tenant: str = "") -> str:
        """Admit + enqueue; raises `QueueFullError` (load shed) without
        registering an entry.  ``tenant`` (the ``X-Dsql-Tenant`` header)
        feeds the packing scheduler's per-tenant token buckets; the cost
        hint (provable byte floor + predicted exec of a plan-cached SQL)
        feeds its byte packing and drain predictions."""
        qid = str(uuid.uuid4())
        cost = None
        if self.context is not None and sql is not None:
            cost = self.context.cost_hint(sql)
        if tenant:
            from ..serving.scheduler import QueryCost

            cost = cost or QueryCost()
            cost.tenant = tenant
        trace = None
        if self.context is not None and self.context._trace_enabled():
            # the lifecycle trace opens at SUBMIT time, so queue wait is a
            # first-class stage; Context.sql reuses the activated trace.
            # NOT registered in the trace store until admission succeeds —
            # a shed query must not evict traces of queries that ran.
            trace = observability.QueryTrace(
                sql=sql, qid=qid, metrics=self.context.metrics,
                profiles=self.context.profiles)

        def run(ticket):
            with self.lock:
                entry = self.entries.get(qid)
                if entry is None:
                    # defensive: entries outlive running queries now, so a
                    # missing entry means a bookkeeping bug upstream — fail
                    # the query rather than report FINISHED with no data
                    raise QueryCancelledError(f"query {qid} entry lost")
                if entry.started is None:
                    # idempotent: the serving runtime re-invokes run() when
                    # it retries a transient failure; the queued->running
                    # gauge transition must count once
                    entry.started = time.monotonic()
                    self.n_queued -= 1
                    self.n_running += 1
                    if trace is not None:
                        # stage recorded once, guarded by the same
                        # started-transition that makes retries idempotent.
                        # `cause` attributes the wait (byte_blocked /
                        # quota_throttled from the packing scheduler,
                        # workers_busy otherwise) so a long queue_wait span
                        # in the slow-query log explains itself
                        trace.add_span("queue_wait", trace.created_perf,
                                       time.perf_counter(),
                                       cause=ticket.queue_reason)
            if trace is None:
                return fn(lambda: self._mark_planned(qid))
            with observability.activate(trace):
                return fn(lambda: self._mark_planned(qid))

        live_entry = None
        if self.context is not None:
            # the in-flight query table (SHOW QUERIES / GET /v1/queries):
            # registered BEFORE runtime.submit makes the ticket poppable —
            # a fast worker could otherwise reach TorchFrame.execute, find
            # no entry, and take ownership of a duplicate; TorchFrame finds
            # this entry through the serving ticket and updates it in place
            from ..serving.admission import CLASSES

            # finished by TorchFrame.execute / the _finish done-callback;
            # every submit failure discards in the except below
            # dsql: allow-unpaired-effect — custodian is _finish
            live_entry = self.context.live_queries.begin(
                qid, sql=sql, trace=trace, tenant=tenant,
                priority_class=priority_class
                if priority_class in CLASSES else "interactive")
        try:
            with self.lock:
                # entry registered (and future attached) under one lock
                # hold so a status poll can never observe a half-built
                # entry
                try:
                    _, fut, ticket = self.runtime.submit(
                        run, qid=qid, priority_class=priority_class,
                        deadline_s=deadline_s, cost=cost)
                except QueueFullError:
                    self.rejected += 1
                    raise
                if live_entry is not None:
                    live_entry.ticket = ticket
                self.entries[qid] = _QueryEntry(future=fut,
                                                submitted=time.monotonic(),
                                                ticket=ticket, trace=trace)
                self.n_queued += 1
        except BaseException:
            if live_entry is not None:
                # never admitted (shed, shutdown race, submit validation):
                # a failed submit must not occupy the live table — it
                # previously leaked the row on any non-QueueFullError
                # failure (the registry has its own lock; no self.lock
                # needed)
                self.context.live_queries.discard(qid)
            raise
        if trace is not None:
            self.context.traces.put(qid, trace)
            self.context.last_trace = trace
        fut.add_done_callback(lambda f: self._finish(qid, f))
        return qid

    def _mark_planned(self, qid: str):
        with self.lock:
            e = self.entries.get(qid)
            if e is not None and e.plan_done is None:
                e.plan_done = time.monotonic()

    def _finish(self, qid: str, fut):
        """Done-callback: single finalization point for every outcome
        (result, error, deadline, cancel-while-queued, cancel-mid-run)."""
        live_state, live_code = "done", None
        with self.lock:
            e = self.entries.get(qid)
            if e is None or e.finished is not None:
                return
            e.finished = time.monotonic()
            if e.started is None:
                self.n_queued -= 1
            else:
                self.n_running -= 1
            if fut.cancelled():
                self.cancelled += 1
                live_state = "cancelled"
            else:
                exc = fut.exception()
                if isinstance(exc, QueryCancelledError):
                    e.error = True
                    self.cancelled += 1
                    live_state = "cancelled"
                    live_code = getattr(exc, "code", None)
                elif exc is not None:
                    e.error = True
                    self.failed += 1
                    live_state = "failed"
                    live_code = getattr(exc, "code", None) \
                        or type(exc).__name__
                else:
                    self.completed += 1
            # the latency average divides by its own sample count: only
            # queries that actually RAN contribute (a 60s queued-then-
            # cancelled or queued-then-expired query must not inflate the
            # operator's latency average with pure queue wait)
            if e.started is not None:
                self.latency_samples += 1
                self.total_latency_s += e.finished - e.submitted
                self.total_queued_s += e.started - e.submitted
            # retain for late polls, bounded: the Future pins the result frame
            self._terminal.append(qid)
            while len(self._terminal) > self.KEEP_TERMINAL:
                self.entries.pop(self._terminal.popleft(), None)
        if self.context is not None:
            # the live table's terminal outcome — recorded AFTER any
            # worker retries, so one retried attempt never shows failed
            self.context.live_queries.finish(qid, live_state, live_code)
            if live_state == "failed":
                observability.flight.flush_on_failure(
                    qid, live_code, self.context.config,
                    self.context.metrics)
        if e.trace is not None and self.context is not None:
            # terminal for EVERY outcome (result, error, deadline, cancel):
            # close the lifecycle so failed/cancelled outliers reach the
            # slow-query check too (finish is idempotent — a completed
            # query's trace was already closed by TorchFrame.compute)
            e.trace.finish(self.context.config, self.context.metrics)

    def get(self, qid: str) -> Optional[_QueryEntry]:
        with self.lock:
            return self.entries.get(qid)

    def cancel(self, qid: str) -> bool:
        with self.lock:
            entry = self.entries.get(qid)
        if entry is None:
            return False
        if entry.future.cancel():
            # still queued: the runtime worker will skip it; _finish runs
            # via the done-callback
            if entry.ticket is not None:
                entry.ticket.cancel()
            return True
        if entry.future.done():
            return False
        if entry.ticket is not None:
            # running: cooperative — raises at the executor's next
            # per-node cancellation checkpoint
            entry.ticket.cancel()
            return True
        return False

    def metrics(self) -> Dict[str, Any]:
        """Queue-depth / latency snapshot + the serving registry."""
        with self.lock:
            n = self.latency_samples
            out = {
                "workers": self.max_workers,
                "queueDepth": self.n_queued,
                "running": self.n_running,
                "completed": self.completed,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "rejected": self.rejected,
                "avgLatencyMillis": int(self.total_latency_s / n * 1000) if n else 0,
                "avgQueuedMillis": int(self.total_queued_s / n * 1000) if n else 0,
            }
        out["serving"] = self.runtime.snapshot()
        if self.context is not None:
            # refresh the HBM-ledger gauges on every scrape, BEFORE the
            # registry snapshot so they ride this response
            out["ledger"] = self.context.ledger.publish(
                self.metrics_registry)
        out["registry"] = self.metrics_registry.snapshot()
        if self.context is not None:
            out["resultCache"] = self.context._result_cache.snapshot()
        return out

    def shutdown(self):
        self.runtime.shutdown()


def _make_handler(context, registry: _QueryRegistry, jdbc_meta: bool,
                  server: Optional["PrestoServer"] = None):
    class Handler(BaseHTTPRequestHandler):
        server_version = "dask-sql-tpu-presto"

        def log_message(self, fmt, *args):  # quiet
            logger.debug(fmt, *args)

        def _send(self, payload: Dict[str, Any], status: int = 200,
                  headers: Optional[Dict[str, str]] = None):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _base(self) -> str:
            host = self.headers.get("Host", "localhost")
            return f"http://{host}"

        # ------------------------------------------------------------ POST
        def do_POST(self):
            path, _, _query = self.path.partition("?")
            parts = path.strip("/").split("/")
            if len(parts) == 4 and parts[0] == "v1" \
                    and parts[1] == "queries" and parts[3] == "cancel":
                # cooperative cancel by qid: flags the query's ticket so
                # the executor's next checkpoint (per plan node / between
                # streamed launches) raises; a queued query is skipped by
                # the worker that pops it.  Also tries the HTTP registry's
                # Future (covers queued-not-started statements).
                qid = parts[2]
                ok = registry.cancel(qid)
                ok = context.cancel_query(qid) or ok
                self._send({"cancelled": bool(ok)}, 200 if ok else 404)
                return
            if path.rstrip("/") == "/v1/drain" and server is not None:
                # graceful drain (same protocol as SIGTERM): health flips
                # to 503-draining immediately, in-flight queries finish
                # (bounded by serving.shutdown.drain_timeout_s), queued
                # work fails with retryable ShutdownError — the fleet
                # router re-dispatches it to a peer (docs/fleet.md).  The
                # response goes out before the drain starts so the caller
                # is never cut off by its own request.
                already = server.draining.is_set()
                if not already:
                    threading.Thread(target=server.drain,
                                     name="dsql-drain",
                                     daemon=True).start()
                self._send({"status": "draining", "already": already})
                return
            if path.rstrip("/") != "/v1/statement":
                self._send({"error": "unknown endpoint"}, 404)
                return
            length = int(self.headers.get("Content-Length", 0))
            sql = self.rfile.read(length).decode()
            if jdbc_meta:
                # JDBC drivers query the unsupported `system` catalog
                from .presto_jdbc import adjust_for_presto_sql

                sql = adjust_for_presto_sql(sql)
            if not sql.strip():
                self._send(self._empty_results())
                return

            def run(mark_planned):
                result = context.sql(sql)
                mark_planned()  # parse/bind/optimize done; device work next
                return result.compute() if result is not None else None

            priority_class = (self.headers.get("X-Dsql-Class")
                              or "interactive").strip().lower()
            deadline_s = None
            deadline_ms = self.headers.get("X-Dsql-Deadline-Ms")
            if deadline_ms:
                try:
                    deadline_s = max(0.0, float(deadline_ms) / 1000.0)
                except ValueError:
                    deadline_s = None
            tenant = (self.headers.get("X-Dsql-Tenant") or "").strip()
            try:
                qid = registry.submit(run, priority_class=priority_class,
                                      deadline_s=deadline_s, sql=sql,
                                      tenant=tenant)
            except QueueFullError as e:
                # load shed: structured retry-after error instead of
                # accepting unbounded work (parity: Trino's 429 + Retry-After)
                retry_after = int(math.ceil(e.retry_after_s))
                self._send(
                    responses.queue_full_results(str(uuid.uuid4()), e),
                    429, headers={"Retry-After": str(retry_after)})
                return
            except ShutdownError as e:
                # draining/shut down: structured 503 with the retryable
                # taxonomy error — a fleet router retries on a peer
                self._send(
                    responses.error_results(str(uuid.uuid4()), None, e), 503)
                return
            self._send({
                "id": qid,
                "infoUri": f"{self._base()}/v1/info/{qid}",
                "nextUri": f"{self._base()}/v1/statement/{qid}",
                "stats": {**responses.query_stats(), "state": "QUEUED"},
                "warnings": [],
            })

        def _empty_results(self):
            qid = str(uuid.uuid4())
            return {"id": qid, "infoUri": "", "stats": responses.query_stats(),
                    "warnings": [], "columns": [], "data": []}

        def _send_text(self, body: str, content_type: str,
                       status: int = 200):
            data = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        # ------------------------------------------------------------- GET
        def do_GET(self):
            path, _, query = self.path.partition("?")
            parts = path.strip("/").split("/")
            if len(parts) == 3 and parts[0] == "v1" and parts[1] == "statement":
                self._status(parts[2])
                return
            if len(parts) == 3 and parts[0] == "v1" and parts[1] == "trace":
                # the query's lifecycle trace as Chrome-trace JSON — load
                # the download straight into chrome://tracing / Perfetto.
                # A trace with causal links (batch member <-> leader) is
                # merged with its linked traces into one multi-process
                # export so the flow arrows have both endpoints loaded.
                trace = context.traces.get(parts[2])
                if trace is None:
                    self._send({"error": f"no trace for query {parts[2]}"},
                               404)
                    return
                linked = [t for t in
                          (context.traces.get(q) for q in trace.links)
                          if t is not None]
                if linked:
                    self._send(observability.merge_chrome_traces(
                        [trace] + linked))
                else:
                    self._send(trace.to_chrome_trace())
                return
            if len(parts) == 3 and parts[0] == "v1" \
                    and parts[1] == "queries":
                entry = context.live_queries.get(parts[2])
                if entry is None:
                    self._send({"error": f"unknown query {parts[2]}"}, 404)
                    return
                self._send(entry.as_dict())
                return
            if path.rstrip("/") == "/v1/queries":
                # the in-flight query table + the HBM ledger, live
                self._send({
                    "queries": context.live_queries.snapshot(),
                    "ledger": context.ledger.snapshot(),
                })
                return
            if path.rstrip("/") == "/v1/debug/events":
                # the flight recorder's ring, oldest first; ?limit= keeps
                # the newest N, ?name=/&qid= filter
                params = parse_qs(query)
                limit = None
                if params.get("limit"):
                    try:
                        limit = int(params["limit"][0])
                    except ValueError:
                        limit = None
                self._send({"events": observability.flight.RECORDER.events(
                    limit=limit,
                    name=(params.get("name") or [None])[0],
                    qid=(params.get("qid") or [None])[0])})
                return
            if path.rstrip("/") == "/v1/empty":
                self._send(self._empty_results())
                return
            if path.rstrip("/") == "/v1/health":
                # readiness for load balancers AND the fleet router: 503
                # while the profile-driven warm-up is compiling hot query
                # families (serving/warmup.py) or while draining, 200 once
                # the process serves them warm; a context with nothing to
                # warm is ready immediately.  The payload also carries the
                # pressure band and ledger headroom so one health probe is
                # everything the router's cost-aware routing loop needs
                # (fleet/router.py reads the same facts in-process).
                warm = getattr(context, "warmup", None)
                if warm is None:
                    payload = {"status": "ready", "warmed": 0, "total": 0}
                    ready = True
                else:
                    payload = dict(warm.status())
                    ready = warm.ready
                try:
                    psnap = context.pressure.snapshot()
                    payload["band"] = psnap["band"]
                    payload["headroomBytes"] = psnap["headroomBytes"]
                except Exception:  # dsql: allow-broad-except — advisory
                    logger.debug("health: pressure read failed",
                                 exc_info=True)
                if server is not None and server.draining.is_set():
                    payload["status"] = "draining"
                    self._send(payload, 503)
                    return
                self._send(payload, 200 if ready else 503)
                return
            if path.rstrip("/") == "/v1/metrics":
                fmt = (parse_qs(query).get("format") or ["json"])[0].lower()
                if fmt == "prometheus":
                    snap = registry.metrics()
                    extra = {
                        "serving.queue_depth": snap["queueDepth"],
                        "serving.running": snap["running"],
                        "serving.workers": snap["workers"],
                        "serving.result_cache.bytes":
                            snap.get("resultCache", {}).get("bytes", 0),
                    }
                    self._send_text(
                        observability.render_prometheus(
                            snap["registry"], extra),
                        observability.PROMETHEUS_CONTENT_TYPE)
                    return
                self._send(registry.metrics())
                return
            self._send({"error": "unknown endpoint"}, 404)

        def _status(self, qid: str):
            entry = registry.get(qid)
            if entry is None:
                self._send({"error": f"unknown query {qid}"}, 404)
                return
            live_stats = {
                "queuedTimeMillis": entry.queued_ms(),
                "elapsedTimeMillis": entry.elapsed_ms(),
            }
            if not entry.future.done():
                # never report a terminal state here: _finish() may have
                # stamped the entry while the Future is still resolving, and
                # a terminal state without data/error would strand the client
                live_state = entry.live_state()
                self._send({
                    "id": qid,
                    "infoUri": f"{self._base()}/v1/info/{qid}",
                    "nextUri": f"{self._base()}/v1/statement/{qid}",
                    "stats": {**responses.query_stats(), **live_stats,
                              "state": live_state,
                              "queued": live_state == "QUEUED",
                              "progressPercentage": 0},
                    "warnings": [],
                })
                return
            try:
                df = entry.future.result()
            except CancelledError:
                self._send(responses.error_results(
                    qid, None, QueryCancelledError(f"query {qid} cancelled")))
                return
            except Exception as e:  # dsql: allow-broad-except — surfaced to the client
                # taxonomy QueryErrors (cancel mid-run, deadline expiry,
                # shutdown shed, compile/execute failures) carry their own
                # wire code + retryable flag; anything else is classified
                # by error_results, so the client always sees structure
                self._send(responses.error_results(qid, None, e))
                return
            payload = {
                "id": qid,
                "infoUri": f"{self._base()}/v1/info/{qid}",
                "stats": {**responses.query_stats(), **live_stats},
                "warnings": [],
            }
            if df is not None:
                t0 = time.perf_counter()
                payload["columns"] = responses.columns_from_frame(df)
                payload["data"] = responses.data_from_frame(df)
                t1 = time.perf_counter()
                # every poll genuinely re-serializes, so every poll
                # observes — and the metric records with tracing off too
                context.metrics.observe("query.serialize_ms",
                                        (t1 - t0) * 1000.0)
                trace = entry.trace
                if trace is not None:
                    # atomic add-once: concurrent polls of a finished query
                    # both serialize, but only the first records the stage
                    trace.add_span_once("serialize", t0, t1,
                                        rows=len(payload["data"]))
            self._send(payload)

        # ---------------------------------------------------------- DELETE
        def do_DELETE(self):
            parts = self.path.strip("/").split("/")
            if len(parts) == 3 and parts[0] == "v1" and parts[1] == "cancel":
                ok = registry.cancel(parts[2])
                self._send({"cancelled": bool(ok)}, 200 if ok else 404)
                return
            self._send({"error": "unknown endpoint"}, 404)

    return Handler


class PrestoServer:
    def __init__(self, context=None, host: str = "0.0.0.0", port: int = 8080,
                 jdbc_metadata: bool = False):
        from ..context import Context

        self.context = context if context is not None else Context()
        if jdbc_metadata:
            from .presto_jdbc import create_meta_data

            create_meta_data(self.context)
        self.registry = _QueryRegistry(context=self.context)
        #: set when SIGTERM / POST /v1/drain landed: health answers 503
        #: "draining" and new statements shed with retryable ShutdownError
        self.draining = threading.Event()
        handler = _make_handler(self.context, self.registry, jdbc_metadata,
                                server=self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):  # pragma: no cover - blocking entrypoint
        logger.info("Presto server listening on %s", self.httpd.server_address)
        self.httpd.serve_forever()

    def start_background(self) -> "PrestoServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def drain(self, wait: bool = True) -> None:
        """Graceful drain (SIGTERM / ``POST /v1/drain``): flip health to
        503-draining, then let the serving runtime finish in-flight work —
        bounded by ``serving.shutdown.drain_timeout_s``, after which
        stragglers fail with retryable `ShutdownError` instead of the
        drain hanging.  The HTTP listener keeps serving so clients can
        poll out results of queries that finished; a follow-up
        `shutdown()` closes it."""
        if self.draining.is_set():
            return
        self.draining.set()
        observability.flight.record("fleet.drain",
                                    replica=f"server:{self.port}")
        self.context.metrics.inc("fleet.drain")
        self.registry.runtime.shutdown(wait=wait)

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.registry.shutdown()


def run_server(context=None, host: str = "0.0.0.0", port: int = 8080,
               startup: bool = False, log_level=None, blocking: bool = True,
               jdbc_metadata: bool = False, on_start=None):
    """Serve the Presto wire protocol for ``context`` (a new Context on
    the CUDA card when None); blocking, or started on a background thread
    and returned (``blocking=False``).  ``on_start(server)`` is called
    with the server before it serves (`Context.run_server` keeps it)."""
    server = PrestoServer(context, host=host, port=port, jdbc_metadata=jdbc_metadata)
    if on_start is not None:
        on_start(server)
    if blocking:  # pragma: no cover - blocking entrypoint
        import signal

        def _on_sigterm(signum, frame):
            # drain off the signal handler's thread: finish in-flight
            # work (bounded), then stop the listener so serve_forever
            # returns and the process exits cleanly
            def _drain_and_exit():
                server.drain(wait=True)
                server.httpd.shutdown()

            threading.Thread(target=_drain_and_exit, name="dsql-drain",
                             daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not the main thread: embedder owns signal wiring
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
        return None
    return server.start_background()


def main(argv=None):  # pragma: no cover - console entrypoint
    import argparse

    from ..context import Context

    parser = argparse.ArgumentParser(description="Start the SQL server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", default=8080, type=int)
    parser.add_argument("--jdbc-metadata", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the tables and queries "
                             "(default: the CUDA card)")
    args = parser.parse_args(argv)
    run_server(context=Context(device=args.device), host=args.host,
               port=args.port, jdbc_metadata=args.jdbc_metadata)


if __name__ == "__main__":  # pragma: no cover
    main()
