"""Query-lifecycle span model.

A copy of `dask_sql_tpu/observability/spans.py` on the port's terms.  The
executor's per-plan-node `Tracer` (tracing.py) answers "where inside the
plan did the time go?", but a query also spends time outside the plan
walk: parse, bind, optimize, parameterize, verify, estimate, pipeline
builds, the device-to-host transfer.  This module records those:

- `QueryTrace`: one trace per query, a flat list of `Span`s: sequential
  lifecycle *stages* (parse, bind, optimize, parameterize, verify,
  estimate, execute, d2h), *detail* spans nested in a stage (per-rung
  pipeline builds, the executor's node tree), and zero-duration *events*
  (ladder step downs, breaker skips, rung-proof skips).
- A `contextvars` activation scope: `activate(trace)` installs the trace
  for the current thread of control, so the planner, the ladder and the
  compiled pipelines attach spans without a handle in every signature.
- Chrome-trace export (`to_chrome_trace`): the JSON that chrome://tracing
  and Perfetto load, emitted by ``EXPLAIN ANALYZE FORMAT JSON``.
- `timed_build`: the port's compile is a pipeline build on a cache miss
  (`physical/compiled.py` `singleflight_get_or_build`; there is no jit
  cache to watch).  A build records a ``compile:<rung>`` detail span, a
  ``resilience.compile_ms.<rung>`` histogram observation and the
  fingerprint's profile entry; a warm hit records nothing.

`stage` also stamps the stage on the in-flight query table (``live``),
and a build records ``compile.start``/``compile.end`` flight events.  With
``resilience.compile_timeout_ms`` set, a build runs under the compile
watchdog (resilience/watchdog.py).  The reference's persistent-cache hit
flag on the span has no counterpart: the port's compile cache keeps the
kernel and planner libraries (serving/compile_cache.py), not pipelines.

Span clocks: `time.perf_counter()` (monotonic, process-wide comparable);
each trace also carries an epoch anchor so exported timestamps are
wall-clock meaningful.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from . import flight, live

#: span kinds: "stage" spans are the sequential lifecycle phases (disjoint
#: by construction), "detail" spans nest inside a stage (compiles, plan
#: nodes), "event" spans are zero-duration markers
STAGE, DETAIL, EVENT = "stage", "detail", "event"


@dataclass
class Span:
    name: str
    t0: float  # perf_counter seconds
    t1: Optional[float] = None  # None while open
    kind: str = STAGE
    parent: Optional[str] = None  # enclosing stage name for detail spans
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur_ms(self) -> Optional[float]:
        return None if self.t1 is None else (self.t1 - self.t0) * 1000.0


class QueryTrace:
    """All spans of one query, id'd and exportable.

    Spans are appended under a lock: the HTTP status-poll thread appends
    the serialize span while the trace already lives in the store."""

    def __init__(self, sql: Optional[str] = None, qid: Optional[str] = None,
                 metrics=None, profiles=None):
        self.trace_id = uuid.uuid4().hex[:16]
        self.qid = qid or self.trace_id
        self.sql = (sql or "").strip()[:500]
        #: the context's MetricsRegistry / ProfileStore, so span recorders
        #: deep in the engine (timed_build) reach them without a Context
        self.metrics = metrics
        self.profiles = profiles
        self.fingerprint: Optional[str] = None
        self.spans: List[Span] = []
        #: qids of causally linked queries (a batch member links its
        #: leader, the leader links its members): /v1/trace/{qid} merges
        #: linked traces into one multi-process Chrome export so the flow
        #: arrows have both endpoints loaded
        self.links: List[str] = []
        self._lock = threading.Lock()
        self.created_perf = time.perf_counter()
        #: epoch - perf offset: export wall-clock timestamps from perf spans
        self.epoch_offset = time.time() - self.created_perf
        self.finished = False
        self.slow_logged = False

    # ------------------------------------------------------------- writes
    def add_span(self, name: str, t0: float, t1: Optional[float],
                 kind: str = STAGE, parent: Optional[str] = None,
                 **attrs) -> Span:
        span = Span(name, t0, t1, kind, parent, dict(attrs))
        with self._lock:
            self.spans.append(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, kind: str = STAGE,
             parent: Optional[str] = None, **attrs):
        """Scoped span, appended OPEN at entry (t1=None) so a reader that
        renders mid-span — EXPLAIN ANALYZE reporting from inside its own
        execute stage — sees it as "(open)"; closed in the finally.  A
        failure inside is recorded on the span and re-raised unchanged."""
        span = self.add_span(name, time.perf_counter(), None, kind, parent,
                             **attrs)
        try:
            yield span.attrs  # callers may add attrs while the span is open
        except BaseException as exc:
            span.attrs["error"] = type(exc).__name__
            raise
        finally:
            span.t1 = time.perf_counter()

    def add_span_once(self, name: str, t0: float, t1: Optional[float],
                      kind: str = STAGE, parent: Optional[str] = None,
                      **attrs) -> bool:
        """Append unless a span of this name exists — one atomic
        check-and-add, so concurrent recorders (two status polls both
        serializing the same finished query) cannot duplicate a stage."""
        with self._lock:
            if any(s.name == name for s in self.spans):
                return False
            self.spans.append(Span(name, t0, t1, kind, parent, dict(attrs)))
            return True

    def event(self, name: str, **attrs) -> Span:
        t = time.perf_counter()
        return self.add_span(name, t, t, EVENT, **attrs)

    def link(self, qid: Optional[str]) -> None:
        """Record a causal link to another query's trace (idempotent)."""
        if not qid or qid == self.qid:
            return
        with self._lock:
            if qid not in self.links:
                self.links.append(qid)

    def finish(self, config=None, metrics=None) -> None:
        """Idempotent end-of-lifecycle hook: first call wins and runs the
        slow-query check (observability/slowlog.py)."""
        with self._lock:
            if self.finished:
                return
            self.finished = True
        if config is not None:
            from .slowlog import maybe_log_slow

            maybe_log_slow(self, config, metrics or self.metrics)

    # -------------------------------------------------------------- reads
    def has_span(self, name: str) -> bool:
        with self._lock:
            return any(s.name == name for s in self.spans)

    def stage_spans(self) -> List[Span]:
        """Closed lifecycle stages, sorted by start time."""
        with self._lock:
            out = [s for s in self.spans if s.kind == STAGE
                   and s.t1 is not None]
        return sorted(out, key=lambda s: s.t0)

    def total_ms(self) -> float:
        with self._lock:
            closed = [s for s in self.spans if s.t1 is not None]
        if not closed:
            return 0.0
        return (max(s.t1 for s in closed) - min(s.t0 for s in closed)) * 1e3

    def attach_node_tree(self, root, parent: str = "execute") -> None:
        """Fold an executor `NodeTrace` tree (tracing.py) in as detail
        spans — real timestamps (NodeTrace records its start), so the
        Chrome trace nests them inside the execute stage."""
        if root is None:
            return
        stack = [root]
        while stack:
            node = stack.pop()
            self.add_span(
                node.node_type, node.t0, node.t0 + node.wall_ms / 1e3,
                kind=DETAIL, parent=parent, label=node.label,
                rows=(node.rows if node.rows >= 0 else None))
            stack.extend(node.children)

    # ------------------------------------------------------------- export
    def chrome_events(self, pid: int = 1) -> List[Dict[str, Any]]:
        """This trace's Chrome-trace event list under process id ``pid``.
        Spans/events carrying ``flow_out`` / ``flow_in`` attrs (cross-query
        causality: batch member -> leader launch, background recompile ->
        trigger) additionally emit flow events (ph=s / ph=f) sharing a
        stable numeric id, so Perfetto draws the arrow — across processes
        when linked traces are merged into one export."""
        import zlib

        with self._lock:
            spans = list(self.spans)
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": f"dask-sql-tpu query {self.qid}"},
        }, {
            "name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
            "args": {"name": "query lifecycle"},
        }]
        for s in spans:
            ts = (s.t0 + self.epoch_offset) * 1e6
            args = {k: v for k, v in s.attrs.items() if v is not None}
            if s.parent:
                args["stage"] = s.parent
            if s.kind == EVENT:
                events.append({"name": s.name, "ph": "i", "ts": ts,
                               "pid": pid, "tid": 1, "s": "t", "args": args})
            else:
                dur = 0.0 if s.t1 is None else (s.t1 - s.t0) * 1e6
                events.append({"name": s.name, "ph": "X", "ts": ts,
                               "dur": dur, "cat": s.kind, "pid": pid,
                               "tid": 1, "args": args})
            for key, ph in (("flow_out", "s"), ("flow_in", "f")):
                flow = s.attrs.get(key)
                if flow is None:
                    continue
                ev = {"name": s.name, "cat": "dsql.flow", "ph": ph,
                      "id": zlib.crc32(str(flow).encode()), "ts": ts,
                      "pid": pid, "tid": 1}
                if ph == "f":
                    ev["bp"] = "e"  # bind to the enclosing slice
                events.append(ev)
        return events

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Chrome `trace event profiling` JSON object (ph=X complete
        events, microsecond timestamps) chrome://tracing and Perfetto load
        directly.  Stages and their nested details share tid 1 (nesting by
        containment); events become ph=i instants."""
        with self._lock:
            links = list(self.links)
        return {
            "displayTimeUnit": "ms",
            "traceEvents": self.chrome_events(),
            "otherData": {
                "traceId": self.trace_id,
                "qid": self.qid,
                "sql": self.sql,
                "fingerprint": self.fingerprint,
                "links": links,
            },
        }

    def format_lines(self) -> List[str]:
        """The lifecycle header EXPLAIN ANALYZE prints above the node
        tree: one line per stage in start order, events inline."""
        with self._lock:
            spans = sorted(self.spans, key=lambda s: s.t0)
        lines = [f"-- query lifecycle (trace {self.trace_id}"
                 + (f", fingerprint {self.fingerprint}" if self.fingerprint
                    else "") + ") --"]
        for s in spans:
            if s.kind == DETAIL and not s.name.startswith("compile:"):
                continue  # the node tree renders itself below the header
            if s.kind == EVENT:
                lines.append(f"  !! {s.name}")
                continue
            dur = "(open)" if s.t1 is None else f"{s.dur_ms:10.2f} ms"
            pad = "    " if s.kind == DETAIL else "  "
            lines.append(f"{pad}{s.name:<14} {dur}")
        return lines


def merge_chrome_traces(traces: List["QueryTrace"]) -> Dict[str, Any]:
    """One Chrome-trace JSON over several causally linked traces — each
    query its own process row, flow arrows crossing between them (the
    ``/v1/trace/{qid}`` export when the trace carries links)."""
    events: List[Dict[str, Any]] = []
    for i, tr in enumerate(traces):
        events.extend(tr.chrome_events(pid=i + 1))
    head = traces[0]
    return {
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "otherData": {
            "traceId": head.trace_id,
            "qid": head.qid,
            "sql": head.sql,
            "fingerprint": head.fingerprint,
            "merged": [tr.qid for tr in traces],
        },
    }


class TraceStore:
    """Bounded qid -> QueryTrace LRU; the backing store of
    ``/v1/trace/{qid}`` and `Context.last_trace`."""

    def __init__(self, keep: int = 256):
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, QueryTrace]" = OrderedDict()

    def put(self, qid: str, trace: QueryTrace) -> None:
        with self._lock:
            self._traces[qid] = trace
            self._traces.move_to_end(qid)
            while len(self._traces) > self.keep:
                self._traces.popitem(last=False)

    def get(self, qid: str) -> Optional[QueryTrace]:
        with self._lock:
            return self._traces.get(qid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


# ---------------------------------------------------------------------------
# activation scope
# ---------------------------------------------------------------------------
_current: "contextvars.ContextVar[Optional[QueryTrace]]" = \
    contextvars.ContextVar("dsql_query_trace", default=None)


def current_trace() -> Optional[QueryTrace]:
    """The QueryTrace of the query running on this thread, if any."""
    return _current.get()


@contextlib.contextmanager
def activate(trace: Optional[QueryTrace]):
    """Install `trace` as the current trace for the dynamic extent."""
    token = _current.set(trace)
    try:
        yield trace
    finally:
        _current.reset(token)


def stage(name: str, **attrs):
    """Scoped stage span on the active trace — a no-op context manager
    when no trace is active, so instrumented code never branches.  Also
    stamps the stage onto the in-flight query table (live.py), which works
    with tracing disabled too."""
    live.update(stage=name)
    tr = current_trace()
    if tr is None:
        return contextlib.nullcontext({})
    return tr.span(name, kind=STAGE, **attrs)


def detail(name: str, parent: str = "execute", **attrs):
    """Scoped DETAIL span nested under ``parent`` on the active trace —
    a no-op context manager without one.  The streaming drive loop uses
    this so each partition renders as a child of the execute stage."""
    tr = current_trace()
    if tr is None:
        return contextlib.nullcontext({})
    return tr.span(name, kind=DETAIL, parent=parent, **attrs)


def trace_event(name: str, **attrs) -> None:
    """Zero-duration marker on the active trace (ladder degradations,
    breaker skips, rung-proof skips, admission sheds); no-op without one."""
    tr = current_trace()
    if tr is not None:
        tr.event(name, **attrs)


# ---------------------------------------------------------------------------
# per-rung compile timing
# ---------------------------------------------------------------------------
#: (metrics, profiles, fingerprint, sql, family) of the executing query —
#: installed by TorchFrame.execute for EVERY execution, trace enabled or
#: not, so compile histograms and profiles never go dark when tracing is off
_sink: "contextvars.ContextVar[Optional[tuple]]" = \
    contextvars.ContextVar("dsql_compile_sink", default=None)


@contextlib.contextmanager
def compile_sink(metrics, profiles=None, fingerprint: Optional[str] = None,
                 sql: Optional[str] = None, family: Optional[str] = None):
    """Install the metric/profile destinations for `timed_build` over
    the dynamic extent of one query execution.  `family` is the query's
    literal-stripped family fingerprint (families/), recorded on the
    profile entry so SHOW PROFILES can group by it."""
    token = _sink.set((metrics, profiles, fingerprint, sql, family))
    try:
        yield
    finally:
        _sink.reset(token)


def timed_build(rung: str, build: Callable[[], Any], context=None) -> Any:
    """Build a compiled pipeline for `rung` (a pipeline-cache miss) and
    record the build as the rung's compile: a
    ``resilience.compile_ms.<rung>`` histogram observation and a
    per-fingerprint profile entry (through the installed `compile_sink`,
    so they stay populated with tracing off), plus a ``compile:<rung>``
    detail span when a trace is active.  A build that raises (the pipeline
    declines the plan) records nothing.

    With ``context`` given and its ``resilience.compile_timeout_ms`` set,
    the build runs under the compile watchdog (resilience/watchdog.py): a
    hung build raises a degradable `CompileTimeoutError` and the ladder
    steps down (the ``compile_hang`` site arms here).  On the card every
    kernel library is built and loaded first, outside the deadline, so an
    ``nvcc`` run is never what the watchdog abandons."""
    metrics = profiles = fingerprint = sql = family = None
    sink = _sink.get()
    if sink is not None:
        metrics, profiles, fingerprint, sql, family = sink
    tr = current_trace()
    if tr is not None and metrics is None:
        metrics = tr.metrics
    deadline_ms = None
    if context is not None:
        from ..resilience import faults, watchdog

        deadline_ms = watchdog.timeout_ms(context.config)
    if deadline_ms is not None:
        if context.device.type == "cuda":
            from .. import _build

            for name in _build.KERNELS:
                _build.library(name)
        t0 = time.perf_counter()
        out = watchdog.watched_call(
            rung, build, deadline_ms=deadline_ms,
            hang_s=faults.hang_duration("compile_hang", context.config),
            metrics=metrics if metrics is not None else context.metrics)
    else:
        t0 = time.perf_counter()
        out = build()
    t1 = time.perf_counter()
    ms = (t1 - t0) * 1000.0
    if tr is not None:
        fingerprint = tr.fingerprint or fingerprint
        tr.add_span(f"compile:{rung}", t0, t1, kind=DETAIL, parent="execute",
                    rung=rung, fingerprint=fingerprint)
        profiles = profiles if profiles is not None else tr.profiles
        sql = sql or tr.sql
    if metrics is not None:
        metrics.observe(f"resilience.compile_ms.{rung}", ms)
    if profiles is not None and fingerprint:
        profiles.record_compile(fingerprint, rung, ms, sql=sql,
                                family=family)
    qid = tr.qid if tr is not None else None
    if qid is None:
        from ..serving.runtime import current_ticket

        ticket = current_ticket()
        qid = ticket.qid if ticket is not None else None
    # the start/end pair is stamped when the build is known to have
    # happened, with explicit timestamps for its true window
    wall_end = time.time()
    flight.record("compile.start", qid=qid, ts=wall_end - ms / 1e3,
                  rung=rung)
    flight.record("compile.end", qid=qid, ts=wall_end, rung=rung,
                  ms=round(ms, 3))
    return out
