"""Query observability: lifecycle tracing, per-fingerprint profiles,
Prometheus exposition and slow-query logging (counterpart of
`dask_sql_tpu/observability/`).

- `spans`      — the `QueryTrace` span model, contextvar activation, the
                 bounded `TraceStore` behind `Context.traces`,
                 `timed_build` per-rung compile timing;
- `profiles`   — `ProfileStore`: rolling per-fingerprint compile, exec and
                 result-bytes profiles behind ``SHOW PROFILES``;
- `prometheus` — text exposition of the `MetricsRegistry`;
- `slowlog`    — threshold-gated span-tree dumps of latency outliers;
- `live`       — `QueryRegistry`: the in-flight query table behind
                 ``SHOW QUERIES`` and the target of ``CANCEL QUERY``;
- `ledger`     — `DeviceLedger`: card-byte accounting (reservations,
                 measured footprints, result cache, tables at rest);
- `flight`     — the always-on bounded flight recorder of engine events.
"""
from . import flight
from . import live
from .ledger import DeviceLedger
from .live import LiveQuery, QueryRegistry
from .profiles import ProfileStore
from .prometheus import CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE
from .prometheus import render_prometheus
from .slowlog import maybe_log_slow
from .spans import (
    QueryTrace,
    Span,
    TraceStore,
    activate,
    compile_sink,
    current_trace,
    detail,
    merge_chrome_traces,
    stage,
    timed_build,
    trace_event,
)

__all__ = [
    "DeviceLedger",
    "LiveQuery",
    "ProfileStore",
    "PROMETHEUS_CONTENT_TYPE",
    "QueryRegistry",
    "QueryTrace",
    "Span",
    "TraceStore",
    "activate",
    "compile_sink",
    "current_trace",
    "detail",
    "flight",
    "live",
    "maybe_log_slow",
    "merge_chrome_traces",
    "render_prometheus",
    "stage",
    "timed_build",
    "trace_event",
]
