"""Query observability: lifecycle tracing, per-fingerprint profiles,
Prometheus exposition and slow-query logging (counterpart of
`dask_sql_tpu/observability/`).

- `spans`      — the `QueryTrace` span model, contextvar activation, the
                 bounded `TraceStore` behind `Context.traces`,
                 `timed_build` per-rung compile timing;
- `profiles`   — `ProfileStore`: rolling per-fingerprint compile, exec and
                 result-bytes profiles behind ``SHOW PROFILES``;
- `prometheus` — text exposition of the `MetricsRegistry`;
- `slowlog`    — threshold-gated span-tree dumps of latency outliers.

The in-flight query table (`live`), the HBM ledger (`ledger`) and the
flight recorder (`flight`) come with the serving runtime (ROADMAP.md
Queue 1 item 8b).
"""
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
    "ProfileStore",
    "PROMETHEUS_CONTENT_TYPE",
    "QueryTrace",
    "Span",
    "TraceStore",
    "activate",
    "compile_sink",
    "current_trace",
    "detail",
    "maybe_log_slow",
    "merge_chrome_traces",
    "render_prometheus",
    "stage",
    "timed_build",
    "trace_event",
]
