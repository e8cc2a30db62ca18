"""The serving tier of the port: the layer between the callers and the
executor for multi-query traffic (counterpart of `dask_sql_tpu/serving/`).

- :mod:`.admission` — bounded per-class admission with deadlines, load
  shedding and the estimated-bytes gate;
- :mod:`.cache` — the LRU-by-bytes result cache;
- :mod:`.metrics` — counters, gauges and histograms (``c.metrics``);
- :mod:`.scheduler` — the packing scheduler (device byte budget,
  deadlines, tenant quotas);
- :mod:`.runtime` — the worker pool tying them together;
- :mod:`.warmup`, :mod:`.background`, :mod:`.compile_cache` — cold
  starts: the profile-driven warm-up, background rebuilds and the kept
  kernel and planner libraries.
"""
from ..resilience.errors import ShutdownError
from .admission import (
    AdmissionController,
    DeadlineExceededError,
    EstimatedBytesExceededError,
    QueryCancelledError,
    QueryTicket,
    QueueFullError,
)
from .cache import ResultCache, table_nbytes
from .metrics import Histogram, MetricsRegistry
from .runtime import ServingRuntime, current_ticket, ticket_scope
from .scheduler import PackingScheduler, QueryCost, TokenBucket

__all__ = [
    "AdmissionController",
    "DeadlineExceededError",
    "EstimatedBytesExceededError",
    "Histogram",
    "MetricsRegistry",
    "PackingScheduler",
    "QueryCancelledError",
    "QueryCost",
    "QueryTicket",
    "QueueFullError",
    "ResultCache",
    "ServingRuntime",
    "ShutdownError",
    "TokenBucket",
    "current_ticket",
    "table_nbytes",
    "ticket_scope",
]
