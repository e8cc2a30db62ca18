"""Slow-query log: the full span tree of latency outliers.
(A copy of `dask_sql_tpu/observability/slowlog.py`.)

A p99 regression is only debuggable if the outlier queries left their
traces behind.  When ``observability.slow_query_ms`` is set (None = off;
0 logs every query — useful in tests and short repros), any query whose
trace spans a total wall time at or above the threshold is written out
once, at trace finish:

- to ``observability.slow_query_path`` as one JSON line per query
  (qid, trace id, sql, total_ms, fingerprint, and every span with
  timestamps/durations/attrs — the machine-readable span tree), or
- to this module's logger at WARNING when no path is configured.

Each write increments the ``observability.slow_query`` counter so SHOW
METRICS shows the outlier *rate* even when nobody tails the log file.
"""
from __future__ import annotations

import json
import logging
import threading
import time

logger = logging.getLogger(__name__)

#: serializes appends from concurrent worker threads so JSONL lines never
#: interleave mid-record
_write_lock = threading.Lock()


def _threshold_ms(config) -> float:
    """The configured threshold in ms, or None when the log is off.
    Unlike the byte budgets, 0 is a real value here (log everything)."""
    raw = config.get("observability.slow_query_ms")
    if raw is None or raw is False or raw == "":
        return None
    if isinstance(raw, str) and raw.strip().lower() in ("none", "off",
                                                        "false"):
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError):
        logger.warning("unparseable observability.slow_query_ms %r; "
                       "slow-query log disabled", raw)
        return None
    return ms if ms >= 0 else None


def maybe_log_slow(trace, config, metrics=None) -> bool:
    """Write `trace` to the slow-query log if it crossed the threshold.
    Called from `QueryTrace.finish`; at most one write per trace."""
    threshold = _threshold_ms(config)
    if threshold is None:
        return False
    total = trace.total_ms()
    if total < threshold:
        return False
    if trace.slow_logged:
        return False
    trace.slow_logged = True
    if metrics is not None:
        metrics.inc("observability.slow_query")
    record = {
        "ts": time.time(),
        "qid": trace.qid,
        "trace_id": trace.trace_id,
        "fingerprint": trace.fingerprint,
        "sql": trace.sql,
        "total_ms": round(total, 3),
        "threshold_ms": threshold,
        "spans": [
            {"name": s.name, "kind": s.kind, "parent": s.parent,
             "start_ms": round((s.t0 - trace.created_perf) * 1e3, 3),
             "dur_ms": None if s.dur_ms is None else round(s.dur_ms, 3),
             "attrs": {k: v for k, v in s.attrs.items() if v is not None}}
            for s in sorted(trace.spans, key=lambda s: s.t0)
        ],
    }
    path = config.get("observability.slow_query_path")
    if path:
        try:
            with _write_lock, open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            logger.warning("slow-query log write to %r failed", path,
                           exc_info=True)
            logger.warning("slow query %s (%.1f ms >= %.1f ms): %s",
                           trace.qid, total, threshold, json.dumps(record))
    else:
        logger.warning("slow query %s (%.1f ms >= %.1f ms): %s",
                       trace.qid, total, threshold, json.dumps(record))
    return True
