"""Prometheus text exposition of the MetricsRegistry.
(A copy of `dask_sql_tpu/observability/prometheus.py`.)

``/v1/metrics?format=prometheus`` renders the same snapshot the JSON
default serves, in the Prometheus `text exposition format 0.0.4` a scrape
job ingests directly — no client library dependency (the image ships
none), just the format:

- counters   -> ``dsql_<name>_total`` (TYPE counter)
- gauges     -> ``dsql_<name>`` (TYPE gauge)
- histograms -> ``dsql_<name>`` (TYPE summary): ``{quantile="0.5|0.95|
  0.99"}`` series from the registry's reservoir percentiles plus
  ``_sum``/``_count``, and a ``dsql_<name>_max`` gauge

Metric names are sanitized (``[^a-zA-Z0-9_:]`` -> ``_``), so the engine's
dotted names stay recognizable: ``query.cache.hit`` ->
``dsql_query_cache_hit_total``.  Output is sorted, making the format
golden-testable byte for byte.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

_PREFIX = "dsql_"
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")

#: the content type a Prometheus scraper expects
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _name(raw: str, suffix: str = "") -> str:
    return _PREFIX + _SANITIZE.sub("_", raw) + suffix


def _num(v: Any) -> str:
    f = float(v)
    if f == int(f):
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: Dict[str, Any],
                      extra_gauges: Optional[Dict[str, Any]] = None) -> str:
    """Render a `MetricsRegistry.snapshot()` (plus optional extra gauges,
    e.g. serving queue depths) to exposition text."""
    lines: List[str] = []

    for raw in sorted(snapshot.get("counters", {})):
        name = _name(raw, "_total")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_num(snapshot['counters'][raw])}")

    gauges = dict(snapshot.get("gauges", {}))
    if "cacheHitRate" in snapshot:
        gauges["query.cache.hit_rate"] = snapshot["cacheHitRate"]
    gauges.update(extra_gauges or {})
    for raw in sorted(gauges):
        name = _name(raw)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_num(gauges[raw])}")

    for raw in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][raw]
        name = _name(raw)
        lines.append(f"# TYPE {name} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'{name}{{quantile="{q}"}} {_num(h[key])}')
        lines.append(f"{name}_sum {_num(h['sum'])}")
        lines.append(f"{name}_count {_num(h['count'])}")
        lines.append(f"# TYPE {name}_max gauge")
        lines.append(f"{name}_max {_num(h['max'])}")

    return "\n".join(lines) + "\n"
