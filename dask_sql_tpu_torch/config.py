"""Per-context configuration of the PyTorch port.

Counterpart of `dask_sql_tpu/config.py`, with only the keys this port reads
and the reference's defaults.  Each `Context` owns one `Config`; `set()`
pushes a scoped overlay (per-query options of `Context.sql`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

DEFAULTS: Dict[str, Any] = {
    "sql.identifier.case_sensitive": True,
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
    # segment-sum mode: auto | scatter | matmul | pallas (the last two pick
    # the hand-written kernel, ops/segsum.py choose_segsum_impl)
    "sql.compile.segsum": "auto",
    # the degradation ladder (resilience/ladder.py): off runs each rung bare,
    # so a degradable failure propagates instead of stepping down
    "resilience.ladder.enabled": True,
    # load-time column encodings (columnar/encodings.py): auto | off
    "columnar.encoding": "auto",
    "columnar.encoding.min_rows": 1024,
    "columnar.encoding.dict": True,
    "columnar.encoding.for": True,
    "columnar.encoding.rle": True,
    "columnar.encoding.dict_max_card": 1 << 15,
}


class Config:
    """Base values + thread-local scoped overlays."""

    def __init__(self):
        self._values: Dict[str, Any] = dict(DEFAULTS)
        self._local = threading.local()

    def get(self, key: str, default: Any = None) -> Any:
        for frame in reversed(getattr(self._local, "stack", None) or ()):
            if key in frame:
                return frame[key]
        return self._values.get(key, default)

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
