"""Device-memory ledger: one live accounting view of the card's bytes.
(A copy of `dask_sql_tpu/observability/ledger.py`.)

Four byte decisions meet here: the packing scheduler reserves each
dispatched query's provable floor (serving/scheduler.py
``reserved_bytes``), executions report a measured footprint when they
finish (``QueryTicket.measured_bytes``), the result cache pins result
Tables (serving/cache.py), and registered tables sit at rest on the card
from ``create_table`` on.  This module reconciles them against the device
budget, exposed as ``serving.ledger.*`` gauges (``publish``, refreshed by
SHOW METRICS) and as the ``(ledger)`` block of ``SHOW QUERIES``
(``rows``).

Accounting identities (all bytes):

    reserved          = the packing scheduler's live reservations (the
                        ``serving.scheduler.inflight_bytes`` gauge)
    inflight_measured = measured footprints live queries reported so far
    result_cache      = resident bytes of cached result Tables
    tables            = at-rest bytes of registered (non-lazy) tables
    models            = the model tier's device-resident weights
                        (inference/registry.py `context_model_bytes`)
    materialized      = pinned sub-plan stems (materialize/manager.py
                        `pinned_bytes`)
    headroom          = budget - reserved - result_cache - tables - models
                        - materialized
    drift             = inflight_measured - reserved

Every read is advisory: a broken accounting input yields a partial
ledger, never a failed query.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class DeviceLedger:
    """Live device-memory accounting over one Context."""

    def __init__(self, context):
        self.context = context
        #: (catalog signature key) -> at-rest bytes, so a metrics scrape
        #: does not re-walk every table buffer until the catalog changes
        self._tables_cache: Optional[Tuple[Any, int]] = None

    # ------------------------------------------------------------- inputs
    def budget_bytes(self) -> Optional[int]:
        from ..config import parse_byte_budget

        config = self.context.config
        budget = parse_byte_budget(
            config.get("serving.scheduler.device_budget_bytes"))
        if budget is None:
            budget = parse_byte_budget(
                config.get("serving.admission.max_estimated_bytes"))
        return budget

    def reserved_bytes(self) -> int:
        """The packing scheduler's live reservations (0 when no serving
        runtime is attached or the scheduler is off)."""
        runtime = getattr(self.context, "serving", None)
        scheduler = getattr(runtime, "scheduler", None) \
            if runtime is not None else None
        if scheduler is None:
            return 0
        with runtime._cv:
            return int(scheduler.reserved_bytes)

    def table_bytes(self) -> int:
        """At-rest resident bytes of every registered non-lazy table
        (`serving/cache.table_nbytes` accounting — the same rule the
        estimator and the measured footprints use), cached per catalog
        version so scrapes stay cheap."""
        ctx = self.context
        try:
            key = (ctx._catalog_serial,
                   tuple((sname, tname, dc.uid)
                         for sname, cont in sorted(ctx.schema.items())
                         for tname, dc in sorted(cont.tables.items())))
        except Exception:  # dsql: allow-broad-except — advisory accounting
            key = None
        cached = self._tables_cache
        if key is not None and cached is not None and cached[0] == key:
            return cached[1]
        total = 0
        try:
            from ..datacontainer import LazyParquetContainer
            from ..serving.cache import table_nbytes

            for container in ctx.schema.values():
                for dc in container.tables.values():
                    if isinstance(dc, LazyParquetContainer):
                        continue  # .table is a LOADING property: never peek
                    table = getattr(dc, "table", None)
                    if table is not None:
                        total += table_nbytes(table)
        except Exception:  # dsql: allow-broad-except — advisory accounting
            logger.debug("ledger table accounting failed", exc_info=True)
        if key is not None:
            self._tables_cache = (key, total)
        return total

    def model_bytes(self) -> int:
        """Device-resident bytes of lowered model params (the
        compiled-PREDICT tier's weights, committed to the device on first
        fused use — inference/registry.py), read without a device-to-host
        copy."""
        try:
            from ..inference import context_model_bytes

            return int(context_model_bytes(self.context))
        except Exception:  # dsql: allow-broad-except — advisory accounting
            logger.debug("ledger model accounting failed", exc_info=True)
            return 0

    def materialized_bytes(self) -> int:
        """Device-resident bytes of pinned sub-plan stems (the semantic
        reuse tier's materializations, materialize/manager.py)."""
        manager = getattr(self.context, "materialize", None)
        if manager is None:
            return 0
        try:
            return int(manager.pinned_bytes())
        except Exception:  # dsql: allow-broad-except — advisory accounting
            logger.debug("ledger materialized accounting failed",
                         exc_info=True)
            return 0

    # ------------------------------------------------------------- outputs
    def snapshot(self) -> Dict[str, Any]:
        ctx = self.context
        budget = self.budget_bytes()
        reserved = self.reserved_bytes()
        measured = int(ctx.live_queries.inflight_measured_bytes())
        cache_bytes = int(ctx._result_cache.stats.bytes)
        tables = self.table_bytes()
        models = self.model_bytes()
        materialized = self.materialized_bytes()
        out: Dict[str, Any] = {
            "budgetBytes": budget,
            "reservedBytes": reserved,
            "inflightMeasuredBytes": measured,
            "resultCacheBytes": cache_bytes,
            "tableBytes": tables,
            "modelBytes": models,
            "materializedBytes": materialized,
            "driftBytes": measured - reserved,
        }
        out["headroomBytes"] = None if budget is None else (
            budget - reserved - cache_bytes - tables - models - materialized)
        return out

    def publish(self, metrics) -> Dict[str, Any]:
        """Refresh the ``serving.ledger.*`` gauges from a fresh snapshot
        (called on every ``/v1/metrics`` scrape and ``SHOW METRICS``)."""
        snap = self.snapshot()
        metrics.gauge("serving.ledger.reserved_bytes",
                      snap["reservedBytes"])
        metrics.gauge("serving.ledger.inflight_measured_bytes",
                      snap["inflightMeasuredBytes"])
        metrics.gauge("serving.ledger.cache_bytes",
                      snap["resultCacheBytes"])
        metrics.gauge("serving.ledger.table_bytes", snap["tableBytes"])
        metrics.gauge("serving.ledger.model_bytes", snap["modelBytes"])
        metrics.gauge("serving.ledger.materialized_bytes",
                      snap["materializedBytes"])
        metrics.gauge("serving.ledger.reserve_drift_bytes",
                      snap["driftBytes"])
        if snap["budgetBytes"] is not None:
            metrics.gauge("serving.ledger.budget_bytes",
                          snap["budgetBytes"])
            metrics.gauge("serving.ledger.headroom_bytes",
                          snap["headroomBytes"])
        return snap

    def rows(self) -> List[Tuple[str, str, str]]:
        """The ``SHOW QUERIES`` summary block under the ``(ledger)``
        pseudo-qid."""
        snap = self.snapshot()
        order = ("budgetBytes", "reservedBytes", "inflightMeasuredBytes",
                 "resultCacheBytes", "tableBytes", "modelBytes",
                 "materializedBytes", "headroomBytes", "driftBytes")
        return [("(ledger)", name, "" if snap[name] is None
                 else str(snap[name])) for name in order]
