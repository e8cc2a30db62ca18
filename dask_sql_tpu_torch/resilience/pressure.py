"""The pressure controller: bands of card headroom, reclaim, shed.

A copy of `dask_sql_tpu/resilience/pressure.py` on the port's ledger
(`observability/ledger.py`).  The observe->decide->act loop over the
card's bytes:

- **Bands** (`band`): headroom is GREEN/YELLOW/RED/CRITICAL against
  fractions of ``serving.scheduler.device_budget_bytes`` (that key only:
  with no device budget everything stays GREEN).  Transitions publish the
  ``resilience.pressure.band`` gauge and a ``pressure.band`` flight event.
- **YELLOW** (`suspend_speculative`): the warm-up's replays
  (serving/warmup.py), background rebuilds (serving/background.py) and
  new stem pins (materialize/manager.py) wait until the band recovers.
- **RED** (`evaluate`): cross-tier reclaim in priority order until
  headroom is back at the YELLOW floor: the result cache's cold entries
  (`serving/cache.py` `reclaim_bytes`), then the pinned stems
  (`materialize/manager.py` `reclaim_bytes`), then the idle committed
  model params (`inference/registry.py` `reclaim_idle_models`, idle for
  ``resilience.pressure.model_idle_s``).
- **CRITICAL**: serving/admission.py routes new admissions to the streamed
  rungs where the plan allows and sheds the rest with a drain-predicted
  `PressureShedError`.
- **In-flight OOM recovery**: the ladder (resilience/ladder.py) calls
  `reclaim_for_oom` on a ``RESOURCE_EXHAUSTED`` failure (a real
  ``torch.cuda.OutOfMemoryError`` too) and retries the SAME rung once
  before stepping down.  The bytes a reclaim frees go back to PyTorch's
  caching allocator, which serves the retry from them; `mem_get_info`
  does not see them return, `torch.cuda.memory_allocated` does.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Tuple

from .errors import INSUFFICIENT_RESOURCES, QueryError

logger = logging.getLogger(__name__)

#: band order — the index is the published ``resilience.pressure.band``
#: gauge value, so dashboards can alert on ``>= 2`` (RED)
BANDS = ("green", "yellow", "red", "critical")
BAND_LEVEL = {name: i for i, name in enumerate(BANDS)}

ENABLED_KEY = "resilience.pressure.enabled"
MODEL_IDLE_KEY = "resilience.pressure.model_idle_s"
#: band -> (config key, default): headroom at or below ``frac * budget``
#: enters the band
_FRAC_KEYS = {
    "yellow": ("resilience.pressure.yellow_frac", 0.25),
    "red": ("resilience.pressure.red_frac", 0.10),
    "critical": ("resilience.pressure.critical_frac", 0.05),
}


class PressureShedError(QueryError):
    """CRITICAL-band load shed: the device is out of headroom and the plan
    has no streamed rung to brown out onto.  Taxonomy: retryable — the
    Retry-After hint is drain-predicted, so clients back off past the
    pressure spike instead of re-failing into it."""

    code = "PRESSURE_SHED"
    error_type = INSUFFICIENT_RESOURCES
    retryable = True

    def __init__(self, message: str = "", *, retry_after_s: float = 1.0,
                 **kwargs):
        super().__init__(message, **kwargs)
        self.retry_after_s = float(retry_after_s)


class PressureController:
    """Tiered pressure bands over ledger headroom plus the cross-tier
    reclaim walk.  One per Context, built next to the ledger; every read
    is advisory and failure-isolated (a broken accounting input yields
    GREEN / a zero reclaim, never a failed query)."""

    def __init__(self, context):
        self.context = context
        self._lock = threading.Lock()
        self._band = "green"

    # ------------------------------------------------------------- sensing
    def enabled(self) -> bool:
        return bool(self.context.config.get(ENABLED_KEY, True))

    def budget_bytes(self) -> Optional[int]:
        # strictly the scheduler's device budget: the admission byte gate
        # (`serving.admission.max_estimated_bytes`) bounds ONE query's
        # estimate, not the device, so banding on it would mark every
        # deployment whose tables exceed the per-query gate CRITICAL
        from ..config import parse_byte_budget

        return parse_byte_budget(self.context.config.get(
            "serving.scheduler.device_budget_bytes"))

    def headroom_bytes(self, snap: Optional[Dict] = None
                       ) -> Tuple[Optional[int], Optional[int]]:
        """``(headroom, budget)`` against the device budget, or
        ``(None, None)`` when no device budget is configured (banding
        off).  Recomputed from the ledger's per-tier components because
        the snapshot's own headroom uses the admission fallback budget."""
        budget = self.budget_bytes()
        if budget is None:
            return None, None
        if snap is None:
            snap = self.context.ledger.snapshot()
        used = (snap["reservedBytes"] + snap["resultCacheBytes"]
                + snap["tableBytes"] + snap["modelBytes"]
                + snap["materializedBytes"])
        return budget - used, budget

    def band(self, snap: Optional[Dict] = None) -> str:
        """Classify current headroom and record the transition (gauge,
        counter, ``pressure.band`` flight event).  No reclaim — this is
        the cheap read speculative-work gates poll."""
        if not self.enabled():
            return "green"
        try:
            headroom, budget = self.headroom_bytes(snap)
        except Exception:  # dsql: allow-broad-except — advisory sensing
            logger.debug("pressure band read failed", exc_info=True)
            return "green"
        if headroom is None:
            return "green"
        band = "green"
        config = self.context.config
        for name in ("critical", "red", "yellow"):
            key, default = _FRAC_KEYS[name]
            if headroom <= float(config.get(key, default)) * budget:
                band = name
                break
        self._record(band, headroom, budget)
        return band

    def _record(self, band: str, headroom: int, budget: int) -> None:
        with self._lock:
            prev, self._band = self._band, band
        metrics = getattr(self.context, "metrics", None)
        if metrics is not None:
            metrics.gauge("resilience.pressure.band", BAND_LEVEL[band])
        if band != prev:
            if metrics is not None:
                metrics.inc("resilience.pressure.transitions")
            from ..observability import flight

            flight.record("pressure.band", band=band, prev=prev,
                          headroom=headroom, budget=budget)
            log = logger.warning if BAND_LEVEL[band] >= BAND_LEVEL["red"] \
                else logger.info
            log("card pressure band %s -> %s (headroom %d of budget %d)",
                prev, band, headroom, budget)

    # -------------------------------------------------------------- policy
    def suspend_speculative(self) -> bool:
        """YELLOW or worse: warm-up replays, background recompiles and new
        stem materialization must wait (and resume on recovery)."""
        return BAND_LEVEL[self.band()] >= BAND_LEVEL["yellow"]

    def evaluate(self) -> str:
        """The admission-time observe->decide->act step: classify the
        band; RED or worse runs the cross-tier reclaim until headroom
        recovers to the YELLOW floor, then re-reads the band."""
        band = self.band()
        if BAND_LEVEL[band] >= BAND_LEVEL["red"]:
            self.reclaim(None, reason="band")
            band = self.band()
        return band

    # ------------------------------------------------------------- reclaim
    def _deficit_bytes(self) -> Optional[int]:
        """Bytes needed to lift headroom back to the YELLOW floor, or None
        when no device budget is configured."""
        headroom, budget = self.headroom_bytes()
        if headroom is None:
            return None
        key, default = _FRAC_KEYS["yellow"]
        target = float(self.context.config.get(key, default)) * budget
        return max(0, int(target - headroom))

    def reclaim(self, bytes_needed: Optional[int] = None, *,
                reason: str = "band") -> int:
        """Cross-tier reclaim in priority order — cold result-cache
        entries -> unpinned materialized stems -> idle committed model
        params — stopping as soon as the target is met; returns total
        bytes freed.

        ``bytes_needed=None`` targets the deficit to the YELLOW floor.
        With no device budget configured (or a healthy-looking ledger) an
        ``oom`` reclaim drains every reclaimable cold byte instead: the
        device just proved the accounting optimistic, and an OOM is real
        regardless of what the ledger believes."""
        if not self.enabled():
            return 0
        target = bytes_needed
        if target is None:
            deficit = self._deficit_bytes()
            if deficit is None or deficit <= 0:
                if reason != "oom":
                    return 0
                target = None  # unbounded: drain all reclaimable tiers
            else:
                target = deficit
        ctx = self.context
        freed = {"cache": 0, "stems": 0, "models": 0}

        def _remaining() -> Optional[int]:
            if target is None:
                return None
            return target - sum(freed.values())

        def _need_more() -> bool:
            rem = _remaining()
            return rem is None or rem > 0

        t0 = time.perf_counter()
        cache = getattr(ctx, "_result_cache", None)
        if cache is not None and _need_more():
            try:
                freed["cache"] = int(cache.reclaim_bytes(_remaining()))
            except Exception:  # dsql: allow-broad-except — advisory reclaim
                logger.debug("cache reclaim failed", exc_info=True)
        manager = getattr(ctx, "materialize", None)
        if manager is not None and _need_more():
            try:
                freed["stems"] = int(manager.reclaim_bytes(_remaining()))
            except Exception:  # dsql: allow-broad-except — advisory reclaim
                logger.debug("stem reclaim failed", exc_info=True)
        if _need_more():
            try:
                from ..inference.registry import reclaim_idle_models

                idle_s = float(ctx.config.get(MODEL_IDLE_KEY, 120.0))
                freed["models"] = int(reclaim_idle_models(
                    ctx, idle_s=idle_s, bytes_needed=_remaining()))
            except Exception:  # dsql: allow-broad-except — advisory reclaim
                logger.debug("model reclaim failed", exc_info=True)
        total = sum(freed.values())
        metrics = getattr(ctx, "metrics", None)
        if metrics is not None:
            metrics.inc("resilience.pressure.reclaims")
            if total:
                metrics.inc("resilience.pressure.reclaimed_bytes", total)
        from ..observability import flight

        flight.record("pressure.reclaim", reason=reason,
                      needed=target, freed=total,
                      cache_bytes=freed["cache"],
                      stem_bytes=freed["stems"],
                      model_bytes=freed["models"])
        if total:
            logger.info(
                "pressure reclaim (%s) freed %d bytes in %.1fms "
                "(cache %d, stems %d, models %d; target %s)",
                reason, total, (time.perf_counter() - t0) * 1000.0,
                freed["cache"], freed["stems"], freed["models"],
                "all" if target is None else target)
        return total

    # ------------------------------------------------------------ readouts
    def snapshot(self) -> Dict[str, object]:
        headroom, budget = None, None
        try:
            headroom, budget = self.headroom_bytes()
        except Exception:  # dsql: allow-broad-except — advisory readout
            logger.debug("pressure snapshot read failed", exc_info=True)
        with self._lock:
            band = self._band
        return {"band": band, "headroomBytes": headroom,
                "budgetBytes": budget, "enabled": self.enabled()}


def reclaim_for_oom(context, config=None) -> int:
    """The ladder's reclaim-before-degrade hook: free reclaimable cold
    bytes after an in-flight RESOURCE_EXHAUSTED; returns bytes freed (0
    means nothing reclaimable — step down as before).  Failure-isolated:
    a reclaim bug must never mask the original OOM handling."""
    pressure = getattr(context, "pressure", None)
    if pressure is None:
        return 0
    cfg = config if config is not None else context.config
    if not cfg.get(ENABLED_KEY, True):
        return 0
    try:
        return pressure.reclaim(None, reason="oom")
    except Exception:  # dsql: allow-broad-except — advisory reclaim
        logger.debug("oom reclaim failed", exc_info=True)
        return 0
