"""Profile-driven warm-up: replay the hot fingerprints before traffic.

A copy of `dask_sql_tpu/serving/warmup.py`.  A checkpoint (checkpoint.py)
carries the per-fingerprint profiles (observability/profiles.py), so a
restarted process knows which query families its predecessor served most.
On `Context.load_state` a background thread replays the top-N profiled
statements through the whole parse->bind->plan->build->execute path: the
plan cache fills, each compiled rung builds its pipeline, and on the card
the kernel libraries load (from the compile cache, serving/compile_cache.py,
when one is set) and the first launches pay their one-time costs.  The
first query after ``ready`` then builds no pipeline in its own path.

Readiness is a state machine (``warming`` -> ``ready``).  The warm-up is
best-effort: a statement that fails to replay (its table dropped since the
snapshot, an injected fault) is counted (``serving.warmup.failed``) and
skipped.  It registers with a `ServingRuntime` when one is attached, whose
shutdown cancels it (between statements, or at the executor's next
checkpoint through the statement's ticket) and joins it.  Under the
pressure controller's YELLOW band it pauses between statements.
"""
from __future__ import annotations

import atexit
import logging
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: warm-up states (the reference's ``/v1/health`` reports them)
IDLE, WARMING, READY = "idle", "warming", "ready"

#: live managers, cancelled and joined (bounded) at interpreter exit: the
#: cancel takes effect at the executor's next checkpoint
_live: "weakref.WeakSet[WarmupManager]" = weakref.WeakSet()
_ATEXIT_JOIN_S = 10.0


@atexit.register
def _drain_at_exit() -> None:
    managers = list(_live)
    for m in managers:
        m.cancel()
    for m in managers:
        m.join(_ATEXIT_JOIN_S)


class WarmupManager:
    """One warm-up pass over the profile store's hottest fingerprints."""

    def __init__(self, context, top_n: int = 8,
                 throttle_s: float = 0.0):
        self.context = context
        self.top_n = max(0, int(top_n))
        self.throttle_s = max(0.0, float(throttle_s))
        self._lock = threading.Lock()
        self._state = IDLE
        self._thread: Optional[threading.Thread] = None
        self._cancel = threading.Event()
        self.total = 0
        self.warmed = 0
        self.failed = 0
        self.skipped = 0
        #: ticket of the in-flight warm statement (cooperative cancel)
        self._current_ticket = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "WarmupManager":
        with self._lock:
            if self._thread is not None:
                return self
            self._state = WARMING
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dsql-warmup")
        _live.add(self)
        self.context.metrics.inc("serving.warmup.started")
        self._thread.start()
        return self

    def cancel(self) -> None:
        """Stop the pass: the in-flight statement aborts at the executor's
        next cancellation checkpoint (its ticket is cancelled), later
        entries never start; ``join`` afterwards for determinism."""
        self._cancel.set()
        with self._lock:
            ticket = self._current_ticket
        if ticket is not None:
            ticket.cancel()

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    # ----------------------------------------------------------- the pass
    @staticmethod
    def _replayable(sql: str) -> bool:
        """Only single read-only statements replay: a profiled SCRIPT can
        carry DDL ("CREATE TABLE ...; SELECT ...") whose re-execution at
        boot would mutate the restored catalog."""
        head = sql.lstrip().lower()
        if not head.startswith(("select", "with", "values", "(")):
            return False
        try:
            from ..planner.parser import parse_sql

            return len(parse_sql(sql)) == 1
        except Exception:  # dsql: allow-broad-except — an unparseable profile
            # is not warmable
            return False

    def _candidates(self) -> List[Tuple[str, str]]:
        return [(fp, sql) for fp, sql
                in self.context.profiles.warm_candidates(self.top_n)
                if self._replayable(sql)]

    def _run(self) -> None:
        ctx = self.context
        entries = self._candidates()
        n_ranked = len(ctx.profiles.top_fingerprints(self.top_n))
        with self._lock:
            self.total = len(entries)
            self.skipped = n_ranked - len(entries)
        if self.skipped:
            # hot fingerprints whose SQL was lost to truncation or never
            # recorded: visible, so an operator knows the warm set is partial
            ctx.metrics.inc("serving.warmup.skipped", self.skipped)
        t_start = time.perf_counter()
        from .admission import QueryTicket
        from . import runtime as _runtime

        for fp, sql in entries:
            # the YELLOW band (resilience/pressure.py): replays are
            # speculative device work; pause between entries until the band
            # recovers (a cancel still takes effect at once)
            paused = False
            pressure = getattr(ctx, "pressure", None)
            while (pressure is not None and not self._cancel.is_set()
                    and pressure.suspend_speculative()):
                if not paused:
                    paused = True
                    ctx.metrics.inc("resilience.pressure.suspended")
                    logger.info("warm-up paused under memory pressure")
                self._cancel.wait(0.05)
            if self._cancel.is_set():
                ctx.metrics.inc("serving.warmup.cancelled")
                logger.info("warm-up cancelled after %d/%d fingerprints",
                            self.warmed, self.total)
                break
            t0 = time.perf_counter()
            # the warm statement runs under a cancellable ticket: cancel()
            # (shutdown drain, interpreter exit) stops it at the executor's
            # next checkpoint
            ticket = QueryTicket(f"warmup-{fp}")
            with self._lock:
                self._current_ticket = ticket
            _runtime._tls.ticket = ticket
            try:
                from ..observability import flight

                flight.record("warmup.replay", fingerprint=fp)
                frame = ctx.sql(sql)
                if frame is not None:
                    if frame._trace is not None:
                        # causality: this trace exists because the warm-up
                        # replayed the profile of fingerprint `fp` — the
                        # export shows why an idle process ran a query
                        frame._trace.event("warmup_replay",
                                           source_profile=fp)
                    # execute only: the warm-up builds and caches; the
                    # pandas tail is per-request work
                    frame.execute()
                with self._lock:
                    self.warmed += 1
                ctx.metrics.inc("serving.warmup.warmed")
                ctx.metrics.observe("serving.warmup.ms",
                                    (time.perf_counter() - t0) * 1000.0)
            except Exception:  # dsql: allow-broad-except — best-effort: one
                # unreplayable profile must not block readiness or later
                # entries
                if self._cancel.is_set():
                    continue  # cancelled mid-statement, not a failure
                with self._lock:
                    self.failed += 1
                ctx.metrics.inc("serving.warmup.failed")
                logger.warning("warm-up replay failed for fingerprint %s",
                               fp, exc_info=True)
            finally:
                _runtime._tls.ticket = None
                with self._lock:
                    self._current_ticket = None
            if self.throttle_s:
                self._cancel.wait(self.throttle_s)
        with self._lock:
            self._state = READY
        logger.info(
            "warm-up ready: %d/%d fingerprints warmed (%d failed) in %.0fms",
            self.warmed, self.total, self.failed,
            (time.perf_counter() - t_start) * 1000.0)

    # -------------------------------------------------------------- reads
    @property
    def ready(self) -> bool:
        with self._lock:
            return self._state == READY

    def status(self) -> Dict[str, object]:
        """The readiness state and counts (the reference's ``/v1/health``
        body)."""
        with self._lock:
            state = self._state
            return {
                "status": state,
                "warmed": self.warmed,
                "total": self.total,
                "failed": self.failed,
            }
