"""Background recompilation: pipeline rebuilds off the query's path.

A copy of `dask_sql_tpu/serving/background.py`.  The compiled pipelines'
caches key on the table's identity and rows (physical/compiled.py), so a
table that was replaced or grew misses its family's pipeline and the next
query would rebuild it on its own path.  With ``serving.bg_compile.enabled``
the miss of a family seen before with another table is served on a lower
rung while this worker rebuilds the pipeline, runs it once (on the card
that loads the kernels and warms the allocator) and swaps it into the
cache under the cache lock (`physical/compiled.py` `defer_rebuild`); the
next query of the family finds it.

One daemon thread, a bounded pending queue (past it a submission is
dropped and the query builds in the foreground next time), one pending
task per family, and every task's build runs through `timed_build`, so the
compile watchdog applies to it.  A failed task un-marks its family: the
next query takes the foreground path and the ladder's policy.  Under the
pressure controller's YELLOW band (resilience/pressure.py) submissions are
deferred (``resilience.pressure.suspended``).  Off by default.
"""
from __future__ import annotations

import atexit
import logging
import threading
import time
import weakref
from collections import deque
from typing import Callable, Optional, Set, Tuple

logger = logging.getLogger(__name__)

#: live compilers, drained at interpreter exit
_live: "weakref.WeakSet[BackgroundCompiler]" = weakref.WeakSet()
_ATEXIT_JOIN_S = 10.0


@atexit.register
def _drain_at_exit() -> None:
    compilers = list(_live)
    for c in compilers:
        c.cancel()
    for c in compilers:
        c.join(_ATEXIT_JOIN_S)


class BackgroundCompiler:
    """Single bounded daemon worker running compile-and-swap tasks."""

    def __init__(self, metrics=None, max_pending: int = 8,
                 suspended: Optional[Callable[[], bool]] = None):
        self.metrics = metrics
        self.max_pending = max(1, int(max_pending))
        #: pressure gate (resilience/pressure.py): when this returns True
        #: (YELLOW band or worse) submissions are deferred — the caller
        #: falls back to the foreground path and re-submits on a later
        #: miss, so background compiles resume once headroom recovers
        self.suspended = suspended
        self._cv = threading.Condition()
        self._queue: "deque[Tuple[object, Callable[[], None]]]" = deque()
        self._pending: Set[object] = set()
        self._shutdown = False
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_config(cls, config, metrics=None,
                    suspended=None) -> "BackgroundCompiler":
        return cls(metrics=metrics,
                   max_pending=int(config.get(
                       "serving.bg_compile.max_pending", 8)),
                   suspended=suspended)

    # ------------------------------------------------------------- submit
    def submit(self, key, task: Callable[[], None]) -> bool:
        """Enqueue ``task`` under dedup key; False = dropped (full, dup,
        shut down, or deferred under memory pressure) — the caller should
        fall back to the foreground path."""
        if self.suspended is not None and self.suspended():
            if self.metrics is not None:
                self.metrics.inc("resilience.pressure.suspended")
            return False
        with self._cv:
            if self._shutdown or key in self._pending:
                return False
            if len(self._queue) >= self.max_pending:
                if self.metrics is not None:
                    self.metrics.inc("serving.bg_compile.dropped")
                return False
            self._pending.add(key)
            self._queue.append((key, task))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="dsql-bg-compile")
                _live.add(self)
                self._thread.start()
            self._cv.notify()
        if self.metrics is not None:
            self.metrics.inc("serving.bg_compile.submitted")
        return True

    def pending(self, key) -> bool:
        with self._cv:
            return key in self._pending

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._shutdown:
                    self._cv.wait()
                if self._shutdown:
                    return
                key, task = self._queue.popleft()
            t0 = time.perf_counter()
            try:
                task()
            except Exception:  # dsql: allow-broad-except — a failed task must
                # not kill the worker; its family is un-marked by the task's
                # own cleanup
                if self.metrics is not None:
                    self.metrics.inc("serving.bg_compile.failed")
                logger.warning("background compile failed", exc_info=True)
            else:
                if self.metrics is not None:
                    self.metrics.inc("serving.bg_compile.completed")
                    self.metrics.observe(
                        "serving.bg_compile.ms",
                        (time.perf_counter() - t0) * 1000.0)
            finally:
                with self._cv:
                    self._pending.discard(key)
                    self._cv.notify_all()

    # ----------------------------------------------------------- lifecycle
    def cancel(self) -> None:
        """Drop queued tasks and stop the worker after the in-flight one."""
        with self._cv:
            self._shutdown = True
            self._queue.clear()
            self._pending.clear()
            self._cv.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until every submitted task finished (tests/bench)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending or self._queue:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True
