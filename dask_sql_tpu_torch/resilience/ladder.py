"""The degradation ladder: compiled rungs, then the interpreted walk.

Counterpart of `plan_fingerprint`, `attempt` and `execute_interpreted` in
`dask_sql_tpu/resilience/ladder.py`.  Each fast path of the executor is a
rung that returns None to decline a plan it does not take; `attempt` also
steps down when the rung fails *degradably* (`errors.classify`: a
`CompileError`, a `ResourceExhaustedError` such as "CUDA out of memory"),
counting ``resilience.degraded`` and ``resilience.degraded.<rung>``.  Any
other failure propagates: a kernel that fails to build or launch is an
`ExecutionError` and must never be hidden by a lower rung.  The rung that
answers is counted in ``resilience.rung.<rung>``.

Rungs in the port: ``compiled_select`` (physical/compiled_select.py),
``compiled_join_aggregate`` (physical/compiled_join.py),
``compiled_aggregate`` (physical/compiled.py), and the interpreted walk
under them (the eager plugins, the eager aggregate among them).  Not in
the port yet: the per-plan circuit breaker, fault injection, reclaim under
memory pressure, cost-based and verifier skips, and the reference's CPU
rung under the interpreted walk, which would re-run a failed query on the
host and so hide the card.
"""
from __future__ import annotations

import hashlib
import logging
from typing import Callable, Optional, TypeVar

from .errors import classify

logger = logging.getLogger(__name__)

T = TypeVar("T")


def plan_fingerprint(rel) -> str:
    """Stable identity of a plan shape: its dataclass repr (every semantic
    field, recursively) hashed down to 16 hex characters."""
    return hashlib.sha1(repr(rel).encode()).hexdigest()[:16]


def attempt(executor, rung: str, fn: Callable[[], Optional[T]],
            rel=None) -> Optional[T]:
    """Run one rung; None means "step down to the next rung".

    ``fn`` returns None to decline (not an error, not counted).  A
    degradable failure inside it also returns None, counted in
    ``resilience.degraded`` and ``resilience.degraded.<rung>``; every other
    failure propagates as raised.  With ``resilience.ladder.enabled`` off
    the rung runs bare, so a degradable failure propagates too."""
    if not executor.config.get("resilience.ladder.enabled", True):
        return fn()
    metrics = executor.context.metrics
    try:
        out = fn()
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as exc:  # degradable failures are the ladder's
        err = classify(exc)
        if not err.degradable:
            raise
        metrics.inc("resilience.degraded")
        metrics.inc(f"resilience.degraded.{rung}")
        logger.info("rung %s degraded (%s) for plan %s; stepping down", rung,
                    err.code, plan_fingerprint(rel) if rel is not None else "-")
        return None
    if out is not None:
        metrics.inc(f"resilience.rung.{rung}")
    return out


def execute_interpreted(executor, rel):
    """The bottom of the ladder: the eager per-operator walk.  A failure
    here propagates; the reference's CPU re-run under it is not in the
    port (it would answer on the host what failed on the card)."""
    return executor.execute(rel)
