"""The degradation ladder: compiled rungs, the interpreted walk, the CPU.

Counterpart of `dask_sql_tpu/resilience/ladder.py`.  Each fast path of the
executor is a rung that returns None to decline a plan it does not take;
`attempt` also steps down when the rung fails *degradably*
(`errors.classify`: a `CompileError`, a `ResourceExhaustedError` such as
``torch.cuda.OutOfMemoryError``), counting ``resilience.degraded`` and
``resilience.degraded.<rung>``.  Any other failure propagates: a kernel
that fails to build or launch is an `ExecutionError` and is never hidden
by a lower rung.  The rung that answers is counted in
``resilience.rung.<rung>``.

- Fault injection (`faults.py`): a rung's ``inject_site`` arms at its entry
  (``compile``), so every step down is provable in a test.
- A per-(plan family, rung) circuit breaker (`retry.py`, the Context's
  ``breaker``): a rung that failed ``resilience.breaker.threshold`` times
  in a row for a family is skipped (``resilience.breaker.skip``) until a
  half-open trial after ``cooldown_s`` passes.  The key is the family
  fingerprint, so Q1 with another date literal is the same entity.
- Verifier skips (`analysis/verifier.py`, `estimator.py`): a rung proven
  doomed at plan time (``_dsql_skip_rungs`` on the node) is skipped without
  an attempt or a breaker charge (``analysis.rung_skip``).
- `execute_interpreted` is the bottom of the device ladder.  On a CPU
  Context a degradable failure of the eager walk re-runs the whole plan
  with the compiled rungs off, ``resilience.rung.cpu``, as the reference's
  CPU rung does.  On the card there is no rung below it: the failure (a
  device OOM) leaves the query as a degradable `ResourceExhaustedError`,
  and the caller may submit the query again to a CPU Context.  The port
  never moves a card query's work to the host behind the caller's back,
  where the kernels would not run.

- The cost-based skip (`cost_skip`, ``resilience.ladder.cost_based``):
  a compiled rung whose predicted build cost can never amortize for a
  family that already runs on a lower rung is skipped, a choice counted
  in ``serving.scheduler.cost_rung_skip``, never a degradation.
- Reclaim-before-degrade: a ``RESOURCE_EXHAUSTED`` failure (an injected
  one or a real ``torch.cuda.OutOfMemoryError``) first asks the pressure
  controller (`pressure.py`) to free cold cached bytes and retries the
  same rung once (``resilience.pressure.rung_retry``/``_ok``); with
  nothing to free it steps down as before.

Rungs in the port: ``compiled_predict`` (physical/compiled_predict.py,
only for a root PREDICT, stepping down to the host tier),
``streamed_select`` and ``streamed_aggregate``
(streaming/, only for plans the admission gate routed there),
over a sharded scan ``spmd_select``, ``spmd_join_aggregate`` and
``spmd_aggregate`` (spmd/, each above its one-device counterpart, a
``rung:<rung>`` event with the spmd attribute marking that one answered),
``compiled_select`` (physical/compiled_select.py),
``compiled_join_aggregate`` (physical/compiled_join.py),
``compiled_aggregate`` (physical/compiled.py), over a sharded input
``dist_aggregate`` and ``dist_sort`` (parallel/dist_plan.py),
``interpreted`` (the eager plugins) and ``cpu`` (on a CPU Context).  Each skip and step down is an event on the query's
lifecycle trace (`observability/spans.py`), and a step down a marker in
EXPLAIN ANALYZE's node tree; a rung that answers records its wall time on
the fingerprint's profile (SHOW PROFILES), the evidence `cost_skip`
reads.  The reference's CPU rung also serves a query on the accelerator
(jax steers new arrays to the host); the port's does not (ROADMAP.md
Queue 3).
"""
from __future__ import annotations

import hashlib
import logging
import time
from typing import Callable, Optional, TypeVar

from ..observability import flight, live, trace_event
from . import faults
from .errors import QueryError, ResourceExhaustedError, classify

logger = logging.getLogger(__name__)

T = TypeVar("T")

#: rung-name prefixes whose first run for a family pays a build: the
#: candidates of the cost-based skip
_COMPILE_RUNG_PREFIXES = ("compiled_", "spmd_")


def plan_fingerprint(rel) -> str:
    """Stable identity of a plan shape: its dataclass repr (every semantic
    field, recursively) hashed down to 16 hex characters."""
    return hashlib.sha1(repr(rel).encode()).hexdigest()[:16]


def _fingerprint_of(executor, rel) -> str:
    """Breaker identity of the executing plan: the literal-stripped family
    fingerprint when plan families are on (a rung that dies for one date
    literal is the same hazard for another), else the plan fingerprint.
    Kept on the executor, so every rung of one query shares it."""
    fp = getattr(executor, "_resilience_fp", None)
    if fp is None:
        from ..families import family_of

        info = family_of(rel, executor.config,
                         metrics=executor.context.metrics)
        fp = info.fingerprint if info is not None else plan_fingerprint(rel)
        executor._resilience_fp = fp
    return fp


def _breaker_of(executor):
    if not executor.config.get("resilience.breaker.enabled", True):
        return None
    return getattr(executor.context, "breaker", None)


def cost_skip(executor, rung: str, rel) -> bool:
    """Cost-based rung selection (``resilience.ladder.cost_based``), the
    reference's rule: skip a build-bearing rung whose predicted build cost
    can never amortize for this family.  Evidence-gated: the family must
    have observed exec history, the rung must not have built for it yet,
    and a per-rung build-cost prior (the p50 of the Context's
    ``resilience.compile_ms.<rung>`` history) must exist.  Skip when
    ``prior > amortize_factor x hits x observed exec_ms p50``.  The port's
    prior is a pipeline build (`timed_build`), far cheaper than the
    reference's XLA compile, so on the same history the skip fires less
    often; given the same profile entries the decision is the
    reference's.  Any failure here means no skip."""
    try:
        config = executor.config
        if not config.get("resilience.ladder.cost_based", True):
            return False
        if not rung.startswith(_COMPILE_RUNG_PREFIXES):
            return False
        # the prior first: without one there is no claim, and reading it
        # is cheaper than copying the family's profile
        compile_pred = executor.context.metrics.hist_percentile(
            f"resilience.compile_ms.{rung}", 0.5)
        if compile_pred is None:
            return False
        profiles = getattr(executor.context, "profiles", None)
        if profiles is None:
            return False
        entry = profiles.get(_fingerprint_of(executor, rel))
        if entry is None:
            return False
        if entry["compile"].get(rung):
            return False
        exec_hist = entry.get("exec_ms") or []
        if not exec_hist:
            return False
        observed = sorted(exec_hist)[len(exec_hist) // 2]
        hits = max(1, int(entry.get("hits", 0)))
        factor = float(
            config.get("resilience.ladder.cost.amortize_factor", 4.0))
        return compile_pred > factor * hits * max(observed, 1e-3)
    except Exception:  # dsql: allow-broad-except — an advisory choice: a bug
        # means no skip
        logger.debug("cost-based rung selection failed open", exc_info=True)
        return False


def _reclaimed(executor) -> int:
    """Bytes the pressure controller freed for an in-flight OOM."""
    from .pressure import reclaim_for_oom

    return reclaim_for_oom(executor.context, executor.config)


def attempt(executor, rung: str, fn: Callable[[], Optional[T]],
            rel=None, inject_site: Optional[str] = None) -> Optional[T]:
    """Run one rung; None means "step down to the next rung".

    ``fn`` returns None to decline (not an error, not counted).  A rung the
    plan verifier or estimator proved doomed, or whose breaker is open for
    this family, is skipped.  A degradable failure inside ``fn`` returns
    None, counted and charged to the breaker; every other failure
    propagates.  With ``resilience.ladder.enabled`` off the rung runs bare
    (its fault site still arms), so a degradable failure propagates too."""
    if not executor.config.get("resilience.ladder.enabled", True):
        if inject_site is not None:
            faults.maybe_inject(inject_site, executor.config)
        return fn()
    metrics = executor.context.metrics
    skip_rungs = getattr(rel, "_dsql_skip_rungs", None)
    if skip_rungs and rung in skip_rungs:
        metrics.inc("analysis.rung_skip")
        metrics.inc(f"analysis.rung_skip.{rung}")
        trace_event(f"rung_proof_skip:{rung}")
        logger.debug("plan verifier marked rung %s doomed: skipping", rung)
        return None
    breaker = _breaker_of(executor)
    key = None
    if breaker is not None and rel is not None:
        key = (_fingerprint_of(executor, rel), rung)
        # a declined rung leaves a half-open trial pending; the cooldown
        # re-arms it (retry.py)
        # dsql: allow-unpaired-effect — cooldown re-arms a pending trial
        if not breaker.allow(key):
            metrics.inc("resilience.breaker.skip")
            metrics.inc(f"resilience.breaker.skip.{rung}")
            trace_event(f"breaker_skip:{rung}", fingerprint=key[0])
            logger.debug("breaker open for rung %s: skipping", rung)
            return None
    if rel is not None and cost_skip(executor, rung, rel):
        # a predicted-cost choice, not a failure: no degradation count,
        # no breaker charge
        metrics.inc("serving.scheduler.cost_rung_skip")
        metrics.inc(f"serving.scheduler.cost_rung_skip.{rung}")
        trace_event(f"cost_rung_skip:{rung}")
        logger.debug("cost model predicts rung %s cannot amortize: "
                     "skipping", rung)
        return None
    t0 = time.perf_counter()
    reclaim_tried = retried = False
    err = None
    while True:
        try:
            if inject_site is not None:
                faults.maybe_inject(inject_site, executor.config)
            out = fn()
            break
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:  # dsql: allow-broad-except — degradable
            # failures are the ladder's
            err = classify(exc)
            if not err.degradable:
                raise
            if not reclaim_tried and isinstance(err, ResourceExhaustedError):
                # reclaim-before-degrade: free cold cached bytes and retry
                # the same rung once; nothing freed steps down as before
                reclaim_tried = True
                code = err.code
                err = exc = None  # the failed run's tensors go first
                if _reclaimed(executor) > 0:
                    metrics.inc("resilience.pressure.rung_retry")
                    trace_event(f"pressure_retry:{rung}", code=code)
                    retried = True
                    continue
                err = ResourceExhaustedError(code=code)
            break
    if err is not None:
        metrics.inc("resilience.degraded")
        metrics.inc(f"resilience.degraded.{rung}")
        trace_event(f"degraded:{rung}", code=err.code)
        from ..serving.runtime import current_ticket

        ticket = current_ticket()
        flight.record("ladder.degrade",
                      qid=ticket.qid if ticket is not None else None,
                      rung=rung, code=err.code)
        if executor.tracer.enabled:
            executor.tracer.event(f"degraded: {rung} [{err.code}]")
        if key is not None and breaker.record_failure(key):
            metrics.inc("resilience.breaker.trip")
            flight.record("breaker.trip", rung=rung, fingerprint=key[0],
                          code=err.code)
            logger.warning("breaker tripped for rung %s (plan %s): %s",
                           rung, key[0], err)
        logger.info("rung %s degraded (%s); stepping down", rung, err.code)
        return None
    if out is not None:
        if retried:
            # the retry after a reclaim answered on the same rung
            metrics.inc("resilience.pressure.rung_retry_ok")
        metrics.inc(f"resilience.rung.{rung}")
        live.update(rung=rung)
        if rung.startswith("spmd_"):
            # the mark that a query ran on a sharded rung: a zero-length
            # span with the spmd attribute
            trace_event(f"rung:{rung}", rung=rung, spmd=True)
        if key is not None and breaker.record_success(key):
            # an open circuit closed on its half-open trial
            flight.record("breaker.restore", rung=rung, fingerprint=key[0])
        if rel is not None:
            # the per-(family, rung) wall time SHOW PROFILES shows (a build
            # on a pipeline-cache miss included)
            executor.context.profiles.record_rung_exec(
                key[0] if key is not None else _fingerprint_of(executor, rel),
                rung, (time.perf_counter() - t0) * 1000.0)
    return out


def execute_interpreted(executor, rel):
    """The bottom of the device ladder: the eager per-operator walk, with
    the CPU rung under it for degradable failures on a CPU Context.

    The CPU rung re-runs the whole plan with the compiled and distributed
    paths off; a failure of the re-run propagates.  On the card a
    degradable failure propagates as it is (`wrap_boundary` makes it a
    `ResourceExhaustedError`, degradable): the rung would run the plan on
    the host copies of the tables, past the card's kernels.  Before either,
    a ``RESOURCE_EXHAUSTED`` failure reclaims cold cached bytes and, when
    any were freed, re-runs the walk once on the same device."""
    metrics = executor.context.metrics
    cpu_rung = executor.context.device.type == "cpu" and \
        executor.config.get("resilience.ladder.cpu_fallback", True)
    freed = 0
    try:
        faults.maybe_inject("exec_oom", executor.config)
        return executor.execute(rel)
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as exc:  # dsql: allow-broad-except — only degradable
        # failures go on below
        err = classify(exc)
        if not err.degradable:
            raise
        if isinstance(err, ResourceExhaustedError):
            # reclaim-before-degrade: free cold cached bytes, then the walk
            # once more on the same device
            freed = _reclaimed(executor)
        if not freed and not cpu_rung:
            raise
        code = err.code
        err = None  # the failed walk's tensors go with its traceback
    if freed:
        metrics.inc("resilience.pressure.rung_retry")
        trace_event("pressure_retry:interpreted", code=code)
        executor._memo.clear()  # drop the failed walk's partials
        try:
            faults.maybe_inject("exec_oom", executor.config)
            out = executor.execute(rel)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc2:  # dsql: allow-broad-except —
            # re-classified below
            err = classify(exc2)
            if not err.degradable or not cpu_rung:
                raise
            code = err.code
            err = None
        else:
            metrics.inc("resilience.pressure.rung_retry_ok")
            return out
    metrics.inc("resilience.degraded")
    metrics.inc("resilience.degraded.interpreted")
    trace_event("degraded:interpreted", code=code)
    from ..serving.runtime import current_ticket

    ticket = current_ticket()
    flight.record("ladder.degrade",
                  qid=ticket.qid if ticket is not None else None,
                  rung="interpreted", code=code)
    if executor.tracer.enabled:
        executor.tracer.event(f"degraded: interpreted [{code}]")
    logger.warning("interpreted path failed degradably (%s); re-executing "
                   "with the compiled rungs off", code)
    executor._memo.clear()  # drop the partial results of the failed walk
    with executor.config.set({
            "sql.distributed.aggregate": "off",
            "sql.distributed.join": "off",
            "sql.distributed.sort": "off",
            "sql.compile": False}):
        out = executor.execute(rel)
    metrics.inc("resilience.rung.cpu")
    live.update(rung="cpu")
    return out


#: the text of the `NotImplementedError` the port raises for what a later
#: slice brings (each names its subsystem or ROADMAP.md item)
LATER_SLICE_MARKER = "not in the port yet"


def wrap_boundary(fn: Callable[[], T], query_id: Optional[str] = None) -> T:
    """Run `fn` and re-raise any failure as a taxonomy QueryError, the
    contract of `TorchFrame.execute`.  The port's `NotImplementedError` for
    a later slice (`LATER_SLICE_MARKER`) passes as it is: callers test for
    that type."""
    try:
        return fn()
    except (QueryError, KeyboardInterrupt, SystemExit):
        raise
    except BaseException as exc:
        if isinstance(exc, NotImplementedError) \
                and LATER_SLICE_MARKER in str(exc):
            raise
        raise classify(exc, query_id=query_id) from exc
