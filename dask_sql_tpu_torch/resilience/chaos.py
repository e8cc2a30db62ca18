"""Chaos campaign harness: seeded fault storms under concurrent mixed load.

Counterpart of `dask_sql_tpu/resilience/chaos.py` (`ChaosReport`,
`run_campaign` and its invariants), on the Context's device: the CUDA card
unless the caller asks for the CPU.

Every resilience mechanism in this package — retry/backoff, the
degradation ladder, circuit breakers, mid-stream repartition, the compile
watchdog, pressure reclaim — was proven by a *targeted* test that arms one
fault site and asserts one recovery path.  Real incidents are not
targeted: a wedged compile, a transient transfer drop and a device OOM
land in the same minute, on different queries, while clients cancel and
the admission queue backs up.  This module is the composition proof: a
deterministic (seeded) campaign arms rotating subsets of every fault-
injection site (resilience/faults.py) as probability specs, drives a
concurrent mixed workload — interactive aggregates, batch scans, streamed
partitioned queries, PREDICT inference, exact-repeat cache hits, random
mid-flight cancels, checkpoint writes — through a real `ServingRuntime`, and then asserts
GLOBAL invariants that must hold after drain no matter which faults fired
in which order:

- every in-flight query table entry reached a terminal state;
- the packing scheduler's byte reservations and the card-byte ledger's
  reserved gauge are back to idle (zero) — no leaked reservation on any
  path;
- every breaker left OPEN admits its half-open trial once its cooldown
  elapses (no permanently-wedged circuit);
- no zombie engine threads survive ``shutdown(wait=True)`` (of those the
  campaign could have started: a thread alive before it began, such as
  another engine's in the same process, is not the storm's);
- the flight-recorder event sequence is causally consistent per query
  (an admit precedes any finish; at most one finish per qid);
- no lock-order violation was observed (when the sanitizer is armed);
- on a card Context, once the runtime is drained and the Context released,
  ``torch.cuda.memory_allocated`` is back within `FREED_SLACK` of its value
  before the campaign (the port's own invariant: tickets, reservations,
  cached results and checkpoint writes all held card tensors).

Individual query outcomes are free — success, degraded success, retryable
failure, shed, cancel are all acceptable under chaos; what is NOT
acceptable is corrupted engine state after the storm passes.  A query that
fails on the card is such an outcome: nothing re-runs it on the host.

Not yet in the port: the replica-kill fleet campaigns (ROADMAP.md Queue 1
item 10b).
"""
from __future__ import annotations

import gc
import itertools
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..runtime import locks as runtime_locks

logger = logging.getLogger(__name__)

#: process-unique campaign nonce folded into every qid: the flight
#: recorder is process-global, so a SECOND campaign in the same process
#: must not see the first campaign's ``query.finish`` events under its
#: own qids when checking per-query causality
_campaign_nonce = itertools.count()

#: every error-raising inject site of the port plus the hang site — the
#: campaign rotates probability-armed subsets of this list
ALL_SITES = ("compile", "oom", "exec_oom", "execute", "checkpoint",
             "spmd", "predict", "partition", "d2h", "compile_hang")

#: base config for a campaign: fast backoff, short breaker cooldown, a
#: short injected hang with a compile deadline it trips, a flight ring
#: big enough that a campaign's events are never evicted mid-run
_BASE_CONFIG = {
    "resilience.retry.max_attempts": 2,
    "resilience.retry.base_s": 0.01,
    "resilience.retry.max_s": 0.05,
    "resilience.breaker.threshold": 2,
    "resilience.breaker.cooldown_s": 0.2,
    "resilience.compile_timeout_ms": 2000.0,
    "resilience.inject.hang_s": 0.05,
    "serving.stream.min_chunk_rows": 64,
    "serving.stream.launch_timeout_ms": 5000.0,
    "observability.flight.capacity": 65536,
}

#: card bytes a campaign may leave allocated once its Context is released
#: (the slack of chip_smoke.py's check_card_freed)
FREED_SLACK = 64 << 20


@dataclass
class ChaosReport:
    """Outcome of one campaign: per-query tallies plus the invariant
    violations (empty = the engine state survived the storm intact)."""

    seed: int
    rounds: int = 0
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    cancelled: int = 0
    shed: int = 0
    violations: List[str] = field(default_factory=list)
    #: per-round armed specs, for reproducing a failure: (round, spec, seed)
    armed: List[Tuple[int, str, int]] = field(default_factory=list)
    #: the device the campaign ran on, and its card bytes allocated before
    #: the campaign and after the Context's release (None on the CPU)
    device: str = ""
    card_before: Optional[int] = None
    card_after: Optional[int] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        return (f"chaos seed={self.seed}: {self.submitted} queries over "
                f"{self.rounds} rounds ({self.completed} ok, {self.failed} "
                f"failed, {self.cancelled} cancelled, {self.shed} shed); "
                f"{len(self.violations)} invariant violation(s)")


def _build_context(rng: random.Random, device=None,
                   config_options: Optional[Dict[str, Any]] = None):
    """A fresh Context with the chaos fixture data: a small table (fast
    interactive aggregates + cache hits), a bigger table sized to force
    streamed routing under the per-query byte gate, and a trained model
    for PREDICT traffic."""
    import numpy as np
    import pandas as pd

    from ..context import Context

    c = Context(device=device,
                config_options={**_BASE_CONFIG, **(config_options or {})})
    n_small, n_big = 200, 4096
    c.create_table("t_small", pd.DataFrame({
        "a": np.arange(n_small, dtype=np.float64),
        "b": np.arange(n_small) % 7,
    }))
    c.create_table("t_big", pd.DataFrame({
        "k": np.arange(n_big) % 13,
        "v": rng.random() + np.arange(n_big, dtype=np.float64),
    }))
    df = pd.DataFrame({
        "x": np.linspace(0.0, 1.0, n_small),
        "y": np.linspace(1.0, 0.0, n_small),
    })
    df["target"] = (df.x * 2 + df.y > 1.2).astype(np.int64)
    c.create_table("train", df)
    c.sql("""CREATE MODEL chaos_model WITH (
                 model_class = 'LinearRegression',
                 target_column = 'target'
             ) AS (SELECT x, y, target FROM train)""")
    return c


def _query_mix(stream_budget: int) -> List[Tuple[str, str, Dict]]:
    """(sql, priority_class, per-query config overrides) templates; the
    campaign cycles through them so every round carries every shape."""
    stream_opts = {"serving.admission.max_estimated_bytes": stream_budget}
    return [
        ("SELECT b, SUM(a) AS s FROM t_small GROUP BY b",
         "interactive", {}),
        # exact repeat of the query above: result-cache / reuse traffic
        ("SELECT b, SUM(a) AS s FROM t_small GROUP BY b",
         "interactive", {}),
        ("SELECT COUNT(*) AS n, SUM(a) AS s FROM t_small", "batch", {}),
        # the per-query byte gate forces this one onto a streamed rung
        ("SELECT k, SUM(v) AS s FROM t_big GROUP BY k",
         "interactive", stream_opts),
        ("SELECT k, SUM(v) AS s FROM t_big GROUP BY k",
         "batch", stream_opts),
        ("SELECT * FROM PREDICT(MODEL chaos_model, "
         "SELECT x, y FROM t_small_pred)", "interactive", {}),
        ("SELECT a, b FROM t_small WHERE a > 50", "interactive", {}),
    ]


def _card_allocated(device) -> Optional[int]:
    import torch

    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    # cuBLAS keeps a workspace a thread's handle in PyTorch's caching
    # allocator, left by the first matmul on each thread (a model fit, a
    # worker's PREDICT program): the library's, not the Context's, so it
    # is dropped before each count
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return int(torch.cuda.memory_allocated(device))


def run_campaign(seed: int, queries: int = 40, rounds: int = 4,
                 workers: int = 4, state_dir: Optional[str] = None,
                 device=None,
                 config_options: Optional[Dict[str, Any]] = None
                 ) -> ChaosReport:
    """Run one seeded chaos campaign on a fresh Context on ``device`` (the
    CUDA card when None); deterministic per (seed, queries, rounds,
    workers) in which faults arm where (individual interleavings still
    race — that is the point — but the invariants are order-independent).
    ``state_dir`` additionally exercises the ``checkpoint`` site with one
    ``save_state`` per round; ``config_options`` are set on the Context
    over the campaign's base config (``analysis.lock_sanitizer`` arms the
    lock sanitizer)."""
    from ..context import resolve_device
    from . import faults

    dev = resolve_device(device)
    report = ChaosReport(seed=seed, device=str(dev))
    faults.reset()
    lock_baseline = runtime_locks.violation_count()
    threads_before = frozenset(threading.enumerate())
    report.card_before = _card_allocated(dev)
    try:
        _storm(report, seed, queries, rounds, workers, state_dir, dev,
               config_options, lock_baseline, threads_before)
    finally:
        faults.reset()
    # the storm's Context, runtime and futures are gone with its frame
    gc.collect()
    report.card_after = _card_allocated(dev)
    if report.card_before is not None \
            and report.card_after - report.card_before > FREED_SLACK:
        report.violations.append(
            f"{report.card_after - report.card_before} card bytes "
            f"allocated after the campaign's Context was released "
            f"(slack {FREED_SLACK})")
    for v in report.violations:
        logger.error("chaos invariant violation: %s", v)
    return report


def _storm(report: ChaosReport, seed: int, queries: int, rounds: int,
           workers: int, state_dir: Optional[str], device,
           config_options: Optional[Dict[str, Any]],
           lock_baseline: int, threads_before: frozenset) -> None:
    """The campaign proper: build, storm, drain, check.  Everything it
    holds (the Context, the runtime, the futures) is released when it
    returns."""
    from ..observability import flight
    from ..serving.cache import table_nbytes
    from ..serving.runtime import ServingRuntime
    from ..serving.scheduler import QueryCost
    from . import faults

    rng = random.Random(seed)
    context = _build_context(rng, device, config_options)
    big_bytes = table_nbytes(context.schema["root"].tables["t_big"].table)
    # per-query gate a third of the big table: full scans exceed it,
    # chunks fit — the streamed templates route instead of shedding
    stream_budget = max(4096, big_bytes // 3)
    # the PREDICT input table (left out of _build_context so its name
    # telegraphs its purpose in SHOW QUERIES output)
    context.sql("CREATE TABLE t_small_pred AS "
                "(SELECT a / 200.0 AS x, b / 7.0 AS y FROM t_small)")
    # device budget for the pressure bands: roomy enough to sit GREEN at
    # idle, tight enough that concurrent reservations + cache growth can
    # push it into YELLOW/RED during a storm
    total_bytes = sum(table_nbytes(dc.table) for dc in
                      context.schema["root"].tables.values())
    context.config.update({
        "serving.scheduler.device_budget_bytes": total_bytes * 3,
    })
    runtime = ServingRuntime(workers=workers, metrics=context.metrics,
                             scheduler_budget_bytes=total_bytes * 2)
    context.serving = runtime
    context.metrics.inc("chaos.campaigns")
    templates = _query_mix(stream_budget)
    qids: List[str] = []
    nonce = next(_campaign_nonce)
    try:
        per_round = max(1, queries // max(1, rounds))
        for rnd in range(rounds):
            n_armed = rng.randint(2, max(2, len(ALL_SITES) // 2))
            sites = rng.sample(ALL_SITES, n_armed)
            spec = ",".join(
                f"{s}:{rng.choice(('0.2', '0.4', 'once'))}" for s in sites)
            round_seed = rng.randint(0, 1 << 30)
            overrides = {"resilience.inject": spec,
                         "resilience.inject.seed": round_seed}
            report.armed.append((rnd, spec, round_seed))
            context.metrics.inc("chaos.rounds")
            flight.record("chaos.arm", round=rnd, spec=spec, seed=round_seed)
            logger.info("chaos round %d arming %r (seed %d)",
                        rnd, spec, round_seed)
            futures = []
            for i in range(per_round):
                sql, cls, qopts = templates[
                    (rnd * per_round + i) % len(templates)]
                qid = f"chaos-{seed}.{nonce}-{rnd}-{i}"

                def job(ticket, _sql=sql, _opts=dict(qopts)):
                    # overlays are thread-local: armed INSIDE the worker
                    # thread, for this job's extent only
                    with context.config.set({**overrides, **_opts}):
                        return context.sql(_sql).compute()

                # dsql: allow-unpaired-effect — settled by _finisher
                entry = context.live_queries.begin(qid, sql=sql,
                                                   priority_class=cls)
                try:
                    _, fut, ticket = runtime.submit(
                        job, qid=qid, priority_class=cls,
                        cost=QueryCost(bytes_lo=rng.randint(1024, 65536)))
                except Exception:  # dsql: allow-broad-except — a
                    # queue-full shed is a legitimate chaos outcome
                    context.live_queries.discard(qid)
                    report.shed += 1
                    continue
                entry.ticket = ticket
                fut.add_done_callback(_finisher(context, qid))
                report.submitted += 1
                context.metrics.inc("chaos.queries")
                qids.append(qid)
                futures.append((qid, fut, ticket))
            if state_dir is not None and futures:
                # exercise the checkpoint site mid-storm (failure is an
                # acceptable outcome; a corrupted CURRENT is not —
                # save_state repoints atomically)
                try:
                    with context.config.set(overrides):
                        context.save_state(state_dir)
                except Exception:  # dsql: allow-broad-except — the
                    # injected write error is the expected outcome
                    logger.info("chaos checkpoint failed (expected under "
                                "injection)", exc_info=True)
            # cancel a random ~15% slice mid-flight: the cooperative
            # checkpoints must release reservations exactly once
            for qid, _fut, ticket in futures:
                if rng.random() < 0.15:
                    flight.record("query.cancel", qid=qid)
                    ticket.cancel()
            for qid, fut, _ticket in futures:
                try:
                    fut.result(60.0)
                    report.completed += 1
                except Exception as exc:  # dsql: allow-broad-except —
                    # every failure taxonomy is an acceptable chaos
                    # outcome; the invariants below are the real check
                    from ..serving.admission import QueryCancelledError

                    if isinstance(exc, QueryCancelledError):
                        report.cancelled += 1
                    else:
                        report.failed += 1
            report.rounds += 1
            faults.reset()  # re-arm `once` budgets for the next round
        # drain FIRST: the thread/ledger/reservation invariants are
        # statements about the engine's state after a clean shutdown
        runtime.shutdown(wait=True)
        _check_invariants(report, context, runtime, qids,
                          lock_baseline=lock_baseline,
                          threads_before=threads_before)
    finally:
        runtime.shutdown(wait=True)
        context.serving = None


def _finisher(context, qid: str):
    """Done-callback mirroring the server front-end: the submitter owns
    the live entry's terminal state (the worker may retry attempts)."""

    def done(fut):
        from ..serving.admission import QueryCancelledError

        if fut.cancelled():
            context.live_queries.finish(qid, "cancelled")
            return
        exc = fut.exception()
        if exc is None:
            context.live_queries.finish(qid, "done")
        elif isinstance(exc, QueryCancelledError):
            context.live_queries.finish(qid, "cancelled",
                                        getattr(exc, "code", None))
        else:
            context.live_queries.finish(
                qid, "failed",
                getattr(exc, "code", None) or type(exc).__name__)

    return done


def _check_invariants(report: ChaosReport, context, runtime,
                      qids: List[str], lock_baseline: int = 0,
                      threads_before: frozenset = frozenset()) -> None:
    """The global post-drain invariants; appends human-readable violation
    strings to the report (and counts ``chaos.violations``).
    ``threads_before`` are the threads alive when the campaign began: the
    zombie check skips them."""
    from ..observability import flight

    def violate(msg: str) -> None:
        report.violations.append(msg)
        context.metrics.inc("chaos.violations")

    # 1. every live-table entry terminal
    live = context.live_queries.live_entries()
    if live:
        violate(f"non-terminal live entries after drain: "
                f"{[(e.qid, e.state) for e in live]}")

    # 2. reservations and ledger back to idle (poll briefly: the last
    # worker's _release runs after its future resolves)
    deadline = time.monotonic() + 5.0
    reserved = context.ledger.reserved_bytes()
    while reserved and time.monotonic() < deadline:
        time.sleep(0.01)
        reserved = context.ledger.reserved_bytes()
    if reserved:
        violate(f"scheduler still holds {reserved} reserved bytes "
                f"after drain")
    snap = context.ledger.snapshot()
    if snap["reservedBytes"] != 0:
        violate(f"ledger reservedBytes={snap['reservedBytes']} != 0 "
                f"after drain")
    if snap["inflightMeasuredBytes"] != 0:
        violate(f"ledger inflightMeasuredBytes="
                f"{snap['inflightMeasuredBytes']} != 0 after drain")

    # 3. every OPEN breaker admits its half-open trial after cooldown
    state = context.breaker.snapshot_state()
    if state["open"]:
        time.sleep(context.breaker.cooldown_s + 0.05)
        for entry in state["open"]:
            key = tuple(entry["key"])
            # invariant probe: the granted trial is intentionally left
            # unsettled — the campaign ends here
            # dsql: allow-unpaired-effect — probe-only grant
            if not context.breaker.allow(key):
                violate(f"breaker {key} still refuses its half-open "
                        f"trial after cooldown")

    # 4. no zombie engine threads past shutdown(wait=True); watchdog
    # helper threads get a grace window to finish their bounded hangs
    for t in runtime._threads:
        if t.is_alive():
            violate(f"serving worker {t.name} alive after "
                    f"shutdown(wait=True)")
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline:
        strays = [t.name for t in threading.enumerate()
                  if t.name.startswith(("dsql-warmup", "dsql-bg-compile",
                                        "dsql-compile-watchdog"))
                  and t.is_alive() and t not in threads_before]
        if not strays:
            break
        time.sleep(0.05)
    else:
        violate(f"zombie background threads after drain: {strays}")

    # 5. flight-recorder causality per submitted qid
    events = flight.RECORDER.events()
    by_qid: Dict[str, List[dict]] = {}
    for e in events:
        q = e.get("qid")
        if q is not None:
            by_qid.setdefault(q, []).append(e)
    for qid in qids:
        evs = by_qid.get(qid, [])
        admits = [e for e in evs if e["event"] == "query.admit"]
        finishes = [e for e in evs if e["event"] == "query.finish"]
        if len(finishes) > 1:
            violate(f"{qid}: {len(finishes)} query.finish events "
                    f"(expected at most 1)")
        if finishes and not admits:
            violate(f"{qid}: query.finish with no query.admit")
        if finishes and admits and admits[0]["ts"] > finishes[0]["ts"]:
            violate(f"{qid}: query.admit after query.finish")

    # 6. no lock-order violation observed (runtime/locks.py sanitizer —
    # a no-op unless armed; the storm IS the stress test for the declared
    # rank order)
    excess = runtime_locks.violation_count() - lock_baseline
    if excess:
        details = "; ".join(
            f"{v['kind']}: holding {v['holding']} acquiring "
            f"{v['acquiring']} on {v['thread']}"
            for v in runtime_locks.violations()[-excess:])
        violate(f"{excess} lock-order violation(s) during the storm "
                f"({details})")
