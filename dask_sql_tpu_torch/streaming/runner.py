"""The partition drive loop: launches and mid-stream OOM recovery.

A copy of `dask_sql_tpu/streaming/runner.py` for both streamed rungs.  Per
partition it

- polls the serving ticket's checkpoint, so a deadline or a CANCEL QUERY
  lands between launches;
- arms the ``partition`` fault site and launches the partition under the
  retry policy (resilience/retry.py): retryable failures retry in place,
  bounded by the ticket's deadline;
- absorbs a degradable ``RESOURCE_EXHAUSTED`` (the injected fault or a
  real ``torch.cuda.OutOfMemoryError``, classified alike by
  `errors.classify`) by HALVING the partition and RESUMING from the first
  row no completed partition covered: the partial state lives in the
  caller's accumulator, so a completed partition never runs again.  Below
  ``serving.stream.min_chunk_rows``, or past twice
  ``serving.stream.max_partitions`` launches, the failure goes to the
  ladder, which counts it, charges the breaker and steps down.

With ``serving.stream.launch_timeout_ms`` set, each launch runs under the
watchdog (resilience/watchdog.py) and waits for a CUDA event it records
after its own work on the current stream: a launch returns before the card
has run it, so without the event the deadline would time nothing.  It
never synchronizes the whole card, which would wait for other queries'
kernels too.  Unwatched, launches are asynchronous and partition i+1's
host work overlaps partition i on the card.
"""
from __future__ import annotations

import logging
from typing import Callable

import torch

from ..observability import detail, flight, live, trace_event
from ..resilience import faults
from ..resilience.errors import (
    ResourceExhaustedError,
    StreamLaunchTimeoutError,
    classify,
)
from ..resilience.retry import BackoffPolicy, retry_call
from ..resilience.watchdog import watched_call
from .partition import partition_layout

logger = logging.getLogger(__name__)


def launch_timeout_ms(config):
    """``serving.stream.launch_timeout_ms`` as a positive float, or None."""
    raw = config.get("serving.stream.launch_timeout_ms")
    if raw is None:
        return None
    try:
        val = float(raw)
    except (TypeError, ValueError):
        logger.warning("unparseable serving.stream.launch_timeout_ms=%r; "
                       "launch watchdog disabled", raw)
        return None
    return val if val > 0 else None


def waited(launch: Callable[[int, int], None], device: torch.device):
    """``launch`` followed by a wait for its own work: an event recorded
    on the current stream after it, synchronized (on the CPU there is
    nothing to wait for)."""
    def run(lo: int, chunk_rows: int) -> None:
        launch(lo, chunk_rows)
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            event.synchronize()

    return run


def drive_partitions(executor, decision, launch: Callable[[int, int], None],
                     rung: str) -> int:
    """Run every partition of ``decision``; returns the number of launches.

    ``launch(lo, chunk_rows)`` runs ONE partition over rows
    ``[lo, min(lo + chunk_rows, total))`` and folds its output into the
    caller's accumulator.  ``lo`` never decreases; ``chunk_rows`` may
    shrink after an absorbed OOM."""
    config = executor.config
    metrics = executor.context.metrics
    from ..serving.runtime import current_ticket

    ticket = current_ticket()
    policy = BackoffPolicy.from_config(config)
    timeout_ms = launch_timeout_ms(config)
    watched = waited(launch, executor.context.device) \
        if timeout_ms is not None else None
    total = int(decision.total_rows)
    chunk_rows = min(int(decision.chunk_rows), total)
    min_rows = min(
        max(1, int(config.get("serving.stream.min_chunk_rows", 4096))),
        total)
    # recovery may at most double the admitted partition bound before the
    # failure degrades down the ladder
    max_launches = 2 * max(1, int(
        config.get("serving.stream.max_partitions", 256)))
    rows_done = part_idx = launches = 0
    live.update(stream_partitions_total=len(partition_layout(total,
                                                             chunk_rows)),
                stream_partitions_done=0, stream_rows_total=total,
                stream_rows_done=0, stream_chunk_rows=chunk_rows)
    while rows_done < total:
        if ticket is not None:
            ticket.checkpoint()
        lo = rows_done
        hi = min(lo + chunk_rows, total)
        try:
            with detail("stream_partition", rung=rung, index=part_idx,
                        row_lo=lo, rows=hi - lo, chunk_rows=chunk_rows):

                def attempt():
                    faults.maybe_inject("partition", config)
                    if watched is not None:
                        watched_call(
                            f"{rung}[{part_idx}]", watched, (lo, chunk_rows),
                            deadline_ms=timeout_ms,
                            hang_s=faults.hang_duration("compile_hang",
                                                        config),
                            metrics=metrics,
                            error_cls=StreamLaunchTimeoutError)
                    else:
                        launch(lo, chunk_rows)

                retry_call(attempt, policy, ticket=ticket, metrics=metrics)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:  # dsql: allow-broad-except — classified:
            # only a degradable OOM
            err = classify(exc)
            if not (err.degradable
                    and isinstance(err, ResourceExhaustedError)):
                raise
            metrics.inc("resilience.partition.oom")
            trace_event("stream_oom", rung=rung, row_lo=lo,
                        chunk_rows=chunk_rows)
            half = chunk_rows // 2
            projected = launches + (-(-(total - rows_done) // half)
                                    if half else 0)
            if half < min_rows or projected > max_launches:
                metrics.inc("resilience.partition.exhausted")
                trace_event("stream_exhausted", rung=rung,
                            chunk_rows=chunk_rows)
                flight.record("stream.exhausted",
                              qid=ticket.qid if ticket else None,
                              rung=rung, chunk_rows=chunk_rows)
                logger.warning(
                    "streamed %s: a partition of %d rows still exhausts the "
                    "card at the %d-row floor; stepping down", rung,
                    chunk_rows, min_rows)
                raise
            err = exc = None  # the failed launch's tensors go first
            chunk_rows = half
            metrics.inc("serving.stream.repartitions")
            trace_event("stream_repartition", rung=rung,
                        chunk_rows=chunk_rows, resume_row=rows_done)
            flight.record("stream.repartition",
                          qid=ticket.qid if ticket else None, rung=rung,
                          chunk_rows=chunk_rows, resume_row=rows_done)
            live.update(
                stream_chunk_rows=chunk_rows,
                stream_partitions_total=part_idx + (
                    -(-(total - rows_done) // chunk_rows)))
            logger.info(
                "streamed %s: mid-stream OOM at row %d; repartitioning to "
                "%d-row partitions and resuming from row %d", rung, lo,
                chunk_rows, rows_done)
            continue  # rows_done unchanged: resume, never restart
        rows_done = hi
        part_idx += 1
        launches += 1
        metrics.inc("serving.stream.partitions")
        metrics.inc("serving.stream.rows", hi - lo)
        metrics.gauge("serving.stream.partitions_done", part_idx)
        metrics.gauge("serving.stream.rows_done", rows_done)
        live.update(stream_partitions_done=part_idx,
                    stream_rows_done=rows_done)
    metrics.observe("serving.stream.chunk_rows", chunk_rows)
    return launches
