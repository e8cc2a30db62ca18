"""Stream decision: can a provably over-budget plan run as N partitions?

A copy of `dask_sql_tpu/streaming/plan.py` on the port's catalog.  The
admission gate (serving/admission.py) has a third answer besides running
a plan and shedding it: when the over-budget part of the provable floor is
ONE registered table's scan, the scan partitions along its rows and the
query runs with a per-partition working set that fits.  The sizing works on
the estimator's provable floors (analysis/estimator.py):

    rest      = peak_bytes.lo - scan_bytes_lo     # does not shrink with N
    headroom  = budget - rest                     # what a partition may spend
    N         = ceil(scan_bytes_lo / headroom)    # partitions needed
    chunk_lo  = ceil(scan_bytes_lo / N) + rest    # the per-partition floor

The shed stays the last resort: it fires only when even one partition
provably cannot fit (``headroom <= 0``, the configured minimum partition
still over the budget, or more partitions than
``serving.stream.max_partitions``).  Eligibility is static and
conservative, as the reference's: exactly one scanned table, registered in
memory (a lazy parquet table streams through `physical/streaming.py`), not
sharded (the sharded rungs own sharded storage), no RLE column, and a
plan shape a streamed rung serves (a
scan->filter*->aggregate chain, or a root scan->filter*->project chain
with no ORDER BY or LIMIT).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

from ..planner import plan as p
from .partition import partition_layout

logger = logging.getLogger(__name__)


@dataclass
class StreamDecision:
    """One admission-time routing verdict.  It holds no plan reference;
    it reaches the matching rung per execution through
    ``Executor.stream_decisions`` (keyed by the streamable node's
    identity), never as state on the shared cached plan."""

    kind: str                # "aggregate" | "select"
    schema_name: str
    table_name: str
    total_rows: int
    chunk_rows: int
    partitions: int
    #: provable per-partition floor: what the packing scheduler reserves
    #: and what the gate compared with the budget
    chunk_bytes_lo: int
    #: the whole scan's floor the partitioning divided
    scan_bytes_lo: int
    #: the gate's numbers, so a rung that finds the plan ineligible when it
    #: builds can shed with the gate's own error
    peak_bytes_lo: int = 0
    budget_bytes: int = 0


def shed_ineligible(decision: StreamDecision, metrics=None,
                    reason: str = "") -> None:
    """A routed plan the rung found it cannot serve when it built (a radix
    span only the data shows, an expression the evaluator does not take):
    raise the gate's shed rather than decline down the ladder into a
    single run of the whole over-budget working set."""
    from ..observability import trace_event
    from ..serving.admission import EstimatedBytesExceededError

    if metrics is not None:
        metrics.inc("serving.shed_estimated_bytes")
    trace_event("shed:estimated_bytes", bytes_lo=decision.peak_bytes_lo,
                budget=decision.budget_bytes, ineligible=reason or True)
    logger.info("streamed rung cannot serve a routed over-budget plan (%s);"
                " shedding with the gate's error", reason or "ineligible")
    raise EstimatedBytesExceededError(decision.peak_bytes_lo,
                                      decision.budget_bytes)


def _streamable_node(plan: p.LogicalPlan):
    """``(node, kind)`` a streamed rung serves, or None: the first
    Aggregate whose scan chain extracts with partial-izable aggregates and
    column group keys, else the root itself as a compiled-select chain
    with no sort or limit window."""
    from ..physical.compiled import (
        _Unsupported,
        _extract_chain,
        check_agg_static_support,
    )
    from ..physical.compiled_select import _extract
    from ..planner.expressions import ColumnRef

    for node in p.walk_plan(plan):
        if not isinstance(node, p.Aggregate):
            continue
        chain = _extract_chain(node)
        if chain is None:
            continue
        _, _, group_exprs, agg_exprs = chain
        try:
            check_agg_static_support(agg_exprs)
        except _Unsupported:
            return None
        if not all(isinstance(e, ColumnRef) and type(e) is ColumnRef
                   for e in group_exprs):
            return None
        return node, "aggregate"
    got = _extract(plan)
    if got is not None:
        _, _, _, sort_keys, sort_fetch, limit, inner_limit = got
        if sort_keys is None and limit is None and inner_limit is None \
                and sort_fetch is None:
            return plan, "select"
    return None


def stream_decision(plan: p.LogicalPlan, estimate, context, config,
                    budget: int
                    ) -> Optional[Tuple[p.LogicalPlan, StreamDecision]]:
    """Route one provably over-budget plan to streamed execution:
    ``(streamable node, decision)``, or None (the caller sheds).  A pure
    read: the plan is not changed."""
    if not config.get("serving.stream.enabled", True):
        return None
    if not config.get("sql.compile", True):
        # the streamed rungs' own precondition: routing a plan they would
        # decline would run the whole over-budget plan on a lower rung
        return None
    scan_lo = int(getattr(estimate, "scan_bytes_lo", 0) or 0)
    if scan_lo <= 0:
        return None
    rest = max(0, int(estimate.peak_bytes.lo) - scan_lo)
    headroom = budget - rest
    if headroom <= 0:
        return None
    scans = [n for n in p.walk_plan(plan) if isinstance(n, p.TableScan)]
    if len(scans) != 1:
        return None
    scan = scans[0]
    container = context.schema.get(scan.schema_name)
    dc = container.tables.get(scan.table_name) if container is not None \
        else None
    if dc is None:
        return None
    from ..datacontainer import LazyParquetContainer

    if isinstance(dc, LazyParquetContainer):
        return None
    from ..columnar.encodings import Encoding
    from ..parallel.dist_plan import table_is_sharded

    table = dc.table
    if table_is_sharded(table):
        return None  # sharded storage never streams: the sharded rungs own it
    if any(c.encoding is Encoding.RLE for c in table.columns.values()):
        return None
    total = int(table.num_rows)
    if total <= 1:
        return None
    got = _streamable_node(plan)
    if got is None:
        return None
    node, kind = got
    if kind == "select" and not config.get("sql.compile.select", True):
        return None
    # the largest partition whose scan share provably fits the headroom
    # (floor division: rounding never overshoots the budget)
    chunk_cap = headroom * total // scan_lo
    chunk_rows = int(config.get("serving.stream.chunk_rows") or 0)
    if chunk_rows <= 0:
        chunk_rows = chunk_cap
    min_rows = max(1, int(config.get("serving.stream.min_chunk_rows", 4096)))
    chunk_rows = max(min(chunk_rows, total), min(min_rows, total))
    if chunk_rows < 1:
        return None
    n_parts = len(partition_layout(total, chunk_rows))
    if n_parts < 2:
        return None
    if n_parts > int(config.get("serving.stream.max_partitions", 256)):
        return None
    chunk_bytes_lo = -(-scan_lo * chunk_rows // total) + rest
    if chunk_bytes_lo > budget:
        return None
    return node, StreamDecision(
        kind=kind,
        schema_name=scan.schema_name,
        table_name=scan.table_name,
        total_rows=total,
        chunk_rows=chunk_rows,
        partitions=n_parts,
        chunk_bytes_lo=chunk_bytes_lo,
        scan_bytes_lo=scan_lo,
        peak_bytes_lo=int(estimate.peak_bytes.lo),
        budget_bytes=int(budget),
    )
