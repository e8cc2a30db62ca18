"""streamed_aggregate: the partial-state aggregation rung.

The port's counterpart of `dask_sql_tpu/streaming/aggregate.py`.
`CompiledAggregate` (physical/compiled.py) reduces a whole
scan->filter->aggregate chain to its FINAL group table, which partitions
cannot combine (an AVG of each partition is not the AVG).  This subclass
keeps the parent's front half (the row selection, the group id, the radix
plan resolved over the FULL table, so group ids agree across partitions,
the same reductions registered on a `SegmentReducer`) and returns the raw
per-group states of each partition: the hit count, each aggregate's sums
and counts, its MIN or MAX contributions.

Counts and float sums of one partition are ONE `ops/segsum.py`
`segsum_typed` call (the hand-written kernel on the card up to its domain
cutoff, the sorted float64 scatter above it, the plain version on the
CPU), whatever ``sql.compile.segsum`` says: the reference pins its scatter
mode here, the only one whose states combine; the port's typed call
returns float64 states, which combine as they are.  The states combine on
the device in partition order (float64 adds, int64 adds, elementwise
MIN/MAX), with no atomics, so a streamed run repeats its bits.  The
finalize (AVG = sum / count, the variance from its three sums) runs once
over the combined states, with the parent's pack and decode and one
transfer.  Integer sums, counts, MIN and MAX are exact; float sums are
grouped differently from the single launch, so a streamed answer is held
to the float64 oracle, not to the in-memory run's bits.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.table import Table
from ..observability import trace_event
from ..physical.compiled import (
    CompiledAggregate,
    SegmentReducer,
    _Unsupported,
    _extract_chain,
    fetch_packed,
    singleflight_get_or_build,
)
from ..planner import plan as p
from .partition import slice_chunk
from .plan import StreamDecision, shed_ineligible
from .runner import drive_partitions

logger = logging.getLogger(__name__)

#: the segment-sum route of every partition: ``auto``, whatever the query's
#: ``sql.compile.segsum`` says (`ops.segsum.choose_segsum_impl`)
_SEGSUM_AUTO = {"sql.compile.segsum": "auto"}


class _States:
    """The combined states as a reducer's ``get`` reads them: handle
    ``("s", i)`` is state i."""

    def __init__(self, states: Sequence[torch.Tensor]):
        self.states = states

    def get(self, h):
        return self.states[h[1]]


class StreamedAggregate(CompiledAggregate):
    """`CompiledAggregate` whose runs return combinable partial states.
    Planned on the FULL table (the integer keys' radix bounds must cover
    every partition), run on its partitions."""

    def __init__(self, agg: p.Aggregate, table: Table, filters, group_exprs,
                 agg_exprs):
        super().__init__(agg, table, filters, group_exprs, agg_exprs,
                         _SEGSUM_AUTO)
        #: per state, its combine ("sum", "min", "max") and whether it is
        #: a count (counts combine as exact int64)
        self._layout: List[Tuple[str, bool]] = []
        #: the hit count and the aggregates' plans over state handles
        self._hit_h = None
        self._plans: List[Tuple] = []

    def run_partition(self, chunk: Table, params: Tuple = ()) -> List:
        """One partition's raw states, on the device, no transfer."""
        ev = self._ev
        slots = self._slots(chunk, params)
        sel = self._selection(ev, slots, chunk)
        reducer = SegmentReducer(self._gid(slots, chunk), self.domain,
                                 self.segsum_mode, chunk.num_rows)
        hit_h, plans = self._register(ev, slots, sel, reducer)
        reducer.finish()
        states: List[torch.Tensor] = []
        layout: List[Tuple[str, bool]] = []

        def state(h, op: str, count: bool) -> Tuple[str, int]:
            x = reducer.get(h)
            if count:  # exact in float64 below 2^53, exact in int64 after
                x = x.to(torch.int64)
            elif op == "sum" and x.is_floating_point():
                x = x.to(torch.float64)
            states.append(x)
            layout.append((op, count))
            return ("s", len(states) - 1)

        new_hit = state(hit_h, "sum", True)
        new_plans = []
        for plan, a in zip(plans, self.agg_exprs):
            kind = plan[0]
            if kind == "count":
                new_plans.append((kind, state(plan[1], "sum", True)))
            elif kind in ("sum", "avg"):
                new_plans.append((kind, state(plan[1], "sum", False),
                                  state(plan[2], "sum", True)))
            elif kind == "minmax":
                new_plans.append((kind, state(plan[1], a.func, False),
                                  state(plan[2], "sum", True)))
            else:  # the variance family: (s1, s2, count)
                new_plans.append((kind, state(plan[1], "sum", False),
                                  state(plan[2], "sum", False),
                                  state(plan[3], "sum", True)))
        if not self._layout:
            self._layout, self._hit_h, self._plans = layout, new_hit, \
                new_plans
        return states

    def combine(self, acc: Optional[List], states: List) -> List:
        """Fold one partition's states into the running ones on the
        device: the partial state a mid-stream recovery resumes from.  Out
        of place: two states may share storage (a deduped reduction)."""
        if acc is None:
            return list(states)
        out = []
        for (op, _), a, s in zip(self._layout, acc, states):
            if op == "sum":
                out.append(a + s)
            elif op == "min":
                out.append(torch.minimum(a, s))
            else:
                out.append(torch.maximum(a, s))
        return out

    def finalize(self, acc: List) -> Table:
        """The parent's finalize over the combined states: the outputs
        packed into one float64 matrix, one transfer, the host decode."""
        tags: List[Tuple[str, np.dtype]] = []
        packed = self._packed(self._hit_h, self._plans, _States(acc), tags)
        host, present = fetch_packed(packed, self.domain)
        return self._decode(host, present, tags)


#: streamed pipelines, keyed like the compiled aggregate's and evicted
#: with their Context (`physical.compiled.pipeline_owner`)
_CACHE_CAP = 8
_cache: "OrderedDict[Tuple, StreamedAggregate]" = OrderedDict()


def reset_cache() -> None:
    """Drop every cached streamed pipeline (tests)."""
    _cache.clear()


def try_streamed_aggregate(rel: p.Aggregate, executor) -> Optional[Table]:
    """The streamed_aggregate rung: fires only for a plan the admission
    gate routed here (this execution's ``executor.stream_decisions``
    entry); None declines down the ladder.  A plan the pipeline cannot
    take when it builds sheds with the gate's error
    (`plan.shed_ineligible`) instead of declining into a single run of the
    whole over-budget plan."""
    decision: Optional[StreamDecision] = \
        executor.stream_decisions.get(id(rel))
    if decision is None or decision.kind != "aggregate":
        return None
    config = executor.config
    if not config.get("serving.stream.enabled", True) \
            or not config.get("sql.compile", True):
        return None
    chain = _extract_chain(rel)
    if chain is None:
        return None
    scan, filters, group_exprs, agg_exprs = chain
    ctx = executor.context
    try:
        dc = ctx.schema[scan.schema_name].tables.get(scan.table_name)
        if dc is None:
            return None
        table = executor.get_table(scan.schema_name, scan.table_name)
        if scan.projection is not None:
            table = table.select(scan.projection)
        from .. import families

        pz = families.pipeline_parameterizer(config)
        filters = [pz.rewrite(f) for f in filters]
        agg_exprs = [pz.rewrite_agg(a) for a in agg_exprs]
        params = pz.params
        key = (
            "streamed_aggregate",
            dc.uid, ctx.table_epoch(scan.schema_name, scan.table_name),
            scan.schema_name, scan.table_name,
            tuple(scan.projection or ()),
            tuple(str(f) for f in filters),
            tuple(str(e) for e in group_exprs),
            tuple(str(a) for a in agg_exprs),
            tuple((f.name, f.sql_type) for f in rel.schema),
            table.num_rows,
        )

        def build():
            return StreamedAggregate(rel, table, filters, group_exprs,
                                     agg_exprs)

        compiled, built_here = singleflight_get_or_build(
            _cache, key, build, "streamed_aggregate", ctx, _CACHE_CAP)
    except (_Unsupported, ValueError, TypeError, NotImplementedError) as e:
        shed_ineligible(decision, ctx.metrics, reason=str(e))
        raise  # unreachable: shed_ineligible raises
    if not built_here and params:
        ctx.metrics.inc("families.hit")
        trace_event("family_hit", rung="streamed_aggregate",
                    params=len(params))
    ctx.metrics.inc("serving.stream.queries")
    acc: List[Optional[List]] = [None]

    def launch(lo: int, chunk_rows: int) -> None:
        states = compiled.run_partition(
            slice_chunk(table, lo, chunk_rows), params)
        acc[0] = compiled.combine(acc[0], states)

    launches = drive_partitions(executor, decision, launch,
                                "streamed_aggregate")
    trace_event("rung:streamed_aggregate", rung="streamed_aggregate",
                partitions=launches, chunk_rows=decision.chunk_rows)
    result = compiled.finalize(acc[0])
    if compiled.has_encoded:
        ctx.metrics.inc("columnar.encoding.late_rows", result.num_rows)
    return result
