"""streamed_select: a root select chain in partitions, survivors in order.

The port's counterpart of `dask_sql_tpu/streaming/select.py`.  It reuses
`CompiledSelect` (physical/compiled_select.py) whole: one pipeline is
planned on the full table (string dictionaries and parameter slots are the
table's), and each partition runs its mask and gather programs over a
slice of the rows.  The survivors of each partition come back to the host
in ascending row order, and the partitions concatenate in order, so the
result is the single run's rows in the single run's order.  An ORDER BY or
LIMIT is a property of all the rows, which no partition sees: such plans
are never routed here (`plan.stream_decision`).
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from typing import List, Optional, Tuple

from ..columnar.table import Table
from ..observability import trace_event
from ..physical.compiled import _Unsupported, singleflight_get_or_build
from ..physical.compiled_select import (
    CompiledSelect,
    _extract,
    resolve_pipeline_inputs,
)
from .partition import slice_chunk
from .plan import StreamDecision, shed_ineligible
from .runner import drive_partitions

logger = logging.getLogger(__name__)

#: streamed select pipelines, evicted with their Context
_CACHE_CAP = 8
_cache: "OrderedDict[Tuple, CompiledSelect]" = OrderedDict()


def reset_cache() -> None:
    """Drop every cached streamed select pipeline (tests)."""
    _cache.clear()


def try_streamed_select(root, executor) -> Optional[Table]:
    """The streamed_select rung (physical/executor.py `execute_root`):
    fires only for a plan the admission gate routed here (this execution's
    ``executor.stream_decisions`` entry); None declines down the ladder."""
    decision: Optional[StreamDecision] = \
        executor.stream_decisions.get(id(root))
    if decision is None or decision.kind != "select":
        return None
    config = executor.config
    if not config.get("serving.stream.enabled", True) \
            or not config.get("sql.compile", True) \
            or not config.get("sql.compile.select", True):
        return None
    got = _extract(root)
    if got is None:
        return None
    scan, upper_filters, proj, sort_keys, sort_fetch, limit, inner_limit = got
    if sort_keys is not None or limit is not None or inner_limit is not None \
            or sort_fetch is not None:
        return None
    ctx = executor.context
    try:
        resolved = resolve_pipeline_inputs(scan, executor)
        if resolved is None:
            return None
        dc, table = resolved
        from .. import families

        pz = families.pipeline_parameterizer(config)
        p_upper = [pz.rewrite(f) for f in upper_filters]
        p_scan_flts = [pz.rewrite(f) for f in scan.filters]
        p_exprs = [pz.rewrite(e) for e in proj.exprs]
        params = pz.params
        key = (
            "streamed_select",
            dc.uid, ctx.table_epoch(scan.schema_name, scan.table_name),
            tuple(scan.projection or ()),
            tuple(str(f) for f in p_upper),
            tuple(str(f) for f in p_scan_flts),
            tuple(str(e) for e in p_exprs),
            tuple((f.name, f.sql_type) for f in proj.schema),
            table.num_rows,
        )

        def build():
            return CompiledSelect(table, p_upper, p_scan_flts, proj, p_exprs,
                                  None, None, None, None, params)

        compiled, built_here = singleflight_get_or_build(
            _cache, key, build, "streamed_select", ctx, _CACHE_CAP)
    except (_Unsupported, ValueError, TypeError, NotImplementedError) as e:
        shed_ineligible(decision, ctx.metrics, reason=str(e))
        raise  # unreachable: shed_ineligible raises
    if not built_here and params:
        ctx.metrics.inc("families.hit")
        trace_event("family_hit", rung="streamed_select",
                    params=len(params))
    ctx.metrics.inc("serving.stream.queries")
    parts: List[Table] = []

    def launch(lo: int, chunk_rows: int) -> None:
        out = compiled.run(slice_chunk(table, lo, chunk_rows), params)
        if out.num_rows:
            parts.append(out)

    launches = drive_partitions(executor, decision, launch,
                                "streamed_select")
    trace_event("rung:streamed_select", rung="streamed_select",
                partitions=launches, chunk_rows=decision.chunk_rows)
    if not parts:
        cols, valids = compiled._decode_packed(None, 0, [])
        result = compiled._assemble(cols, valids, 0)
    else:
        result = parts[0] if len(parts) == 1 else Table.concat(parts)
    if compiled.has_encoded:
        ctx.metrics.inc("columnar.encoding.late_rows", result.num_rows)
    return result
