"""Peak device bytes of the port's fused programs, for `peak_bytes.hi`.

The reference's estimator charges a compiled aggregate its packed matrix
and its group ids only (`estimator._aggregate_scratch`).  The port's fused
programs hold more at their peak: the decoded columns, the expression
temporaries of the evaluator, the masks, the group ids, and the select's
survivor indices and packed matrix.  This module bounds those bytes from
the plan alone, read off the pipelines' code:

- `physical/compiled.py` `CompiledAggregate.run`: the filter mask, the
  radix gid (int32), each distinct (argument, FILTER) pair's values and
  validity kept until the one reduction, the reducer's conversions;
- `physical/compiled_join.py` `CompiledJoinAggregate.run`: the same over
  the probe rows, plus each join's probe temporaries, its safe build row
  (int32), the build columns gathered to the probe rows, and the build
  keys' lookup tables (at most ``max(8 x rows, 65536)`` int32 entries,
  `ops/join.py` `dense_unique_lut`);
- `physical/compiled_select.py` `CompiledSelect.run`: the mask program
  over every row (mask, int64 running count, `sized_nonzero`'s
  temporaries), then the gather program over the survivor bucket (a power
  of two above the survivors, at most the one above the table's rows: the
  estimator cannot see a filter's selectivity).

The evaluator (`compiled.py` `_TraceEval`) is charged per row by a
recurrence over the expression tree: a column of the table aliases its
buffer, a DICT or FOR column decodes once into the run's slots and stays,
a literal or parameter is 0-dim, a cast allocates its output over its
operand's, and a function holds its evaluated operands while it allocates
its output and up to two masks (its validity and a NaN or zero guard).
Any other node (CASE, IN, LIKE, subquery placeholders) is charged every
node of its subtree at once.  Every count is an upper bound of what the
code keeps live at once; a table's rows are its registered row count.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from ..columnar.dtypes import SqlType, sql_to_np
from ..planner import plan as p
from ..planner.expressions import (
    Cast,
    ColumnRef,
    Expr,
    Literal,
    ParamRef,
    ScalarFunc,
    walk,
)

#: int32 radix group ids, int64 row indices and counts, bool masks
_GID, _INDEX, _MASK = 4, 8, 1
#: per-row bytes of building a radix gid key by key (the widened digit,
#: its clamp and NULL slot, the multiply-add of the running gid)
_GID_BUILD = 4 * _GID
#: the largest domain the segment-sum kernel takes (`ops/segsum.py`
#: KERNEL_MAX_DOMAIN); above it `SortedSegments` sorts the ids once
#: (an int64 permutation and the sorted ids) and gathers one column at a
#: time in that order
_SORTED_SCRATCH = 3 * _INDEX


def _width(t: SqlType) -> int:
    """Device bytes per value (strings are int32 codes)."""
    if t == SqlType.BOOLEAN:
        return 1
    try:
        return int(sql_to_np(t).itemsize)
    except Exception:  # dsql: allow-broad-except — an exotic type: the widest
        # claim
        return 8


class _Program:
    """Per-row live bytes of one fused program: `live` bytes held from
    here to the reduction, `peak` the most held at any point."""

    def __init__(self, decoded: Dict[int, int]):
        #: slot index -> decoded width of a DICT or FOR column
        self._decoded_width = decoded
        self._decoded: set = set()
        self.live = 0
        self.peak = 0

    def hold(self, nbytes: int) -> None:
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def touch(self, transient: int) -> None:
        """A transient of `transient` bytes on top of what is held."""
        self.peak = max(self.peak, self.live + transient)

    def expr(self, e: Expr) -> Tuple[int, int]:
        """(result bytes, transient peak bytes) of evaluating `e`; a
        decoded column joins the held bytes for the rest of the run."""
        if isinstance(e, ColumnRef) and type(e) is ColumnRef:
            w = self._decoded_width.get(e.index)
            if w is not None and e.index not in self._decoded:
                self._decoded.add(e.index)
                self.hold(w)
            return 0, 0
        if isinstance(e, (Literal, ParamRef)):
            return 0, 0
        if isinstance(e, Cast):
            res, peak = self.expr(e.arg)
            w = _width(e.sql_type)
            return w, max(peak, res + w)
        if isinstance(e, ScalarFunc):
            held = peak = 0
            for arg in e.args:
                res, pk = self.expr(arg)
                peak = max(peak, held + pk)
                held += res
            w = _width(e.sql_type)
            return w + _MASK, max(peak, held + w + 2 * _MASK)
        total = 0
        for node in walk(e):
            if isinstance(node, ColumnRef) and type(node) is ColumnRef:
                self.expr(node)
            else:
                total += _width(getattr(node, "sql_type", SqlType.BIGINT)) \
                    + 3 * _MASK
        return _width(e.sql_type) + _MASK, total

    def eval_held(self, e: Expr) -> int:
        """Evaluate `e` and hold its result; returns the result bytes."""
        res, peak = self.expr(e)
        self.touch(peak)
        self.hold(res)
        return res

    def fold_masks(self, predicates: Iterable[Expr]) -> None:
        """Predicates folded into one row mask (each result, its validity
        AND and the running AND live while it folds)."""
        first = True
        for f in predicates:
            res, peak = self.expr(f)
            self.touch(max(peak, res + 2 * _MASK))
            if first:
                self.hold(_MASK)
                first = False

    def aggregates(self, agg_exprs, domain: Optional[int]) -> None:
        """`segment_agg_outputs`: every distinct (argument, FILTER) pair's
        values and validity held to the one reduction, plus the reducer's
        conversions, then the reduction itself."""
        seen = set()
        for a in agg_exprs:
            key = (str(a.args[0]) if a.args else "*",
                   str(a.filter) if a.filter is not None else None)
            if key not in seen:
                seen.add(key)
                if a.filter is not None:
                    self.eval_held(a.filter)
                    self.hold(_MASK)
                if a.args:
                    self.eval_held(a.args[0])
                    # valid & arg validity, & ~isnan(arg)
                    self.touch(2 * _MASK)
                    self.hold(_MASK)
            func = a.func
            if a.args and a.args[0].sql_type == SqlType.BOOLEAN \
                    and func in ("sum", "avg"):
                self.hold(4)  # the bool argument as int32
            elif func in ("min", "max"):
                arg_w = _width(a.args[0].sql_type) if a.args else 8
                self.hold(max(arg_w, 4))  # the fill-masked contribution
                self.touch(_INDEX)  # scatter_reduce's int64 ids
            elif func not in ("count", "count_star", "sum", "avg"):
                self.hold(2 * 8)  # the variance family's x and x * x
        from ..ops.segsum import KERNEL_MAX_DOMAIN

        if domain is None or domain > KERNEL_MAX_DOMAIN:
            self.touch(_SORTED_SCRATCH)


def _decoded_widths(context, scan: p.TableScan) -> Dict[int, int]:
    """Scan slot -> decoded width of each DICT or FOR column the fused
    programs decode when they read it as values."""
    from ..columnar.dtypes import STRING_TYPES
    from ..columnar.encodings import Encoding, resolve_encoded_scan

    got = resolve_encoded_scan(context, scan)
    if got is None:
        return {}
    table, names = got
    out = {}
    for i, n in enumerate(names):
        col = table.columns[n]
        if col.encoding in (Encoding.DICT, Encoding.FOR) \
                and col.sql_type not in STRING_TYPES:
            out[i] = _width(col.sql_type)
    return out


def _packed_bytes(rows: int, n_rows_out: int) -> int:
    """`pack_flat`: the float64 copies of the narrower outputs and the
    stacked matrix, live together."""
    return 2 * n_rows_out * rows * 8


def aggregate_scratch(node: p.Aggregate, scan_rows: Optional[int],
                      domain: Optional[int], context) -> Optional[int]:
    """Peak bytes of `CompiledAggregate.run` for `node`, or None when the
    node is not a scan chain the fused aggregate takes or its scan's rows
    are unknown."""
    from ..physical.compiled import _extract_chain

    chain = _extract_chain(node)
    if chain is None or scan_rows is None:
        return None
    scan, filters, group_exprs, agg_exprs = chain
    prog = _Program(_decoded_widths(context, scan))
    prog.fold_masks(filters)
    if not filters:
        prog.hold(_MASK)  # the all-rows selection
    # the group keys are columns read as their codes: nothing decodes
    prog.touch(_GID_BUILD)
    prog.hold(_GID)
    prog.aggregates(agg_exprs, domain)
    out_domain = domain if domain is not None else _radix_limit()
    return scan_rows * prog.peak \
        + _packed_bytes(out_domain, 1 + 2 * len(agg_exprs))


def join_aggregate_scratch(node: p.Aggregate, probe_rows: Optional[int],
                           build_rows: List[Optional[int]],
                           domain: Optional[int], context) -> Optional[int]:
    """Peak bytes of `CompiledJoinAggregate.run` for `node`, with its
    build keys' lookup tables, or None when the node is not a join chain
    the pipeline takes or a row count is unknown.  `build_rows` are the
    row bounds of the build sides, in join order."""
    from ..ops.join import _DENSE_RANGE_FLOOR, _DENSE_RANGE_SLACK
    from ..physical.compiled_join import _BuildRef, _extract

    got = _extract(node)
    if got is None or probe_rows is None \
            or any(r is None for r in build_rows):
        return None
    ext, group_exprs, agg_exprs = got
    if len(build_rows) != len(ext.joins):
        return None
    prog = _Program(_decoded_widths(context, ext.scan))
    prog.hold(_MASK)  # the running match mask
    exprs = (list(ext.conjuncts) + [j["lkey"] for j in ext.joins]
             + [x for a in agg_exprs for x in a.args]
             + [a.filter for a in agg_exprs if a.filter is not None]
             + list(group_exprs))
    used = {(s.k, s.col): _width(s.sql_type) for e in exprs
            for s in walk(e) if isinstance(s, _BuildRef)}
    luts = 0
    for k, j in enumerate(ext.joins):
        res, peak = prog.expr(j["lkey"])
        # `_probe`: the widened key, the in-range mask, the index, the
        # gathered row and its clamp
        prog.touch(max(peak, res + 2 * _INDEX + 2 * 4 + 3 * _MASK))
        prog.hold(4 + _MASK)  # the safe build row, the matched flags
        prog.hold(sum(w + _MASK for (bk, _), w in used.items() if bk == k))
        luts += 4 * max(_DENSE_RANGE_SLACK * build_rows[k],
                        _DENSE_RANGE_FLOOR)
    prog.fold_masks(ext.conjuncts)
    for e in group_exprs:
        prog.expr(e)
    prog.touch(_GID_BUILD)
    prog.hold(_GID)
    prog.aggregates(agg_exprs, domain)
    out_domain = domain if domain is not None else _radix_limit()
    return probe_rows * prog.peak + luts \
        + _packed_bytes(out_domain, 1 + 2 * len(agg_exprs)
                        + 2 * len(group_exprs))


def select_scratch(root: p.LogicalPlan, scan_rows: Optional[int],
                   context) -> Optional[int]:
    """Peak bytes of `CompiledSelect.run` for a root select chain, or None
    when `root` is not one or its scan's rows are unknown."""
    from ..physical.compiled_select import _extract

    got = _extract(root)
    if got is None or scan_rows is None:
        return None
    scan, upper_filters, proj, _, _, _, inner_limit = got
    decoded = _decoded_widths(context, scan)
    # the mask program over every row
    mask = _Program(decoded)
    mask.fold_masks(list(scan.filters) + list(upper_filters))
    if not scan.filters and not upper_filters:
        mask.hold(_MASK)
    if inner_limit is not None:
        mask.touch(_INDEX + 2 * _MASK)  # the window's running count
    mask.hold(_INDEX)  # the running survivor count
    # sized_nonzero: the position test, the ordinal - 1, the positions,
    # then the row ids scattered into the bucket
    mask.touch(2 * _MASK + 3 * _INDEX)
    rows_part = scan_rows * mask.peak
    # the gather program over the bucket, the mask and the count still held
    bucket = 1 << max(scan_rows - 1, 0).bit_length()
    gather = _Program(decoded)
    gather.hold(_INDEX)  # the survivor row ids
    gather.hold(sum(_width(f.sql_type) + _MASK for f in scan.schema))
    gather.hold(_MASK)  # the all-valid flags
    for e in proj.exprs:
        gather.eval_held(e)
    gather.touch(_packed_bytes(1, 2 * len(proj.exprs)))
    return max(rows_part,
               scan_rows * mask.live + (bucket + 1) * gather.peak)


def _radix_limit() -> int:
    from ..ops.grouping import RADIX_DOMAIN_LIMIT

    return RADIX_DOMAIN_LIMIT
