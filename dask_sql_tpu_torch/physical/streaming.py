"""The out-of-core aggregate: a lazy parquet table streams in batches
through partial and final aggregate states.

Counterpart of `dask_sql_tpu/physical/streaming.py` on torch.  An
aggregate whose input reads one lazy parquet table (`LazyParquetContainer`)
of more rows than ``sql.streaming.batch_rows`` scans it batch by batch:
each batch is read with the scan's projection and pyarrow filters, moved to
the Context's device, run through the plan under the aggregate (filters,
projections and the joins whose streamed side is the preserved one, with
the other sides run once and shared) and reduced to one partial row a
group.  Only the partial tables stay on the device; their concatenation is
reduced once more to the result.  Float sums and counts go through the
segment sum (`ops/grouping.py`), so the hand-written kernel runs on each
batch's partials and on the final combine wherever the group domain fits
it; integer sums stay exact in int64.  A shape that cannot be split into
batches (another operator on the path, a FULL join, an embedded subquery,
DISTINCT or an aggregate without partial states) returns None and takes the
in-memory path.  A failure while streaming raises.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import torch

from ..columnar.column import Column
from ..columnar.dtypes import SqlType
from ..columnar.table import Table
from ..datacontainer import LazyParquetContainer
from ..ops import grouping as g
from ..planner import plan as p
from ..planner.expressions import (
    AggExpr,
    ExistsExpr,
    InSubqueryExpr,
    ScalarSubqueryExpr,
    walk,
)

logger = logging.getLogger(__name__)

#: the partial states of each aggregate that streams
_PARTIALIZABLE = {
    "sum": ("sum",),
    "count": ("count",),
    "count_star": ("count_star",),
    "avg": ("sum", "count"),
    "min": ("min",),
    "max": ("max",),
    "var_samp": ("count", "sum", "sumsq"),
    "var_pop": ("count", "sum", "sumsq"),
    "stddev_samp": ("count", "sum", "sumsq"),
    "stddev_pop": ("count", "sum", "sumsq"),
}

_SUBQUERIES = (ScalarSubqueryExpr, InSubqueryExpr, ExistsExpr)


def _node_exprs(node) -> list:
    """The expressions a plan node evaluates, a join's residual filter
    included (a subquery can sit there)."""
    from ..planner.optimizer.rules import _node_exprs as exprs

    out = list(exprs(node))
    if isinstance(node, p.Join) and node.filter is not None:
        out.append(node.filter)
    return out


def _has_subquery(node) -> bool:
    return any(isinstance(x, _SUBQUERIES) for e in _node_exprs(node)
               for x in walk(e))


def _find_stream_axis(plan: p.LogicalPlan, context):
    """``(scan, container, off_path)`` of the one lazy parquet scan under
    `plan`, or None when the plan cannot stream it: another lazy scan, an
    operator on the path to it other than Filter, Projection, alias and a
    join whose streamed side is preserved, or a subquery anywhere (it would
    read a batch in place of the table).  `off_path` holds the other sides
    of the joins on the path, which run once."""
    lazy = []
    for node in p.walk_plan(plan):
        if isinstance(node, p.TableScan):
            container = context.schema.get(node.schema_name)
            dc = container.tables.get(node.table_name) if container else None
            if isinstance(dc, LazyParquetContainer):
                lazy.append((node, dc))
    if len(lazy) != 1:
        return None
    scan, dc = lazy[0]

    def path_to(node):
        if node is scan:
            return [node]
        for child in node.inputs():
            sub = path_to(child)
            if sub is not None:
                return [node] + sub
        return None

    path = path_to(plan)
    if path is None or any(_has_subquery(node)
                           for node in p.walk_plan(plan)):
        return None
    off_path: List[p.LogicalPlan] = []
    for parent, child in zip(path[:-1], path[1:]):
        if isinstance(parent, (p.Filter, p.Projection, p.SubqueryAlias)):
            continue
        if isinstance(parent, p.Join):
            on_left = child is parent.left
            jt = parent.join_type
            # the union of the batches' joins is the whole join only where
            # the streamed side is the preserved (or probe) side
            if not (jt == "INNER"
                    or (on_left and jt in ("LEFT", "LEFTSEMI", "LEFTANTI"))
                    or (not on_left and jt == "RIGHT")):
                return None
            off_path.append(parent.right if on_left else parent.left)
            continue
        return None
    return scan, dc, off_path


def try_streaming_aggregate(rel: p.Aggregate, executor) -> Optional[Table]:
    """The aggregate `rel` over its lazy parquet table in batches, or None
    when it does not stream (see the module's docstring).  Logs the number
    of batches."""
    config = executor.config
    if not config.get("sql.streaming.enabled", True):
        return None
    if _has_subquery(rel):
        return None  # the aggregate's own expressions would read a batch
    axis = _find_stream_axis(rel.input, executor.context)
    if axis is None:
        return None
    scan, dc, off_path = axis
    batch_rows = int(config.get("sql.streaming.batch_rows", 2_000_000))
    total = (dc.statistics or {}).get("num-rows", 0)
    if not total or total <= batch_rows:
        return None  # it fits: the in-memory path is faster
    if any(agg.func not in _PARTIALIZABLE or agg.distinct
           for agg in rel.agg_exprs):
        return None
    from .executor import Executor
    from .utils.filter import filters_to_pyarrow

    # the other sides of the path's joins run once, shared by the batches
    shared = {id(node): executor.execute(node) for node in off_path}

    # the partial states, each computed once however many aggregates read it
    partial_specs: List[Tuple[str, AggExpr]] = []
    spec_index: Dict = {}

    def partial_of(agg: AggExpr, kind: str) -> int:
        if kind == "count_star":
            probe = AggExpr("count_star", (), SqlType.BIGINT, False,
                            agg.filter)
        elif kind == "sumsq":
            probe = AggExpr("sumsq", agg.args, SqlType.DOUBLE, False,
                            agg.filter)
        else:
            out_t = SqlType.BIGINT if kind == "count" else (
                SqlType.DOUBLE if kind == "sum" else agg.sql_type)
            probe = AggExpr(kind, agg.args, out_t, False, agg.filter)
        key = (probe.func, probe.args, probe.filter)
        if key not in spec_index:
            spec_index[key] = len(partial_specs)
            partial_specs.append((kind, probe))
        return spec_index[key]

    finalize = [(agg.func, [partial_of(agg, k) for k in _PARTIALIZABLE[agg.func]])
                for agg in rel.agg_exprs]

    names = scan.projection if scan.projection is not None else [
        f.name for f in dc.fields]
    pa_filters, _ = filters_to_pyarrow(scan.filters, list(names))
    ngroups = len(rel.group_exprs)
    partial_tables: List[Table] = []
    for batch in _iter_batches(dc, names, pa_filters, batch_rows):
        sub = Executor(executor.context)
        sub.table_overrides[(scan.schema_name, scan.table_name)] = batch
        sub._memo.update(shared)
        del batch
        try:
            part = _batch_partials(rel, sub, partial_specs)
        finally:
            # the executor and its evaluator refer to each other: without
            # this the batch and its intermediates wait for the cycle
            # collector, and the batches pile up on the device
            sub._memo.clear()
            sub.table_overrides.clear()
        if part is not None:
            partial_tables.append(part)
    if not partial_tables:
        # no row reached the aggregate: the eager aggregate over an empty
        # batch gives the empty answer, and the file stays on disk
        sub = Executor(executor.context)
        sub.table_overrides[(scan.schema_name, scan.table_name)] = \
            Table.from_arrow(_dataset(dc).schema.empty_table().select(names),
                             dc.device)
        sub._memo.update(shared)
        with config.set({"sql.streaming.enabled": False,
                         "sql.compile": False}):
            return sub.execute(rel)

    combined = Table.concat(partial_tables)
    gcols = [combined.columns[f"__g{i}"] for i in range(ngroups)]
    gid, num_groups, mode, keys, present = g.group_rows(
        gcols, combined.num_rows, combined.device, config)
    from .rel.base import unique_names
    from .rel.logical.aggregate import _mk, _mk_like

    out_names = unique_names([f.name for f in rel.schema])
    out: Dict[str, Column] = dict(zip(out_names, keys))

    def combine(j: int, how: str):
        # a string state's dictionary is sorted (each batch's was, and the
        # concatenation merges them sorted): code order is string order
        col = combined.columns[f"__p{j}"]
        fn = {"sum": g.seg_sum, "min": g.seg_min, "max": g.seg_max}[how]
        vals, ok = fn(col.data, col.valid_mask(), gid, num_groups, mode)
        return vals, ok, col

    for name, agg, (func, idxs) in zip(out_names[ngroups:], rel.agg_exprs,
                                       finalize):
        if func in ("sum", "count", "count_star"):
            vals, ok, _ = combine(idxs[0], "sum")
            col = _mk(vals, ok if func == "sum" else None, agg.sql_type)
        elif func == "avg":
            s = combine(idxs[0], "sum")[0].to(torch.float64)
            cnt = combine(idxs[1], "sum")[0]
            col = _mk(s / torch.clamp(cnt, min=1), cnt > 0, SqlType.DOUBLE)
        elif func in ("min", "max"):
            vals, ok, src = combine(idxs[0], func)
            col = _mk_like(vals, ok, src, agg.sql_type)
        else:  # the variance family from (count, sum, sum of squares)
            cnt = combine(idxs[0], "sum")[0].to(torch.float64)
            s = combine(idxs[1], "sum")[0].to(torch.float64)
            s2 = combine(idxs[2], "sum")[0]
            ddof = 1 if func.endswith("samp") else 0
            mean = s / torch.clamp(cnt, min=1)
            var = torch.clamp(s2 - cnt * mean * mean, min=0.0) / torch.clamp(
                cnt - ddof, min=1)
            vals = torch.sqrt(var) if func.startswith("stddev") else var
            col = _mk(vals, cnt > ddof, SqlType.DOUBLE)
        out[name] = col if present is None else col.take(present)
    logger.info("streaming aggregate over %d batches", len(partial_tables))
    rows = num_groups if present is None else int(present.shape[0])
    return Table(out, rows, combined.device)


def _batch_partials(rel: p.Aggregate, sub, partial_specs) -> Optional[Table]:
    """One batch through the plan under the aggregate (`sub` reads the
    batch in place of the table) and reduced to its partial states, a row
    a group (``__g*`` the keys, ``__p*`` the states); None when no row
    reaches the aggregate."""
    inp = sub.execute(rel.input)
    if inp.num_rows == 0:
        return None
    gcols = [sub.eval_expr(e, inp) for e in rel.group_exprs]
    gid, num_groups, mode, keys, present = g.group_rows(
        gcols, inp.num_rows, inp.device, sub.config)
    cols: Dict[str, Column] = {f"__g{i}": k for i, k in enumerate(keys)}
    for j, (kind, probe) in enumerate(partial_specs):
        col = _partial_kernel(kind, probe, inp, gid, num_groups, mode, sub)
        cols[f"__p{j}"] = col if present is None else col.take(present)
    rows = num_groups if present is None else int(present.shape[0])
    return Table(cols, rows, inp.device)


def _partial_kernel(kind: str, probe: AggExpr, inp: Table, gid,
                    num_groups: int, mode: str, sub) -> Column:
    """One partial state of a batch, a row a group id: counts, sums (exact
    int64 for integers and booleans, float64 otherwise), sums of squares,
    or min and max (strings over their sorted batch dictionary)."""
    from .rel.logical.aggregate import _mk, _mk_like

    n = inp.num_rows
    fmask = None
    if probe.filter is not None:
        fc = sub.eval_expr(probe.filter, inp)
        fmask = fc.data & fc.valid_mask()
    if kind == "count_star":
        valid = torch.ones(n, dtype=torch.bool, device=inp.device) \
            if fmask is None else fmask
        return Column(g.seg_count(valid, gid, num_groups, mode),
                      SqlType.BIGINT)
    col = sub.eval_expr(probe.args[0], inp)
    if kind in ("min", "max") and col.dictionary is not None:
        col = col.compact_dictionary()  # code order is string order
    valid = col.valid_mask()
    if fmask is not None:
        valid = valid & fmask
    if col.data.is_floating_point():
        valid = valid & ~torch.isnan(col.data)
    if kind == "count":
        return Column(g.seg_count(valid, gid, num_groups, mode),
                      SqlType.BIGINT)
    if kind == "sum":
        if col.data.is_floating_point():
            vals, ok = g.seg_sum(col.data, valid, gid, num_groups, mode)
            return _mk(vals, ok, SqlType.DOUBLE)
        vals, ok = g.seg_sum(col.data.to(torch.int64), valid, gid,
                             num_groups, mode)
        return _mk(vals, ok, SqlType.BIGINT)
    if kind == "sumsq":
        x = col.data.to(torch.float64)
        vals, ok = g.seg_sum(x * x, valid, gid, num_groups, mode)
        return _mk(vals, ok, SqlType.DOUBLE)
    fn = g.seg_min if kind == "min" else g.seg_max
    vals, ok = fn(col.data, valid, gid, num_groups, mode)
    return _mk_like(vals, ok, col, col.sql_type)


def _iter_batches(dc: LazyParquetContainer, columns, pa_filters,
                  batch_rows: int):
    """The location's rows as Tables on its device, at most `batch_rows`
    each: a pyarrow dataset scanner with the projection and the filters,
    whose batches also end at row-group boundaries (count them; their
    number is not ``ceil(rows / batch_rows)``).  Empty batches are
    skipped."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    expr = pq.filters_to_expression(pa_filters) if pa_filters else None
    scanner = _dataset(dc).scanner(columns=list(columns) if columns else None,
                                   filter=expr, batch_size=batch_rows)
    for record_batch in scanner.to_batches():
        if record_batch.num_rows:
            yield Table.from_arrow(pa.Table.from_batches([record_batch]),
                                   dc.device)


def _dataset(dc: LazyParquetContainer):
    """The pyarrow dataset of the location's parquet files."""
    import pyarrow.dataset as ds

    from .utils.statistics import _paths_for

    return ds.dataset(_paths_for(dc.location), format="parquet")
