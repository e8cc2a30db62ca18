"""Dynamic partition pruning.

Copied from `dask_sql_tpu/planner/optimizer/dpp.py`; only import paths differ.

Role parity: reference src/sql/optimizer/dynamic_partition_pruning.rs — for
fact ⋈ dim inner joins it reads the *smaller* side's join-key values at plan
time and injects InList filters into the fact table's scan so IO skips
non-matching row groups (dynamic_partition_pruning.rs:1-8; gated by
`sql.dynamic_partition_pruning` and `fact_dimension_ratio`).

Here the dim side is evaluated with a scoped executor at plan time (the
reference reads parquet directly at plan time, the same plan/execute blur),
and the distinct key values become a bulk InArrayExpr on the fact TableScan —
which the lazy-parquet scan path then converts into a pyarrow row-group
filter (physical/utils/filter.py), completing the IO pruning.
"""
from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from .. import plan as p
from ..expressions import ColumnRef, InArrayExpr

logger = logging.getLogger(__name__)

_MAX_INLIST = 50_000


def apply(plan, config, catalog, context=None):
    if context is None:
        return plan
    ratio = float(config.get("sql.optimizer.fact_dimension_ratio", 0.7)) or 0.7

    def go(node):
        kids = [go(k) for k in node.inputs()]
        node = node.with_inputs(kids) if kids else node
        if isinstance(node, p.Join) and node.join_type == "INNER" and node.on:
            node = _try_prune(node, catalog, context, ratio) or node
        return node

    return go(plan)


def _scan_of(node) -> Optional[p.TableScan]:
    while isinstance(node, (p.Filter, p.SubqueryAlias, p.Projection)):
        node = node.inputs()[0]
    return node if isinstance(node, p.TableScan) else None


def _rows(scan: Optional[p.TableScan], catalog) -> Optional[float]:
    if scan is None:
        return None
    try:
        t = catalog.schemas[scan.schema_name].tables[scan.table_name]
        return t.statistics.row_count
    except KeyError:
        return None


def _has_filters(node) -> bool:
    while isinstance(node, (p.SubqueryAlias, p.Projection)):
        node = node.inputs()[0]
    if isinstance(node, p.Filter):
        return True
    return isinstance(node, p.TableScan) and bool(node.filters)


def _try_prune(join: p.Join, catalog, context, ratio):
    lscan, rscan = _scan_of(join.left), _scan_of(join.right)
    lrows, rrows = _rows(lscan, catalog), _rows(rscan, catalog)
    if lrows is None or rrows is None or not lrows or not rrows:
        return None
    nleft = len(join.left.schema)
    for key_pair in join.on:
        lkey, rkey = key_pair
        # fact = the big side; dim = the small *filtered* side
        if rrows / lrows <= (1 - ratio) and _has_filters(join.right) \
                and isinstance(lkey, ColumnRef) and lscan is not None:
            new_left = _inject(join.left, lscan, lkey, join.right, rkey, nleft,
                               context, side="right")
            if new_left is not None:
                return p.Join(new_left, join.right, join.join_type, join.on,
                              join.filter, join.schema, join.null_aware)
        if lrows / rrows <= (1 - ratio) and _has_filters(join.left) \
                and isinstance(rkey, ColumnRef) and rscan is not None:
            new_right = _inject(join.right, rscan, rkey, join.left, lkey, nleft,
                                context, side="left")
            if new_right is not None:
                return p.Join(join.left, new_right, join.join_type, join.on,
                              join.filter, join.schema, join.null_aware)
    return None


def _inject(fact_side, fact_scan: p.TableScan, fact_key: ColumnRef,
            dim_side, dim_key, nleft: int, context, side: str):
    """Evaluate the dim side now, collect distinct key values, filter fact scan.

    `nleft` is the left input's schema width: with the dim on the left
    (side="left") the fact key lives in the join's combined output space and
    must be rebased by -nleft before resolving into the fact scan; with the
    dim on the right it is the dim key that needs the rebase.
    """
    try:
        from ...physical.executor import Executor

        executor = Executor(context)
        dim_table = executor.execute(dim_side)
        if side == "right":
            key_expr = _rebase(dim_key, nleft)
        else:
            key_expr = dim_key
        col = executor.eval_expr(key_expr, dim_table)
        vals = col.to_numpy()
        vals = vals[~_isnull(vals)]
        uniq = np.unique(vals)
        if len(uniq) == 0 or len(uniq) > _MAX_INLIST:
            return None
        if uniq.dtype.kind == "M":
            uniq = uniq.astype("datetime64[ns]").view("int64")
        # the fact key must resolve inside the scan (column ref path only)
        scan_idx = fact_key.index
        if side == "left":
            scan_idx = fact_key.index - nleft
        # map through any projections between scan and join input
        ref = _resolve_to_scan(fact_side, scan_idx)
        if ref is None:
            return None
        in_filter = InArrayExpr(ref, uniq, False)
        new_scan = p.TableScan(fact_scan.schema_name, fact_scan.table_name,
                               fact_scan.schema, fact_scan.projection,
                               list(fact_scan.filters) + [in_filter])
        return _replace_scan(fact_side, fact_scan, new_scan)
    except Exception as e:  # dsql: allow-broad-except — DPP must never break planning
        logger.debug("DPP skipped: %s", e)
        return None


def _rebase(expr, nleft):
    from ..expressions import shift_columns

    return shift_columns(expr, -nleft)


def _resolve_to_scan(node, index: int) -> Optional[ColumnRef]:
    """Trace a column index at `node`'s output down to the scan schema."""
    while True:
        if isinstance(node, (p.Filter, p.SubqueryAlias)):
            node = node.inputs()[0]
            continue
        if isinstance(node, p.Projection):
            e = node.exprs[index]
            if not (isinstance(e, ColumnRef) and type(e) is ColumnRef):
                return None
            index = e.index
            node = node.input
            continue
        if isinstance(node, p.TableScan):
            f = node.schema[index]
            return ColumnRef(index, f.name, f.sql_type, f.nullable)
        return None


def _replace_scan(node, old_scan, new_scan):
    if node is old_scan:
        return new_scan
    kids = node.inputs()
    if not kids:
        return node
    return node.with_inputs([_replace_scan(k, old_scan, new_scan) for k in kids])


def _isnull(vals: np.ndarray) -> np.ndarray:
    if vals.dtype == object:
        return np.array([v is None for v in vals])
    if vals.dtype.kind == "f":
        return np.isnan(vals)
    if vals.dtype.kind == "M":
        return np.isnat(vals)
    return np.zeros(len(vals), dtype=bool)

