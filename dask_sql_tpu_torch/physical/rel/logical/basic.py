"""Relational converters: scan, projection, filter and sort.

Counterpart of the TableScan, Projection, Filter and Sort plugins of
`dask_sql_tpu/physical/rel/logical/basic.py`.
"""
from __future__ import annotations

from ....columnar.table import Table
from ....ops.sorting import sort_permutation
from ....planner import plan as p
from ....planner.expressions import ColumnRef
from ...executor import Executor
from ..base import BaseRelPlugin, unique_names


def _predicate_mask(executor, predicates, table: Table):
    """AND of the predicates over `table`; NULL counts as False."""
    mask = None
    for f in predicates:
        col = executor.eval_expr(f, table)
        m = col.data & col.valid_mask()
        mask = m if mask is None else (mask & m)
    return mask


@Executor.add_plugin_class
class TableScanPlugin(BaseRelPlugin):
    """Projection + pushed-down filters over a registered table."""

    class_name = "TableScan"

    def convert(self, rel: p.TableScan, executor) -> Table:
        table = executor.get_table(rel.schema_name, rel.table_name)
        if rel.projection is not None:
            table = table.select(rel.projection)
        if rel.filters:
            # filters are bound against the *projected* schema
            table = table.filter(_predicate_mask(executor, rel.filters, table))
        return self.fix_column_to_row_type(table, rel.schema)


@Executor.add_plugin_class
class ProjectionPlugin(BaseRelPlugin):
    class_name = "Projection"

    def convert(self, rel: p.Projection, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        names = unique_names([f.name for f in rel.schema])
        cols = {}
        for name, expr in zip(names, rel.exprs):
            if isinstance(expr, ColumnRef) and type(expr) is ColumnRef:
                cols[name] = inp.columns[inp.column_names[expr.index]]
            else:
                cols[name] = executor.eval_expr(expr, inp)
        return Table(cols, inp.num_rows, inp.device)


@Executor.add_plugin_class
class FilterPlugin(BaseRelPlugin):
    class_name = "Filter"

    def convert(self, rel: p.Filter, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        return inp.filter(_predicate_mask(executor, [rel.predicate], inp))


@Executor.add_plugin_class
class SortPlugin(BaseRelPlugin):
    class_name = "Sort"

    def convert(self, rel: p.Sort, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        if inp.num_rows == 0:
            return inp
        cols = [executor.eval_expr(k.expr, inp) for k in rel.keys]
        perm = sort_permutation(
            cols, [k.ascending for k in rel.keys],
            [k.nulls_first_resolved() for k in rel.keys])
        if rel.fetch is not None:
            perm = perm[: rel.fetch]
        return inp.take(perm)
