"""Relational converters: scan, projection, filter, limit, sort and
subquery alias.

Counterpart of the TableScan, Projection, Filter, Limit, Sort and
SubqueryAlias plugins of `dask_sql_tpu/physical/rel/logical/basic.py`.
"""
from __future__ import annotations

from ....columnar.table import Table
from ....ops.sorting import sort_permutation, topk_permutation
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
    """Projection + pushed-down filters over a registered table.  The eager
    operators work in value space, so an encoded table (columnar/
    encodings.py) decodes once here, counted in
    ``metrics["columnar.encoding.decode"]``; the compiled pipelines read the
    codes and never reach this plugin."""

    class_name = "TableScan"

    def convert(self, rel: p.TableScan, executor) -> Table:
        table = executor.get_table(rel.schema_name, rel.table_name)
        if rel.projection is not None:
            table = table.select(rel.projection)
        if table.has_encoded_columns():
            executor.context.metrics.inc("columnar.encoding.decode")
            table = table.decode()
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
class LimitPlugin(BaseRelPlugin):
    class_name = "Limit"

    def convert(self, rel: p.Limit, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        start = rel.skip or 0
        stop = inp.num_rows if rel.fetch is None else start + rel.fetch
        return inp.slice(start, stop)


@Executor.add_plugin_class
class SortPlugin(BaseRelPlugin):
    """Full stable sort, or with a fetch, top-k on the first key and then
    the exact sort of the survivors."""

    class_name = "Sort"

    def convert(self, rel: p.Sort, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        if inp.num_rows == 0:
            return inp
        cols = [executor.eval_expr(k.expr, inp) for k in rel.keys]
        limit = executor.config.get("sql.sort.topk-nelem-limit", 1_000_000)
        if (rel.fetch is not None and cols
                and rel.fetch * max(len(inp.columns), 1) <= limit):
            idx = topk_permutation(cols[0], rel.keys[0].ascending,
                                   rel.fetch * 4, exact_ties=len(cols) > 1)
            if idx is not None:
                sub = inp.take(idx)
                sub_cols = [executor.eval_expr(k.expr, sub) for k in rel.keys]
                perm = sort_permutation(
                    sub_cols, [k.ascending for k in rel.keys],
                    [k.nulls_first_resolved() for k in rel.keys])
                return sub.take(perm[: rel.fetch])
        perm = sort_permutation(
            cols, [k.ascending for k in rel.keys],
            [k.nulls_first_resolved() for k in rel.keys])
        if rel.fetch is not None:
            perm = perm[: rel.fetch]
        return inp.take(perm)


@Executor.add_plugin_class
class SubqueryAliasPlugin(BaseRelPlugin):
    class_name = "SubqueryAlias"

    def convert(self, rel: p.SubqueryAlias, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        return self.fix_column_to_row_type(inp, rel.schema)
