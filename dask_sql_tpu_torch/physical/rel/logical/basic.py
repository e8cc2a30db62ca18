"""Relational converters: scan, projection, filter, limit, sort, the set
operations, VALUES, SELECT without FROM, subquery alias, TABLESAMPLE,
DISTRIBUTE BY and EXPLAIN.

Counterpart of `dask_sql_tpu/physical/rel/logical/basic.py`.  Set
operations compare rows with NULLs equal (IS NOT DISTINCT FROM); a
DISTINCT, INTERSECT or EXCEPT keeps the first row of each distinct key in
input order.  TABLESAMPLE draws from a `torch.Generator` seeded with the
statement's seed: the same seed keeps the same rows, but not the rows the
reference's `jax.random` keeps.
"""
from __future__ import annotations

import numpy as np
import torch

from ....columnar.column import Column, torch_dtype
from ....columnar.concat import concat_columns, concat_tables
from ....columnar.dtypes import STRING_TYPES, sql_to_np
from ....columnar.table import Table
from ....ops.grouping import factorize, group_first_indices, key_arrays
from ....ops.sorting import sort_permutation, topk_permutation
from ....planner import plan as p
from ....planner.expressions import Cast, ColumnRef, Literal
from ....utils import host_ints
from ...executor import Executor
from ..base import BaseRelPlugin, gather_global, on_one_device, unique_names


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
    ``metrics.counter("columnar.encoding.decode")``; the compiled pipelines read the
    codes and never reach this plugin.  A batch of the streamed aggregate
    (`executor.table_overrides`) stands in for its table; a lazy parquet
    table reads only the projected columns, with the filters pyarrow can
    take passed to it as row-group filters.  Every filter still runs here
    afterwards."""

    class_name = "TableScan"

    def convert(self, rel: p.TableScan, executor) -> Table:
        from ....datacontainer import LazyParquetContainer

        override = executor.table_overrides.get((rel.schema_name,
                                                 rel.table_name))
        container = executor.context.schema.get(rel.schema_name)
        dc = container.tables.get(rel.table_name) if container else None
        if override is not None:
            table = override
        elif isinstance(dc, LazyParquetContainer):
            from ...utils.filter import filters_to_pyarrow

            names = rel.projection if rel.projection is not None else [
                f.name for f in dc.fields]
            pa_filters, _ = filters_to_pyarrow(rel.filters, list(names))
            table = dc.scan(columns=rel.projection, filters=pa_filters)
        else:
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
        # row by row: a sharded input keeps its blocks
        (inp,) = self.assert_inputs(rel, 1, executor, keep_shards=True)
        names = unique_names([f.name for f in rel.schema])
        cols = {}
        for name, expr in zip(names, rel.exprs):
            if isinstance(expr, ColumnRef) and type(expr) is ColumnRef:
                cols[name] = inp.columns[inp.column_names[expr.index]]
            else:
                cols[name] = executor.eval_expr(expr, inp)
        return Table(cols, inp.num_rows, inp.device, inp.sharding)


@Executor.add_plugin_class
class FilterPlugin(BaseRelPlugin):
    class_name = "Filter"

    def convert(self, rel: p.Filter, executor) -> Table:
        # each block keeps its own survivors
        (inp,) = self.assert_inputs(rel, 1, executor, keep_shards=True)
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
        (inp,) = self.assert_inputs(rel, 1, executor, keep_shards=True)
        if inp.num_rows == 0:
            return gather_global(inp, executor)
        cols = [executor.eval_expr(k.expr, inp) for k in rel.keys]
        if rel.fetch is None and cols:
            # a full sort of a sharded input: the range-partition sort over
            # its mesh, the output sharded in sort order (a top-k keeps the
            # path below: its k survivors are few whatever the sharding).
            # An exchange past its ladder steps down to the sort below
            from ....parallel import dist_plan
            from ....resilience import ladder

            mesh = dist_plan.should_distribute(
                executor, "sql.distributed.sort", inp)
            if mesh is not None:
                sorted_t = ladder.attempt(
                    executor, "dist_sort",
                    lambda: dist_plan.dist_sort_table(
                        mesh, inp, cols,
                        [k.ascending for k in rel.keys],
                        [k.nulls_first_resolved() for k in rel.keys],
                        metrics=executor.context.metrics),
                    rel=rel)
                if sorted_t is not None:
                    return self.fix_column_to_row_type(sorted_t, rel.schema)
        inp = gather_global(inp, executor)
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
        (inp,) = self.assert_inputs(rel, 1, executor, keep_shards=True)
        return self.fix_column_to_row_type(inp, rel.schema)


@Executor.add_plugin_class
class UnionPlugin(BaseRelPlugin):
    """Each input cast to the plan's row type and renamed to its fields,
    then concatenated (string dictionaries merge).  UNION without ALL is
    planned as a Distinct above this node."""

    class_name = "Union"

    def convert(self, rel: p.Union, executor) -> Table:
        tables = on_one_device([executor.execute(c) for c in rel.inputs()])
        names = unique_names([f.name for f in rel.schema])
        renamed = []
        for t in tables:
            t = self.fix_dtype_to_row_type(t, rel.schema)
            renamed.append(Table(dict(zip(names, t.columns.values())),
                                 t.num_rows, t.device))
        return concat_tables(renamed)


def _first_rows(table: Table) -> torch.Tensor:
    """Row indices of the first occurrence of each distinct row, in input
    order."""
    gid, _, num = factorize(key_arrays(
        [table.columns[n] for n in table.column_names]))
    return torch.sort(group_first_indices(gid, num)).values


@Executor.add_plugin_class
class DistinctPlugin(BaseRelPlugin):
    class_name = "Distinct"

    def convert(self, rel: p.Distinct, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        if inp.num_rows == 0:
            return inp
        return inp.take(_first_rows(inp))


def _intersect_except(rel, executor, plugin, anti: bool) -> Table:
    from ....ops.join import join_key_gids, semi_join_mask

    left, right = (plugin.fix_dtype_to_row_type(t, rel.schema)
                   for t in on_one_device([executor.execute(i)
                                           for i in rel.inputs()]))
    if left.num_rows == 0:
        return left
    lcols = [left.columns[n] for n in left.column_names]
    rcols = [right.columns[n] for n in right.column_names]
    # NULLs compare equal in set operations (IS NOT DISTINCT FROM)
    lgid, rgid = join_key_gids(lcols, rcols, null_equals_null=True)
    if rel.all:
        # multisets: INTERSECT ALL keeps min(count_l, count_r) copies of a
        # row, EXCEPT ALL max(count_l - count_r, 0); the joint ids are
        # dense, so counting needs no second factorization
        (num,) = host_ints(torch.cat([lgid, rgid]).max() + 1)
        cl = torch.bincount(lgid, minlength=num)
        cr = torch.bincount(rgid, minlength=num)
        keep = torch.clamp(cl - cr, min=0) if anti else torch.minimum(cl, cr)
        first = group_first_indices(lgid, num)
        present = torch.nonzero((keep > 0) & (first < left.num_rows)).flatten()
        reps = keep[present]
        (total,) = host_ints(reps.sum())
        return left.take(torch.repeat_interleave(first[present], reps,
                                                 output_size=total))
    out = left.filter(semi_join_mask(lgid, rgid, anti=anti))
    if out.num_rows:
        out = out.take(_first_rows(out))
    return out


@Executor.add_plugin_class
class IntersectPlugin(BaseRelPlugin):
    class_name = "Intersect"

    def convert(self, rel, executor) -> Table:
        return _intersect_except(rel, executor, self, anti=False)


@Executor.add_plugin_class
class ExceptPlugin(BaseRelPlugin):
    class_name = "Except"

    def convert(self, rel, executor) -> Table:
        return _intersect_except(rel, executor, self, anti=True)


def _null_column(n: int, sql_type, device) -> Column:
    """`n` NULLs of `sql_type`."""
    if sql_type in STRING_TYPES:
        data = torch.zeros(n, dtype=torch.int32, device=device)
        dictionary = np.array([""], dtype=object)
    else:
        data = torch.zeros(n, dtype=torch_dtype(sql_to_np(sql_type)),
                           device=device)
        dictionary = None
    return Column(data, sql_type,
                  torch.zeros(n, dtype=torch.bool, device=device), dictionary)


def _value_column(expr, executor, one_row: Table) -> Column:
    """One VALUES cell as a one-row column: a NULL (or a cast of one) of
    its field's type, anything else through the evaluator."""
    lit = expr.arg if isinstance(expr, Cast) else expr
    if isinstance(lit, Literal) and lit.value is None:
        return _null_column(1, expr.sql_type, one_row.device)
    return executor.eval_expr(expr, one_row)


@Executor.add_plugin_class
class ValuesPlugin(BaseRelPlugin):
    class_name = "Values"

    def convert(self, rel: p.Values, executor) -> Table:
        device = executor.context.device
        names = unique_names([f.name for f in rel.schema])
        one_row = Table({}, 1, device)
        cols = {}
        for j, (name, f) in enumerate(zip(names, rel.schema)):
            vals = [_value_column(row[j], executor, one_row)
                    for row in rel.rows]
            col = concat_columns(vals) if vals else _null_column(
                0, f.sql_type, device)
            cols[name] = col.cast(f.sql_type) if col.sql_type != f.sql_type \
                else col
        return Table(cols, len(rel.rows), device)


@Executor.add_plugin_class
class EmptyRelationPlugin(BaseRelPlugin):
    """SELECT without FROM: one row (or none) of NULLs under the plan's
    fields."""

    class_name = "EmptyRelation"

    def convert(self, rel: p.EmptyRelation, executor) -> Table:
        device = executor.context.device
        n = 1 if rel.produce_one_row else 0
        names = unique_names([f.name for f in rel.schema])
        cols = {name: _null_column(n, f.sql_type, device)
                for name, f in zip(names, rel.schema)}
        return Table(cols, n, device)


#: blocks TABLESAMPLE SYSTEM keeps or drops whole (the reference's count)
SAMPLE_BLOCKS = 16


@Executor.add_plugin_class
class SamplePlugin(BaseRelPlugin):
    """TABLESAMPLE BERNOULLI keeps each row with the fraction's
    probability; SYSTEM keeps or drops whole blocks of rows, one of
    `SAMPLE_BLOCKS` consecutive blocks each.  The draws come from a
    `torch.Generator` on the host seeded with REPEATABLE's seed, so a seed
    repeats its rows on every device."""

    class_name = "Sample"

    def convert(self, rel: p.Sample, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        frac = rel.fraction / 100.0
        seed = rel.seed if rel.seed is not None \
            else int(np.random.randint(0, 2 ** 31 - 1))
        gen = torch.Generator().manual_seed(int(seed))
        n = inp.num_rows
        if rel.method == "SYSTEM":
            chosen = torch.rand(SAMPLE_BLOCKS, generator=gen) < frac
            bounds = torch.linspace(0, n, SAMPLE_BLOCKS + 1,
                                    dtype=torch.float64).to(torch.int64)
            block = torch.searchsorted(bounds[1:], torch.arange(n), right=True)
            mask = chosen[torch.clamp(block, 0, SAMPLE_BLOCKS - 1)]
        else:
            mask = torch.rand(n, generator=gen) < frac
        return inp.filter(mask.to(inp.device))


@Executor.add_plugin_class
class DistributeByPlugin(BaseRelPlugin):
    """DISTRIBUTE BY on one device: the rows clustered by key (the order a
    hash re-shard gives each shard), equal keys together."""

    class_name = "DistributeBy"

    def convert(self, rel: p.DistributeBy, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        cols = [executor.eval_expr(k, inp) for k in rel.keys]
        if inp.num_rows == 0:
            return inp
        _, order, _ = factorize(key_arrays(cols))
        return inp.take(order)


@Executor.add_plugin_class
class ExplainPlugin(BaseRelPlugin):
    """EXPLAIN: the plan's text, one row a line, as the reference's.
    EXPLAIN LINT gives the plan verifier's findings (`analysis/verifier.py`,
    errors and doomed-rung warnings first, then the advisories) and EXPLAIN
    ESTIMATE the estimator's intervals (`analysis/estimator.py`) with the
    budget proofs execution would act on; neither runs its input.  EXPLAIN
    ANALYZE runs its input under the per-node tracer (`tracing.py`; on the
    card each node waits for its device work) and prints the node tree
    under the query's lifecycle stages so far (`observability/spans.py`;
    the ``execute`` stage is still open while it renders); with FORMAT
    JSON it gives the lifecycle trace as Chrome-trace JSON."""

    class_name = "Explain"

    def convert(self, rel: p.Explain, executor) -> Table:
        metrics = executor.context.metrics
        if getattr(rel, "lint", False):
            from ....analysis import verify_plan

            verdict = verify_plan(rel.input, context=executor.context,
                                  collect_info=True)
            metrics.inc("analysis.explain_lint")
            rows = verdict.format_rows()
        elif getattr(rel, "estimate", False):
            from ....analysis import estimator

            est = estimator.estimate_plan(rel.input, context=executor.context)
            # reported, not applied: the proofs execution would act on
            est.rung_proofs = estimator.collect_rung_proofs(
                est, estimator.device_budget_bytes(executor.config))
            metrics.inc("analysis.explain_estimate")
            rows = est.format_rows()
        elif rel.analyze:
            import json

            from ....observability import QueryTrace, current_trace
            from ...executor import Executor

            traced = Executor(executor.context, trace=True)
            traced.execute(rel.input)
            root = traced.tracer.root
            tr = current_trace()
            if tr is not None and root is not None:
                tr.attach_node_tree(root)
            if getattr(rel, "fmt_json", False):
                if tr is None:
                    # tracing off: the node tree alone, still a loadable
                    # Chrome trace
                    tr = QueryTrace(sql="EXPLAIN ANALYZE")
                    tr.attach_node_tree(root)
                rows = [json.dumps(tr.to_chrome_trace())]
            else:
                rows = []
                if tr is not None:
                    rows.extend(tr.format_lines())
                    rows.append("")
                rows.extend((root.format() if root else "").split("\n"))
        else:
            rows = rel.input.explain().split("\n")
        lines = np.array(rows, dtype=object)
        col = rel.schema[0].name if rel.schema else "PLAN"
        return Table({col: Column.from_numpy(
            lines, device=executor.context.device, encode=False)},
            len(lines), executor.context.device)
