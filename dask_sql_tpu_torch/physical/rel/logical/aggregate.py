"""Aggregate converter (counterpart of `AggregatePlugin` in
`dask_sql_tpu/physical/rel/logical/aggregate.py`).

An aggregate over a lazy parquet table larger than
``sql.streaming.batch_rows`` streams it in batches first
(`physical/streaming.py`); that is not a rung of the ladder, and a failure
there raises.  Then the rungs of the degradation ladder in the reference's
order: the streamed aggregate of a plan the admission gate
routed to partitions (`streaming/aggregate.py`); over a sharded scan the
sharded rungs (`spmd/`: the join->aggregate pipeline, then the scan-chain
aggregate, each with the ``spmd`` fault site at its entry); then, each
with the ``compile`` fault site at its entry, the join->aggregate
pipeline, the fused scan-chain aggregate; over a sharded input the
collectives engine (`parallel/dist_plan.py`, the ``dist_aggregate`` rung);
then the eager aggregate here, over the global rows.  The eager rung runs its input through the
other plugins and groups it: a mixed radix of small-domain keys
(`ops.grouping.radix_gid`, no sort; the present groups compacted at the
end), or one lexicographic sort (`factorize`) with each group's first row
giving its keys; no GROUP BY gives one row.  Every aggregate is then a
masked segment reduction (`ops.grouping.seg_*`): float sums and counts
through the segment sum under the compiled pipelines' policy (the
hand-written kernel on the card where the group domain fits it).
"""
from __future__ import annotations

from typing import Dict

import torch

from ....columnar.column import Column, torch_dtype
from ....columnar.dtypes import SqlType, sql_to_np
from ....columnar.table import Table
from ....ops import grouping as g
from ....planner import plan as p
from ....planner.expressions import AggExpr, Literal
from ....resilience import ladder
from ...compiled import try_compiled_aggregate
from ...compiled_join import try_compiled_join_aggregate
from ...executor import Executor
from ...streaming import try_streaming_aggregate
from ....parallel.dist_plan import (
    plan_has_sharded_scan,
    table_is_sharded,
    try_dist_aggregate,
)
from ..base import BaseRelPlugin, gather_global, unique_names


@Executor.add_plugin_class
class AggregatePlugin(BaseRelPlugin):
    class_name = "Aggregate"

    def convert(self, rel: p.Aggregate, executor) -> Table:
        def rung(name, fn):
            return ladder.attempt(executor, name, fn, rel=rel,
                                  inject_site="compile")

        streamed = try_streaming_aggregate(rel, executor)
        if streamed is not None:
            return streamed
        if id(rel) in executor.stream_decisions:
            # a plan the admission gate routed to partitions (streaming/):
            # its own (family, rung) breaker entity above the single runs
            from ....streaming import try_streamed_aggregate

            streamed = ladder.attempt(
                executor, "streamed_aggregate",
                lambda: try_streamed_aggregate(rel, executor), rel=rel)
            if streamed is not None:
                return streamed
        if plan_has_sharded_scan(rel.input, executor.context):
            # the sharded rungs that take the plan's shape first, each its
            # own (family, rung) breaker entity with the ``spmd`` fault
            # site at its entry, then the
            # one-device compiled rungs over the global columns, then the
            # collectives engine over the sharded input
            from ....spmd import spmd_rungs_for

            for name, fn in spmd_rungs_for(rel):
                out = ladder.attempt(executor, name,
                                     lambda fn=fn: fn(rel, executor),
                                     rel=rel, inject_site="spmd")
                if out is not None:
                    return out
        joined = rung("compiled_join_aggregate",
                      lambda: try_compiled_join_aggregate(rel, executor))
        if joined is not None:
            return joined
        compiled = rung("compiled_aggregate",
                        lambda: try_compiled_aggregate(rel, executor))
        if compiled is not None:
            return compiled
        (inp,) = self.assert_inputs(rel, 1, executor, keep_shards=True)
        if table_is_sharded(inp):
            # a capacity ladder topping out inside the engine steps down
            # to the one-device aggregate below
            dist = ladder.attempt(
                executor, "dist_aggregate",
                lambda: try_dist_aggregate(rel, executor, inp), rel=rel)
            if dist is not None:
                return dist
        inp = gather_global(inp, executor)
        n = inp.num_rows
        device = inp.device

        group_cols = [executor.eval_expr(e, inp) for e in rel.group_exprs]
        names = unique_names([f.name for f in rel.schema])
        gid, num_groups, mode, keys, present = g.group_rows(
            group_cols, n, device, executor.config)
        out: Dict[str, Column] = dict(zip(names, keys))
        for name, agg in zip(names[len(group_cols):], rel.agg_exprs):
            col = self._compute_agg(agg, inp, gid, num_groups, mode, executor)
            if present is not None:
                col = col.take(present)
            out[name] = col
        nrows = int(present.shape[0]) if present is not None else num_groups
        return Table(out, nrows, device)

    # ------------------------------------------------------------------
    def _compute_agg(self, agg: AggExpr, inp: Table, gid, num_groups: int,
                     mode: str, executor) -> Column:
        n = inp.num_rows
        func = agg.func
        device = inp.device

        # FILTER (WHERE ...) restricts the contributing rows
        fmask = None
        if agg.filter is not None:
            fc = executor.eval_expr(agg.filter, inp)
            fmask = fc.data & fc.valid_mask()

        if func == "count_star":
            valid = torch.ones(n, dtype=torch.bool, device=device) \
                if fmask is None else fmask
            if agg.distinct:
                # COUNT(DISTINCT *) over all columns
                cols = [inp.columns[c] for c in inp.column_names]
                return self._count_distinct(cols, valid, gid, num_groups, mode)
            return Column(g.seg_count(valid, gid, num_groups, mode),
                          SqlType.BIGINT)

        if func.startswith("udaf:"):
            return self._udaf(func[5:], agg, inp, gid, num_groups, executor,
                              fmask)

        args = [executor.eval_expr(a, inp) for a in agg.args]
        col = args[0] if args else None
        if col is not None and col.dictionary is not None:
            # a sorted dictionary: min/max over codes is string min/max
            col = col.compact_dictionary()
        valid = col.valid_mask() if col is not None else torch.ones(
            n, dtype=torch.bool, device=device)
        if fmask is not None:
            valid = valid & fmask
        if col is not None and col.sql_type in (SqlType.FLOAT, SqlType.DOUBLE,
                                                SqlType.DECIMAL):
            valid = valid & ~torch.isnan(col.data)

        if agg.distinct and func not in ("min", "max"):
            # one row per (group, value) pair before reducing
            valid = valid & _first_of_pairs([col], gid)

        values = col.data if col is not None else None

        if func == "count":
            return Column(g.seg_count(valid, gid, num_groups, mode),
                          SqlType.BIGINT)
        if func == "sum":
            vals, ok = g.seg_sum(values, valid, gid, num_groups, mode)
            return _mk(vals, ok, agg.sql_type)
        if func in ("min", "max"):
            fn = g.seg_min if func == "min" else g.seg_max
            vals, ok = fn(values, valid, gid, num_groups, mode)
            return _mk_like(vals, ok, col, agg.sql_type)
        if func == "avg":
            vals, ok = g.seg_avg(values, valid, gid, num_groups, mode)
            return _mk(vals, ok, SqlType.DOUBLE)
        if func in ("var_samp", "var_pop", "stddev_samp", "stddev_pop"):
            ddof = 1 if func.endswith("samp") else 0
            vals, ok = g.seg_var(values, valid, gid, num_groups, ddof, mode)
            if func.startswith("stddev"):
                vals = torch.sqrt(vals)
            return _mk(vals, ok, SqlType.DOUBLE)
        if func in ("every", "bool_or"):
            fn = g.seg_bool_and if func == "every" else g.seg_bool_or
            vals, ok = fn(values, valid, gid, num_groups, mode)
            return _mk(vals, ok, SqlType.BOOLEAN)
        if func in ("bit_and", "bit_or", "bit_xor"):
            vals, ok = g.seg_bitwise(values, valid, gid, num_groups, func, mode)
            return _mk_like(vals.to(col.data.dtype), ok, col, agg.sql_type)
        if func in ("single_value", "first_value", "last_value"):
            fn = g.seg_last if func == "last_value" else g.seg_first
            vals, ok = fn(values, valid, gid, num_groups, mode)
            return _mk_like(vals, ok, col, agg.sql_type)
        if func == "percentile":
            # MEDIAN(x), APPROX_PERCENTILE(x, q), PERCENTILE_CONT(q) WITHIN
            # GROUP: the fraction is the second argument's first value
            q = 0.5
            if len(args) > 1:
                if isinstance(agg.args[1], Literal):
                    q = float(agg.args[1].value)
                elif n:
                    from ....utils import count_d2h

                    count_d2h()
                    q = float(args[1].data.reshape(-1)[0].cpu())
            vals, ok = g.seg_percentile(values, valid, gid, num_groups, q,
                                        mode)
            return _mk(vals, ok, SqlType.DOUBLE)
        if func == "approx_count_distinct":
            return self._count_distinct([col], valid, gid, num_groups, mode)
        if func == "regr_count":
            y, x = args
            both = valid & x.valid_mask()
            return Column(g.seg_count(both, gid, num_groups, mode),
                          SqlType.BIGINT)
        if func in ("regr_syy", "regr_sxx"):
            y, x = args
            both = y.valid_mask() & x.valid_mask()
            if fmask is not None:
                both = both & fmask
            target = y if func == "regr_syy" else x
            vals, ok = g.seg_var(target.data, both, gid, num_groups, 0, mode)
            cnt = g.seg_count(both, gid, num_groups, mode)
            return _mk(vals * cnt, ok, SqlType.DOUBLE)
        raise NotImplementedError(f"aggregate {func}")

    def _udaf(self, name: str, agg: AggExpr, inp: Table, gid, num_groups,
              executor, fmask) -> Column:
        """A registered aggregation: the function takes a pandas GroupBy of
        its argument on the host and gives one value a group, as the
        reference defines it.  Only the argument column, the group ids and
        the FILTER mask move to the host; the result moves back to the
        input's device."""
        import numpy as np
        import pandas as pd

        from ....utils import count_d2h

        fd = executor.lookup_function(name, [a.sql_type for a in agg.args])
        col = executor.eval_expr(agg.args[0], inp)
        on_card = col.device.type != "cpu"
        ser = pd.Series(col.to_numpy())
        if on_card:
            count_d2h()
        gids = gid.cpu().numpy()
        if fmask is not None:
            if on_card:
                count_d2h()
            keep = fmask.cpu().numpy()
            ser = ser[keep]
            gids = gids[keep]
        result = fd.func(ser.groupby(gids))
        out = np.full(num_groups, np.nan)
        out[np.asarray(result.index, dtype=int)] = result.to_numpy()
        res = Column.from_numpy(out, device=inp.device, encode=False)
        return res.cast(fd.return_type)

    def _count_distinct(self, cols, valid, gid, num_groups, mode) -> Column:
        keep = _first_of_pairs(cols, gid)
        allv = torch.ones_like(valid)
        for c in cols:
            allv = allv & c.valid_mask()
        cnt = g.seg_count(keep & valid & allv, gid, num_groups, mode)
        return Column(cnt, SqlType.BIGINT)


def _first_of_pairs(cols, gid) -> torch.Tensor:
    """Rows that are the first of their (group, values of `cols`) pair: the
    DISTINCT dedup before a reduction."""
    n = int(gid.shape[0])
    keep = torch.zeros(n, dtype=torch.bool, device=gid.device)
    if n:
        pair_gid, _, pair_num = g.factorize([gid] + g.key_arrays(cols))
        keep[g.group_first_indices(pair_gid, pair_num)] = True
    return keep


def _mk(vals, ok, sql_type: SqlType) -> Column:
    """An aggregate's result column in `sql_type`'s dtype, NULL where `ok`
    is false.  The validity stays a device mask even when every group is
    valid: testing that would cost a transfer, and an all-true mask reads
    as no NULL everywhere."""
    target = torch_dtype(sql_to_np(sql_type))
    return Column(vals.to(target), sql_type, ok)


def _mk_like(vals, ok, src: Column, sql_type: SqlType) -> Column:
    """A result that keeps the source column's string dictionary (min and
    max of strings, first/last values)."""
    return Column(vals, sql_type, ok, src.dictionary)

