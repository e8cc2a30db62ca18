"""Join converters: INNER equijoins (with a residual filter) and cross joins.

Counterpart of `JoinPlugin` and `CrossJoinPlugin` in
`dask_sql_tpu/physical/rel/logical/join.py`, on one device: the keys become
comparable ids (`ops.join.join_key_gids`), the pairs come from a lookup
table or a sorted probe (`ops.join.inner_join_indices`), and the combined
table is gathered through them.  The other join types raise
NotImplementedError naming the type.
"""
from __future__ import annotations

import torch

from ....columnar.table import Table
from ....ops import join as join_ops
from ....planner import plan as p
from ....planner.expressions import shift_columns
from ...executor import Executor
from ..base import BaseRelPlugin, unique_names


def _materialize(left: Table, right: Table, li, ri,
                 l_may_pad=None, r_may_pad=None) -> Table:
    """The combined table gathered from index pairs; -1 gives NULL."""
    names = unique_names(list(left.column_names) + list(right.column_names))
    cols = {}
    for name, src in zip(names[: len(left.column_names)], left.column_names):
        cols[name] = join_ops.take_with_nulls(left.columns[src], li, l_may_pad)
    for name, src in zip(names[len(left.column_names):], right.column_names):
        cols[name] = join_ops.take_with_nulls(right.columns[src], ri, r_may_pad)
    return Table(cols, int(li.shape[0]), left.device)


@Executor.add_plugin_class
class JoinPlugin(BaseRelPlugin):
    class_name = "Join"

    def convert(self, rel: p.Join, executor) -> Table:
        if rel.join_type != "INNER":
            raise NotImplementedError(
                f"join type {rel.join_type} is not in the port yet")
        left, right = self.assert_inputs(rel, 2, executor)
        # an aggregate's group table lives on the host: it joins on the
        # device of the other side
        if left.device.type == "cpu":
            left = left.to(right.device)
        right = right.to(left.device)
        nleft = len(rel.left.schema)
        if rel.on:
            lkeys = [executor.eval_expr(lk, left) for lk, _ in rel.on]
            rkeys = [executor.eval_expr(shift_columns(rk, -nleft), right)
                     for _, rk in rel.on]
            lgid, rgid = join_ops.join_key_gids(lkeys, rkeys)
        else:
            # no equi keys: every row matches every row (filtered below)
            lgid = torch.zeros(left.num_rows, dtype=torch.int64, device=left.device)
            rgid = torch.zeros(right.num_rows, dtype=torch.int64, device=right.device)
        # probe from the bigger side so the build runs on the smaller one
        if right.num_rows <= left.num_rows:
            li, ri = join_ops.inner_join_indices(lgid, rgid)
        else:
            ri, li = join_ops.inner_join_indices(rgid, lgid)
        combined = _materialize(left, right, li, ri, False, False)
        if rel.filter is not None:
            cond = executor.eval_expr(rel.filter, combined)
            combined = combined.filter(cond.data & cond.valid_mask())
        return self.fix_column_to_row_type(combined, rel.schema)


@Executor.add_plugin_class
class CrossJoinPlugin(BaseRelPlugin):
    class_name = "CrossJoin"

    def convert(self, rel: p.CrossJoin, executor) -> Table:
        left, right = self.assert_inputs(rel, 2, executor)
        nl, nr = left.num_rows, right.num_rows
        li = torch.arange(nl, dtype=torch.int64, device=left.device).repeat_interleave(nr)
        ri = torch.arange(nr, dtype=torch.int64, device=right.device).repeat(nl)
        return self.fix_column_to_row_type(
            _materialize(left, right, li, ri, False, False), rel.schema)
