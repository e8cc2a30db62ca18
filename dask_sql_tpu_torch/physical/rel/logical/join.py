"""Join converters: every join type, and cross joins.

Counterpart of `JoinPlugin` and `CrossJoinPlugin` in
`dask_sql_tpu/physical/rel/logical/join.py`: the keys become
comparable ids (`ops.join.join_key_gids`), the pairs or the per-row match
flags come from a lookup table or a sorted probe (`ops.join`), and the
combined table is gathered through them.  INNER, LEFT, RIGHT and FULL
joins (an ON residual applies to the matched pairs before the outer rows
pad), LEFTSEMI and LEFTANTI (with a residual: a match under it), the
null-aware anti join of ``NOT IN (subquery)`` (SQL's three-valued answer)
and LEFTMARK (the left rows with a matched flag, EXISTS under OR).  With
a sharded input the pairs come from the collectives engine
(`_maybe_dist_pairs`: `parallel/dist_plan.py`'s broadcast or hash-shuffle
matching) and an INNER join's rows stay sharded; without one, a sharded
input is read as its global rows.
"""
from __future__ import annotations

import torch

from ....columnar.column import Column
from ....columnar.dtypes import SqlType
from ....columnar.table import Table
from ....ops import join as join_ops
from ....planner import plan as p
from ....planner.expressions import shift_columns
from ....utils import host_ints
from ...executor import Executor
from ..base import BaseRelPlugin, gather_global, unique_names


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


def _none_of(n: int, device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.bool, device=device)


@Executor.add_plugin_class
class JoinPlugin(BaseRelPlugin):
    class_name = "Join"

    def convert(self, rel: p.Join, executor) -> Table:
        left, right = self.assert_inputs(rel, 2, executor, keep_shards=True)
        # an aggregate's group table lives on the host: it joins on the
        # device of the other side
        if left.device.type == "cpu":
            left = left.to(right.device)
        right = right.to(left.device)
        nleft = len(rel.left.schema)
        jt = rel.join_type
        if rel.on:
            lkeys = [executor.eval_expr(lk, left) for lk, _ in rel.on]
            rkeys = [executor.eval_expr(shift_columns(rk, -nleft), right)
                     for _, rk in rel.on]
            lgid, rgid = join_ops.join_key_gids(lkeys, rkeys)
        else:
            # no equi keys: every row matches every row (filtered below)
            lkeys = rkeys = []
            lgid = torch.zeros(left.num_rows, dtype=torch.int64, device=left.device)
            rgid = torch.zeros(right.num_rows, dtype=torch.int64, device=right.device)

        # a sharded input: the collectives engine's pairs (a hash shuffle,
        # or the small side broadcast to the big side's shards)
        dist = None
        if rel.on and not (jt == "LEFTANTI" and rel.null_aware):
            dist = self._maybe_dist_pairs(executor, left, right, lkeys,
                                          rkeys, lgid, rgid)
        if dist is not None:
            return self._from_dist_pairs(rel, executor, left, right, *dist)
        left = gather_global(left, executor)
        right = gather_global(right, executor)

        if jt == "LEFTANTI" and rel.null_aware:
            return self.fix_column_to_row_type(
                self._null_aware_anti(left, lkeys, rkeys, lgid, rgid,
                                      right.num_rows), rel.schema)

        if jt == "LEFTMARK":
            # the left rows pass through with a matched flag appended (the
            # decorrelation of EXISTS under OR)
            if rel.filter is None:
                mask = join_ops.semi_join_mask(lgid, rgid)
            else:
                li, ri = join_ops.inner_join_indices(lgid, rgid)
                mask = self._filtered_match_mask(rel, executor, left, right,
                                                 li, ri)
            return self.fix_column_to_row_type(
                self._append_mark(rel, left, mask), rel.schema)

        if jt in ("LEFTSEMI", "LEFTANTI"):
            if rel.filter is None:
                mask = join_ops.semi_join_mask(lgid, rgid,
                                               anti=(jt == "LEFTANTI"))
                return self.fix_column_to_row_type(left.filter(mask),
                                                   rel.schema)
            li, ri = join_ops.inner_join_indices(lgid, rgid)
            matched = self._filtered_match_mask(rel, executor, left, right,
                                                li, ri)
            if jt == "LEFTANTI":
                matched = ~matched
            return self.fix_column_to_row_type(left.filter(matched),
                                               rel.schema)

        if jt == "INNER":
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

        if jt in ("LEFT", "RIGHT", "FULL"):
            li, ri = join_ops.inner_join_indices(lgid, rgid)
            return self._outer_from_pairs(rel, executor, left, right, li, ri,
                                          jt)

        raise NotImplementedError(f"join type {jt}")

    @staticmethod
    def _maybe_dist_pairs(executor, left, right, lkeys, rkeys, lgid, rgid):
        """The matching pairs of a join with a sharded input, or None for
        the one-device path: (left row ids, right row ids, left matched
        flags, output block boundaries or None, mesh).  Honors
        ``sql.join.broadcast``: True broadcasts always, a number is a row
        threshold, None (auto) broadcasts a small side well under the big
        one; the big side never moves."""
        from ....parallel import dist_plan

        mesh = dist_plan.should_distribute(
            executor, "sql.distributed.join", left, right)
        if mesh is None:
            return None

        def valid_of(keys, n, device):
            v = torch.ones(n, dtype=torch.bool, device=device)
            for c in keys:
                if c.validity is not None:
                    v = v & c.valid_mask()
            return v

        def offsets_of(t):
            sh = t.sharding
            return sh.offsets if sh is not None and sh.mesh == mesh else None

        lvalid = valid_of(lkeys, left.num_rows, left.device)
        rvalid = valid_of(rkeys, right.num_rows, right.device)
        broadcast = executor.config.get("sql.join.broadcast", None)
        small = min(left.num_rows, right.num_rows)
        big = max(left.num_rows, right.num_rows)
        explicit = (broadcast is True
                    or (broadcast not in (None, False)
                        and small <= float(broadcast)))
        auto = broadcast is None and small <= 65536 and small * 4 <= big
        metrics = executor.context.metrics
        if explicit or auto:
            metrics.inc("parallel.dist.broadcast_join")
            if right.num_rows <= left.num_rows:
                li, ri, lmatch, blocks = dist_plan.broadcast_inner_pairs(
                    lgid, lvalid, rgid, rvalid, offsets_of(left))
                return li, ri, lmatch, blocks, mesh
            ri, li, _, blocks = dist_plan.broadcast_inner_pairs(
                rgid, rvalid, lgid, lvalid, offsets_of(right))
            lmatch = _none_of(left.num_rows, left.device)
            lmatch[li] = True
            return li, ri, lmatch, blocks, mesh
        metrics.inc("parallel.dist.join_kernel")
        li, ri, lmatch, blocks = dist_plan.dist_inner_pairs(
            mesh, lgid, lvalid, rgid, rvalid, offsets_of(left),
            offsets_of(right))
        return li, ri, lmatch, blocks, mesh

    def _from_dist_pairs(self, rel, executor, left, right, li, ri, lmatch,
                         blocks, mesh) -> Table:
        """A join's result from the engine's pairs.  An INNER join's rows
        stay sharded in the pairs' blocks; semi, anti and mark joins keep
        the left side's."""
        from ....parallel.mesh import RowBlocks

        jt = rel.join_type
        if jt in ("LEFTMARK", "LEFTSEMI", "LEFTANTI"):
            mask = lmatch if rel.filter is None else \
                self._filtered_match_mask(rel, executor, left, right, li, ri)
            if jt == "LEFTMARK":
                return self.fix_column_to_row_type(
                    self._append_mark(rel, left, mask), rel.schema)
            if jt == "LEFTANTI":
                mask = ~mask
            return self.fix_column_to_row_type(left.filter(mask), rel.schema)
        if jt == "INNER":
            combined = _materialize(left, right, li, ri, False, False)
            if blocks is not None:
                combined.sharding = RowBlocks(mesh, blocks)
            if rel.filter is not None:
                cond = executor.eval_expr(rel.filter, combined)
                combined = combined.filter(cond.data & cond.valid_mask())
            return self.fix_column_to_row_type(combined, rel.schema)
        if jt in ("LEFT", "RIGHT", "FULL"):
            return self._outer_from_pairs(
                rel, executor, left.unsharded(), right.unsharded(), li, ri,
                jt)
        raise NotImplementedError(f"join type {jt}")

    @staticmethod
    def _filtered_match_mask(rel, executor, left, right, li, ri):
        """Per left row: a match that the residual keeps (the semi, anti
        and mark joins with an ON residual)."""
        combined = _materialize(left, right, li, ri, False, False)
        cond = executor.eval_expr(rel.filter, combined)
        keep = cond.data & cond.valid_mask()
        hits = torch.zeros(left.num_rows, dtype=torch.int32,
                           device=left.device)
        if int(li.shape[0]):
            hits.index_add_(0, li, keep.to(torch.int32))
        return hits > 0

    @staticmethod
    def _append_mark(rel, left: Table, mask) -> Table:
        names = unique_names([f.name for f in rel.schema])
        cols = {n: left.columns[src]
                for n, src in zip(names[:-1], left.column_names)}
        cols[names[-1]] = Column(mask, SqlType.BOOLEAN)
        return Table(cols, left.num_rows, left.device, left.sharding)

    @staticmethod
    def _null_aware_anti(left: Table, lkeys, rkeys, lgid, rgid,
                         n_right: int) -> Table:
        """SQL's ``NOT IN (subquery)`` as one mask, three-valued over the
        build set S (per correlation group when correlated):
          S empty          -> every probe row passes, even a NULL argument;
          a NULL in S      -> no probe row of that group passes;
          a NULL argument  -> never passes against a non-empty S;
          else             -> passes when it has no match."""
        if len(lkeys) == 1:
            # uncorrelated: the set's emptiness and NULLs decide on the
            # host before any probe
            if n_right == 0:
                return left
            if rkeys[0].validity is not None:
                (all_valid,) = host_ints(rkeys[0].validity.all())
                if not all_valid:
                    return left.filter(_none_of(left.num_rows, left.device))
        arg_valid = lkeys[0].valid_mask()
        match = join_ops.semi_join_mask(lgid, rgid)
        if len(lkeys) == 1:
            return left.filter(arg_valid & ~match)
        # correlated: emptiness and NULLs are per correlation group
        cl, cr = join_ops.join_key_gids(lkeys[1:], rkeys[1:])
        empty_row = join_ops.semi_join_mask(cl, cr, anti=True)
        rnull = ~rkeys[0].valid_mask()
        has_null_row = join_ops.semi_join_mask(cl, cr[rnull])
        return left.filter(empty_row | (arg_valid & ~has_null_row & ~match))

    def _outer_from_pairs(self, rel, executor, left, right, li, ri,
                          jt) -> Table:
        """An outer join from the inner pairs: the residual applies to the
        matched pairs, then each outer row left without a match pads once
        (the pairs first, then the padded rows, in row order)."""
        if rel.filter is not None and int(li.shape[0]):
            combined = _materialize(left, right, li, ri, False, False)
            cond = executor.eval_expr(rel.filter, combined)
            keep = cond.data & cond.valid_mask()
            li, ri = li[keep], ri[keep]
        li2, ri2 = li, ri
        device = left.device
        if jt in ("LEFT", "FULL"):
            lm = _none_of(left.num_rows, device)
            lm[li] = True
            pad = torch.nonzero(~lm).flatten()
            li2 = torch.cat([li2, pad])
            ri2 = torch.cat([ri2, torch.full((pad.shape[0],), -1,
                                             dtype=torch.int64, device=device)])
        if jt in ("RIGHT", "FULL"):
            rm = _none_of(right.num_rows, device)
            rm[ri] = True
            pad = torch.nonzero(~rm).flatten()
            li2 = torch.cat([li2, torch.full((pad.shape[0],), -1,
                                             dtype=torch.int64, device=device)])
            ri2 = torch.cat([ri2, pad])
        # LEFT and FULL pad the right side, RIGHT and FULL the left
        combined = _materialize(left, right, li2, ri2,
                                jt in ("RIGHT", "FULL"), jt in ("LEFT", "FULL"))
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
