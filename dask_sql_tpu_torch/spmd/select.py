"""spmd_select: the sharded compiled rung of ROOT select chains.

Counterpart of `dask_sql_tpu/spmd/select.py`.  A ``scan -> filter* ->
project [limit]`` chain over a sharded table runs the `CompiledSelect`
programs a shard at a time:

1. the mask program a shard, over its block: a row mask and its survivor
   count; the shards' counts cross to the host in one transfer;
2. a gather a shard into one power-of-two bucket, sized by the largest
   shard's survivors, the buckets stacked into one packed matrix that
   crosses in the second transfer; each shard's real rows are sliced off
   and concatenated in shard order, which is global row order (the blocks
   are contiguous and each gather's ids ascend).

A LIMIT parked above the scan windows the GLOBAL survivor ordinal: each
shard's ordinal continues the counts of the shards before it.  An outer
LIMIT without ORDER BY takes a prefix across the shards in shard order.
The rung declines ORDER BY chains: the range-partition sort keeps its
result sharded in sort order.  As the port's one-device compiled select,
it leaves out the family batcher.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..columnar.table import Table
from ..parallel import collectives as cx
from ..parallel.mesh import mesh_key
from ..physical.compiled import _Unsupported, singleflight_get_or_build
from ..physical.compiled_select import CompiledSelect, _buffers, _extract
from ..utils import count_d2h, host_ints
from .core import mesh_of_sharded_table, rung_enabled, shard_blocks

logger = logging.getLogger(__name__)


class SpmdSelect(CompiledSelect):
    """CompiledSelect over a sharded table: both programs a shard, two
    transfers for the whole mesh."""

    def __init__(self, mesh, table, upper_filters, scan_filters, proj,
                 proj_exprs, sort_keys, sort_fetch, limit, inner_limit,
                 params=()):
        if sort_keys is not None:
            raise _Unsupported("spmd select keeps ORDER BY on dist_sort")
        super().__init__(table, upper_filters, scan_filters, proj,
                         proj_exprs, sort_keys, sort_fetch, limit,
                         inner_limit, params)
        self.mesh = mesh

    def run(self, table: Table, params: Tuple = ()) -> Table:
        blocks = shard_blocks(table)
        first = self.mesh.devices[0]
        # the inner window's ordinal carries from shard to shard
        carry = [torch.zeros((), dtype=torch.int64, device=first)] \
            if self.inner_limit is not None else None
        runs = []
        counts = []
        for b in blocks:
            datas, valids = _buffers(b)
            if carry is not None:
                carry[0] = carry[0].to(b.device)
            mask, ordinal = self._mask(datas, valids, params, carry)
            runs.append((datas, valids, mask, ordinal))
            counts.append(ordinal[-1:] if ordinal.shape[0] else
                          torch.zeros(1, dtype=torch.int64, device=b.device))
        # the shards' survivor counts: the first transfer
        counts_h = np.asarray(host_ints(*cx.all_gather(counts, first)
                                        .unbind(0)), dtype=np.int64)
        total = int(counts_h.sum())
        want = self._limit_trim(total)
        if want < total:
            # no ORDER BY: the window is a prefix across shards in order
            before = np.concatenate(([0], np.cumsum(counts_h)[:-1]))
            take = np.clip(want - before, 0, counts_h)
        else:
            take = counts_h
        count = int(take.sum())
        tags: List[Tuple[str, np.dtype]] = []
        if count == 0:
            cols, valid_arrs = self._decode_packed(None, 0, tags)
            return self._assemble(cols, valid_arrs, 0)
        bucket = 1 << (int(take.max()) - 1).bit_length()
        packs = []
        for (datas, valids, mask, ordinal), t in zip(runs, take):
            if t:
                packs.append(self._gather(datas, valids, mask, ordinal,
                                          bucket, params, tags))
        stacked = cx.all_gather([pk[None] for pk in packs], first)
        count_d2h()
        # dsql: allow-host-sync — the packed survivors, the second pull
        host_all = stacked.cpu().numpy()  # [shards with rows, R, bucket]
        host = np.concatenate([h[:, :int(t)] for h, t
                               in zip(host_all, [t for t in take if t])],
                              axis=1)
        cols, valid_arrs = self._decode_packed(host, count, tags)
        return self._assemble(cols, valid_arrs, count)


#: LRU of sharded root-select pipelines, evicted with their Context
_CACHE_CAP = 16
_cache: "OrderedDict[Tuple, SpmdSelect]" = OrderedDict()


def try_spmd_select(root, executor) -> Optional[Table]:
    """The sharded rung of a root select chain over a sharded scan; None
    steps down (the compiled select declines sharded tables, so the
    interpreted walk answers next)."""
    if not executor.config.get("sql.compile", True) \
            or not executor.config.get("sql.compile.select", True):
        return None
    if not rung_enabled(executor.config, "spmd_select"):
        return None
    got = _extract(root)
    if got is None:
        return None
    scan, upper_filters, proj, sort_keys, sort_fetch, limit, inner_limit = got
    if sort_keys is not None:
        return None  # ORDER BY keeps the range-partition sort's layout
    try:
        ctx = executor.context
        from ..datacontainer import LazyParquetContainer

        dc = ctx.schema[scan.schema_name].tables.get(scan.table_name)
        if dc is None or isinstance(dc, LazyParquetContainer):
            return None
        table = executor.get_table(scan.schema_name, scan.table_name)
        if scan.projection is not None:
            table = table.select(scan.projection)
        if not table.column_names or not table.num_rows:
            return None
        mesh = mesh_of_sharded_table(table)
        if mesh is None:
            return None
        from .. import families

        pz = families.pipeline_parameterizer(executor.config)
        p_upper = [pz.rewrite(f) for f in upper_filters]
        p_scan_flts = [pz.rewrite(f) for f in scan.filters]
        p_exprs = [pz.rewrite(e) for e in proj.exprs]
        params = pz.params
        key = (
            "spmd_select",
            mesh_key(mesh),
            dc.uid, ctx.table_epoch(scan.schema_name, scan.table_name),
            scan.schema_name, scan.table_name,
            tuple(scan.projection or ()),
            tuple(str(f) for f in p_upper),
            tuple(str(f) for f in p_scan_flts),
            tuple(str(e) for e in p_exprs),
            tuple((f.name, f.sql_type) for f in proj.schema),
            limit,
            inner_limit,
            table.num_rows,
        )

        def build():
            return SpmdSelect(mesh, table, p_upper, p_scan_flts, proj,
                              p_exprs, sort_keys, sort_fetch, limit,
                              inner_limit, params)

        compiled, built_here = singleflight_get_or_build(
            _cache, key, build, "spmd_select", ctx, _CACHE_CAP)
        if not built_here and params:
            ctx.metrics.inc("families.hit")
            from ..observability import trace_event

            trace_event("family_hit", rung="spmd_select", params=len(params))
        if built_here and compiled.codespace_preds:
            ctx.metrics.inc("columnar.encoding.codespace_pred",
                            compiled.codespace_preds)
        ctx.metrics.inc("parallel.spmd.launches")
        ctx.metrics.inc("parallel.spmd.rows", table.num_rows)
        from ..resilience import faults

        faults.maybe_inject("oom", executor.config)
        result = compiled.run(table, params)
        if compiled.has_encoded:
            ctx.metrics.inc("columnar.encoding.late_rows", result.num_rows)
        return result
    except _Unsupported as e:
        logger.debug("spmd select unsupported: %s", e)
        return None
    except (ValueError, TypeError, NotImplementedError) as e:
        logger.debug("spmd select declined: %s", e)
        return None
