"""spmd_aggregate: the sharded compiled scan->aggregate rung.

Counterpart of `dask_sql_tpu/spmd/aggregate.py`.  `SpmdAggregate` is the
fused `CompiledAggregate` run once a shard over that shard's row block:
the same masks, the same radix group ids (the plan is made on the whole
table, so every shard shares its domain), the same registrations.  Each
shard finishes its reductions alone (one `ops.segsum.segsum_typed` call a
shard: the hand-written kernel on the card), and the shards' raw states
then combine in shard order on the first shard's device: sums and counts
add in float64 (integer sums in int64), minima and maxima reduce.  The
shared finalize and the one packed transfer follow, as on one device.

The reference pins the scatter mode and psums its raw states.  Here each
shard's kernel call is the divergence that the streamed partitions
already take (ROADMAP.md, "Incremental and streamed sums"): integers,
counts, MIN and MAX are exact; float sums are held to the float64 oracle,
and repeated runs give the same bits.  The family batcher's stacked call
runs a shard at a time too (`run_batched`), each member bit-equal to its
solo run.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.table import Table
from ..parallel import collectives as cx
from ..parallel.mesh import mesh_key
from ..physical.compiled import (
    CompiledAggregate,
    SegmentReducer,
    _TableMeta,
    _TraceEval,
    _Unsupported,
    _extract_chain,
    defer_rebuild,
    fetch_packed,
    remember_family,
    singleflight_get_or_build,
)
from ..planner import plan as p
from .core import mesh_of_sharded_table, rung_enabled, shard_blocks

logger = logging.getLogger(__name__)


class ShardReducer(SegmentReducer):
    """One shard's SegmentReducer: every state it finishes alone (a scatter
    sum, a minimum, a maximum) is recorded, in registration order, with
    how the shards' copies combine."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.states: List[Tuple[torch.Tensor, str]] = []
        self._index: Dict[int, int] = {}

    def _record(self, t: torch.Tensor, how: str) -> torch.Tensor:
        self._index[id(t)] = len(self.states)
        self.states.append((t, how))
        return t

    def _scatter(self, x):
        return self._record(super()._scatter(x), "sum")

    def _reduce(self, contrib, how):
        return self._record(super()._reduce(contrib, how), how)

    def finish(self):
        if self.n_rows == 0 and self._columns:
            # an empty block adds nothing: no launch over zero rows
            self._out = torch.zeros((self.domain, len(self._columns)),
                                    dtype=torch.float64,
                                    device=self.gid.device)
            return
        super().finish()


def finish_shard(reducers: List[ShardReducer]) -> None:
    """Finish one shard's reducers: alone, or the members of a stacked
    family run in one call."""
    if len(reducers) == 1 or reducers[0].n_rows == 0:
        for r in reducers:
            r.finish()
    else:
        SegmentReducer.finish_stacked(reducers)


class MeshReducer:
    """The shards' reducers combined: the `get` view the shared assembly
    reads.  Typed-column sums (the kernel's float64 output) and recorded
    sums add in shard order; minima and maxima reduce."""

    def __init__(self, shards: List[ShardReducer]):
        first = shards[0]
        for s in shards[1:]:
            if len(s.states) != len(first.states) or \
                    len(s._columns) != len(first._columns):
                raise _Unsupported("shards registered different reductions")
        self._index = first._index
        combine = {"sum": cx.psum, "amin": cx.pmin, "amax": cx.pmax}
        self.states = [combine[how]([s.states[k][0] for s in shards])
                       for k, (_, how) in enumerate(first.states)]
        self._out = None if first._out is None else \
            cx.psum([s._out for s in shards])

    def get(self, h):
        if h[0] == "done":
            return self.states[self._index[id(h[1])]]
        return self._out[:, h[1]]


class SpmdAggregate(CompiledAggregate):
    """CompiledAggregate over a sharded table: the same pipeline a shard,
    the raw states combined across the shards before the shared
    finalize."""

    def __init__(self, mesh, agg: p.Aggregate, table: Table, filters,
                 group_exprs, agg_exprs, config):
        self.mesh = mesh
        super().__init__(agg, table, filters, group_exprs, agg_exprs, config)
        self._evs: Dict[torch.device, _TraceEval] = {
            self._ev.device: self._ev}

    def _ev_for(self, device) -> _TraceEval:
        ev = self._evs.get(device)
        if ev is None:
            meta = self._ev.table
            ev = self._evs[device] = _TraceEval(_TableMeta(
                device=device, names=meta.column_names,
                columns=[meta.columns[n] for n in meta.column_names]))
        return ev

    def _shard_runs(self, block: Table, params_list: List[Tuple]):
        """One shard's registrations for each member, finished: a list of
        (reducer, hit handle, plans)."""
        ev = self._ev_for(block.device)
        memo: Optional[Dict] = {} if len(params_list) > 1 else None
        gid = None
        runs = []
        for params in params_list:
            slots = self._slots(block, params, memo)
            sel = self._selection(ev, slots, block)
            if gid is None:
                gid = self._gid(slots, block)
            red = ShardReducer(gid, self.domain, self.segsum_mode,
                               block.num_rows,
                               segments=runs[0][0]._segments if runs else None)
            hit_h, plans = self._register(ev, slots, sel, red)
            runs.append((red, hit_h, plans))
        finish_shard([r[0] for r in runs])
        return runs

    def _combined(self, table: Table, params_list: List[Tuple]):
        """Per member: (combined reducer, hit handle, plans) over every
        shard."""
        per_shard = [self._shard_runs(b, params_list)
                     for b in shard_blocks(table)]
        out = []
        for m in range(len(params_list)):
            first = per_shard[0][m]
            out.append((MeshReducer([s[m][0] for s in per_shard]),
                        first[1], first[2]))
        return out

    def run(self, table: Table, params: Tuple = ()) -> Table:
        ((reducer, hit_h, plans),) = self._combined(table, [params])
        tags: List[Tuple[str, np.dtype]] = []
        packed = self._packed(hit_h, plans, reducer, tags)
        host, present = fetch_packed(packed, self.domain)
        return self._decode(host, present, tags)

    def run_batched(self, table: Table,
                    params_list: List[Tuple]) -> List[Table]:
        """Several members of this family over one sharded scan: a shard at
        a time, the members' columns in one stacked call; one transfer of
        every member's packed matrix."""
        from ..utils import count_d2h

        tags: List[Tuple[str, np.dtype]] = []
        packed = torch.stack([self._packed(hit_h, plans, reducer, tags)
                              for reducer, hit_h, plans
                              in self._combined(table, params_list)])
        count_d2h()
        # dsql: allow-host-sync — the stacked packed transfer, one pull
        host_all = packed.cpu().numpy()
        out = []
        for host in host_all:
            present = np.nonzero(host[0] != 0.0)[0]
            out.append(self._decode(host[:, present], present, tags))
        return out


#: LRU of sharded aggregate pipelines, keyed like the one-device cache plus
#: the mesh, evicted with their Context (`compiled.pipeline_owner`)
_CACHE_CAP = 16
_cache: "OrderedDict[Tuple, SpmdAggregate]" = OrderedDict()


def try_spmd_aggregate(rel: p.Aggregate, executor) -> Optional[Table]:
    """The sharded rung for an Aggregate over a scan chain; None steps down
    the ladder (the one-device compiled rungs, then the collectives
    engine)."""
    if not executor.config.get("sql.compile", True):
        return None
    if not rung_enabled(executor.config, "spmd_aggregate"):
        return None
    chain = _extract_chain(rel)
    if chain is None:
        return None
    scan, filters, group_exprs, agg_exprs = chain
    ctx = executor.context
    compiled = None
    try:
        from ..datacontainer import LazyParquetContainer

        dc = ctx.schema[scan.schema_name].tables.get(scan.table_name)
        if dc is None or isinstance(dc, LazyParquetContainer):
            return None
        table = executor.get_table(scan.schema_name, scan.table_name)
        if scan.projection is not None:
            table = table.select(scan.projection)
        mesh = mesh_of_sharded_table(table)
        if mesh is None:
            return None
        from .. import families

        pz = families.pipeline_parameterizer(executor.config)
        filters = [pz.rewrite(f) for f in filters]
        agg_exprs = [pz.rewrite_agg(a) for a in agg_exprs]
        params = pz.params
        key = (
            "spmd_aggregate",
            mesh_key(mesh),
            dc.uid, ctx.table_epoch(scan.schema_name, scan.table_name),
            scan.schema_name, scan.table_name,
            tuple(scan.projection or ()),
            tuple(str(f) for f in filters),
            tuple(str(e) for e in group_exprs),
            tuple(str(a) for a in agg_exprs),
            tuple((f.name, f.sql_type) for f in rel.schema),
            table.num_rows,
            str(executor.config.get("sql.compile.segsum", "auto")),
        )
        # the family drops the table identity and its rows
        family = key[:2] + key[4:11] + key[12:]
        bucket = (key[2], key[3], key[11])

        def build():
            return SpmdAggregate(mesh, rel, table, filters, group_exprs,
                                 agg_exprs, executor.config)

        def build_and_warm():
            obj = build()
            obj.run(table, params)
            return obj

        from ..physical.compiled import _cache_lock, pipeline_owner

        with _cache_lock:
            cached = ((pipeline_owner(ctx),) + key) in _cache
        if not cached and defer_rebuild(ctx, "spmd_aggregate", _cache,
                                        _CACHE_CAP, key, family, bucket,
                                        build_and_warm):
            return None  # served on a lower rung while the rebuild runs
        compiled, built_here = singleflight_get_or_build(
            _cache, key, build, "spmd_aggregate", ctx, _CACHE_CAP)
        if built_here:
            remember_family(ctx, family, bucket)
        if not built_here and params:
            ctx.metrics.inc("families.hit")
            from ..observability import trace_event

            trace_event("family_hit", rung="spmd_aggregate",
                        params=len(params))
        ctx.metrics.inc("parallel.spmd.launches")
        ctx.metrics.inc("parallel.spmd.rows", table.num_rows)
        from ..resilience import faults

        faults.maybe_inject("oom", executor.config)
        batcher = families.batcher_of(ctx)
        if batcher is not None and params and compiled.batchable:
            pipeline = compiled
            result = batcher.run(
                key, params,
                solo=lambda: pipeline.run(table, params),
                batched=lambda members: pipeline.run_batched(table, members))
        else:
            result = compiled.run(table, params)
        if compiled.has_encoded:
            ctx.metrics.inc("columnar.encoding.late_rows", result.num_rows)
        return result
    except _Unsupported as e:
        logger.debug("spmd aggregate unsupported: %s", e)
        from ..physical.compiled import evict

        evict(_cache, compiled)
        return None
    except (ValueError, TypeError, NotImplementedError) as e:
        # a shape the sharded run mishandles never sinks the query: the
        # one-device rungs below are always correct
        logger.debug("spmd aggregate declined: %s", e)
        return None
