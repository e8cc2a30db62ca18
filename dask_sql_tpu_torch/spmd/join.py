"""spmd_join_aggregate: the sharded compiled scan->joins->aggregate rung.

Counterpart of `dask_sql_tpu/spmd/join.py`.  The probe table stays
sharded; every build side is small (dimension tables after their filters)
and broadcasts: its lookup table and used columns replicate to each
shard's device (no copy where a shard names the build's device), and each
shard probes its own block with gathers.  The partial states then combine
across the shards as `spmd_aggregate`'s do (one segment-sum call a shard,
the float64 states added in shard order); the pipeline's body is the
one-device `CompiledJoinAggregate`'s, so join semantics, radix plans and
the finalize are shared.

A build side of more than ``parallel.spmd.broadcast_rows`` rows declines
the rung: the hash-shuffle engine (`parallel/dist_plan.py`,
``dist_inner_pairs``) answers big-big joins.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from ..columnar.table import Table
from ..parallel import dist_plan as _dp
from ..parallel.mesh import mesh_key
from ..physical.compiled import (
    _TableMeta,
    _TraceEval,
    _Unsupported,
    check_agg_static_support,
    singleflight_get_or_build,
)
from ..physical.compiled_join import (
    CompiledJoinAggregate,
    _extract,
    _plan_nodes,
)
from ..planner import plan as p
from .aggregate import MeshReducer, ShardReducer, finish_shard
from .core import mesh_of_sharded_table, rung_enabled, shard_blocks

logger = logging.getLogger(__name__)


class SpmdJoinAggregate(CompiledJoinAggregate):
    """CompiledJoinAggregate whose probe side is sharded and whose
    aggregation states combine across the shards."""

    def __init__(self, mesh, rel, ext, group_exprs, agg_exprs, probe_table,
                 build_tables, executor):
        self.mesh = mesh
        super().__init__(rel, ext, group_exprs, agg_exprs, probe_table,
                         build_tables, executor)
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

    def run(self, probe_table: Table, build_tables: List[Table],
            params: Tuple = ()) -> Table:
        """Tables are per-call arguments: the cached pipeline serves
        concurrent workers and keeps no table state."""
        _dp._stat("sharded_join_agg")
        shards = []
        builds_on: Dict[torch.device, List[Table]] = {}
        for block in shard_blocks(probe_table):
            dev = block.device
            if dev not in builds_on:
                # the broadcast: one copy of each build side a device
                builds_on[dev] = [bt.to(dev) for bt in build_tables]
            red, hit_h, plans = self._register_run(
                self._ev_for(dev), block, builds_on[dev], params,
                ShardReducer)
            finish_shard([red])
            shards.append((red, hit_h, plans))
        reducer = MeshReducer([s[0] for s in shards])
        first = self.mesh.devices[0]
        return self._finish_run(reducer, shards[0][1], shards[0][2],
                                builds_on.get(first, build_tables))


#: LRU of sharded join pipelines, evicted with their Context; declined
#: plan shapes, reset wholesale at a small cap (keys carry table uids)
_CACHE_CAP = 8
_cache: "OrderedDict[tuple, SpmdJoinAggregate]" = OrderedDict()
_DECLINED_CAP = 256
_declined: set = set()


def _remember_decline(key) -> None:
    if len(_declined) >= _DECLINED_CAP:
        _declined.clear()
    _declined.add(key)


def try_spmd_join_aggregate(rel: p.Aggregate, executor) -> Optional[Table]:
    """The sharded broadcast-join pipeline of an Aggregate over a join
    chain; None steps down to the one-device compiled rungs and the
    shuffle engine."""
    config = executor.config
    if not config.get("sql.compile", True) \
            or not config.get("sql.compile.join_pipeline", True):
        return None
    if not rung_enabled(config, "spmd_join_aggregate"):
        return None
    extraction = _extract(rel)
    if extraction is None:
        return None
    ext, group_exprs, agg_exprs = extraction
    decline_key = None
    try:
        from ..datacontainer import LazyParquetContainer

        ctx = executor.context
        dc = ctx.schema[ext.scan.schema_name].tables.get(ext.scan.table_name)
        if dc is None or isinstance(dc, LazyParquetContainer):
            return None
        uids = [(dc.uid, ctx.table_epoch(ext.scan.schema_name,
                                         ext.scan.table_name))]
        for j in ext.joins:
            for node in _plan_nodes(j["plan"]):
                if isinstance(node, p.TableScan):
                    bdc = ctx.schema[node.schema_name].tables.get(
                        node.table_name)
                    if bdc is None:
                        return None
                    uids.append((bdc.uid, ctx.table_epoch(node.schema_name,
                                                          node.table_name)))
        # the broadcast threshold is part of the decline's identity:
        # raising it re-opens a family declined for size
        limit = int(config.get("parallel.spmd.broadcast_rows", 1 << 20))
        decline_key = (tuple(uids), "spmd", limit, str(rel))
        if decline_key in _declined:
            return None
        probe_table = executor.get_table(ext.scan.schema_name,
                                         ext.scan.table_name)
        if ext.scan.projection is not None:
            probe_table = probe_table.select(ext.scan.projection)
        if not probe_table.column_names:
            return None
        mesh = mesh_of_sharded_table(probe_table)
        if mesh is None:
            return None
        check_agg_static_support(agg_exprs)
        from .. import families

        pz = families.pipeline_parameterizer(config)
        ext.conjuncts = [pz.rewrite(e) for e in ext.conjuncts]
        agg_exprs = [pz.rewrite_agg(a) for a in agg_exprs]
        params = pz.params
        # build sides run through the eager converters, then broadcast;
        # a big one declines to the shuffle engine (memoized, so a repeat
        # does not run the build subtrees again just to measure them)
        build_tables = [executor.execute(j["plan"]).to(probe_table.device)
                        for j in ext.joins]
        if any(bt.num_rows > limit for bt in build_tables):
            _remember_decline(decline_key)
            logger.debug("spmd join declining: a build side exceeds "
                         "parallel.spmd.broadcast_rows=%d", limit)
            return None
        key = (
            "spmd_join_aggregate",
            mesh_key(mesh),
            tuple(uids),
            ext.scan.schema_name, ext.scan.table_name,
            tuple(ext.scan.projection or ()),
            tuple(repr(j["plan"]) for j in ext.joins),
            tuple(str(j["lkey"]) + "=" + str(j["rkey"]) for j in ext.joins),
            tuple(str(e) for e in ext.conjuncts),
            tuple(str(e) for e in group_exprs),
            tuple(str(a) for a in agg_exprs),
            tuple((f.name, f.sql_type) for f in rel.schema),
            probe_table.num_rows,
            tuple(bt.num_rows for bt in build_tables),
            str(config.get("sql.compile.segsum", "auto")),
        )

        def build():
            return SpmdJoinAggregate(mesh, rel, ext, group_exprs, agg_exprs,
                                     probe_table, build_tables, executor)

        compiled, built_here = singleflight_get_or_build(
            _cache, key, build, "spmd_join_aggregate", ctx, _CACHE_CAP)
        if not built_here and params:
            ctx.metrics.inc("families.hit")
            from ..observability import trace_event

            trace_event("family_hit", rung="spmd_join_aggregate",
                        params=len(params))
        ctx.metrics.inc("parallel.spmd.launches")
        ctx.metrics.inc("parallel.spmd.rows", probe_table.num_rows)
        from ..resilience import faults

        faults.maybe_inject("oom", config)
        result = compiled.run(probe_table, build_tables, params)
        if compiled.has_encoded:
            ctx.metrics.inc("columnar.encoding.late_rows", result.num_rows)
        return result
    except _Unsupported as e:
        logger.debug("spmd join pipeline unsupported: %s", e)
        if decline_key is not None:
            _remember_decline(decline_key)
        return None
    except (ValueError, TypeError, NotImplementedError) as e:
        logger.debug("spmd join pipeline declined: %s", e)
        return None
