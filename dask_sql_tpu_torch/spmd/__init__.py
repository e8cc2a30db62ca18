"""Sharded query execution: sharded storage and the sharded compiled rungs.

Counterpart of `dask_sql_tpu/spmd/`:

- `storage`: the ``parallel.auto_shard`` policy (sharding eligible
  registrations over the default mesh, keeping DICT and FOR encodings);
- `select` / `aggregate` / `join`: the ``spmd_select``, ``spmd_aggregate``
  and ``spmd_join_aggregate`` rungs of the degradation ladder, the
  one-device compiled pipelines run a shard at a time, their aggregation
  states combined across the shards and their build sides broadcast;
- `core`: the switches, the sharded-scan rule and the per-shard argument
  packing the rungs share.

Each rung sits above its one-device counterpart and is breaker-isolated
per (family, rung): a failing sharded rung steps down to the one-device
compiled rung without charging it.
"""
from .aggregate import SpmdAggregate, try_spmd_aggregate
from .core import mesh_of_sharded_table, rung_enabled, spmd_enabled
from .join import SpmdJoinAggregate, try_spmd_join_aggregate
from .select import SpmdSelect, try_spmd_select
from .storage import auto_shard_enabled, maybe_auto_shard, truthy_option


def spmd_rungs_for(rel):
    """The sharded aggregate rungs whose plan shape an Aggregate has, in
    ladder order, as (rung name, try function) pairs.  The reference
    attempts each rung, and arms its ``spmd`` fault site, whatever the
    shape; the port attempts only a rung that can take the plan, so an
    injected fault lands where a sharded run would have happened."""
    from ..physical.compiled import _extract_chain
    from ..physical.compiled_join import _extract as join_chain

    out = []
    if join_chain(rel) is not None:
        out.append(("spmd_join_aggregate", try_spmd_join_aggregate))
    if _extract_chain(rel) is not None:
        out.append(("spmd_aggregate", try_spmd_aggregate))
    return out


def takes_spmd_select(root) -> bool:
    """Whether a plan root is a select chain the ``spmd_select`` rung takes
    (no ORDER BY), the gate of its attempt and fault site."""
    from ..physical.compiled_select import _extract

    got = _extract(root)
    return got is not None and got[3] is None

__all__ = [
    "SpmdAggregate",
    "SpmdJoinAggregate",
    "SpmdSelect",
    "auto_shard_enabled",
    "maybe_auto_shard",
    "mesh_of_sharded_table",
    "rung_enabled",
    "spmd_enabled",
    "spmd_rungs_for",
    "takes_spmd_select",
    "truthy_option",
    "try_spmd_aggregate",
    "try_spmd_join_aggregate",
    "try_spmd_select",
]
