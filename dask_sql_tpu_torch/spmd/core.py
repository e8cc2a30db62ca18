"""Shared plumbing of the sharded compiled rungs.

Counterpart of `dask_sql_tpu/spmd/core.py`: the switches
(``parallel.spmd`` and its per-rung keys), the rule that decides whether a
scan reads a sharded table (shared by the rungs, the estimator's
per-device budget and the EXPLAIN LINT advisory, so they never disagree),
and the argument packing of a shard's run.  The reference wraps each
traced pipeline in one `shard_map` program whose arguments are the packed
sharded columns; here a rung runs its pipeline's torch ops once a shard
over that shard's block (`shard_blocks`).
"""
from __future__ import annotations

import logging
from typing import List

logger = logging.getLogger(__name__)


def _mode(config, key: str, default="auto") -> str:
    return str(config.get(key, default)).lower()


def spmd_enabled(config) -> bool:
    """Master switch of the sharded compiled rungs (``parallel.spmd``)."""
    return _mode(config, "parallel.spmd") not in ("off", "false", "0", "none")


def rung_enabled(config, rung: str) -> bool:
    """Per-rung switch under the master one, e.g. ``parallel.spmd.select``
    for ``spmd_select``."""
    if not spmd_enabled(config):
        return False
    short = rung[len("spmd_"):] if rung.startswith("spmd_") else rung
    v = config.get(f"parallel.spmd.{short}", True)
    return str(v).lower() not in ("off", "false", "0", "none")


def mesh_of_sharded_table(table):
    """The mesh a table's rows are sharded over, or None when it is not
    sharded or its mesh has a single shard (the rungs decline there, as
    the reference's do below two devices)."""
    from ..parallel.dist_plan import mesh_for_table

    mesh = mesh_for_table(table)
    if mesh is None or mesh.size < 2:
        return None
    return mesh


def resolve_sharded_scan(context, node):
    """(table, mesh) when a TableScan reads a registered, loaded, sharded
    table; None otherwise.  Never loads a lazy parquet table."""
    if context is None:
        return None
    schema = getattr(context, "schema", {}).get(node.schema_name)
    dc = schema.tables.get(node.table_name) if schema else None
    if dc is None:
        return None
    from ..datacontainer import LazyParquetContainer

    if isinstance(dc, LazyParquetContainer):
        return None
    table = getattr(dc, "table", None)
    if table is None:
        return None
    mesh = mesh_of_sharded_table(table)
    if mesh is None:
        return None
    return table, mesh


def shard_blocks(table) -> List:
    """The argument packing of a sharded run: one block Table a shard, on
    its shard's device, in shard order.  A pipeline planned on the global
    table runs unchanged over each block (the same columns, fewer rows)."""
    return table.sharding.blocks(table)
