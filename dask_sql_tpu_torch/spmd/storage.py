"""Sharded storage at registration: the ``parallel.auto_shard`` policy.

Counterpart of `dask_sql_tpu/spmd/storage.py`.  `create_table(...,
distributed=True)` and the ``CREATE TABLE ... WITH (distributed = ...)``
passthrough shard explicitly; with ``parallel.auto_shard`` on, every
eligible registration shards over the default mesh of its device kind.

Eligible: a loaded (non-lazy) table of at least
``parallel.auto_shard.min_rows`` rows, not sharded already, whose default
mesh has two or more shards.  Sharding keeps DICT and FOR encodings.
"""
from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def truthy_option(value) -> bool:
    """A create_table option that may arrive as a SQL WITH literal (bool,
    number or string): the string ``'false'`` must not shard."""
    if isinstance(value, str):
        return value.strip().lower() in ("true", "1", "on", "yes")
    return bool(value)


def auto_shard_enabled(config) -> bool:
    mode = str(config.get("parallel.auto_shard", "off")).lower()
    return mode in ("on", "auto", "true", "1")


def maybe_auto_shard(dc, config, metrics=None):
    """Apply the auto-shard policy to a freshly built DataContainer; returns
    the (possibly sharded) container.  Never raises: a table that cannot
    shard stays on one device (policy, not contract)."""
    if not auto_shard_enabled(config):
        return dc
    from ..datacontainer import LazyParquetContainer

    if isinstance(dc, LazyParquetContainer):
        return dc  # lazy scans keep their pushdown
    table = getattr(dc, "table", None)
    if table is None:
        return dc
    min_rows = int(config.get("parallel.auto_shard.min_rows", 32768) or 0)
    if table.num_rows < min_rows:
        return dc
    try:
        from ..parallel.dist_plan import table_is_sharded
        from ..parallel.distribute import shard_table
        from ..parallel.mesh import default_mesh

        if table_is_sharded(table):
            return dc
        mesh = default_mesh(table.device.type)
        if mesh.size < 2:
            return dc
        dc.table = shard_table(table, mesh)
        if metrics is not None:
            metrics.inc("parallel.auto_shard.tables")
        logger.debug("auto-sharded a registration over %d shards", mesh.size)
    except (RuntimeError, ValueError) as e:
        # a device that cannot take the blocks keeps the registration on
        # one device rather than failing CREATE TABLE
        logger.warning("auto_shard failed (%s); keeping one device", e)
    return dc
