"""Sharding of columnar tables over a shard mesh.

Counterpart of `dask_sql_tpu/parallel/distribute.py`.  A distributed table
is the same `Table` with a ``sharding``: contiguous row blocks, one a
shard (`mesh.RowBlocks`).  The reference pads the rows to a multiple of
the device count and carries a ``row_valid`` mask; port tables are never
padded, so the blocks are uneven instead (the first ``n % width`` blocks
hold one row more).  Where the shards name the table's device the blocks
are views of the loaded columns, so the device bytes do not grow; a shard
on another device gets its block copied once, here.
"""
from __future__ import annotations

from typing import Optional

from ..columnar.encodings import Encoding
from ..columnar.table import Table
from .mesh import Mesh, RowBlocks, block_offsets, default_mesh


def shard_table(table: Table, mesh: Optional[Mesh] = None) -> Table:
    """The same rows as a sharded table over ``mesh`` (the default mesh of
    the table's device kind when None).  DICT and FOR codes shard like
    values; RLE runs are not row-partitionable, so an RLE column decodes
    first, as the reference does.  The global columns live on the first
    shard's device."""
    mesh = mesh or default_mesh(table.device.type)
    home = mesh.devices[0]
    cols = {}
    for name, col in table.columns.items():
        if col.encoding is Encoding.RLE:
            col = col.decode()
        cols[name] = col.to(home)
    offsets = block_offsets(table.num_rows, mesh.size)
    resident = {}
    for col in cols.values():
        parts = []
        for i, device in enumerate(mesh.devices):
            if device == home:
                parts.append(None)
            else:
                parts.append(col.slice(offsets[i], offsets[i + 1]).to(device))
        if any(p is not None for p in parts):
            # the column object keys its blocks; it stays alive with them
            resident[id(col)] = (col, parts)
    return Table(cols, table.num_rows, home,
                 RowBlocks(mesh, offsets, resident))


def table_sharding_info(table: Table) -> dict:
    """Debug helper: per-column placement descriptions."""
    sh = table.sharding
    if sh is None:
        return {name: f"{table.device} (unsharded)" for name in table.columns}
    desc = f"{sh.mesh!r} blocks={sh.sizes}"
    return {name: desc for name in table.columns}
