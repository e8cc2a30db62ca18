"""Multi-device execution of the port: the shard mesh, sharded tables, the
exchanges between shards and the collectives engine (counterpart of
`dask_sql_tpu/parallel/`, without the multi-host bootstrap)."""
from .mesh import (
    AXIS,
    Mesh,
    RowBlocks,
    default_mesh,
    make_mesh,
    row_sharding,
    set_default_mesh,
    shard_rows,
)

__all__ = [
    "AXIS",
    "Mesh",
    "RowBlocks",
    "default_mesh",
    "make_mesh",
    "row_sharding",
    "set_default_mesh",
    "shard_rows",
]
