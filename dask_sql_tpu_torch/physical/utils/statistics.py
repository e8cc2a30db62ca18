"""Parquet footer statistics (parity: reference physical/utils/statistics.py:21
— per-file/per-row-group num-rows and per-column min/max read from footers,
no data scan; feeds the optimizer's row-count statistics).

Copied from `dask_sql_tpu/physical/utils/statistics.py`, without one unused
import."""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional


def _paths_for(location: str) -> List[str]:
    if any(ch in location for ch in "*?["):
        return sorted(glob.glob(location))
    if os.path.isdir(location):
        return sorted(glob.glob(os.path.join(location, "**", "*.parquet"), recursive=True))
    return [location]


def parquet_statistics(location: str, columns: Optional[List[str]] = None) -> Optional[dict]:
    """Read footers only.  Returns {"num-rows": int, "columns": {name: {min, max, null_count}}}."""
    try:
        import pyarrow.parquet as pq
    except ImportError:  # pragma: no cover
        return None
    paths = _paths_for(location)
    if not paths:
        return None
    total = 0
    col_stats: Dict[str, dict] = {}
    for path in paths:
        try:
            meta = pq.ParquetFile(path).metadata
        except Exception:  # dsql: allow-broad-except — unreadable footer
            # means "no statistics", never a query failure
            return None
        total += meta.num_rows
        for rg in range(meta.num_row_groups):
            group = meta.row_group(rg)
            for ci in range(group.num_columns):
                col = group.column(ci)
                name = col.path_in_schema
                if columns is not None and name not in columns:
                    continue
                stats = col.statistics
                if stats is None or not stats.has_min_max:
                    continue
                entry = col_stats.setdefault(name, {"min": None, "max": None, "null_count": 0})
                entry["min"] = stats.min if entry["min"] is None else min(entry["min"], stats.min)
                entry["max"] = stats.max if entry["max"] is None else max(entry["max"], stats.max)
                if stats.null_count is not None:
                    entry["null_count"] += stats.null_count
    return {"num-rows": total, "columns": col_stats}


def parquet_schema_fields(location: str):
    """Arrow schema of a parquet dataset (footer only) -> planner Fields."""
    import pyarrow.parquet as pq

    from ...columnar.dtypes import SqlType
    from ...planner.expressions import Field
    import pyarrow as pa

    paths = _paths_for(location)
    schema = pq.ParquetFile(paths[0]).schema_arrow
    fields = []
    for f in schema:
        t = f.type
        if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_dictionary(t):
            st = SqlType.VARCHAR
        elif pa.types.is_timestamp(t):
            st = SqlType.TIMESTAMP
        elif pa.types.is_date(t):
            st = SqlType.DATE
        elif pa.types.is_boolean(t):
            st = SqlType.BOOLEAN
        elif pa.types.is_integer(t):
            st = {8: SqlType.TINYINT, 16: SqlType.SMALLINT,
                  32: SqlType.INTEGER}.get(t.bit_width, SqlType.BIGINT)
        elif pa.types.is_floating(t):
            st = SqlType.FLOAT if t == pa.float32() else SqlType.DOUBLE
        elif pa.types.is_decimal(t):
            st = SqlType.DECIMAL
        else:
            st = SqlType.VARCHAR
        fields.append(Field(f.name, st, f.nullable))
    return fields
