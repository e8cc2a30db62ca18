"""Input plugins: user inputs -> a DataContainer on the Context's device.

Counterpart of `dask_sql_tpu/input_utils/plugins.py`: in-memory frames,
Arrow tables, dicts and port Tables; file locations (parquet, eager or
lazy, CSV and JSON; globs and directories) and published datasets (the
``memory`` format); Hive tables through a cursor, Intake catalogs and
SQLAlchemy connections, each recognised by its type's name so that no
package is needed to register the others.  Every table lands on the
Context's device.
"""
from __future__ import annotations

import glob
import os

from ..columnar.table import Table
from ..datacontainer import DataContainer, LazyParquetContainer
from .base import BaseInputPlugin

#: published datasets by name, read back with format="memory"
_PUBLISHED: dict = {}


def publish_dataset(name: str, dc: DataContainer) -> None:
    _PUBLISHED[name] = dc


def unpublish_dataset(name: str) -> None:
    _PUBLISHED.pop(name, None)


def _type_name(item) -> str:
    return ".".join([type(item).__module__, type(item).__name__])


class PandasLikeInputPlugin(BaseInputPlugin):
    """A pandas frame."""

    def is_correct_input(self, input_item, table_name, format=None, **kwargs):
        import pandas as pd

        return isinstance(input_item, pd.DataFrame)

    def to_dc(self, input_item, table_name, device, format=None, **kwargs):
        return DataContainer(Table.from_pandas(input_item, device))


class ArrowInputPlugin(BaseInputPlugin):
    def is_correct_input(self, input_item, table_name, format=None, **kwargs):
        try:
            import pyarrow as pa
        except ImportError:
            return False
        return isinstance(input_item, pa.Table)

    def to_dc(self, input_item, table_name, device, format=None, **kwargs):
        return DataContainer(Table.from_arrow(input_item, device))


class DeviceTableInputPlugin(BaseInputPlugin):
    """A port Table (or DataContainer) already on the Context's device."""

    def is_correct_input(self, input_item, table_name, format=None, **kwargs):
        return isinstance(input_item, (Table, DataContainer))

    def to_dc(self, input_item, table_name, device, format=None, **kwargs):
        table = input_item.table if isinstance(input_item, DataContainer) \
            else input_item
        if table.device != device:
            raise ValueError(f"table on {table.device}, context on {device}")
        if isinstance(input_item, DataContainer):
            return input_item
        return DataContainer(input_item)


class DictInputPlugin(BaseInputPlugin):
    def is_correct_input(self, input_item, table_name, format=None, **kwargs):
        return isinstance(input_item, dict)

    def to_dc(self, input_item, table_name, device, format=None, **kwargs):
        import pandas as pd

        return DataContainer(Table.from_pandas(pd.DataFrame(input_item), device))


class LocationInputPlugin(BaseInputPlugin):
    """A location string: a parquet, CSV or JSON file, a glob or a
    directory of them, or with ``format="memory"`` the name of a published
    dataset.  Parquet stays on disk (`LazyParquetContainer`, footers read
    now) unless ``persist`` asks for it to be loaded."""

    def is_correct_input(self, input_item, table_name, format=None, **kwargs):
        return isinstance(input_item, str)

    def to_dc(self, input_item, table_name, device, format=None, **kwargs):
        if format == "memory":
            if input_item not in _PUBLISHED:
                raise KeyError(f"No published dataset {input_item!r}")
            dc = _PUBLISHED[input_item]
            on = dc.device if isinstance(dc, LazyParquetContainer) \
                else dc.table.device
            if on != device:
                raise ValueError(f"dataset {input_item!r} on {on}, "
                                 f"context on {device}")
            return dc
        fmt = format
        if not fmt:
            ext = os.path.splitext(
                input_item.split("*")[0].rstrip("/"))[-1].lstrip(".")
            fmt = ext or "parquet"
        paths = sorted(glob.glob(input_item)) \
            if any(ch in input_item for ch in "*?[") else [input_item]
        if not paths:
            raise FileNotFoundError(input_item)
        persist = kwargs.pop("persist", True)
        if fmt in ("parquet", "pq"):
            if not persist:
                from ..physical.utils.statistics import (
                    parquet_schema_fields, parquet_statistics)

                return LazyParquetContainer(
                    input_item, parquet_schema_fields(input_item), device,
                    parquet_statistics(input_item))
            return self._read_parquet(paths, device, **kwargs)
        if fmt == "csv":
            return self._read_csv(paths, device, **kwargs)
        if fmt == "json":
            return self._read_json(paths, device, **kwargs)
        raise NotImplementedError(f"Input format {fmt!r}")

    def _read_parquet(self, paths, device, columns=None, filters=None,
                      **kwargs):
        import pyarrow as pa
        import pyarrow.parquet as pq

        files = []
        for path in paths:
            if os.path.isdir(path):
                files.extend(sorted(glob.glob(
                    os.path.join(path, "**", "*.parquet"), recursive=True)))
            else:
                files.append(path)
        tables = [pq.read_table(f, columns=columns, filters=filters)
                  for f in files]
        at = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        return DataContainer(Table.from_arrow(at, device))

    def _read_csv(self, paths, device, **kwargs):
        import pandas as pd

        options = {k: v for k, v in kwargs.items()
                   if k not in ("backend", "gpu", "statistics")}
        frames = [pd.read_csv(p, **options) for p in paths]
        df = pd.concat(frames, ignore_index=True) if len(frames) > 1 \
            else frames[0]
        return DataContainer(Table.from_pandas(df, device))

    def _read_json(self, paths, device, **kwargs):
        import pandas as pd

        frames = [pd.read_json(p, lines=kwargs.get("lines", True))
                  for p in paths]
        df = pd.concat(frames, ignore_index=True) if len(frames) > 1 \
            else frames[0]
        return DataContainer(Table.from_pandas(df, device))


class HiveInputPlugin(BaseInputPlugin):
    """A Hive table through a DB-API cursor (pyhive's, or any object whose
    type names Hive and that has ``execute``): ``DESCRIBE FORMATTED`` gives
    the storage location and format, whose files load as a location does;
    a partitioned table is the union of its partitions' files, each with
    its partition columns added."""

    def is_correct_input(self, input_item, table_name, format=None, **kwargs):
        type_name = _type_name(input_item)
        return ("pyhive" in type_name
                or ("hive" in type_name.lower()
                    and hasattr(input_item, "execute")))

    def _fetch_kv(self, cursor, sql: str):
        cursor.execute(sql)
        rows = cursor.fetchall()
        out = {}
        for row in rows:
            key = str(row[0]).strip().rstrip(":")
            val = str(row[1]).strip() if len(row) > 1 and row[1] is not None \
                else ""
            if key:
                out[key] = val
        return out

    def to_dc(self, input_item, table_name, device, format=None, **kwargs):
        cursor = input_item
        hive_table = kwargs.get("hive_table_name", table_name)
        schema = kwargs.get("hive_schema_name", "default")
        info = self._fetch_kv(cursor,
                              f"DESCRIBE FORMATTED {schema}.{hive_table}")
        in_fmt = info.get("InputFormat", "").lower()
        if "parquet" in in_fmt:
            fmt = "parquet"
        elif "text" in in_fmt or "csv" in in_fmt:
            fmt = "csv"
        else:
            raise NotImplementedError(
                f"Unsupported hive storage format {in_fmt!r}")
        location = info.get("Location", "").replace("file:", "").rstrip("/")
        try:
            cursor.execute(f"SHOW PARTITIONS {schema}.{hive_table}")
            partitions = [r[0] for r in cursor.fetchall()]
        except Exception:  # dsql: allow-broad-except: a metastore without
            # partition support holds an unpartitioned table
            partitions = []
        plugin = LocationInputPlugin()
        if not partitions:
            return plugin.to_dc(location + "/*", table_name, device,
                                format=fmt, persist=True)
        import pandas as pd

        frames = []
        for part in partitions:
            dc = plugin.to_dc(f"{location}/{part.rstrip('/')}/*", table_name,
                              device, format=fmt, persist=True)
            frame = dc.table.to_pandas()
            for piece in part.split("/"):
                key, _, val = piece.partition("=")
                frame[key] = val
            frames.append(frame)
        return DataContainer(Table.from_pandas(
            pd.concat(frames, ignore_index=True), device))


class IntakeCatalogInputPlugin(BaseInputPlugin):
    """An Intake catalog: its entry of the table's name (or
    ``intake_table_name``) read to pandas."""

    def is_correct_input(self, input_item, table_name, format=None, **kwargs):
        return _type_name(input_item).startswith("intake.")

    def to_dc(self, input_item, table_name, device, format=None, **kwargs):
        source = getattr(input_item,
                         kwargs.get("intake_table_name", table_name))
        return DataContainer(Table.from_pandas(source.read(), device))


class SqlalchemyInputPlugin(BaseInputPlugin):
    """A SQLAlchemy connection or engine: ``query`` (by default the whole
    table of that name) read with pandas."""

    def is_correct_input(self, input_item, table_name, format=None, **kwargs):
        return type(input_item).__module__.startswith("sqlalchemy")

    def to_dc(self, input_item, table_name, device, format=None, **kwargs):
        import pandas as pd

        query = kwargs.get("query", f"SELECT * FROM {table_name}")
        return DataContainer(Table.from_pandas(pd.read_sql(query, input_item),
                                               device))
