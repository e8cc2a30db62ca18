"""Registered tables and functions of the PyTorch port.

Counterpart of `dask_sql_tpu/datacontainer.py`, lean: an input becomes a
`Table` on the context's device (`input_utils`), registered in a schema
inside a `DataContainer` whose `uid` keys the plan cache and the compiled
pipelines' caches.  A schema also holds its tables' statistics (the row
counts the planner reads) and its registered functions: the latest
registration of each name (`functions`) and every overload of it
(`function_lists`), and the location each file-backed table was read from
(`filepaths`).  Views live in the Context, as in the reference.

A parquet location registered without ``persist`` stays on disk in a
`LazyParquetContainer`: its fields and row count come from the footers,
and a scan reads only the columns and row groups a query asks for.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .columnar.table import Table
from .planner.catalog import FunctionDescription, Statistics

__all__ = ["DataContainer", "LazyParquetContainer", "SchemaContainer",
           "Statistics", "FunctionDescription"]

_dc_serial = itertools.count()


class DataContainer:
    """A registered Table and its unique serial (id() can be recycled):
    registering a table again gives it a new uid; an append keeps it."""

    def __init__(self, table: Table):
        self.table = table
        self.uid = next(_dc_serial)


class LazyParquetContainer(DataContainer):
    """A parquet location (a file, a glob or a directory) that stays on
    disk until a query scans it, as the reference's non-persisted location
    tables do.  `fields` and `statistics` come from the footers; `scan`
    reads the projected columns with pyarrow row-group filters onto the
    Context's `device`.  `table` loads and keeps the whole location: the
    planner and the catalog read `fields` and `statistics` instead."""

    def __init__(self, location: str, fields, device, statistics=None):
        self.location = location
        self.fields = list(fields)
        self.device = device
        self.statistics = statistics
        self._table: Optional[Table] = None
        self.uid = next(_dc_serial)

    @property
    def table(self) -> Table:
        if self._table is None:
            self._table = self.scan()
        return self._table

    def scan(self, columns=None, filters=None) -> Table:
        """The location's rows on the device: only `columns` (all when
        None), and only the rows that pass the pyarrow `filters`."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        from .physical.utils.statistics import _paths_for

        tables = [pq.read_table(path, columns=list(columns) if columns
                                else None, filters=filters)
                  for path in _paths_for(self.location)]
        at = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        return Table.from_arrow(at, self.device)


@dataclass
class SchemaContainer:
    name: str
    tables: Dict[str, DataContainer] = field(default_factory=dict)
    statistics: Dict[str, Statistics] = field(default_factory=dict)
    functions: Dict[str, FunctionDescription] = field(default_factory=dict)
    function_lists: Dict[str, List[FunctionDescription]] = field(
        default_factory=dict)
    models: Dict[str, Tuple[object, List[str]]] = field(default_factory=dict)
    experiments: Dict[str, object] = field(default_factory=dict)
    filepaths: Dict[str, str] = field(default_factory=dict)
