"""Registered tables and functions of the PyTorch port.

Counterpart of `dask_sql_tpu/datacontainer.py`, lean: an input becomes a
`Table` on the context's device (`input_utils`), registered in a schema
inside a `DataContainer` whose `uid` keys the plan cache and the compiled
pipelines' caches.  A schema also holds its tables' statistics (the row
counts the planner reads) and its registered functions: the latest
registration of each name (`functions`) and every overload of it
(`function_lists`).  Views live in the Context, as in the reference.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List

from .columnar.table import Table
from .planner.catalog import FunctionDescription, Statistics

__all__ = ["DataContainer", "SchemaContainer", "Statistics",
           "FunctionDescription"]

_dc_serial = itertools.count()


class DataContainer:
    """A registered Table and its unique serial (id() can be recycled):
    registering a table again gives it a new uid; an append keeps it."""

    def __init__(self, table: Table):
        self.table = table
        self.uid = next(_dc_serial)


@dataclass
class SchemaContainer:
    name: str
    tables: Dict[str, DataContainer] = field(default_factory=dict)
    statistics: Dict[str, Statistics] = field(default_factory=dict)
    functions: Dict[str, FunctionDescription] = field(default_factory=dict)
    function_lists: Dict[str, List[FunctionDescription]] = field(
        default_factory=dict)
