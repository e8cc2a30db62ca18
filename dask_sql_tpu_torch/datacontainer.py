"""Registered tables of the PyTorch port.

Counterpart of `dask_sql_tpu/datacontainer.py`, lean: an input becomes a
`Table` on the context's device (`input_utils`), registered in a schema
inside a `DataContainer` whose `uid` keys the plan cache and the compiled
pipelines' caches.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict

from .columnar.table import Table

_dc_serial = itertools.count()


class DataContainer:
    """A registered Table and its unique serial (id() can be recycled):
    registering a table again gives it a new uid."""

    def __init__(self, table: Table):
        self.table = table
        self.uid = next(_dc_serial)


@dataclass
class SchemaContainer:
    name: str
    tables: Dict[str, DataContainer] = field(default_factory=dict)

