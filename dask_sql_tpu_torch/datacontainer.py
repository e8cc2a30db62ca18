"""Registered tables of the PyTorch port.

Counterpart of `dask_sql_tpu/datacontainer.py` and of its pandas ingest
(`input_utils/convert.py`), lean: a pandas frame (or a port `Table`) becomes
a `Table` on the context's device, registered in a schema inside a
`DataContainer` whose `uid` keys the plan cache and the join pipeline's
cache.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict

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


def to_table(input_table: Any, device) -> Table:
    """pandas DataFrame or port Table -> Table on `device`."""
    import pandas as pd

    if isinstance(input_table, Table):
        if input_table.device != device:
            raise ValueError(
                f"table on {input_table.device}, context on {device}")
        return input_table
    if isinstance(input_table, pd.DataFrame):
        return Table.from_pandas(input_table, device)
    raise ValueError(f"Do not understand the input type {type(input_table)}")
