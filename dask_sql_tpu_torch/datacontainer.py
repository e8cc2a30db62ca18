"""Registered tables of the PyTorch port.

Counterpart of `dask_sql_tpu/datacontainer.py` and of its pandas ingest
(`input_utils/convert.py`), lean: a pandas frame (or a port `Table`) becomes
a `Table` on the context's device, registered in a schema.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

from .columnar.table import Table


@dataclass
class SchemaContainer:
    name: str
    tables: Dict[str, Table] = field(default_factory=dict)


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
