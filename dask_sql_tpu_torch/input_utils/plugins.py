"""Input plugins: user inputs -> a DataContainer on the Context's device.

Counterpart of the DeviceTable, Arrow, PandasLike and Dict plugins of
`dask_sql_tpu/input_utils/plugins.py`.
"""
from __future__ import annotations

from ..columnar.table import Table
from ..datacontainer import DataContainer
from .base import BaseInputPlugin


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
