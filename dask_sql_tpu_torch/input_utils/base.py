"""Input plugin base (counterpart of `dask_sql_tpu/input_utils/base.py`)."""
from __future__ import annotations


class BaseInputPlugin:
    """Converts one kind of user input into a DataContainer on a device."""

    def is_correct_input(self, input_item, table_name: str, format: str = None,
                         **kwargs) -> bool:
        raise NotImplementedError

    def to_dc(self, input_item, table_name: str, device, format: str = None,
              **kwargs):
        raise NotImplementedError
