"""Input conversion (counterpart of
`dask_sql_tpu/input_utils/convert.py`).

Registration is the load boundary: the plugin's host->device conversions
run inside `columnar.encodings.load_scope`, carrying the registering
Context's config, so the ``columnar.encoding*`` keys pick each column's
compressed encoding there and nowhere else.  The Hive, Intake, Sqlalchemy
and Location plugins of the reference are not ported.
"""
from __future__ import annotations

from typing import Any, List, Optional

from ..datacontainer import DataContainer
from .base import BaseInputPlugin
from .plugins import (
    ArrowInputPlugin,
    DeviceTableInputPlugin,
    DictInputPlugin,
    PandasLikeInputPlugin,
)


class InputUtil:
    _plugins: List[BaseInputPlugin] = [
        DeviceTableInputPlugin(),
        ArrowInputPlugin(),
        PandasLikeInputPlugin(),
        DictInputPlugin(),
    ]

    @classmethod
    def to_dc(cls, input_item: Any, table_name: str, device,
              format: Optional[str] = None, config=None,
              **kwargs) -> DataContainer:
        from ..columnar import encodings

        for plugin in cls._plugins:
            if plugin.is_correct_input(input_item, table_name, format=format,
                                       **kwargs):
                with encodings.load_scope(config):
                    return plugin.to_dc(input_item, table_name, device,
                                        format=format, **kwargs)
        raise ValueError(f"Do not understand the input type {type(input_item)}")
