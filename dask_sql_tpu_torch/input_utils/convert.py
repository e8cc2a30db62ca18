"""Input conversion (counterpart of
`dask_sql_tpu/input_utils/convert.py`).

The plugins are asked in the reference's order, a location string last; a
plugin whose probe raises does not take the input.  Registration is the
load boundary: the plugin's host->device conversions run inside
`columnar.encodings.load_scope`, carrying the registering Context's
config, so the ``columnar.encoding*`` keys pick each column's compressed
encoding there and nowhere else (a lazy parquet table reads nothing now,
and its scans at query time stay PLAIN, as the reference's do).
"""
from __future__ import annotations

from typing import Any, List, Optional

from ..datacontainer import DataContainer
from .base import BaseInputPlugin
from .plugins import (
    ArrowInputPlugin,
    DeviceTableInputPlugin,
    DictInputPlugin,
    HiveInputPlugin,
    IntakeCatalogInputPlugin,
    LocationInputPlugin,
    PandasLikeInputPlugin,
    SqlalchemyInputPlugin,
)


class InputUtil:
    _plugins: List[BaseInputPlugin] = [
        DeviceTableInputPlugin(),
        ArrowInputPlugin(),
        PandasLikeInputPlugin(),
        DictInputPlugin(),
        HiveInputPlugin(),
        IntakeCatalogInputPlugin(),
        SqlalchemyInputPlugin(),
        LocationInputPlugin(),  # last: a string is the most generic input
    ]

    @classmethod
    def add_plugin_class(cls, plugin_class) -> None:
        """Ask a plugin of this class before every other."""
        cls._plugins.insert(0, plugin_class())

    @classmethod
    def to_dc(cls, input_item: Any, table_name: str, device,
              format: Optional[str] = None, persist: bool = False,
              config=None, **kwargs) -> DataContainer:
        """The container of `input_item` on `device`; a location string is
        kept as the container's ``filepath``."""
        from ..columnar import encodings

        for plugin in cls._plugins:
            try:
                matches = plugin.is_correct_input(input_item, table_name,
                                                  format=format, **kwargs)
            except Exception:  # dsql: allow-broad-except: a probe that
                # raises declines the input
                matches = False
            if matches:
                with encodings.load_scope(config):
                    dc = plugin.to_dc(input_item, table_name, device,
                                      format=format, persist=persist,
                                      **kwargs)
                dc.filepath = input_item if isinstance(input_item, str) \
                    else None
                return dc
        raise ValueError(f"Do not understand the input type {type(input_item)}")
