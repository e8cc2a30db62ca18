"""Aggregate converter (counterpart of `AggregatePlugin` in
`dask_sql_tpu/physical/rel/logical/aggregate.py`): the compiled rung only.
A plan it declines raises NotImplementedError naming the reason."""
from __future__ import annotations

from ....columnar.table import Table
from ....planner import plan as p
from ...compiled import try_compiled_aggregate
from ...executor import Executor
from ..base import BaseRelPlugin


@Executor.add_plugin_class
class AggregatePlugin(BaseRelPlugin):
    class_name = "Aggregate"

    def convert(self, rel: p.Aggregate, executor) -> Table:
        return try_compiled_aggregate(rel, executor)
