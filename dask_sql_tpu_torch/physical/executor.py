"""Physical executor: walks the logical plan and produces Tables.

Counterpart of `dask_sql_tpu/physical/executor.py` on one device: the plan
root first tries the compiled root select (`compiled_select.py`) as a rung
of the degradation ladder (`resilience/ladder.py`), then the interpreted
walk, where each plan node goes to the plugin registered for its node
type.
"""
from __future__ import annotations

from typing import Dict

from ..columnar.table import Table
from ..planner.plan import LogicalPlan
from .rel.base import BaseRelPlugin
from .rex.convert import RexConverter


class Executor:
    _plugins: Dict[str, BaseRelPlugin] = {}

    def __init__(self, context):
        self.context = context
        self.rex = RexConverter(self)
        self._memo: Dict[int, Table] = {}

    @classmethod
    def add_plugin_class(cls, plugin_class):
        plugin = plugin_class()
        cls._plugins[plugin.class_name] = plugin
        return plugin_class

    def execute_root(self, rel: LogicalPlan) -> Table:
        """Entry for the plan ROOT, whose result goes straight to the host:
        a root select chain runs as the compiled select (two programs, two
        transfers), the `compiled_select` rung of the ladder; anything else,
        or a degradable failure there, takes the interpreted walk."""
        from ..resilience import ladder
        from .compiled_select import try_compiled_select

        out = ladder.attempt(self, "compiled_select",
                             lambda: try_compiled_select(rel, self), rel=rel)
        if out is not None:
            return out
        return ladder.execute_interpreted(self, rel)

    def execute(self, rel: LogicalPlan) -> Table:
        key = id(rel)
        if key in self._memo:
            return self._memo[key]
        plugin = self._plugins.get(rel.node_type)
        if plugin is None:
            raise NotImplementedError(
                f"No rel plugin for node type {rel.node_type!r} in the port yet")
        out = plugin.convert(rel, self)
        self._memo[key] = out
        return out

    # -- services for plugins ----------------------------------------------
    def eval_expr(self, expr, table: Table):
        return self.rex.convert(expr, table)

    def get_table(self, schema_name: str, table_name: str) -> Table:
        return self.context.get_table_data(schema_name, table_name)

    @property
    def config(self):
        return self.context.config


# the plugin modules register themselves with Executor on import
from .rel.logical import aggregate, basic, join, window  # noqa: E402,F401
