"""Aggregate converter (counterpart of `AggregatePlugin` in
`dask_sql_tpu/physical/rel/logical/aggregate.py`): the compiled rungs in
the reference's order, the join->aggregate pipeline first, then the fused
aggregate.  A plan that both decline raises NotImplementedError naming the
reason; the eager aggregate rung is not in the port yet.  The rung that
answers is counted in ``metrics["resilience.rung.<rung>"]``, as the
reference's ladder counts it."""
from __future__ import annotations

from ....columnar.table import Table
from ....planner import plan as p
from ...compiled import try_compiled_aggregate
from ...compiled_join import try_compiled_join_aggregate
from ...executor import Executor
from ..base import BaseRelPlugin


@Executor.add_plugin_class
class AggregatePlugin(BaseRelPlugin):
    class_name = "Aggregate"

    def convert(self, rel: p.Aggregate, executor) -> Table:
        joined = try_compiled_join_aggregate(rel, executor)
        if joined is not None:
            executor.context.metrics.inc(
                "resilience.rung.compiled_join_aggregate")
            return joined
        return try_compiled_aggregate(rel, executor)
