"""Physical executor: walks the logical plan and produces Tables.

Counterpart of `dask_sql_tpu/physical/executor.py`: the plan
root runs under the degradation ladder (`resilience/ladder.py`): the fused
PREDICT of a root PREDICT over a select chain (`compiled_predict.py`), the
streamed root select of a plan the admission gate routed to partitions
(`streaming/select.py`, `stream_decisions`), the sharded root select of
a plan over a sharded table (`spmd/select.py`, ``spmd`` fault site), the
compiled root select (`compiled_select.py`), then the interpreted
walk, where each plan node goes to the plugin registered for its node
type: the relational operators (`rel/logical/`) and the statements
(`rel/custom/ddl.py`, `rel/custom/ml.py`).  With ``trace`` on, each plan node runs under the
per-node `Tracer` (tracing.py): EXPLAIN ANALYZE and
``serving.metrics.node_traces``.  The query's serving ticket is checked
before the one-kernel fast path and before every plan node (a cancel or a
deadline raises there; a node's queued card work still runs).
"""
from __future__ import annotations

from typing import Dict

from ..columnar.table import Table
from ..planner.plan import LogicalPlan
from ..serving.runtime import current_ticket
from .rel.base import BaseRelPlugin
from .rex.convert import RexConverter


class Executor:
    _plugins: Dict[str, BaseRelPlugin] = {}

    def __init__(self, context, trace: bool = False):
        from ..tracing import Tracer

        self.context = context
        self.rex = RexConverter(self)
        self._memo: Dict[int, Table] = {}
        self.tracer = Tracer(context.device)
        if trace:
            self.tracer.start()
        #: (schema, table) -> the Table that a scan of it reads instead
        #: (a batch of the streamed aggregate, `streaming.py`)
        self.table_overrides: Dict[tuple, Table] = {}
        #: id(plan node) -> the admission gate's `StreamDecision` for THIS
        #: execution (streaming/): the streamed rungs fire only for it
        self.stream_decisions: Dict[int, object] = {}

    @classmethod
    def add_plugin_class(cls, plugin_class):
        plugin = plugin_class()
        cls._plugins[plugin.class_name] = plugin
        return plugin_class

    def execute_root(self, rel: LogicalPlan) -> Table:
        """Entry for the plan ROOT, whose result goes straight to the host.
        The ``execute`` fault site arms first.  A root PREDICT over a
        select chain runs model inference inside the compiled select's
        programs, the `compiled_predict` rung (``predict`` site at its
        entry), stepping down to the host tier (the PredictModelPlugin of
        the interpreted walk).  A root select chain runs as the compiled
        select (two programs, two transfers), the `compiled_select` rung of
        the ladder (``compile`` site at its entry); anything else, or a
        degradable failure there, takes the interpreted walk, with the CPU
        rung under it on a CPU Context.  With the ladder off the sites
        still arm, and a failure propagates."""
        from ..resilience import faults, ladder
        from .compiled_predict import root_has_predict, try_compiled_predict
        from .compiled_select import try_compiled_select

        ticket = current_ticket()
        if ticket is not None:  # checkpoint before the one-kernel fast path
            ticket.checkpoint()
        faults.maybe_inject("execute", self.config)
        # the sharded rung is worth a try only where the plan is a select
        # chain that scans a sharded table
        from ..parallel.dist_plan import plan_has_sharded_scan
        from ..spmd import takes_spmd_select, try_spmd_select

        sharded = takes_spmd_select(rel) and plan_has_sharded_scan(
            rel, self.context)
        # a root select the admission gate routed to partitions (streaming/)
        streamed = id(rel) in self.stream_decisions
        # fused PREDICT: its own (family, compiled_predict) breaker entity,
        # stepping down to the host tier below
        predict_root = root_has_predict(rel)
        if self.config.get("resilience.ladder.enabled", True):
            if predict_root:
                out = ladder.attempt(self, "compiled_predict",
                                     lambda: try_compiled_predict(rel, self),
                                     rel=rel, inject_site="predict")
                if out is not None:
                    return out
            if streamed:
                from ..streaming import try_streamed_select

                out = ladder.attempt(self, "streamed_select",
                                     lambda: try_streamed_select(rel, self),
                                     rel=rel)
                if out is not None:
                    return out
            if sharded:
                # the sharded rung above the one-device one (which declines
                # sharded tables): its own (family, spmd_select) breaker
                # entity, the ``spmd`` fault site at its entry
                out = ladder.attempt(self, "spmd_select",
                                     lambda: try_spmd_select(rel, self),
                                     rel=rel, inject_site="spmd")
                if out is not None:
                    return out
            out = ladder.attempt(self, "compiled_select",
                                 lambda: try_compiled_select(rel, self),
                                 rel=rel, inject_site="compile")
            if out is not None:
                return out
            return ladder.execute_interpreted(self, rel)
        if predict_root:
            faults.maybe_inject("predict", self.config)
            out = try_compiled_predict(rel, self)
            if out is not None:
                return out
        if streamed:
            from ..streaming import try_streamed_select

            out = try_streamed_select(rel, self)
            if out is not None:
                return out
        if sharded:
            faults.maybe_inject("spmd", self.config)
            out = try_spmd_select(rel, self)
            if out is not None:
                return out
        faults.maybe_inject("compile", self.config)
        out = try_compiled_select(rel, self)
        if out is not None:
            return out
        faults.maybe_inject("exec_oom", self.config)
        return self.execute(rel)

    def execute(self, rel: LogicalPlan) -> Table:
        # cooperative checkpoint between plan nodes: a cancelled query or
        # one past its deadline raises here
        ticket = current_ticket()
        if ticket is not None:
            ticket.checkpoint()
        key = id(rel)
        if key in self._memo:
            return self._memo[key]
        plugin = self._plugins.get(rel.node_type)
        if plugin is None:
            raise NotImplementedError(
                f"No rel plugin for node type {rel.node_type!r} in the port yet")
        if self.tracer.enabled:
            with self.tracer.node(rel) as ctx:
                out = plugin.convert(rel, self)
                ctx.rows = out.num_rows
        else:
            out = plugin.convert(rel, self)
        self._memo[key] = out
        return out

    # -- services for plugins ----------------------------------------------
    def eval_expr(self, expr, table: Table):
        return self.rex.convert(expr, table)

    def get_table(self, schema_name: str, table_name: str) -> Table:
        return self.context.get_table_data(schema_name, table_name)

    def lookup_function(self, name: str, arg_types=None):
        fd = self.context.lookup_function(name, arg_types)
        if fd is None:
            raise KeyError(f"Function {name!r} not registered")
        return fd

    @property
    def config(self):
        return self.context.config


# the plugin modules register themselves with Executor on import
from .rel.custom import ddl, ml  # noqa: E402,F401
from .rel.logical import aggregate, basic, join, window  # noqa: E402,F401
