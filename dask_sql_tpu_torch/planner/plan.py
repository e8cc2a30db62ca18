"""Logical plan nodes.

Copied from `dask_sql_tpu/planner/plan.py`; only import paths differ.

Role parity: DataFusion `LogicalPlan` as surfaced by the reference's
`PyLogicalPlan` (src/sql/logical.rs: node-type dispatch logical.rs:300-377,
typed per-node accessors logical.rs:102-253, per-node binding files
src/sql/logical/*.rs).  Every node carries its output `Schema`; the physical
layer dispatches on `node_type` through a plugin registry just like the
reference's RelConverter (physical/rel/convert.py:50-61 there).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .expressions import AggExpr, Expr, Field, Schema, SortKey, WindowExpr


class LogicalPlan:
    schema: Schema

    @property
    def node_type(self) -> str:
        return type(self).__name__

    def inputs(self) -> List["LogicalPlan"]:
        return []

    def with_inputs(self, inputs: List["LogicalPlan"]) -> "LogicalPlan":
        return self

    # -- plan display (EXPLAIN; parity logical.rs:380 explain_original) -----
    def _label(self) -> str:
        return self.node_type

    def explain(self, indent: int = 0) -> str:
        lines = ["  " * indent + self._label()]
        for child in self.inputs():
            lines.append(child.explain(indent + 1))
        return "\n".join(lines)

    @property
    def field_names(self) -> List[str]:
        return [f.name for f in self.schema]


@dataclass(eq=False)
class TableScan(LogicalPlan):
    """Parity: src/sql/logical/table_scan.rs (projections + DNF filter pushdown)."""

    schema_name: str
    table_name: str
    schema: Schema
    projection: Optional[List[str]] = None  # backend column names to read
    filters: List[Expr] = field(default_factory=list)  # conjunctive pushed-down filters

    def _label(self):
        proj = f" projection={self.projection}" if self.projection is not None else ""
        filt = f" filters={[str(f) for f in self.filters]}" if self.filters else ""
        return f"TableScan: {self.schema_name}.{self.table_name}{proj}{filt}"


@dataclass(eq=False)
class Projection(LogicalPlan):
    input: LogicalPlan
    exprs: List[Expr]
    schema: Schema

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return Projection(inputs[0], self.exprs, self.schema)

    def _label(self):
        return "Projection: " + ", ".join(
            f"{e} AS {f.name}" for e, f in zip(self.exprs, self.schema)
        )


@dataclass(eq=False)
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: Expr
    schema: Schema

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return Filter(inputs[0], self.predicate, self.schema)

    def _label(self):
        return f"Filter: {self.predicate}"


@dataclass(eq=False)
class Join(LogicalPlan):
    """Parity: src/sql/logical/join.rs (getCondition/getJoinType join.rs:26,106)."""

    left: LogicalPlan
    right: LogicalPlan
    join_type: str  # INNER, LEFT, RIGHT, FULL, LEFTSEMI, LEFTANTI
    on: List[Tuple[Expr, Expr]]  # equi-join key pairs (left expr, right expr)
    filter: Optional[Expr]  # residual non-equi condition over combined schema
    schema: Schema
    # LEFTANTI only: SQL `NOT IN` 3VL semantics (empty build side passes every
    # probe row; any NULL build key passes none; NULL probe keys never pass).
    # on[0] is the IN-arg pair, on[1:] are correlation pairs.
    null_aware: bool = False

    def inputs(self):
        return [self.left, self.right]

    def with_inputs(self, inputs):
        return Join(inputs[0], inputs[1], self.join_type, self.on, self.filter,
                    self.schema, self.null_aware)

    def _label(self):
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        resid = f" filter={self.filter}" if self.filter is not None else ""
        na = " null_aware" if self.null_aware else ""
        return f"Join({self.join_type}{na}): on [{on}]{resid}"


@dataclass(eq=False)
class CrossJoin(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    schema: Schema

    def inputs(self):
        return [self.left, self.right]

    def with_inputs(self, inputs):
        return CrossJoin(inputs[0], inputs[1], self.schema)


@dataclass(eq=False)
class Aggregate(LogicalPlan):
    """Parity: src/sql/logical/aggregate.rs (getGroupSets/getNamedAggCalls)."""

    input: LogicalPlan
    group_exprs: List[Expr]
    agg_exprs: List[AggExpr]
    schema: Schema  # group fields then agg fields

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return Aggregate(inputs[0], self.group_exprs, self.agg_exprs, self.schema)

    def _label(self):
        return (
            "Aggregate: groupBy=["
            + ", ".join(map(str, self.group_exprs))
            + "] aggs=["
            + ", ".join(map(str, self.agg_exprs))
            + "]"
        )


@dataclass(eq=False)
class Window(LogicalPlan):
    """Parity: src/sql/logical/window.rs (getGroups/getWindowFrame)."""

    input: LogicalPlan
    window_exprs: List[WindowExpr]
    schema: Schema  # input fields + one per window expr

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return Window(inputs[0], self.window_exprs, self.schema)


@dataclass(eq=False)
class Sort(LogicalPlan):
    """Parity: src/sql/logical/sort.rs (getCollation + getNumRows for top-k)."""

    input: LogicalPlan
    keys: List[SortKey]
    schema: Schema
    fetch: Optional[int] = None

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return Sort(inputs[0], self.keys, self.schema, self.fetch)

    def _label(self):
        ks = ", ".join(
            f"{k.expr} {'ASC' if k.ascending else 'DESC'}"
            + ("" if k.nulls_first is None
               else (" NULLS FIRST" if k.nulls_first else " NULLS LAST"))
            for k in self.keys
        )
        return f"Sort: [{ks}]" + (f" fetch={self.fetch}" if self.fetch is not None else "")


@dataclass(eq=False)
class Limit(LogicalPlan):
    """Parity: src/sql/logical/limit.rs (getSkip/getFetch)."""

    input: LogicalPlan
    skip: int
    fetch: Optional[int]
    schema: Schema

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return Limit(inputs[0], self.skip, self.fetch, self.schema)

    def _label(self):
        return f"Limit: skip={self.skip} fetch={self.fetch}"


@dataclass(eq=False)
class Union(LogicalPlan):
    children: List[LogicalPlan]
    all: bool
    schema: Schema

    def inputs(self):
        return list(self.children)

    def with_inputs(self, inputs):
        return Union(list(inputs), self.all, self.schema)


@dataclass(eq=False)
class Intersect(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    all: bool
    schema: Schema

    def inputs(self):
        return [self.left, self.right]

    def with_inputs(self, inputs):
        return Intersect(inputs[0], inputs[1], self.all, self.schema)


@dataclass(eq=False)
class Except(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    all: bool
    schema: Schema

    def inputs(self):
        return [self.left, self.right]

    def with_inputs(self, inputs):
        return Except(inputs[0], inputs[1], self.all, self.schema)


@dataclass(eq=False)
class Distinct(LogicalPlan):
    input: LogicalPlan
    schema: Schema

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return Distinct(inputs[0], self.schema)


@dataclass(eq=False)
class Values(LogicalPlan):
    rows: List[List[Expr]]  # literal expressions
    schema: Schema


@dataclass(eq=False)
class EmptyRelation(LogicalPlan):
    schema: Schema
    produce_one_row: bool = False


@dataclass(eq=False)
class SubqueryAlias(LogicalPlan):
    input: LogicalPlan
    alias: str
    schema: Schema

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return SubqueryAlias(inputs[0], self.alias, self.schema)

    def _label(self):
        return f"SubqueryAlias: {self.alias}"


@dataclass(eq=False)
class Sample(LogicalPlan):
    input: LogicalPlan
    method: str  # SYSTEM | BERNOULLI
    fraction: float  # percentage 0-100
    seed: Optional[int]
    schema: Schema

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return Sample(inputs[0], self.method, self.fraction, self.seed, self.schema)


@dataclass(eq=False)
class DistributeBy(LogicalPlan):
    """Parity: physical/rel/custom/distributeby.py — explicit re-shard."""

    input: LogicalPlan
    keys: List[Expr]
    schema: Schema

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return DistributeBy(inputs[0], self.keys, self.schema)


@dataclass(eq=False)
class Explain(LogicalPlan):
    input: LogicalPlan
    schema: Schema
    analyze: bool = False
    lint: bool = False  # EXPLAIN LINT: static verifier findings as rows
    estimate: bool = False  # EXPLAIN ESTIMATE: static cost/memory intervals
    fmt_json: bool = False  # FORMAT JSON: Chrome-trace JSON (with ANALYZE)

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return Explain(inputs[0], self.schema, self.analyze, self.lint,
                       self.estimate, self.fmt_json)


# ---------------------------------------------------------------------------
# Custom nodes: DDL / ML / introspection (parity: Extension nodes, sql.rs:668-814)
# ---------------------------------------------------------------------------
@dataclass(eq=False)
class CustomNode(LogicalPlan):
    """Base for statement nodes handled by `physical/rel/custom` plugins."""

    schema: Schema = field(default_factory=list)


@dataclass(eq=False)
class CreateTableNode(CustomNode):
    name: List[str] = None
    kwargs: Dict[str, Any] = None
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass(eq=False)
class CreateMemoryTableNode(CustomNode):
    name: List[str] = None
    input: LogicalPlan = None
    persist: bool = True  # TABLE persists, VIEW stays lazy
    if_not_exists: bool = False
    or_replace: bool = False

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return CreateMemoryTableNode([], self.name, inputs[0], self.persist,
                                     self.if_not_exists, self.or_replace)


@dataclass(eq=False)
class DropTableNode(CustomNode):
    name: List[str] = None
    if_exists: bool = False


@dataclass(eq=False)
class CreateSchemaNode(CustomNode):
    schema_name: str = ""
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass(eq=False)
class DropSchemaNode(CustomNode):
    schema_name: str = ""
    if_exists: bool = False


@dataclass(eq=False)
class UseSchemaNode(CustomNode):
    schema_name: str = ""


@dataclass(eq=False)
class AlterSchemaNode(CustomNode):
    old_name: str = ""
    new_name: str = ""


@dataclass(eq=False)
class AlterTableNode(CustomNode):
    old_name: List[str] = None
    new_name: str = ""
    if_exists: bool = False


@dataclass(eq=False)
class ShowSchemasNode(CustomNode):
    like: Optional[str] = None


@dataclass(eq=False)
class ShowTablesNode(CustomNode):
    schema_name: Optional[str] = None


@dataclass(eq=False)
class ShowColumnsNode(CustomNode):
    table: List[str] = None


@dataclass(eq=False)
class ShowModelsNode(CustomNode):
    schema_name: Optional[str] = None


@dataclass(eq=False)
class ShowMetricsNode(CustomNode):
    """SHOW METRICS — serving runtime observability (serving/metrics.py)."""

    like: Optional[str] = None


@dataclass(eq=False)
class ShowProfilesNode(CustomNode):
    """SHOW PROFILES — per-fingerprint query profiles
    (observability/profiles.py)."""

    like: Optional[str] = None


@dataclass(eq=False)
class ShowQueriesNode(CustomNode):
    """SHOW QUERIES — the in-flight query table + HBM-ledger summary
    (observability/live.py, observability/ledger.py)."""

    like: Optional[str] = None


@dataclass(eq=False)
class ShowMaterializedNode(CustomNode):
    """SHOW MATERIALIZED — the semantic-reuse state (materialize/):
    pinned sub-plan stems and incremental aggregate states."""

    like: Optional[str] = None


@dataclass(eq=False)
class ShowReplicasNode(CustomNode):
    """SHOW REPLICAS — the fleet router's member table (fleet/router.py):
    state, pressure band, headroom, routed tally per replica."""

    like: Optional[str] = None


@dataclass(eq=False)
class InsertIntoNode(CustomNode):
    """INSERT INTO — the append path (Context.append_rows): delta-epoch
    bump + incremental maintenance instead of wholesale invalidation."""

    name: List[str] = None
    input: LogicalPlan = None

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return InsertIntoNode(self.schema, self.name, inputs[0])


@dataclass(eq=False)
class CancelQueryNode(CustomNode):
    """CANCEL QUERY '<qid>' — cooperative in-flight cancellation
    (observability/live.py -> QueryTicket)."""

    qid: str = ""


@dataclass(eq=False)
class AnalyzeTableNode(CustomNode):
    table: List[str] = None
    columns: List[str] = None


@dataclass(eq=False)
class CreateModelNode(CustomNode):
    name: List[str] = None
    kwargs: Dict[str, Any] = None
    input: LogicalPlan = None
    if_not_exists: bool = False
    or_replace: bool = False

    def inputs(self):
        return [self.input] if self.input is not None else []


@dataclass(eq=False)
class DropModelNode(CustomNode):
    name: List[str] = None
    if_exists: bool = False


@dataclass(eq=False)
class DescribeModelNode(CustomNode):
    name: List[str] = None


@dataclass(eq=False)
class ExportModelNode(CustomNode):
    name: List[str] = None
    kwargs: Dict[str, Any] = None


@dataclass(eq=False)
class CreateExperimentNode(CustomNode):
    name: List[str] = None
    kwargs: Dict[str, Any] = None
    input: LogicalPlan = None
    if_not_exists: bool = False
    or_replace: bool = False

    def inputs(self):
        return [self.input] if self.input is not None else []


@dataclass(eq=False)
class PredictModelNode(CustomNode):
    model_name: List[str] = None
    input: LogicalPlan = None

    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return PredictModelNode(self.schema, self.model_name, inputs[0])


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------
def transform_plan(plan: LogicalPlan, fn) -> LogicalPlan:
    """Bottom-up plan rewrite."""
    kids = [transform_plan(c, fn) for c in plan.inputs()]
    return fn(plan.with_inputs(kids))


def walk_plan(plan: LogicalPlan):
    yield plan
    for c in plan.inputs():
        yield from walk_plan(c)
