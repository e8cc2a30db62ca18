"""SQL abstract syntax tree.

Copied from `dask_sql_tpu/planner/sqlast.py`; only import paths differ.

Role parity: sqlparser-rs's AST plus the dask-specific statements the reference
adds in `src/parser.rs:336` (DaskStatement enum: CreateModel, CreateExperiment,
PredictModel, ExportModel, DescribeModel, ShowSchemas/Tables/Columns/Models,
AnalyzeTable, AlterTable/Schema, UseSchema, CreateCatalogSchema, CreateTable
WITH(...), DropModel/Table/Schema).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------
class Expr:
    pass


@dataclass
class Identifier(Expr):
    parts: List[str]  # a.b.c
    quoted: List[bool] = None

    @property
    def name(self) -> str:
        return self.parts[-1]


@dataclass
class Wildcard(Expr):
    qualifier: Optional[List[str]] = None  # t.* -> ['t']


@dataclass
class Literal(Expr):
    value: Any  # python scalar; None for NULL
    type_name: Optional[str] = None  # e.g. DATE '...', TIMESTAMP '...'


@dataclass
class IntervalLiteral(Expr):
    value: str
    unit: str  # DAY, MONTH, YEAR, HOUR, MINUTE, SECOND, or compound "DAY TO SECOND"


@dataclass
class UnaryOp(Expr):
    op: str  # -, +, NOT
    operand: Expr


@dataclass
class BinaryOp(Expr):
    op: str  # +,-,*,/,%,=,<>,<,<=,>,>=,AND,OR,||
    left: Expr
    right: Expr


@dataclass
class Cast(Expr):
    operand: Expr
    type_name: str
    safe: bool = False  # TRY_CAST


@dataclass
class Case(Expr):
    operand: Optional[Expr]  # CASE x WHEN ... vs CASE WHEN ...
    whens: List[Tuple[Expr, Expr]]
    else_: Optional[Expr]


@dataclass
class FunctionCall(Expr):
    name: str
    args: List[Expr]
    distinct: bool = False
    filter: Optional[Expr] = None  # FILTER (WHERE ...)
    over: Optional["WindowSpec"] = None
    ignore_nulls: bool = False


@dataclass
class WindowSpec:
    partition_by: List[Expr] = field(default_factory=list)
    order_by: List["OrderItem"] = field(default_factory=list)
    frame: Optional["WindowFrame"] = None


@dataclass
class WindowFrame:
    units: str  # ROWS | RANGE
    start: Tuple[str, Optional[Expr]]  # (kind, offset) kind in {UNBOUNDED_PRECEDING, PRECEDING, CURRENT_ROW, FOLLOWING, UNBOUNDED_FOLLOWING}
    end: Tuple[str, Optional[Expr]]


@dataclass
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False
    symmetric: bool = False


@dataclass
class InList(Expr):
    operand: Expr
    items: List[Expr]
    negated: bool = False


@dataclass
class InSubquery(Expr):
    operand: Expr
    subquery: "Select"
    negated: bool = False


@dataclass
class Exists(Expr):
    subquery: "Select"
    negated: bool = False


@dataclass
class ScalarSubquery(Expr):
    subquery: "Select"


@dataclass
class Like(Expr):
    operand: Expr
    pattern: Expr
    negated: bool = False
    case_insensitive: bool = False  # ILIKE
    similar: bool = False  # SIMILAR TO
    escape: Optional[str] = None


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass
class IsBool(Expr):
    operand: Expr
    value: bool  # IS TRUE / IS FALSE
    negated: bool = False


@dataclass
class IsDistinctFrom(Expr):
    left: Expr
    right: Expr
    negated: bool = False


@dataclass
class Extract(Expr):
    unit: str
    operand: Expr


@dataclass
class Substring(Expr):
    operand: Expr
    start: Optional[Expr]
    length: Optional[Expr]


@dataclass
class Trim(Expr):
    operand: Expr
    where: str  # BOTH | LEADING | TRAILING
    chars: Optional[Expr]


@dataclass
class Position(Expr):
    needle: Expr
    haystack: Expr


@dataclass
class Overlay(Expr):
    operand: Expr
    replacement: Expr
    start: Expr
    length: Optional[Expr]


@dataclass
class CeilFloorTo(Expr):
    """CEIL(ts TO DAY) / FLOOR(ts TO MONTH) — reference dialect.rs:48 rewrites."""

    func: str  # CEIL | FLOOR
    operand: Expr
    unit: str


@dataclass
class Alias(Expr):
    operand: Expr
    name: str


# ---------------------------------------------------------------------------
# Query structure
# ---------------------------------------------------------------------------
@dataclass
class GroupingSets(Expr):
    sets: List[List[Expr]]


@dataclass
class Rollup(Expr):
    exprs: List[Expr]


@dataclass
class Cube(Expr):
    exprs: List[Expr]


@dataclass
class OrderItem:
    expr: Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = dialect default (nulls last for asc)


@dataclass
class TableRef:
    pass


@dataclass
class NamedTable(TableRef):
    parts: List[str]
    alias: Optional[str] = None
    sample: Optional[Tuple[str, float, Optional[int]]] = None  # (SYSTEM|BERNOULLI, fraction%, seed)


@dataclass
class DerivedTable(TableRef):
    subquery: "Select"
    alias: Optional[str] = None


@dataclass
class TableFunction(TableRef):
    """PREDICT(MODEL m, SELECT ...) in the FROM clause (reference parser.rs PredictModel)."""

    name: str
    model_name: List[str]
    subquery: "Select"
    alias: Optional[str] = None


@dataclass
class Join(TableRef):
    left: TableRef
    right: TableRef
    join_type: str  # INNER, LEFT, RIGHT, FULL, CROSS, LEFT SEMI, LEFT ANTI
    condition: Optional[Expr] = None
    using: Optional[List[str]] = None


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class Select:
    """A full query expression: SELECT core + set ops + order/limit, with CTEs."""

    projections: List[SelectItem] = field(default_factory=list)
    from_: Optional[TableRef] = None
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    distinct: bool = False
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    ctes: List[Tuple[str, "Select"]] = field(default_factory=list)
    set_op: Optional[Tuple[str, bool, "Select"]] = None  # (UNION|INTERSECT|EXCEPT, all, rhs)
    distribute_by: List[Expr] = field(default_factory=list)
    values: Optional[List[List[Expr]]] = None  # VALUES (...) , (...)
    named_windows: Dict[str, "WindowSpec"] = field(default_factory=dict)  # WINDOW w AS (...)


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------
class Statement:
    pass


@dataclass
class QueryStatement(Statement):
    query: Select


@dataclass
class ExplainStatement(Statement):
    """EXPLAIN [ANALYZE|LINT|ESTIMATE] [FORMAT JSON] <query> — LINT runs
    the static plan verifier (analysis/verifier.py), ESTIMATE the static
    cost & memory abstract interpreter (analysis/estimator.py); both return
    their findings as a result set without executing the query.  FORMAT
    JSON with ANALYZE emits the query-lifecycle trace as Chrome-trace JSON
    (observability/spans.py) instead of the text tree."""

    query: Select
    analyze: bool = False
    lint: bool = False
    estimate: bool = False
    fmt_json: bool = False


@dataclass
class CreateTableWith(Statement):
    """CREATE TABLE t WITH (location=..., format=..., persist=..., backend=...)."""

    name: List[str]
    kwargs: Dict[str, Any]
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class CreateTableAs(Statement):
    name: List[str]
    query: Select
    persist: bool = True  # TABLE persists; VIEW stays lazy (create_memory_table.py)
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropTable(Statement):
    name: List[str]
    if_exists: bool = False


@dataclass
class CreateSchema(Statement):
    name: str
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropSchema(Statement):
    name: str
    if_exists: bool = False


@dataclass
class UseSchema(Statement):
    name: str


@dataclass
class AlterSchema(Statement):
    old_name: str
    new_name: str


@dataclass
class AlterTable(Statement):
    old_name: List[str]
    new_name: str
    if_exists: bool = False


@dataclass
class ShowSchemas(Statement):
    like: Optional[str] = None


@dataclass
class ShowTables(Statement):
    schema: Optional[str] = None


@dataclass
class ShowColumns(Statement):
    table: List[str] = None


@dataclass
class ShowModels(Statement):
    schema: Optional[str] = None


@dataclass
class ShowMetrics(Statement):
    """SHOW METRICS: serving-runtime counters/histograms as a result set."""

    like: Optional[str] = None


@dataclass
class ShowProfiles(Statement):
    """SHOW PROFILES: per-fingerprint query profiles (observability/
    profiles.py — hits, exec/compile wall times, result bytes)."""

    like: Optional[str] = None


@dataclass
class ShowQueries(Statement):
    """SHOW QUERIES: the in-flight query table (observability/live.py —
    live stage/rung/batch-role/stream-progress per admitted query) plus
    the HBM-ledger summary block."""

    like: Optional[str] = None


@dataclass
class ShowMaterialized(Statement):
    """SHOW MATERIALIZED: the semantic-reuse state (materialize/) —
    pinned sub-plan stems (rows/bytes/hits) and incrementally-maintained
    aggregate states, one row each."""

    like: Optional[str] = None


@dataclass
class ShowReplicas(Statement):
    """SHOW REPLICAS: the fleet router's member table (fleet/router.py) —
    one row per replica (plus the warm standby): lifecycle state, pressure
    band, ledger headroom, routed-query tally."""

    like: Optional[str] = None


@dataclass
class InsertInto(Statement):
    """INSERT INTO t VALUES ... / INSERT INTO t SELECT ...: the append
    path (Context.append_rows) — rows concat onto the existing container,
    only the per-table delta epoch bumps, and the semantic reuse tiers
    (materialize/) fold the delta instead of rescanning history."""

    table: List[str] = None
    query: Any = None  # a Select (SELECT or VALUES body)


@dataclass
class CancelQuery(Statement):
    """CANCEL QUERY '<qid>': cooperative cancellation of an in-flight
    query through its `QueryTicket` (executor checkpoints raise at the
    next poll)."""

    qid: str = ""


@dataclass
class AnalyzeTable(Statement):
    table: List[str]
    columns: List[str] = field(default_factory=list)


@dataclass
class CreateModel(Statement):
    name: List[str]
    kwargs: Dict[str, Any]
    query: Select
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropModel(Statement):
    name: List[str]
    if_exists: bool = False


@dataclass
class DescribeModel(Statement):
    name: List[str]


@dataclass
class ExportModel(Statement):
    name: List[str]
    kwargs: Dict[str, Any]


@dataclass
class CreateExperiment(Statement):
    name: List[str]
    kwargs: Dict[str, Any]
    query: Select
    if_not_exists: bool = False
    or_replace: bool = False
