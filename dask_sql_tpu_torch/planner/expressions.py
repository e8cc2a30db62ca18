"""Typed relational expression IR.

Copied from `dask_sql_tpu/planner/expressions.py`; only import paths differ.

Role parity: DataFusion `Expr` as exposed through the reference's `PyExpr`
(src/expression.rs: RexType classification expression.rs:318, operands/operator
expression.rs:333,458, result type expression.rs:511).  Bound, type-annotated,
and column references are positional — ready for the physical rex layer to
lower to jax kernels without name resolution.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, List, Optional, Tuple

import numpy as np

from ..columnar.dtypes import SqlType


class RexType:
    REFERENCE = "RexType.Reference"
    CALL = "RexType.Call"
    LITERAL = "RexType.Literal"
    ALIAS = "RexType.Alias"
    SUBQUERY = "RexType.ScalarSubquery"


@dataclass(frozen=True)
class Field:
    name: str
    sql_type: SqlType
    nullable: bool = True


Schema = List[Field]


class Expr:
    sql_type: SqlType

    @property
    def rex_type(self) -> str:
        return RexType.CALL

    def children(self) -> List["Expr"]:
        return []

    def with_children(self, children: List["Expr"]) -> "Expr":
        return self


@dataclass(frozen=True)
class ColumnRef(Expr):
    index: int
    name: str
    sql_type: SqlType
    nullable: bool = True

    @property
    def rex_type(self) -> str:
        return RexType.REFERENCE

    def __str__(self):
        return f"#{self.index}:{self.name}"


@dataclass(frozen=True)
class Literal(Expr):
    value: Any
    sql_type: SqlType

    @property
    def rex_type(self) -> str:
        return RexType.LITERAL

    def __str__(self):
        return repr(self.value)


@dataclass(frozen=True)
class ParamRef(Expr):
    """A runtime query parameter: slot `index` of the per-query parameter
    vector (families/parameterize.py lifts eligible literals into these).

    Never produced by the binder — the parameterization pass creates them
    post-optimize so one compiled executable can serve a whole *family* of
    queries that differ only in literal values.  The repr/str carries the
    slot and the SQL type but NOT the value: two plans that differ only in
    parameterized literals stringify identically, which is exactly what
    keys the family fingerprint and the compiled-pipeline caches."""

    index: int
    sql_type: SqlType

    @property
    def rex_type(self) -> str:
        return RexType.LITERAL

    def __str__(self):
        return f"?{self.index}:{self.sql_type.name}"


@dataclass(frozen=True)
class InParamExpr(Expr):
    """Membership test against a runtime parameter *vector*: the
    parameterized form of an all-literal ``IN (...)`` list.

    The value list itself lives in the query's parameter vector (slot
    `index`), host-normalized to `cmp_dtype` and padded to the power-of-two
    `length` bucket — so IN lists of 5, 6 and 8 values share one compiled
    kernel (bucket 8) while a 9-value list is its own family.  Padding
    repeats an existing member, which cannot change membership."""

    arg: Expr
    index: int
    length: int  # pow2 value-vector length (the family's bucket)
    cmp_dtype: str  # numpy dtype name the comparison runs in
    negated: bool = False
    sql_type: SqlType = SqlType.BOOLEAN

    def children(self):
        return [self.arg]

    def with_children(self, children):
        return replace(self, arg=children[0])

    def __str__(self):
        neg = " negated" if self.negated else ""
        return (f"in_param({self.arg}, ?{self.index}x{self.length}"
                f":{self.cmp_dtype}{neg})")


@dataclass(frozen=True)
class ScalarFunc(Expr):
    """A call of a named kernel op — the unit the physical rex layer maps.

    Canonical op names are the keys of `physical.rex.operations.OPERATION_MAPPING`
    (parity: reference call.py:1047-1156).
    """

    op: str
    args: Tuple[Expr, ...]
    sql_type: SqlType

    def children(self):
        return list(self.args)

    def with_children(self, children):
        return replace(self, args=tuple(children))

    def __str__(self):
        return f"{self.op}({', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class GroupingExpr(Expr):
    """GROUPING(e1, ...) — binder-internal marker, resolved during grouping
    sets expansion to a per-branch literal bitmask (leftmost arg = most
    significant bit, 1 = aggregated in this set).  Parity: the reference
    surfaces DataFusion's grouping-id through aggregate.rs getGroupSets;
    here the binder lowers it while expanding ROLLUP/CUBE/GROUPING SETS."""

    args: Tuple[Expr, ...]
    sql_type: SqlType

    def children(self):
        return list(self.args)

    def with_children(self, children):
        return replace(self, args=tuple(children))

    def __str__(self):
        return f"grouping({', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class Cast(Expr):
    arg: Expr
    sql_type: SqlType
    safe: bool = False

    def children(self):
        return [self.arg]

    def with_children(self, children):
        return replace(self, arg=children[0])

    def __str__(self):
        return f"CAST({self.arg} AS {self.sql_type})"


@dataclass(frozen=True)
class CaseExpr(Expr):
    whens: Tuple[Tuple[Expr, Expr], ...]
    else_: Optional[Expr]
    sql_type: SqlType

    def children(self):
        out = []
        for c, r in self.whens:
            out += [c, r]
        if self.else_ is not None:
            out.append(self.else_)
        return out

    def with_children(self, children):
        n = len(self.whens)
        whens = tuple((children[2 * i], children[2 * i + 1]) for i in range(n))
        else_ = children[2 * n] if len(children) > 2 * n else None
        return replace(self, whens=whens, else_=else_)


@dataclass(frozen=True)
class InListExpr(Expr):
    arg: Expr
    items: Tuple[Expr, ...]
    negated: bool
    sql_type: SqlType = SqlType.BOOLEAN

    def children(self):
        return [self.arg, *self.items]

    def with_children(self, children):
        return replace(self, arg=children[0], items=tuple(children[1:]))


@dataclass(frozen=True, eq=False)
class InArrayExpr(Expr):
    """Membership test against a bulk host array (plan-time generated filters).

    Role parity: the reference's DynamicPartitionPruning injects `InList`
    filters with thousands of values (dynamic_partition_pruning.rs:1-8);
    carrying them as one numpy array keeps plan walks O(1) in the value
    count and lets the kernels evaluate membership with a single vectorized
    sorted-lookup instead of one comparison per value.

    `values` is already normalized to the comparison domain: numerics keep
    their numpy dtype, datetimes are int64 nanoseconds, strings are an
    object array.  Identity equality (eq=False) — the array payload makes
    structural equality both expensive and unnecessary.
    """

    arg: Expr
    values: Any  # np.ndarray, sorted unique, no nulls
    negated: bool = False
    sql_type: SqlType = SqlType.BOOLEAN

    def children(self):
        return [self.arg]

    def with_children(self, children):
        return replace(self, arg=children[0])

    def __repr__(self):
        # content digest: str(expr) keys compiled-plan caches, so two arrays
        # with equal length but different values must stringify differently
        import hashlib

        v = np.ascontiguousarray(self.values)
        digest = hashlib.sha1(v.tobytes() + str(v.dtype).encode()).hexdigest()[:12]
        return (f"InArray(arg={self.arg!r}, n={len(self.values)}, "
                f"digest={digest}, negated={self.negated})")


@dataclass(frozen=True)
class AggExpr(Expr):
    """Aggregate call inside an Aggregate plan node (parity aggregate.rs:24-58)."""

    func: str
    args: Tuple[Expr, ...]
    sql_type: SqlType
    distinct: bool = False
    filter: Optional[Expr] = None

    def children(self):
        return list(self.args) + ([self.filter] if self.filter is not None else [])

    def with_children(self, children):
        if self.filter is not None:
            return replace(self, args=tuple(children[:-1]), filter=children[-1])
        return replace(self, args=tuple(children))

    def __str__(self):
        inner = ", ".join(map(str, self.args))
        d = "DISTINCT " if self.distinct else ""
        return f"{self.func}({d}{inner})"


@dataclass(frozen=True)
class SortKey:
    expr: Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None

    def nulls_first_resolved(self) -> bool:
        # SQL default: NULLS LAST for ASC, NULLS FIRST for DESC (Calcite/Postgres)
        if self.nulls_first is None:
            return not self.ascending
        return self.nulls_first


@dataclass(frozen=True)
class WindowFrameBound:
    kind: str  # UNBOUNDED_PRECEDING / PRECEDING / CURRENT_ROW / FOLLOWING / UNBOUNDED_FOLLOWING
    offset: Optional[int] = None


@dataclass(frozen=True)
class WindowSpec:
    partition_by: Tuple[Expr, ...]
    order_by: Tuple[SortKey, ...]
    units: str = "ROWS"  # ROWS | RANGE
    start: WindowFrameBound = WindowFrameBound("UNBOUNDED_PRECEDING")
    end: WindowFrameBound = WindowFrameBound("CURRENT_ROW")
    explicit_frame: bool = False


@dataclass(frozen=True)
class WindowExpr(Expr):
    func: str
    args: Tuple[Expr, ...]
    spec: WindowSpec
    sql_type: SqlType
    ignore_nulls: bool = False

    def children(self):
        return (list(self.args) + list(self.spec.partition_by)
                + [k.expr for k in self.spec.order_by])

    def with_children(self, children):
        na, np_ = len(self.args), len(self.spec.partition_by)
        args = tuple(children[:na])
        part = tuple(children[na : na + np_])
        order = tuple(
            replace(k, expr=children[na + np_ + i]) for i, k in enumerate(self.spec.order_by)
        )
        return replace(self, args=args, spec=replace(self.spec, partition_by=part, order_by=order))


@dataclass(frozen=True)
class ScalarSubqueryExpr(Expr):
    plan: Any  # LogicalPlan
    sql_type: SqlType

    @property
    def rex_type(self) -> str:
        return RexType.SUBQUERY


@dataclass(frozen=True)
class InSubqueryExpr(Expr):
    arg: Expr
    plan: Any  # LogicalPlan producing one column
    negated: bool
    sql_type: SqlType = SqlType.BOOLEAN

    def children(self):
        return [self.arg]

    def with_children(self, children):
        return replace(self, arg=children[0])


@dataclass(frozen=True)
class ExistsExpr(Expr):
    plan: Any
    negated: bool
    sql_type: SqlType = SqlType.BOOLEAN


@dataclass(frozen=True)
class UdfExpr(Expr):
    """Call of a user-registered function (context.register_function parity)."""

    name: str
    args: Tuple[Expr, ...]
    sql_type: SqlType
    row_udf: bool = False

    def children(self):
        return list(self.args)

    def with_children(self, children):
        return replace(self, args=tuple(children))


# ---------------------------------------------------------------------------
# Traversal helpers
# ---------------------------------------------------------------------------
def walk(expr: Expr):
    yield expr
    for c in expr.children():
        yield from walk(c)


def transform(expr: Expr, fn) -> Expr:
    """Bottom-up rewrite."""
    kids = [transform(c, fn) for c in expr.children()]
    return fn(expr.with_children(kids))


def referenced_columns(expr: Expr) -> set:
    return {e.index for e in walk(expr) if isinstance(e, ColumnRef)}


def shift_columns(expr: Expr, delta: int) -> Expr:
    def fn(e):
        if isinstance(e, ColumnRef):
            return replace(e, index=e.index + delta)
        return e

    return transform(expr, fn)


def remap_columns(expr: Expr, mapping: dict) -> Expr:
    def fn(e):
        if isinstance(e, ColumnRef):
            return replace(e, index=mapping[e.index])
        return e

    return transform(expr, fn)
