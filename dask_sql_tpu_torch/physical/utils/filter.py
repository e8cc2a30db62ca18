"""Predicate -> pyarrow DNF filter conversion for parquet IO pruning.

Role parity: reference physical/utils/filter.py:17 `attempt_predicate_pushdown`
(extracts a DNF expression from the task graph and regenerates the IO layer
with `filters=`) and the Rust-side DNF extraction (table_scan.rs:52
`_expand_dnf_filter`).  Here the optimizer has already pushed conjuncts into
`TableScan.filters`; this module translates the convertible subset into
pyarrow row-group filters so the reader skips data — the remaining predicates
still run on device afterwards (safe double-filtering).

Copied from `dask_sql_tpu/physical/utils/filter.py`, but for one repair: a
literal compared with a FLOAT column goes to pyarrow as float32, the
precision the device compares in (the reference passes the double, and
pyarrow then compares in double and drops rows such as ``x <= 0.09`` where
x is float32 0.09, which the device filter keeps).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from ...columnar.dtypes import DATETIME_TYPES, SqlType
from ...planner.expressions import (
    ColumnRef,
    Expr,
    InArrayExpr,
    InListExpr,
    Literal,
    ScalarFunc,
)

_OP_MAP = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}


def _literal_value(lit: Literal, compared_type: Optional[SqlType] = None):
    """The literal as pyarrow compares it with a column of
    `compared_type`."""
    if lit.sql_type in DATETIME_TYPES:
        return np.datetime64(int(lit.value), "ns")
    if compared_type in (SqlType.FLOAT, SqlType.REAL) \
            and isinstance(lit.value, (int, float)) \
            and not isinstance(lit.value, bool):
        return np.float32(lit.value)
    return lit.value


def conjunct_to_filter(expr: Expr, field_names: List[str]) -> Optional[Tuple[str, str, Any]]:
    """One conjunct -> (column, op, value), or None when not convertible."""
    if isinstance(expr, ScalarFunc) and expr.op in _OP_MAP and len(expr.args) == 2:
        a0, b0 = expr.args
        a = _strip_cast(a0)
        b = _strip_cast(b0)
        if isinstance(a, ColumnRef) and isinstance(b, Literal) and b.value is not None:
            return (field_names[a.index], _OP_MAP[expr.op],
                    _literal_value(b, a0.sql_type))
        if isinstance(b, ColumnRef) and isinstance(a, Literal) and a.value is not None:
            return (field_names[b.index], _FLIP[_OP_MAP[expr.op]],
                    _literal_value(a, b0.sql_type))
        return None
    if isinstance(expr, InListExpr):
        arg = _strip_cast(expr.arg)
        if isinstance(arg, ColumnRef) and all(
                isinstance(i, Literal) and i.value is not None for i in expr.items):
            op = "not in" if expr.negated else "in"
            return (field_names[arg.index], op,
                    [_literal_value(i, expr.arg.sql_type) for i in expr.items])
        return None
    if isinstance(expr, InArrayExpr):
        arg = _strip_cast(expr.arg)
        if isinstance(arg, ColumnRef):
            vals = np.asarray(expr.values)
            if arg.sql_type in DATETIME_TYPES:
                vals = vals.astype(np.int64).view("datetime64[ns]")
            op = "not in" if expr.negated else "in"
            return (field_names[arg.index], op, list(vals))
        return None
    if isinstance(expr, ScalarFunc) and expr.op in ("is_null", "is_not_null"):
        arg = _strip_cast(expr.args[0])
        if isinstance(arg, ColumnRef):
            # pyarrow accepts in/== against None via "is null"-less syntax only
            return None
        return None
    return None


def _strip_cast(e: Expr) -> Expr:
    from ...planner.expressions import Cast

    while isinstance(e, Cast):
        e = e.arg
    return e


def filters_to_pyarrow(conjuncts: List[Expr], field_names: List[str]):
    """Convertible conjuncts -> pyarrow filters list (AND semantics), plus a
    flag telling whether every conjunct was converted."""
    out = []
    complete = True
    for c in conjuncts:
        f = conjunct_to_filter(c, field_names)
        if f is None:
            complete = False
        else:
            out.append(f)
    return (out or None), complete
