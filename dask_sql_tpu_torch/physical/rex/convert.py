"""Rex converter: typed Expr -> Column over a Table.

Counterpart of `dask_sql_tpu/physical/rex/convert.py`.  Column references
pass through; every other expression is evaluated by the pipeline's
evaluator (`physical/compiled.py` `_TraceEval`: literals, casts,
arithmetic and division, comparisons, AND/OR/NOT, CASE, IN lists, LIKE,
the IS predicates, math, EXTRACT and datetime arithmetic, COALESCE), so the
eager operators and the fused pipelines share one set of semantics.  This
converter runs the expression's subquery plans through the executor first
and hands their results to the evaluator: a scalar subquery's first value,
an ``IN (subquery)`` mask and an EXISTS flag.  String-valued expressions
other than column references and SUBSTRING with constant offsets are not
in the port yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...columnar.column import Column, torch_dtype
from ...columnar.dtypes import STRING_TYPES, sql_to_np
from ...columnar.table import Table
from ...planner.expressions import (
    ColumnRef,
    ExistsExpr,
    Expr,
    InSubqueryExpr,
    ScalarFunc,
    ScalarSubqueryExpr,
    walk,
)
from ...utils import host_ints


class RexConverter:
    """Evaluates bound expressions over a Table; `executor` runs the plans
    of subquery expressions."""

    def __init__(self, executor=None):
        self.executor = executor

    def convert(self, expr: Expr, table: Table) -> Column:
        if isinstance(expr, ColumnRef) and type(expr) is ColumnRef:
            return table.columns[table.column_names[expr.index]]
        from ..compiled import SUBQUERY_SLOT, _TraceEval, _Unsupported

        substring = isinstance(expr, ScalarFunc) and expr.op == "substring"
        if expr.sql_type in STRING_TYPES and not substring:
            raise NotImplementedError(
                f"string-valued expression {expr} not in the port yet")
        slots: Dict = {i: (c.data, c.validity)
                       for i, c in enumerate(table.columns.values())}
        for sub in walk(expr):
            if isinstance(sub, (ScalarSubqueryExpr, InSubqueryExpr,
                                ExistsExpr)):
                slots[(SUBQUERY_SLOT, id(sub))] = self._subquery(sub, table)
        ev = _TraceEval(table, eager=True)
        n = table.num_rows
        try:
            if substring:
                codes, valid, dictionary, _ = ev.string_operand(expr, slots)
                return Column(codes, expr.sql_type, valid, dictionary)
            data, valid = ev.eval(expr, slots)
        except _Unsupported as e:
            raise NotImplementedError(
                f"expression {expr} not in the port yet: {e}") from e
        data = data.expand(n) if data.dim() == 0 else data
        if valid is not None and valid.dim() == 0:
            valid = valid.expand(n)
        return Column(data, expr.sql_type, valid)

    def _subquery(self, expr: Expr, table: Table):
        """A subquery's result as the evaluator takes it, on `table`'s
        device: ``(data, validity)``, 0-dim for a scalar and a flag, per row
        for a membership.  An aggregate's result lives on the host; it
        moves to the table's device here."""
        device = table.device
        sub = self.executor.execute(expr.plan)
        if isinstance(expr, ExistsExpr):
            exists = sub.num_rows > 0
            flag = (not exists) if expr.negated else exists
            return torch.tensor(flag, dtype=torch.bool, device=device), None
        col = sub.columns[sub.column_names[0]]
        if isinstance(expr, ScalarSubqueryExpr):
            if col.sql_type in STRING_TYPES:
                raise NotImplementedError(
                    "string-valued scalar subquery not in the port yet")
            if sub.num_rows == 0:
                dtype = torch_dtype(sql_to_np(expr.sql_type))
                return (torch.zeros((), dtype=dtype, device=device),
                        torch.zeros((), dtype=torch.bool, device=device))
            first = col.decode().slice(0, 1).to(device)
            valid = None if first.validity is None else first.validity[0]
            return first.data[0], valid
        return self._in_subquery(expr, table, col.to(device))

    def _in_subquery(self, expr: InSubqueryExpr, table: Table, sub_col):
        """``arg [NOT] IN (subquery)``: NULL where the argument is NULL, or
        where it has no match and the subquery holds a NULL."""
        from ...ops.join import join_key_gids, semi_join_mask

        arg = self.convert(expr.arg, table)
        lgid, rgid = join_key_gids([arg], [sub_col])
        mask = semi_join_mask(lgid, rgid)
        value = ~mask if expr.negated else mask
        sub_has_null = False
        if sub_col.validity is not None and len(sub_col):
            (all_valid,) = host_ints(sub_col.validity.all())
            sub_has_null = not all_valid
        known = mask | (not sub_has_null)
        if arg.validity is not None:
            known = known & arg.validity
        return value, known
