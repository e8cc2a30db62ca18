"""Rex converter: typed Expr -> Column over a Table.

Counterpart of `dask_sql_tpu/physical/rex/convert.py`.  Column references
pass through; every other expression is evaluated by the pipeline's
evaluator (`physical/compiled.py` `_TraceEval`: literals, casts,
arithmetic and division, comparisons, AND/OR/NOT, CASE, IN lists, LIKE,
the IS predicates, math and ROUND, EXTRACT and datetime arithmetic,
COALESCE, and the rest of the reference's registry in
`rex/operations.py`), so the eager operators and the fused pipelines share
one set of semantics.  This converter runs the expression's subquery plans
through the executor and calls its user functions first, and hands their
results to the evaluator: a scalar subquery's first value (a number or a
string), an ``IN (subquery)`` mask, an EXISTS flag, a function's column.
A string-valued expression becomes codes over a host dictionary
(`_TraceEval.string_operand`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...columnar.column import Column, torch_dtype
from ...columnar.dtypes import STRING_TYPES, sql_to_np
from ...columnar.table import Table
from ...planner.expressions import (
    ColumnRef,
    ExistsExpr,
    Expr,
    InSubqueryExpr,
    ScalarSubqueryExpr,
    UdfExpr,
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
        from ..compiled import SUBQUERY_SLOT, UDF_SLOT, _TraceEval, _Unsupported

        slots: Dict = {i: (c.data, c.validity)
                       for i, c in enumerate(table.columns.values())}
        for sub in _outer_calls(expr):
            if isinstance(sub, UdfExpr):
                slots[(UDF_SLOT, id(sub))] = _operand(self._udf(sub, table))
            else:
                slots[(SUBQUERY_SLOT, id(sub))] = self._subquery(sub, table)
        ev = _TraceEval(table, eager=True)
        n = table.num_rows
        try:
            if expr.sql_type in STRING_TYPES:
                got = ev.string_operand(expr, slots)
                if got is None:
                    raise NotImplementedError(
                        f"string-valued expression {expr} not in the port yet")
                data, valid, dictionary, _ = got
            else:
                data, valid = ev.eval(expr, slots)
                dictionary = None
        except _Unsupported as e:
            raise NotImplementedError(
                f"expression {expr} not in the port yet: {e}") from e
        data = data.expand(n) if data.dim() == 0 else data
        if valid is not None and valid.dim() == 0:
            valid = valid.expand(n)
        return Column(data, expr.sql_type, valid, dictionary)

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
            if sub.num_rows == 0:
                dtype = torch_dtype(sql_to_np(expr.sql_type))
                null = (torch.zeros((), dtype=dtype, device=device),
                        torch.zeros((), dtype=torch.bool, device=device))
                if col.sql_type in STRING_TYPES:
                    return null + (np.array([""], dtype=object), ("null",))
                return null
            first = col.decode().slice(0, 1).to(device)
            valid = None if first.validity is None else first.validity[0]
            if col.sql_type in STRING_TYPES:
                # a string operand: its code over the column's dictionary
                return (first.data[0], valid, col.dictionary,
                        ("subquery", id(expr)))
            return first.data[0], valid
        return self._in_subquery(expr, table, col.to(device))

    def _udf(self, expr: UdfExpr, table: Table) -> Column:
        """A registered function's column (the reference's `_udf`).  A
        tensor function takes the argument tensors on the table's device
        (the reference hands it jax arrays) and its result goes to that
        device in the return type's dtype.  A row function takes each row
        as a pandas Series of its parameters, on the host, as in the
        reference.  NULL where an argument is NULL (a tensor function) or
        where the row function returns None.  A row function polls the
        query's serving ticket before each row, as the reference's does: a
        host loop over rows is the longest stretch of a plan, and a cancel
        or a deadline takes effect inside it."""
        import pandas as pd

        from ...serving.runtime import current_ticket

        fd = self.executor.lookup_function(
            expr.name, [a.sql_type for a in expr.args])
        args = [self.convert(a, table) for a in expr.args]
        device = table.device
        if fd.row_udf:
            ticket = current_ticket()

            def call(row):
                if ticket is not None:
                    ticket.checkpoint()
                return fd.func(row)

            frame = pd.DataFrame({f"arg{i}": a.to_numpy()
                                  for i, a in enumerate(args)})
            frame.columns = [p[0] for p in fd.parameters][: len(args)]
            out = frame.apply(call, axis=1).to_numpy() if len(frame) \
                else np.zeros(0, dtype=sql_to_np(fd.return_type))
            col = Column.from_numpy(np.asarray(out), device=device,
                                    encode=False)
        else:
            out = fd.func(*[a.data for a in args])
            data = torch.as_tensor(out, device=device).to(
                torch_dtype(sql_to_np(fd.return_type)))
            if data.dim() == 0:
                data = data.expand(table.num_rows)
            valid = None
            for a in args:
                if a.validity is not None:
                    av = a.valid_mask()
                    valid = av if valid is None else (valid & av)
            col = Column(data, fd.return_type, valid)
        return col.cast(fd.return_type) if col.sql_type != fd.return_type \
            else col

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


def _outer_calls(expr: Expr):
    """The subquery expressions and user-function calls of `expr` that no
    other such call encloses (a call's own arguments are converted when it
    runs)."""
    stack = [expr]
    while stack:
        e = stack.pop()
        if isinstance(e, (ScalarSubqueryExpr, InSubqueryExpr, ExistsExpr,
                          UdfExpr)):
            yield e
            continue
        stack.extend(e.children())


def _operand(col: Column):
    """A converted column as the evaluator's slot: (data, validity), with
    its dictionary and a key for a string."""
    if col.sql_type in STRING_TYPES:
        return col.data, col.validity, col.dictionary, ("udf", id(col))
    return col.data, col.validity
