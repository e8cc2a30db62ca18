"""Rex converter: typed Expr -> Column over a Table.

Counterpart of `dask_sql_tpu/physical/rex/convert.py`.  Column references
pass through; every other expression is evaluated by the pipeline's
evaluator (`physical/compiled.py` `_TraceEval`: literals, casts,
arithmetic and division, comparisons, AND/OR/NOT, CASE, IN lists, LIKE,
the IS predicates, math, EXTRACT and datetime arithmetic, COALESCE), so the
eager operators and the fused pipelines share one set of semantics.
String-valued expressions other than column references are not in the
port yet.
"""
from __future__ import annotations

from ...columnar.column import Column
from ...columnar.dtypes import STRING_TYPES
from ...columnar.table import Table
from ...planner.expressions import ColumnRef, Expr


class RexConverter:
    def convert(self, expr: Expr, table: Table) -> Column:
        if isinstance(expr, ColumnRef) and type(expr) is ColumnRef:
            return table.columns[table.column_names[expr.index]]
        from ..compiled import _TraceEval, _Unsupported

        if expr.sql_type in STRING_TYPES:
            raise NotImplementedError(
                f"string-valued expression {expr} not in the port yet")
        slots = {i: (c.data, c.validity)
                 for i, c in enumerate(table.columns.values())}
        try:
            data, valid = _TraceEval(table).eval(expr, slots)
        except _Unsupported as e:
            raise NotImplementedError(
                f"expression {expr} not in the port yet: {e}") from e
        n = table.num_rows
        data = data.expand(n) if data.dim() == 0 else data
        if valid is not None and valid.dim() == 0:
            valid = valid.expand(n)
        return Column(data, expr.sql_type, valid)
