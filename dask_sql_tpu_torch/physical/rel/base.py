"""Base plugin for relational converters (counterpart of
`dask_sql_tpu/physical/rel/base.py`)."""
from __future__ import annotations

from typing import List

from ...columnar.table import Table
from ...planner.expressions import Schema
from ...planner.plan import LogicalPlan


class BaseRelPlugin:
    class_name: str = ""

    def convert(self, rel: LogicalPlan, executor) -> Table:
        raise NotImplementedError

    @staticmethod
    def assert_inputs(rel: LogicalPlan, n: int, executor) -> List[Table]:
        inputs = rel.inputs()
        if len(inputs) != n:
            raise ValueError(f"{rel.node_type} expects {n} inputs")
        return [executor.execute(i) for i in inputs]

    @staticmethod
    def fix_column_to_row_type(table: Table, schema: Schema) -> Table:
        """Rename positional columns to the plan's field names (made unique)."""
        names = unique_names([f.name for f in schema])
        cols = {}
        for new, old in zip(names, table.column_names):
            cols[new] = table.columns[old]
        return Table(cols, table.num_rows, table.device)


def unique_names(names: List[str]) -> List[str]:
    """Disambiguate duplicates with __N suffixes, collision-proof against
    inputs that already carry a suffix (Table columns are a dict, so a
    collision would silently drop a column)."""
    seen = set()
    counts: dict = {}
    out = []
    for n in names:
        if n not in seen:
            seen.add(n)
            out.append(n)
            continue
        i = counts.get(n, 0) + 1
        cand = f"{n}__{i}"
        while cand in seen:
            i += 1
            cand = f"{n}__{i}"
        counts[n] = i
        seen.add(cand)
        out.append(cand)
    return out
