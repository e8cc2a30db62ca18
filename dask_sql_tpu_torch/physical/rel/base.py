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
    def assert_inputs(rel: LogicalPlan, n: int, executor,
                      keep_shards: bool = False) -> List[Table]:
        """The inputs' tables.  A sharded input reaches a plugin with no
        sharded path as its global rows (`gather_global`); one that has
        such a path asks for the blocks with ``keep_shards``."""
        inputs = rel.inputs()
        if len(inputs) != n:
            raise ValueError(f"{rel.node_type} expects {n} inputs")
        tables = [executor.execute(i) for i in inputs]
        if keep_shards:
            return tables
        return [gather_global(t, executor) for t in tables]

    @staticmethod
    def fix_column_to_row_type(table: Table, schema: Schema) -> Table:
        """Rename positional columns to the plan's field names (made
        unique); a sharded table keeps its blocks."""
        names = unique_names([f.name for f in schema])
        cols = {}
        for new, old in zip(names, table.column_names):
            cols[new] = table.columns[old]
        return Table(cols, table.num_rows, table.device, table.sharding)

    @staticmethod
    def fix_dtype_to_row_type(table: Table, schema: Schema) -> Table:
        """Cast each column to the type of its field in `schema`."""
        cols = {}
        for name, f in zip(table.column_names, schema):
            col = table.columns[name]
            if col.sql_type != f.sql_type:
                col = col.cast(f.sql_type)
            cols[name] = col
        return Table(cols, table.num_rows, table.device)


def gather_global(table: Table, executor) -> Table:
    """The global rows of a sharded table, for an operator with no sharded
    path: the columns on the mesh's first shard's device (where the
    blocks share that device, the loaded columns themselves; the
    reference's implicit all-gather of a sharded array), counted in
    ``metrics.counter("parallel.dist.gather")``.  Never a move to the
    host.  Identity for an unsharded table."""
    if table.sharding is None:
        return table
    if table.sharding.mesh.size > 1:
        executor.context.metrics.inc("parallel.dist.gather")
    return table.unsharded()


def on_one_device(tables: List[Table]) -> List[Table]:
    """The tables on one device: an aggregate's group table lives on the
    host, so host tables move to the device of any table that is not."""
    device = next((t.device for t in tables if t.device.type != "cpu"), None)
    return tables if device is None else [t.to(device) for t in tables]


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
