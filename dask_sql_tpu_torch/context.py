"""The Context of the PyTorch port: register frames, run SQL, get pandas back.

Counterpart of `dask_sql_tpu/context.py`, lean: `create_table`, `sql` and a
lazy frame whose `compute()` returns pandas.  Tables live on the context's
device, which is the CUDA card unless the caller asks for the CPU.  Plans
come from the Python parser and binder, unoptimized.  The serving, cache,
admission and observability tiers of the reference are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .columnar.dtypes import SqlType
from .columnar.table import Table, normalize_device
from .config import Config
from .datacontainer import SchemaContainer, to_table
from .planner import plan as plan_nodes
from .planner.binder import Binder
from .planner.catalog import Catalog, CatalogTable, Statistics
from .planner.expressions import Field
from .planner.parser import parse_sql


def resolve_device(device=None) -> torch.device:
    """The device of a Context: ``None`` means the CUDA card, which must be
    present; the CPU only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dask_sql_tpu_torch runs on a CUDA device, and none is available; "
            "pass device='cpu' to run on the CPU")
    return normalize_device(dev)


class TorchFrame:
    """Lazy query result: holds the plan; executes on `.compute()`
    (counterpart of the reference's `TpuFrame`)."""

    def __init__(self, context: "Context", plan, field_names: List[str],
                 config_options: Optional[Dict[str, Any]] = None):
        self._context = context
        self._plan = plan
        self._field_names = field_names
        self._result: Optional[Table] = None
        self._config_options = dict(config_options or {})

    @property
    def columns(self) -> List[str]:
        return list(self._field_names)

    def execute(self) -> Table:
        """Run the plan to a Table (cached)."""
        if self._result is None:
            from .physical.executor import Executor

            with self._context.config.set(self._config_options):
                self._result = Executor(self._context).execute(self._plan)
        return self._result

    def compute(self):
        """Materialize to a pandas DataFrame with the SQL output names."""
        df = self.execute().to_pandas()
        df.columns = self._disambiguated_names()
        return df

    def _disambiguated_names(self) -> List[str]:
        seen: Dict[str, int] = {}
        out = []
        for n in self._field_names:
            if n in seen:
                seen[n] += 1
                out.append(f"{n}{seen[n]}")
            else:
                seen[n] = 0
                out.append(n)
        return out


class Context:
    DEFAULT_SCHEMA_NAME = "root"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.schema_name = self.DEFAULT_SCHEMA_NAME
        self.schema: Dict[str, SchemaContainer] = {
            self.DEFAULT_SCHEMA_NAME: SchemaContainer(self.DEFAULT_SCHEMA_NAME)
        }
        self.config = Config()

    def create_table(self, table_name: str, input_table: Any,
                     schema_name: Optional[str] = None) -> None:
        """Register a pandas frame (or a port Table on this device)."""
        schema_name = schema_name or self.schema_name
        if schema_name not in self.schema:
            raise KeyError(f"Schema {schema_name} not found")
        self.schema[schema_name].tables[table_name] = to_table(input_table,
                                                               self.device)

    def sql(self, sql: str, return_futures: bool = True,
            config_options: Optional[Dict[str, Any]] = None):
        """Parse and bind a SQL query; run it lazily (`.compute()`) or, with
        ``return_futures=False``, now to pandas."""
        if not isinstance(sql, str):
            raise ValueError("sql must be a string")
        with self.config.set(config_options):
            statements = parse_sql(sql)
            if len(statements) != 1:
                raise NotImplementedError("one statement per call in the port")
            plan = self._get_ral(statements[0])
        if isinstance(plan, plan_nodes.CustomNode):
            raise NotImplementedError(
                f"{type(plan).__name__} statements are not in the port yet")
        frame = TorchFrame(self, plan, [f.name for f in plan.schema],
                           config_options)
        return frame if return_futures else frame.compute()

    def _get_ral(self, stmt):
        """AST -> bound plan (the Python binder; no optimizer yet)."""
        catalog = self._prepare_catalog()
        case_sensitive = bool(self.config.get("sql.identifier.case_sensitive", True))
        catalog.case_sensitive = case_sensitive
        return Binder(catalog, case_sensitive=case_sensitive).bind_statement(stmt)

    def _prepare_catalog(self) -> Catalog:
        catalog = Catalog(self.schema_name)
        catalog.current_schema = self.schema_name
        for schema_name, container in self.schema.items():
            catalog.add_schema(schema_name)
            cschema = catalog.schemas[schema_name]
            for table_name, table in container.tables.items():
                fields = [
                    Field(name, col.sql_type, col.validity is not None or
                          col.sql_type in (SqlType.FLOAT, SqlType.DOUBLE))
                    for name, col in table.columns.items()
                ]
                cschema.tables[table_name] = CatalogTable(
                    table_name, schema_name, fields,
                    Statistics(float(table.num_rows)))
        return catalog

    def get_table_data(self, schema_name: str, table_name: str) -> Table:
        table = self.schema[schema_name].tables.get(table_name)
        if table is None:
            raise KeyError(f"Table {schema_name}.{table_name} not found")
        return table
