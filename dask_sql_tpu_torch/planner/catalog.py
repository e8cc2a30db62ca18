"""Catalog metadata objects the planner binds against.

Copied from `dask_sql_tpu/planner/catalog.py`; only import paths differ.

Role parity: reference `src/sql/table.rs` (DaskTable table.rs:114,
DaskTableSource table.rs:28-55, DaskStatistics table.rs:95), `schema.rs`
(DaskSchema), `function.rs` (DaskFunction overloaded signature map).  The
Python-side `SchemaContainer` (datacontainer.py:281 there) holds the actual
data; these objects are the *planner's* view: names, field types, row counts,
file paths for scan-time pruning.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..columnar.dtypes import SqlType
from .expressions import Field, Schema


@dataclass
class Statistics:
    """Parity: dask_sql.Statistics (datacontainer.py:174) / DaskStatistics."""

    row_count: Optional[float] = None

    def is_exact(self) -> bool:
        return self.row_count is not None


@dataclass
class CatalogTable:
    name: str
    schema_name: str
    fields: Schema
    statistics: Statistics = field(default_factory=Statistics)
    filepath: Optional[str] = None  # source parquet path for plan-time pruning

    @property
    def field_map(self) -> Dict[str, Field]:
        return {f.name: f for f in self.fields}


@dataclass
class FunctionDescription:
    """Parity: dask_sql FunctionDescription (datacontainer.py:9)."""

    name: str
    func: Callable
    parameters: List[tuple]  # [(param_name, SqlType)]
    return_type: SqlType
    aggregation: bool = False
    row_udf: bool = False


@dataclass
class CatalogSchema:
    name: str
    tables: Dict[str, CatalogTable] = field(default_factory=dict)
    functions: Dict[str, List[FunctionDescription]] = field(default_factory=dict)
    models: Dict[str, object] = field(default_factory=dict)
    experiments: Dict[str, object] = field(default_factory=dict)


class Catalog:
    """Planner-visible registry of schemas (parity: DaskSQLContext schema map, sql.rs:85)."""

    def __init__(self, default_schema: str = "root"):
        self.schemas: Dict[str, CatalogSchema] = {default_schema: CatalogSchema(default_schema)}
        self.current_schema = default_schema
        self.case_sensitive = True

    def add_schema(self, name: str) -> None:
        self.schemas.setdefault(name, CatalogSchema(name))

    def drop_schema(self, name: str) -> None:
        self.schemas.pop(name, None)

    def resolve_table(self, parts: List[str]) -> CatalogTable:
        if len(parts) == 1:
            schema_name, table_name = self.current_schema, parts[0]
        elif len(parts) == 2:
            schema_name, table_name = parts
        else:
            schema_name, table_name = parts[-2], parts[-1]
        schema = self.schemas.get(schema_name)
        if schema is None:
            raise KeyError(f"Schema {schema_name!r} not found")
        table = schema.tables.get(table_name)
        if table is None and not self.case_sensitive:
            lowered = {k.lower(): v for k, v in schema.tables.items()}
            table = lowered.get(table_name.lower())
        if table is None:
            raise KeyError(f"Table {table_name!r} not found in schema {schema_name!r}")
        return table

    def resolve_function(self, name: str) -> Optional[List[FunctionDescription]]:
        schema = self.schemas[self.current_schema]
        fns = schema.functions.get(name)
        if fns is None and not self.case_sensitive:
            lowered = {k.lower(): v for k, v in schema.functions.items()}
            fns = lowered.get(name.lower())
        return fns
