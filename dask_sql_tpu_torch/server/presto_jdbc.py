"""JDBC metadata emulation.

Copied from `dask_sql_tpu/server/presto_jdbc.py`; only import paths
differ.  The metadata tables are registered on the Context's device like
any other table.

Parity: reference server/presto_jdbc.py — a `system_jdbc` schema holding
`schemas`/`tables`/`columns` frames with the standard JDBC
DatabaseMetaData column sets (getSchemas/getTables/getColumns), so JDBC
drivers and DB tools (DBeaver) can introspect.  The driver queries
`system.jdbc`; the statement endpoint rewrites it to `system_jdbc`
(reference app.py:78-82) since catalogs aren't supported.
"""
from __future__ import annotations

import logging

import pandas as pd

logger = logging.getLogger(__name__)

SYSTEM_SCHEMA = "system_jdbc"


def adjust_for_presto_sql(sql: str) -> str:
    """Rewrites the unsupported `system` catalog to the metadata schema
    (parity: reference app.py:78-82)."""
    return sql.replace("system.jdbc", SYSTEM_SCHEMA)


def create_meta_data(context) -> None:
    if context is None:
        logger.warning("Context None: jdbc meta data not created")
        return
    catalog = ""
    context.create_schema(SYSTEM_SCHEMA)

    schema_rows = []
    table_rows = []
    column_rows = []
    for schema_name, schema in context.schema.items():
        schema_rows.append(create_schema_row(catalog, schema_name))
        for table_name, dc in schema.tables.items():
            table_rows.append(create_table_row(catalog, schema_name, table_name))
            for pos, (col, c) in enumerate(dc.table.columns.items(), start=1):
                column_rows.append(create_column_row(
                    catalog, schema_name, table_name, str(c.sql_type.value),
                    col, str(pos), "YES" if c.validity is not None else "NO"))

    schemas = (pd.DataFrame(schema_rows) if schema_rows
               else pd.DataFrame(create_schema_row(), index=[0]))
    context.create_table("schemas", schemas, schema_name=SYSTEM_SCHEMA)
    tables = (pd.DataFrame(table_rows) if table_rows
              else pd.DataFrame(create_table_row(), index=[0]))
    context.create_table("tables", tables, schema_name=SYSTEM_SCHEMA)
    columns = (pd.DataFrame(column_rows) if column_rows
               else pd.DataFrame(create_column_row(), index=[0]))
    context.create_table("columns", columns, schema_name=SYSTEM_SCHEMA)
    logger.info("jdbc meta data ready for %d tables", len(table_rows))


def create_catalog_row(catalog: str = ""):
    return {"TABLE_CAT": catalog}


def create_schema_row(catalog: str = "", schema: str = ""):
    return {"TABLE_CATALOG": catalog, "TABLE_SCHEM": schema}


def create_table_row(catalog: str = "", schema: str = "", table: str = ""):
    # the JDBC DatabaseMetaData.getTables() result-set columns
    return {
        "TABLE_CAT": catalog,
        "TABLE_SCHEM": schema,
        "TABLE_NAME": table,
        "TABLE_TYPE": "TABLE",
        "REMARKS": "",
        "TYPE_CAT": "",
        "TYPE_SCHEM": "",
        "TYPE_NAME": "",
        "SELF_REFERENCING_COL_NAME": "",
        "REF_GENERATION": "",
    }


def create_column_row(catalog: str = "", schema: str = "", table: str = "",
                      dtype: str = "", column: str = "", pos: str = "",
                      nullable: str = ""):
    # the JDBC DatabaseMetaData.getColumns() result-set columns
    return {
        "TABLE_CAT": catalog,
        "TABLE_SCHEM": schema,
        "TABLE_NAME": table,
        "COLUMN_NAME": column,
        "DATA_TYPE": dtype,
        "TYPE_NAME": dtype,
        "COLUMN_SIZE": "",
        "BUFFER_LENGTH": "",
        "DECIMAL_DIGITS": "",
        "NUM_PREC_RADIX": "",
        "NULLABLE": "",
        "REMARKS": "",
        "COLUMN_DEF": "",
        "SQL_DATA_TYPE": dtype,
        "SQL_DATETIME_SUB": "",
        "CHAR_OCTET_LENGTH": "",
        "ORDINAL_POSITION": pos,
        "IS_NULLABLE": nullable,
        "SCOPE_CATALOG": "",
        "SCOPE_SCHEMA": "",
        "SCOPE_TABLE": "",
        "SOURCE_DATA_TYPE": "",
        "IS_AUTOINCREMENT": "",
        "IS_GENERATEDCOLUMN": "",
    }
