"""SQL type system and dtype mappings for the TPU columnar backend.

Copied from `dask_sql_tpu/columnar/dtypes.py`; only import paths differ.

Role parity: reference `src/sql/types.rs` (SqlTypeName enum, types.rs:214) and
`dask_sql/mappings.py` (python<->sql type tables, mappings.py:17-90).  Re-designed for a
JAX/XLA backend: every SQL type maps onto a *device representation* — a jax/numpy dtype for
the data buffer plus an encoding tag (strings are dictionary-encoded int32 codes; datetimes
are int64 epoch values) — instead of pandas nullable extension dtypes.
"""
from __future__ import annotations

import datetime
import enum
from decimal import Decimal

import numpy as np


class SqlType(enum.Enum):
    """Calcite-style SQL type names (reference types.rs:214 SqlTypeName)."""

    NULL = "NULL"
    BOOLEAN = "BOOLEAN"
    TINYINT = "TINYINT"
    SMALLINT = "SMALLINT"
    INTEGER = "INTEGER"
    BIGINT = "BIGINT"
    FLOAT = "FLOAT"
    REAL = "REAL"
    DOUBLE = "DOUBLE"
    DECIMAL = "DECIMAL"
    VARCHAR = "VARCHAR"
    CHAR = "CHAR"
    DATE = "DATE"
    TIME = "TIME"
    TIMESTAMP = "TIMESTAMP"
    TIMESTAMP_WITH_LOCAL_TIME_ZONE = "TIMESTAMP_WITH_LOCAL_TIME_ZONE"
    INTERVAL_DAY_TIME = "INTERVAL_DAY_TIME"
    INTERVAL_YEAR_MONTH = "INTERVAL_YEAR_MONTH"
    BINARY = "BINARY"
    VARBINARY = "VARBINARY"
    ANY = "ANY"

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return self.value


# ---------------------------------------------------------------------------
# Device representation
# ---------------------------------------------------------------------------
# Strings live on device as int32 dictionary codes (+ a host-side array of unique
# values); datetimes as int64 nanoseconds since epoch; dates as int32 days since
# epoch; intervals as int64 (ns for day-time, months for year-month).

_SQL_TO_NP = {
    SqlType.BOOLEAN: np.dtype(np.bool_),
    SqlType.TINYINT: np.dtype(np.int8),
    SqlType.SMALLINT: np.dtype(np.int16),
    SqlType.INTEGER: np.dtype(np.int32),
    SqlType.BIGINT: np.dtype(np.int64),
    SqlType.FLOAT: np.dtype(np.float32),
    SqlType.REAL: np.dtype(np.float32),
    SqlType.DOUBLE: np.dtype(np.float64),
    SqlType.DECIMAL: np.dtype(np.float64),  # decimal policy: float64 (sql.yaml:33 analogue)
    SqlType.VARCHAR: np.dtype(np.int32),  # dictionary codes
    SqlType.CHAR: np.dtype(np.int32),
    SqlType.DATE: np.dtype(np.int64),  # ns since epoch (midnight)
    SqlType.TIME: np.dtype(np.int64),
    SqlType.TIMESTAMP: np.dtype(np.int64),  # ns since epoch
    SqlType.TIMESTAMP_WITH_LOCAL_TIME_ZONE: np.dtype(np.int64),
    SqlType.INTERVAL_DAY_TIME: np.dtype(np.int64),  # nanoseconds
    SqlType.INTERVAL_YEAR_MONTH: np.dtype(np.int64),  # months
    SqlType.NULL: np.dtype(np.float64),
    SqlType.ANY: np.dtype(np.object_),
}

_NP_TO_SQL = {
    np.dtype(np.bool_): SqlType.BOOLEAN,
    np.dtype(np.int8): SqlType.TINYINT,
    np.dtype(np.int16): SqlType.SMALLINT,
    np.dtype(np.int32): SqlType.INTEGER,
    np.dtype(np.int64): SqlType.BIGINT,
    np.dtype(np.uint8): SqlType.SMALLINT,
    np.dtype(np.uint16): SqlType.INTEGER,
    np.dtype(np.uint32): SqlType.BIGINT,
    np.dtype(np.uint64): SqlType.BIGINT,
    np.dtype(np.float16): SqlType.FLOAT,
    np.dtype(np.float32): SqlType.FLOAT,
    np.dtype(np.float64): SqlType.DOUBLE,
    np.dtype(np.object_): SqlType.VARCHAR,
    np.dtype(np.str_): SqlType.VARCHAR,
}

_PY_SCALAR_TO_SQL = {
    bool: SqlType.BOOLEAN,
    int: SqlType.BIGINT,
    float: SqlType.DOUBLE,
    str: SqlType.VARCHAR,
    bytes: SqlType.VARBINARY,
    Decimal: SqlType.DECIMAL,
    datetime.datetime: SqlType.TIMESTAMP,
    datetime.date: SqlType.DATE,
    datetime.timedelta: SqlType.INTERVAL_DAY_TIME,
    type(None): SqlType.NULL,
}

#: SQL types whose device buffer is an integer *encoding* rather than the value itself
STRING_TYPES = frozenset({SqlType.VARCHAR, SqlType.CHAR})
DATETIME_TYPES = frozenset(
    {SqlType.DATE, SqlType.TIME, SqlType.TIMESTAMP, SqlType.TIMESTAMP_WITH_LOCAL_TIME_ZONE}
)
INTERVAL_TYPES = frozenset({SqlType.INTERVAL_DAY_TIME, SqlType.INTERVAL_YEAR_MONTH})
INTEGER_TYPES = frozenset(
    {SqlType.TINYINT, SqlType.SMALLINT, SqlType.INTEGER, SqlType.BIGINT}
)
FLOAT_TYPES = frozenset({SqlType.FLOAT, SqlType.REAL, SqlType.DOUBLE, SqlType.DECIMAL})
NUMERIC_TYPES = INTEGER_TYPES | FLOAT_TYPES


def sql_to_np(sql_type: SqlType) -> np.dtype:
    """Device-buffer numpy dtype for a SQL type."""
    return _SQL_TO_NP[sql_type]


def np_to_sql(dtype) -> SqlType:
    """SQL type for a numpy/pandas dtype (datetime64/timedelta64 handled by kind)."""
    dtype = np.dtype(dtype) if not hasattr(dtype, "kind") else dtype
    kind = getattr(dtype, "kind", None)
    if kind == "M":
        return SqlType.TIMESTAMP
    if kind == "m":
        return SqlType.INTERVAL_DAY_TIME
    if kind in ("U", "S", "O"):
        return SqlType.VARCHAR
    try:
        return _NP_TO_SQL[np.dtype(dtype)]
    except (KeyError, TypeError):
        # pandas extension dtypes (Int64, boolean, string, ...)
        name = str(dtype).lower()
        for probe, st in (
            ("int8", SqlType.TINYINT),
            ("int16", SqlType.SMALLINT),
            ("int32", SqlType.INTEGER),
            ("int64", SqlType.BIGINT),
            ("float32", SqlType.FLOAT),
            ("float64", SqlType.DOUBLE),
            ("bool", SqlType.BOOLEAN),
            ("str", SqlType.VARCHAR),
            ("decimal", SqlType.DECIMAL),
            ("date", SqlType.TIMESTAMP),
        ):
            if probe in name:
                return st
        raise NotImplementedError(f"No SQL type known for dtype {dtype!r}")


def python_to_sql_type(value) -> SqlType:
    """SQL type of a python scalar (reference mappings.py:92 python_to_sql_type)."""
    if isinstance(value, np.generic):
        return np_to_sql(value.dtype)
    for py_type, st in _PY_SCALAR_TO_SQL.items():
        if isinstance(value, py_type) and type(value) is not bool or py_type is bool and isinstance(value, bool):
            # bool is a subclass of int; check bool first via the explicit clause
            if py_type is bool and not isinstance(value, bool):
                continue
            return st
    raise NotImplementedError(f"No SQL type known for python value {value!r}")


# Type-promotion lattice (reference mappings.py:264 `similar_type` — avoid needless casts).
_PROMOTION_ORDER = [
    SqlType.BOOLEAN,
    SqlType.TINYINT,
    SqlType.SMALLINT,
    SqlType.INTEGER,
    SqlType.BIGINT,
    SqlType.FLOAT,
    SqlType.REAL,
    SqlType.DOUBLE,
    SqlType.DECIMAL,
]


def promote(a: SqlType, b: SqlType) -> SqlType:
    """Least common supertype for arithmetic/comparison, SQL-style."""
    if a == b:
        return a
    if a == SqlType.NULL:
        return b
    if b == SqlType.NULL:
        return a
    if a in STRING_TYPES and b in STRING_TYPES:
        return SqlType.VARCHAR
    if a in DATETIME_TYPES and b in DATETIME_TYPES:
        return SqlType.TIMESTAMP
    # datetime +- interval keeps the datetime type
    if a in DATETIME_TYPES and b in INTERVAL_TYPES:
        return a
    if b in DATETIME_TYPES and a in INTERVAL_TYPES:
        return b
    if a in _PROMOTION_ORDER and b in _PROMOTION_ORDER:
        # int64 op float32 -> float64 to not lose precision (SQL semantics)
        ia, ib = _PROMOTION_ORDER.index(a), _PROMOTION_ORDER.index(b)
        hi = _PROMOTION_ORDER[max(ia, ib)]
        lo = _PROMOTION_ORDER[min(ia, ib)]
        if hi in (SqlType.FLOAT, SqlType.REAL) and lo in (SqlType.INTEGER, SqlType.BIGINT):
            return SqlType.DOUBLE
        return hi
    if a in DATETIME_TYPES and b in NUMERIC_TYPES:
        return a
    if b in DATETIME_TYPES and a in NUMERIC_TYPES:
        return b
    raise NotImplementedError(f"Cannot promote {a} and {b}")


def similar_type(a: SqlType, b: SqlType) -> bool:
    """True when a cast between the two types would be a no-op family-wise."""
    fams = (INTEGER_TYPES, FLOAT_TYPES, STRING_TYPES, DATETIME_TYPES, INTERVAL_TYPES,
            frozenset({SqlType.BOOLEAN}))
    for fam in fams:
        if a in fam and b in fam:
            return True
    return a == b


def parse_sql_type(name: str) -> SqlType:
    """Parse a SQL type name as written in queries (e.g. ``CAST(x AS BIGINT)``)."""
    name = name.strip().upper()
    base = name.split("(")[0].strip()
    aliases = {
        "INT": SqlType.INTEGER,
        "INT2": SqlType.SMALLINT,
        "INT4": SqlType.INTEGER,
        "INT8": SqlType.BIGINT,
        "LONG": SqlType.BIGINT,
        "STRING": SqlType.VARCHAR,
        "TEXT": SqlType.VARCHAR,
        "BOOL": SqlType.BOOLEAN,
        "NUMERIC": SqlType.DECIMAL,
        "FLOAT4": SqlType.FLOAT,
        "FLOAT8": SqlType.DOUBLE,
        "DOUBLE PRECISION": SqlType.DOUBLE,
        "TIMESTAMP WITHOUT TIME ZONE": SqlType.TIMESTAMP,
        "TIMESTAMP WITH TIME ZONE": SqlType.TIMESTAMP_WITH_LOCAL_TIME_ZONE,
        "DATETIME": SqlType.TIMESTAMP,
    }
    if base in aliases:
        return aliases[base]
    try:
        return SqlType[base.replace(" ", "_")]
    except KeyError:
        raise NotImplementedError(f"Unknown SQL type: {name}")
