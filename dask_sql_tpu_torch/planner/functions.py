"""Built-in function signature tables for the binder.

Copied from `dask_sql_tpu/planner/functions.py`; only import paths differ.

Role parity: the reference's ContextProvider built-ins (`get_function_meta`
sql.rs:198, `get_aggregate_meta` sql.rs:405) plus the SQL-standard functions
DataFusion itself provides.  Each entry maps a SQL name to a canonical kernel
op (lowered by `physical.rex.operations`) and a result-type rule.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..columnar.dtypes import (
    DATETIME_TYPES,
    FLOAT_TYPES,
    INTEGER_TYPES,
    SqlType,
    promote,
)

# result-type rules:
#   "double" | "bigint" | "integer" | "boolean" | "string" | "arg0" | "promote"
#   "timestamp" | "interval" | "sum" (int->bigint, float->arg) | "avg"
_S = lambda op, rt, lo, hi=None: (op, rt, lo, hi if hi is not None else lo)

#: SQL scalar function name -> (canonical op, result rule, min_args, max_args)
SCALAR_FUNCTIONS: Dict[str, Tuple[str, str, int, int]] = {
    # math (reference call.py:1086-1113 op list)
    "ABS": _S("abs", "arg0", 1),
    "ACOS": _S("acos", "double", 1),
    "ASIN": _S("asin", "double", 1),
    "ATAN": _S("atan", "double", 1),
    "ATAN2": _S("atan2", "double", 2),
    "CBRT": _S("cbrt", "double", 1),
    "CEIL": _S("ceil", "arg0", 1),
    "CEILING": _S("ceil", "arg0", 1),
    "COS": _S("cos", "double", 1),
    "COT": _S("cot", "double", 1),
    "DEGREES": _S("degrees", "double", 1),
    "EXP": _S("exp", "double", 1),
    "FLOOR": _S("floor", "arg0", 1),
    "LN": _S("ln", "double", 1),
    "LOG": _S("log", "double", 1, 2),
    "LOG10": _S("log10", "double", 1),
    "LOG2": _S("log2", "double", 1),
    "POWER": _S("power", "double", 2),
    "POW": _S("power", "double", 2),
    "RADIANS": _S("radians", "double", 1),
    "ROUND": _S("round", "arg0", 1, 2),
    "SIGN": _S("sign", "arg0", 1),
    "SIN": _S("sin", "double", 1),
    "SQRT": _S("sqrt", "double", 1),
    "TAN": _S("tan", "double", 1),
    "TRUNCATE": _S("truncate", "arg0", 1, 2),
    "TRUNC": _S("truncate", "arg0", 1, 2),
    "MOD": _S("mod", "promote", 2),
    "RAND": _S("rand", "double", 0, 1),
    "RANDOM": _S("rand", "double", 0, 1),
    "RAND_INTEGER": _S("rand_integer", "integer", 1, 2),
    "PI": _S("pi", "double", 0),
    # string (reference call.py:1114-1135)
    "CHAR_LENGTH": _S("char_length", "bigint", 1),
    "CHARACTER_LENGTH": _S("char_length", "bigint", 1),
    "LENGTH": _S("char_length", "bigint", 1),
    "UPPER": _S("upper", "string", 1),
    "LOWER": _S("lower", "string", 1),
    "CONCAT": _S("concat", "string", 1, 99),
    "INITCAP": _S("initcap", "string", 1),
    "REPLACE": _S("replace", "string", 3),
    "REVERSE": _S("reverse", "string", 1),
    "LEFT": _S("left", "string", 2),
    "RIGHT": _S("right", "string", 2),
    "REPEAT": _S("repeat_str", "string", 2),
    "LPAD": _S("lpad", "string", 2, 3),
    "RPAD": _S("rpad", "string", 2, 3),
    "ASCII": _S("ascii", "integer", 1),
    "CHR": _S("chr", "string", 1),
    "STRPOS": _S("position", "integer", 2),
    "SPLIT_PART": _S("split_part", "string", 3),
    "SUBSTR": _S("substring", "string", 2, 3),
    "SUBSTRING": _S("substring", "string", 2, 3),
    "BTRIM": _S("btrim", "string", 1, 2),
    "LTRIM": _S("ltrim", "string", 1, 2),
    "RTRIM": _S("rtrim", "string", 1, 2),
    "TRIM": _S("btrim", "string", 1, 2),
    # conditional / null handling
    "COALESCE": _S("coalesce", "promote", 1, 99),
    "NULLIF": _S("nullif", "arg0", 2),
    "NVL": _S("coalesce", "promote", 2),
    "IFNULL": _S("coalesce", "promote", 2),
    "GREATEST": _S("greatest", "promote", 1, 99),
    "LEAST": _S("least", "promote", 1, 99),
    # datetime (reference sql.rs:198 UDF list: year, timestampadd/diff/ceil/floor,
    # dsql_totimestamp, extract_date, last_day)
    "YEAR": _S("extract_year", "bigint", 1),
    "MONTH": _S("extract_month", "bigint", 1),
    "DAY": _S("extract_day", "bigint", 1),
    "HOUR": _S("extract_hour", "bigint", 1),
    "MINUTE": _S("extract_minute", "bigint", 1),
    "SECOND": _S("extract_second", "bigint", 1),
    "QUARTER": _S("extract_quarter", "bigint", 1),
    "DAYOFWEEK": _S("extract_dow", "bigint", 1),
    "DAYOFYEAR": _S("extract_doy", "bigint", 1),
    "WEEK": _S("extract_week", "bigint", 1),
    "LAST_DAY": _S("last_day", "timestamp", 1),
    "TO_TIMESTAMP": _S("to_timestamp", "timestamp", 1, 2),
    "DSQL_TOTIMESTAMP": _S("to_timestamp", "timestamp", 1, 2),
    "TIMESTAMPADD": _S("timestampadd", "timestamp", 3),
    "TIMESTAMPDIFF": _S("timestampdiff", "bigint", 3),
    "DATEDIFF": _S("timestampdiff", "bigint", 3),
    "DATE_TRUNC": _S("date_trunc", "timestamp", 2),
    "CURRENT_TIMESTAMP": _S("current_timestamp", "timestamp", 0),
    "CURRENT_DATE": _S("current_date", "timestamp", 0),
    "NOW": _S("current_timestamp", "timestamp", 0),
    # misc
    "MD5": _S("md5", "string", 1),
    "HASH": _S("hash64", "bigint", 1, 99),
}

#: aggregate name -> (canonical op, result rule)
AGGREGATE_FUNCTIONS: Dict[str, Tuple[str, str]] = {
    # reference aggregate.py:117-231 AGGREGATION_MAPPING
    "SUM": ("sum", "sum"),
    "MIN": ("min", "arg0"),
    "MAX": ("max", "arg0"),
    "COUNT": ("count", "bigint"),
    "AVG": ("avg", "double"),
    "MEAN": ("avg", "double"),
    "STDDEV": ("stddev_samp", "double"),
    "STDDEV_SAMP": ("stddev_samp", "double"),
    "STDDEV_POP": ("stddev_pop", "double"),
    "VARIANCE": ("var_samp", "double"),
    "VAR_SAMP": ("var_samp", "double"),
    "VAR_POP": ("var_pop", "double"),
    "BIT_AND": ("bit_and", "arg0"),
    "BIT_OR": ("bit_or", "arg0"),
    "BIT_XOR": ("bit_xor", "arg0"),
    "EVERY": ("every", "boolean"),
    "BOOL_AND": ("every", "boolean"),
    "BOOL_OR": ("bool_or", "boolean"),
    "ANY_VALUE": ("single_value", "arg0"),
    "SINGLE_VALUE": ("single_value", "arg0"),
    "FIRST_VALUE": ("first_value", "arg0"),
    "LAST_VALUE": ("last_value", "arg0"),
    "REGR_COUNT": ("regr_count", "bigint"),
    "REGR_SXX": ("regr_sxx", "double"),
    "REGR_SYY": ("regr_syy", "double"),
    "APPROX_COUNT_DISTINCT": ("approx_count_distinct", "bigint"),
    # percentile family (BASELINE config 5; device sort-based exact quantiles)
    "MEDIAN": ("percentile", "double"),
    "APPROX_PERCENTILE": ("percentile", "double"),
    "PERCENTILE_CONT": ("percentile", "double"),
    "QUANTILE": ("percentile", "double"),
}

#: pure window functions (aggregates are also usable OVER windows)
WINDOW_FUNCTIONS: Dict[str, str] = {
    # reference window.py:214-225 ops + rank family
    "ROW_NUMBER": "bigint",
    "RANK": "bigint",
    "DENSE_RANK": "bigint",
    "PERCENT_RANK": "double",
    "CUME_DIST": "double",
    "NTILE": "bigint",
    "LAG": "arg0",
    "LEAD": "arg0",
    "NTH_VALUE": "arg0",
}


def resolve_type(rule: str, arg_types) -> SqlType:
    if rule == "double":
        return SqlType.DOUBLE
    if rule == "bigint":
        return SqlType.BIGINT
    if rule == "integer":
        return SqlType.INTEGER
    if rule == "boolean":
        return SqlType.BOOLEAN
    if rule == "string":
        return SqlType.VARCHAR
    if rule == "timestamp":
        return SqlType.TIMESTAMP
    if rule == "interval":
        return SqlType.INTERVAL_DAY_TIME
    if rule == "arg0":
        return arg_types[0] if arg_types else SqlType.DOUBLE
    if rule == "promote":
        t = arg_types[0]
        for u in arg_types[1:]:
            t = promote(t, u)
        return t
    if rule == "sum":
        t = arg_types[0]
        if t in INTEGER_TYPES:
            return SqlType.BIGINT
        if t in FLOAT_TYPES:
            return SqlType.DOUBLE if t == SqlType.DECIMAL else t
        return t
    raise NotImplementedError(f"type rule {rule}")
