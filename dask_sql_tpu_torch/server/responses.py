"""Presto wire-protocol response objects (QueryResults, DataResults,
ErrorResults and the placeholder stage stats).

Copied from `dask_sql_tpu/server/responses.py`; only import paths differ.
The frames it serializes are pandas on the host: the one transfer of a
query's result happened in `TorchFrame.compute`."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np


def stage_stats() -> Dict[str, Any]:
    # parity: the reference fills these with placeholders too (server/app.py:124-127)
    return {
        "state": "FINISHED",
        "queued": False,
        "scheduled": True,
        "nodes": 1,
        "totalSplits": 1,
        "queuedSplits": 0,
        "runningSplits": 0,
        "completedSplits": 1,
        "cpuTimeMillis": 0,
        "wallTimeMillis": 0,
        "processedRows": 0,
        "processedBytes": 0,
        "physicalInputBytes": 0,
        "failedTasks": 0,
        "coordinatorOnly": False,
        "subStages": [],
    }


def query_stats() -> Dict[str, Any]:
    return {
        "state": "FINISHED",
        "queued": False,
        "scheduled": True,
        "nodes": 1,
        "totalSplits": 1,
        "queuedSplits": 0,
        "runningSplits": 0,
        "completedSplits": 1,
        "cpuTimeMillis": 0,
        "wallTimeMillis": 0,
        "queuedTimeMillis": 0,
        "elapsedTimeMillis": 0,
        "processedRows": 0,
        "processedBytes": 0,
        "physicalInputBytes": 0,
        "peakMemoryBytes": 0,
        "spilledBytes": 0,
        "rootStage": stage_stats(),
        "progressPercentage": 100,
    }


_SQL_TYPE_TO_PRESTO = {
    "BOOLEAN": "boolean",
    "TINYINT": "tinyint",
    "SMALLINT": "smallint",
    "INTEGER": "integer",
    "BIGINT": "bigint",
    "FLOAT": "real",
    "REAL": "real",
    "DOUBLE": "double",
    "DECIMAL": "double",
    "VARCHAR": "varchar",
    "CHAR": "char",
    "DATE": "date",
    "TIME": "time",
    "TIMESTAMP": "timestamp",
    "TIMESTAMP_WITH_LOCAL_TIME_ZONE": "timestamp with time zone",
    "INTERVAL_DAY_TIME": "interval day to second",
    "INTERVAL_YEAR_MONTH": "interval year to month",
    "NULL": "varchar",
    "VARBINARY": "varbinary",
    "ANY": "varchar",
}


def presto_type(sql_type) -> str:
    return _SQL_TYPE_TO_PRESTO.get(str(sql_type), "varchar")


def columns_from_frame(df) -> List[Dict[str, Any]]:
    cols = []
    for name, dtype in zip(df.columns, df.dtypes):
        kind = getattr(dtype, "kind", "O")
        t = {
            "i": "bigint", "u": "bigint", "f": "double", "b": "boolean",
            "M": "timestamp", "m": "interval day to second",
        }.get(kind, "varchar")
        cols.append({
            "name": str(name),
            "type": t,
            "typeSignature": {"rawType": t, "arguments": []},
        })
    return cols


def data_from_frame(df) -> List[List[Any]]:
    out = []
    for row in df.itertuples(index=False):
        vals = []
        for v in row:
            if v is None:
                vals.append(None)
            elif isinstance(v, float) and math.isnan(v):
                vals.append(None)
            elif isinstance(v, (np.integer,)):
                vals.append(int(v))
            elif isinstance(v, (np.floating,)):
                vals.append(float(v))
            elif isinstance(v, (np.bool_, bool)):
                vals.append(bool(v))
            elif isinstance(v, np.datetime64):
                vals.append(str(v))
            elif hasattr(v, "isoformat"):
                vals.append(v.isoformat(sep=" ") if hasattr(v, "hour") else v.isoformat())
            else:
                vals.append(None if v is np.nan else str(v) if not isinstance(v, (int, float, str, bool)) else v)
        out.append(vals)
    return out


def error_results(query_id: str, next_uri: Optional[str], error: Exception,
                  error_name: Optional[str] = None,
                  error_type: Optional[str] = None) -> Dict[str, Any]:
    """Presto ErrorResults (parity: reference responses.py:128-141).

    Taxonomy-aware: a resilience `QueryError` carries its own stable
    ``code`` (-> errorName), wire ``error_type`` and the retryable /
    degradable flags, so drivers and load balancers can back off or reroute
    without string-matching messages.  Non-taxonomy exceptions are
    classified first, so every failure leaves the server structured."""
    from ..resilience.errors import QueryError, classify

    if not isinstance(error, QueryError) and error_name is None \
            and error_type is None:
        error = classify(error)
    payload = {
        "code": type(error).__name__,
        "errorType": error_type or "USER_ERROR",
        "retryable": False,
        "degradable": False,
    }
    if isinstance(error, QueryError):
        payload.update(error.payload())
    # payload() is the extension point: any keys beyond the standard four
    # are subclass-declared wire fields (e.g. the OOM gate's
    # estimatedBytesLow/budgetBytes proof) and ride the error dict as-is
    extra = {k: v for k, v in payload.items()
             if k not in ("code", "errorType", "retryable", "degradable")}
    return {
        "id": query_id,
        "infoUri": "",
        "stats": {**query_stats(), "state": "FAILED"},
        "error": {
            "message": str(error),
            "errorCode": 1,
            "errorName": error_name or payload["code"],
            "errorType": error_type or payload["errorType"],
            "retryable": payload["retryable"],
            "degradable": payload["degradable"],
            "failureInfo": {
                "type": type(error).__name__,
                "message": str(error),
                "stack": [],
            },
            **extra,
        },
        "warnings": [],
    }


def queue_full_results(query_id: str, error) -> Dict[str, Any]:
    """Load-shed response: the admission queue is at its bound.  Structured
    like a Presto ErrorResults with QUERY_QUEUE_FULL / INSUFFICIENT_RESOURCES
    so drivers surface it as retryable, plus a machine-readable
    ``retryAfterSeconds`` (also sent as the HTTP Retry-After header)."""
    # QueueFullError carries code=QUERY_QUEUE_FULL / INSUFFICIENT_RESOURCES /
    # retryable=True through the taxonomy; error_results reads them off
    payload = error_results(query_id, None, error)
    payload["error"]["retryAfterSeconds"] = float(
        getattr(error, "retry_after_s", 1.0))
    payload["error"]["priorityClass"] = getattr(error, "priority_class", "")
    return payload
