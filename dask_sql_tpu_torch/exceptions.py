"""Public exception types (parity: reference src/error.rs DaskPlannerError and
sql/exceptions.rs ParsingException/OptimizationException).  Copied from
`dask_sql_tpu/exceptions.py`.

Every class here is rooted in the resilience taxonomy
(:mod:`dask_sql_tpu_torch.resilience.errors`): each carries a stable ``code``, an
``error_type`` for the Presto wire, and ``retryable`` / ``degradable`` flags
the serving runtime and degradation ladder act on.  The historical names
(`ParsingException`, `BindError`, `OptimizationException`, `LexError`) are
kept as subclasses/aliases so existing callers and tests keep working.
"""
from __future__ import annotations

from .planner.binder import BindError
from .planner.lexer import LexError
from .planner.parser import ParsingException
from .resilience.errors import (
    BindingError,
    CancelledError,
    CompileError,
    DeadlineError,
    ExecutionError,
    ParseError,
    PlanError,
    QueryError,
    ResourceExhaustedError,
    ShutdownError,
    TransientExecutionError,
    classify,
)


class OptimizationException(PlanError):
    """Raised when optimization fails irrecoverably (the driver normally
    falls back to the unoptimized plan instead, context.py:857 parity).
    Still a RuntimeError through PlanError/QueryError."""

    code = "OPTIMIZATION_ERROR"


__all__ = [
    "BindError",
    "BindingError",
    "CancelledError",
    "CompileError",
    "DeadlineError",
    "ExecutionError",
    "LexError",
    "OptimizationException",
    "ParseError",
    "ParsingException",
    "PlanError",
    "QueryError",
    "ResourceExhaustedError",
    "ShutdownError",
    "TransientExecutionError",
    "classify",
]
