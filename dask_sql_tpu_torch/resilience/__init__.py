"""Resilient execution: the error taxonomy, the degradation ladder, the
circuit breaker and deterministic fault injection.

Counterpart of `dask_sql_tpu/resilience/__init__.py`, with its exports:

- `errors`: the taxonomy every failure crossing the executor boundary is
  wrapped into (``code`` / ``retryable`` / ``degradable``);
- `ladder`: compiled rungs -> interpreted walk -> CPU (on a CPU Context),
  counted in the Context's ``metrics`` (``resilience.*``);
- `retry`: the per-plan-family circuit breaker the ladder consults;
- `faults`: config-keyed deterministic fault injection
  (``resilience.inject = "compile:0.5,oom:once"``), so every rung and the
  breaker are provable in tests.

- `pressure`: the memory-pressure controller (bands, reclaim,
  reclaim-before-degrade);
- `watchdog`: the deadline on a pipeline build or a watched launch.

Retry with backoff (`BackoffPolicy`, `retry_call`) is in `retry`; the
chaos campaigns (`chaos.py`) wait for ROADMAP.md Queue 1 item 8d.
"""
from .errors import (
    BindingError,
    CancelledError,
    CompileError,
    DeadlineError,
    ExecutionError,
    InjectedFault,
    ParseError,
    PlanError,
    QueryError,
    ResourceExhaustedError,
    ShutdownError,
    TransientExecutionError,
    classify,
    is_degradable,
    is_retryable,
)
from .faults import FaultInjector, get_injector, maybe_inject
from .ladder import attempt, execute_interpreted, plan_fingerprint, wrap_boundary
from .retry import CircuitBreaker

__all__ = [
    "BindingError",
    "CancelledError",
    "CircuitBreaker",
    "CompileError",
    "DeadlineError",
    "ExecutionError",
    "FaultInjector",
    "InjectedFault",
    "ParseError",
    "PlanError",
    "QueryError",
    "ResourceExhaustedError",
    "ShutdownError",
    "TransientExecutionError",
    "attempt",
    "classify",
    "execute_interpreted",
    "get_injector",
    "is_degradable",
    "is_retryable",
    "maybe_inject",
    "plan_fingerprint",
    "wrap_boundary",
]
