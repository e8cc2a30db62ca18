"""Structured error taxonomy for every failure crossing the executor boundary.

Copied from `dask_sql_tpu/resilience/errors.py`; import paths differ, and
`classify` knows the card's failures (`_CUDA_FAULT_MARKERS`).

Role parity: the reference delegates fault tolerance to dask.distributed —
a failed task is retried by the scheduler and the user sees dask's exception
chain.  The TPU-native rewrite dropped that layer; this module replaces it
with an explicit taxonomy so the serving runtime, the degradation ladder
(resilience/ladder.py) and the Presto wire (server/responses.py) can make
policy decisions from three flags instead of string-matching tracebacks:

- ``code``       stable machine-readable name (also the Presto errorName);
- ``retryable``  a bounded-backoff retry at the ServingRuntime worker may
                 succeed (transient device/runtime hiccup, NOT a user error);
- ``degradable`` a lower execution rung (compiled -> interpreted,
                 sharded -> single-device, device -> CPU) may succeed.

This module must stay import-light (no jax, no package-internal imports):
planner/serving/executor modules all base their exceptions on it.
"""
from __future__ import annotations

import re as _re
from typing import Optional

#: Presto wire errorType values (server/responses.py maps code -> payload)
USER_ERROR = "USER_ERROR"
INTERNAL_ERROR = "INTERNAL_ERROR"
INSUFFICIENT_RESOURCES = "INSUFFICIENT_RESOURCES"


class QueryError(RuntimeError):
    """Base of the taxonomy.  Subclasses pin class-level defaults; an
    instance can override any of them via keyword arguments (e.g. a
    compile failure that is known-permanent can set ``retryable=False``)."""

    code: str = "QUERY_ERROR"
    error_type: str = INTERNAL_ERROR
    retryable: bool = False
    degradable: bool = False

    def __init__(self, message: str = "", *,
                 code: Optional[str] = None,
                 error_type: Optional[str] = None,
                 retryable: Optional[bool] = None,
                 degradable: Optional[bool] = None,
                 query_id: Optional[str] = None):
        super().__init__(message or self.__class__.code)
        if code is not None:
            self.code = code
        if error_type is not None:
            self.error_type = error_type
        if retryable is not None:
            self.retryable = retryable
        if degradable is not None:
            self.degradable = degradable
        self.query_id = query_id

    def payload(self) -> dict:
        """The structured fields the Presto wire error embeds."""
        return {
            "code": self.code,
            "errorType": self.error_type,
            "retryable": bool(self.retryable),
            "degradable": bool(self.degradable),
        }


# --------------------------------------------------------------- frontend
class ParseError(QueryError, ValueError):
    """SQL text rejected by the lexer/parser.  ValueError base kept for
    compatibility with the planner's historical ParsingException/LexError."""

    code = "PARSE_ERROR"
    error_type = USER_ERROR


class BindingError(QueryError, ValueError):
    """Name/type resolution failed (unknown table/column/function)."""

    code = "BIND_ERROR"
    error_type = USER_ERROR


class PlanError(QueryError):
    """Logical planning or optimization failed irrecoverably (the driver
    normally falls back to the unoptimized plan instead)."""

    code = "PLAN_ERROR"


# --------------------------------------------------------------- execution
class CompileError(QueryError):
    """The compiled fast path (whole-pipeline jit, compiled select, XLA
    lowering) failed.  Degradable: the interpreted per-op path computes the
    same answer without that compiler."""

    code = "COMPILE_ERROR"
    degradable = True


class CompileTimeoutError(CompileError):
    """An XLA compile exceeded ``resilience.compile_timeout_ms`` and was
    abandoned by the watchdog (resilience/watchdog.py).  Degradable like
    any CompileError — the ladder serves the query on a lower rung and the
    breaker is charged so the fingerprint stops re-attempting the hang."""

    code = "COMPILE_TIMEOUT"


class StreamLaunchTimeoutError(QueryError):
    """A streamed per-chunk launch exceeded
    ``serving.stream.launch_timeout_ms`` and was abandoned by the watchdog
    BETWEEN chunks (streaming/runner.py) instead of wedging the ticket's
    reservation forever.  Degradable — the ladder steps the streamed rung
    down and charges the breaker — but deliberately NOT a
    `ResourceExhaustedError`: a wedged launch is not memory pressure, so
    the reclaim-before-degrade retry does not apply."""

    code = "STREAM_LAUNCH_TIMEOUT"
    error_type = INSUFFICIENT_RESOURCES
    degradable = True


class ExecutionError(QueryError):
    """A plan node failed while executing device kernels."""

    code = "EXECUTION_ERROR"


class TransientExecutionError(ExecutionError):
    """An execution failure that is expected to succeed on retry (device
    runtime hiccup, transient transfer failure)."""

    code = "TRANSIENT_EXECUTION_ERROR"
    retryable = True


class ResourceExhaustedError(QueryError):
    """Device memory / capacity exhausted (XLA RESOURCE_EXHAUSTED, capacity
    ladder tops out).  Degradable — a smaller-footprint rung (interpreted
    ops, single device, CPU host memory) may fit."""

    code = "RESOURCE_EXHAUSTED"
    error_type = INSUFFICIENT_RESOURCES
    degradable = True


class DeadlineError(QueryError):
    """The query ran past its deadline and was cancelled at a checkpoint."""

    code = "EXCEEDED_TIME_LIMIT"
    error_type = INSUFFICIENT_RESOURCES


class CancelledError(QueryError):
    """The client cancelled the query; raised at the next checkpoint."""

    code = "USER_CANCELED"
    error_type = USER_ERROR


class ShutdownError(QueryError):
    """The serving runtime shut down before this query could run; queued
    futures fail with this instead of hanging forever."""

    code = "SERVER_SHUTTING_DOWN"
    retryable = True  # another replica (or a restart) can take the query


class ReplicaFailedError(QueryError):
    """The replica a query was routed to died (or was draining / timed
    out) before the query reached a terminal state.  Retryable: a
    re-dispatch to a SURVIVING replica — deduped by the idempotency key,
    which is the result-cache key's ingredients — can succeed; the fleet
    router (fleet/router.py) does exactly that with bounded backoff.  The
    serving worker's in-replica retry loop never sees this error (it is
    set on routed futures by the kill/drain paths, above the worker), so
    the flag cannot make a dead replica retry onto itself."""

    code = "REPLICA_FAILED"
    error_type = INSUFFICIENT_RESOURCES
    retryable = True


class UnroutableStatementError(QueryError, ValueError):
    """A catalog- or session-mutating statement the fleet router cannot
    safely fan out (CREATE/DROP/ALTER, model statements, USE SCHEMA,
    multi-statement scripts containing a mutation).  Only single-statement
    ``INSERT INTO`` mutates through the router's epoch-fenced write
    fan-out; executing any other mutation on a single routed replica would
    silently diverge the members' catalogs and poison the per-table epoch
    fences, so the router rejects it up front — apply such DDL to every
    replica at fleet build time instead."""

    code = "FLEET_UNROUTABLE"
    error_type = USER_ERROR


class ModelError(QueryError, ValueError):
    """CREATE MODEL / PREDICT / EXPORT MODEL failed on the model layer
    (unresolvable model_class, fit/predict raising, bad WITH options).
    USER_ERROR: the statement — not the engine — is wrong, so the Presto
    wire reports it as such instead of an INTERNAL_ERROR traceback.
    ValueError base kept for compatibility with the historical raw raises
    (the ParseError/BindingError pattern)."""

    code = "MODEL_ERROR"
    error_type = USER_ERROR


class ModelNotFoundError(ModelError):
    """The referenced model is not registered in the target schema."""

    code = "MODEL_NOT_FOUND"


class InjectedFault(QueryError):
    """Marker mixin-style base for faults raised by resilience/faults.py so
    tests and logs can tell injected failures from organic ones."""

    code = "INJECTED_FAULT"


#: markers of low-level runtime errors that mean "out of device memory".
#: OOM must be word-bounded — a bare substring would match ROOM/ZOOM/BOOM
#: and misroute an unrelated bug onto the degradation ladder.
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory",
                "failed to allocate")
_OOM_RE = _re.compile(r"\bOOM\b")
#: a failure of the card that is not an allocation: torch reports a CUDA
#: runtime status as "CUDA error: <text>", the kernel wrappers (ops/segsum.py)
#: theirs as "segsum kernel ... CUDA error <code>", and a kernel that fails
#: to build carries nvcc's output.  Whatever words such a text holds (the
#: status text of cudaErrorMemoryAllocation is "out of memory"), it is an
#: ExecutionError: stepping down would hide a broken kernel or device.
_CUDA_FAULT_MARKERS = ("CUDA error", "segsum kernel", "nvcc")


def classify(exc: BaseException, *, query_id: Optional[str] = None) -> QueryError:
    """Wrap an arbitrary exception into the taxonomy (idempotent).

    XLA surfaces device OOM as an XlaRuntimeError whose message leads with
    RESOURCE_EXHAUSTED; jax re-raises various transient runtime failures the
    same way.  Everything unrecognized becomes a non-retryable
    ExecutionError so the wire payload is structured either way."""
    if isinstance(exc, QueryError):
        if query_id is not None and exc.query_id is None:
            exc.query_id = query_id
        return exc
    msg = f"{type(exc).__name__}: {exc}"
    text = str(exc)
    if type(exc).__name__ == "OutOfMemoryError" or isinstance(exc,
                                                              MemoryError):
        # torch.cuda.OutOfMemoryError: the caching allocator could not
        # serve an allocation on the card ("CUDA out of memory. Tried to
        # allocate ...")
        err: QueryError = ResourceExhaustedError(msg, query_id=query_id)
    elif any(m in text for m in _CUDA_FAULT_MARKERS):
        err = ExecutionError(msg, query_id=query_id)
    elif any(m in text for m in _OOM_MARKERS) or _OOM_RE.search(text):
        err = ResourceExhaustedError(msg, query_id=query_id)
    elif isinstance(exc, (ConnectionError, TimeoutError)):
        # deliberately NOT all OSError: FileNotFoundError/PermissionError are
        # permanent — retrying them burns the deadline and tells clients to
        # resubmit a query that can never succeed
        err = TransientExecutionError(msg, query_id=query_id)
    else:
        err = ExecutionError(msg, query_id=query_id)
    err.__cause__ = exc
    return err


def is_retryable(exc: BaseException) -> bool:
    return isinstance(exc, QueryError) and exc.retryable


def is_degradable(exc: BaseException) -> bool:
    return isinstance(exc, QueryError) and exc.degradable
