"""Compile watchdog: a deadline on a pipeline build or a watched launch.

A copy of `dask_sql_tpu/resilience/watchdog.py` on the port's builds.  A
pipeline build (`observability/spans.py` `timed_build`, the port's
compile) or a streamed partition launch (`streaming/runner.py`) has no
cooperative cancellation point, so a wedged one would hold a serving
worker.  `watched_call` runs the callable on a helper thread and waits at
most the deadline; on expiry the *caller* gets a degradable
`CompileTimeoutError` (or the ``error_cls`` it names) at once, the ladder
steps the rung down and charges the breaker, and the helper thread is
abandoned to finish off the query's path (``resilience.watchdog.abandoned``
counts them).

The helper thread runs in a copy of the caller's contextvars (the active
trace, the compile sink), and on the caller's CUDA device and current
stream, which torch keeps per thread and a new thread would not see: a
launch on the helper then orders with the caller's work.  An injected hang
(`faults.hang_duration`, the ``compile_hang`` site) waits on an `Event`
that `release_hangs` sets, so no abandoned thread outlives a test or a
process (`join_abandoned`, and the exit hook).
"""
from __future__ import annotations

import atexit
import contextlib
import contextvars
import logging
import threading
import time
from typing import Callable, List, Optional

from .errors import CompileTimeoutError

logger = logging.getLogger(__name__)

CONFIG_KEY = "resilience.compile_timeout_ms"

#: abandoned helper threads, joined (bounded) at interpreter exit
_abandoned: List[threading.Thread] = []
_abandoned_lock = threading.Lock()
_ATEXIT_JOIN_S = 15.0
#: the events injected hangs wait on; `release_hangs` sets them
_hangs: List[threading.Event] = []


def release_hangs() -> None:
    """Cut every injected hang short: its helper thread finishes now."""
    with _abandoned_lock:
        events = list(_hangs)
        _hangs.clear()
    for ev in events:
        ev.set()


def join_abandoned(timeout: float = _ATEXIT_JOIN_S) -> int:
    """Release the injected hangs and join the abandoned helper threads;
    returns how many are still alive after ``timeout``."""
    release_hangs()
    with _abandoned_lock:
        threads = [t for t in _abandoned if t.is_alive()]
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    with _abandoned_lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        return len(_abandoned)


atexit.register(join_abandoned)


def timeout_ms(config) -> Optional[float]:
    """The configured build deadline in ms, or None (watchdog off).
    String values arrive through SET statements; non-positive disables."""
    raw = config.get(CONFIG_KEY)
    if raw is None:
        return None
    try:
        val = float(raw)
    except (TypeError, ValueError):
        logger.warning("unparseable %s=%r; watchdog disabled", CONFIG_KEY, raw)
        return None
    return val if val > 0 else None


def _device_scope():
    """A factory of the caller's CUDA device and current stream as a
    context for another thread, or of a null context off the card."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return contextlib.nullcontext
    device = torch.cuda.current_device()
    stream = torch.cuda.current_stream(device)

    @contextlib.contextmanager
    def scope():
        with torch.cuda.device(device), torch.cuda.stream(stream):
            yield

    return scope


def watched_call(label: str, fn: Callable, args=(), kwargs=None, *,
                 deadline_ms: float, hang_s: float = 0.0, metrics=None,
                 error_cls: type = CompileTimeoutError):
    """Run ``fn(*args, **kwargs)`` on a helper thread; raise ``error_cls``
    (default `CompileTimeoutError`) if it has not finished within
    ``deadline_ms``.  ``hang_s`` is the fault-injection seam: the armed
    duration is resolved on the caller's thread and waited inside the
    helper, before ``fn``."""
    box: list = []
    done = threading.Event()
    ctx = contextvars.copy_context()
    scope = _device_scope()
    hang = None
    if hang_s > 0:
        hang = threading.Event()
        with _abandoned_lock:
            _hangs.append(hang)

    def target():
        try:
            if hang is not None:
                hang.wait(hang_s)
            with scope():
                box.append((True, ctx.run(fn, *args, **(kwargs or {}))))
        except BaseException as exc:  # dsql: allow-broad-except — re-raised on
            # the caller's thread
            box.append((False, exc))
        finally:
            done.set()

    t = threading.Thread(target=target, daemon=True,
                         name=f"dsql-compile-watchdog-{label}")
    t.start()
    if not done.wait(deadline_ms / 1000.0):
        with _abandoned_lock:
            _abandoned.append(t)
            _abandoned[:] = [x for x in _abandoned if x.is_alive()]
        if metrics is not None:
            metrics.inc("resilience.watchdog.timeout")
            metrics.inc("resilience.watchdog.abandoned")
        logger.warning(
            "watched call %s exceeded %0.0fms; abandoning the helper "
            "thread and degrading the rung", label, deadline_ms)
        raise error_cls(
            f"watched call {label!r} exceeded its {deadline_ms:g}ms deadline")
    if hang is not None:
        with _abandoned_lock:
            if hang in _hangs:
                _hangs.remove(hang)
    ok, value = box[0]
    if ok:
        return value
    raise value
