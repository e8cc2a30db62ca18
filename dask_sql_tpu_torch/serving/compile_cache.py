"""The compile cache: the built kernel and planner libraries, kept on disk.

The port's counterpart of `dask_sql_tpu/serving/compile_cache.py`.  The
reference persists XLA executables, so a restarted process deserializes
them instead of compiling.  What the port compiles ahead of its queries
are the `_build.py` libraries: each CUDA kernel source (``nvcc``, seconds)
and the native planner (``g++``, about 20 s), each already named by a hash
of its source and flags.  ``serving.compile_cache.path`` names the
directory where they are kept and found (otherwise the package's
``_build/``), so a new process, or another checkout pointed at the same
directory, loads them without a compiler run.  A pipeline build (the
port's compile, `observability/spans.py` `timed_build`) makes Python
objects over the Context's tensors and has nothing to persist (ROADMAP.md
Queue 3).

- A library found intact counts ``resilience.compile_cache.hit``; a
  compiler run counts ``.miss``.  Both land in the metrics of every
  Context that enabled the cache, and in `stats`.
- A torn file (a crash mid-write by another tool; the builds themselves
  write a temporary file and rename it) is not an intact shared object:
  it is removed and rebuilt, a miss, never an error.

The directory is process-wide state, one path per process, as the
reference's: `enable` is idempotent for the same path and logs (rather
than switches) on a second one.
"""
from __future__ import annotations

import logging
import os
import struct
import threading
import weakref
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)

CONFIG_PATH_KEY = "serving.compile_cache.path"
CONFIG_MIN_COMPILE_KEY = "serving.compile_cache.min_compile_time_s"

_lock = threading.Lock()
_state: Dict[str, Optional[str]] = {"path": None}
_counters = {"hits": 0, "misses": 0, "torn": 0}
#: the metrics registries of the Contexts that enabled the cache
_listeners: "weakref.WeakSet" = weakref.WeakSet()


def enable(path: str) -> bool:
    """Keep and find the built libraries under ``path`` (idempotent).
    True when the cache is on ``path`` after the call."""
    with _lock:
        current = _state["path"]
        if current == path:
            return True
        if current is not None:
            logger.warning("compile cache already enabled at %r; ignoring "
                           "second path %r", current, path)
            return False
        os.makedirs(path, exist_ok=True)
        _state["path"] = path
    logger.info("compile cache enabled at %s", path)
    return True


def disable() -> None:
    """Back to the package's ``_build/`` (tests: undo process-wide state)."""
    with _lock:
        _state["path"] = None
        _listeners.clear()


def maybe_enable(config, metrics=None) -> bool:
    """Enable from ``serving.compile_cache.path``; a no-op when it is
    unset.  Called from `Context.__init__`; the Context's metrics then
    receive the hit and miss counts."""
    path = config.get(CONFIG_PATH_KEY)
    if not path:
        return False
    ok = enable(str(path))
    if ok and metrics is not None:
        with _lock:
            _listeners.add(metrics)
        metrics.gauge("resilience.compile_cache.enabled", 1.0)
    return ok


def enabled_path() -> Optional[str]:
    with _lock:
        return _state["path"]


def cache_dir(default: Path) -> Path:
    """Where libraries are kept: the enabled path, else ``default``."""
    path = enabled_path()
    return Path(path) if path is not None else default


def stats() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def _count(kind: str) -> None:
    with _lock:
        _counters[kind] += 1
        listeners = list(_listeners) if kind != "torn" else []
    for metrics in listeners:
        if kind == "hits":
            metrics.inc("resilience.compile_cache.hit")
        else:
            metrics.inc("resilience.compile_cache.miss")


def intact(path: Path) -> bool:
    """True when ``path`` is a whole ELF shared object: its header reads
    and its section header table ends inside the file (a file cut short
    fails that)."""
    try:
        size = path.stat().st_size
        with open(path, "rb") as f:
            head = f.read(64)
    except OSError:
        return False
    if len(head) < 64 or head[:4] != b"\x7fELF" or head[4] != 2:
        return False
    order = "<" if head[5] == 1 else ">"
    e_type = struct.unpack_from(order + "H", head, 16)[0]
    shoff = struct.unpack_from(order + "Q", head, 40)[0]
    shentsize, shnum = struct.unpack_from(order + "HH", head, 58)
    return e_type == 3 and 0 < shoff and shoff + shentsize * shnum <= size


def lookup(path: Path) -> bool:
    """True (a hit) when ``path`` is an intact library; a torn file is
    removed, so the caller builds it (and calls `stored`)."""
    if path.exists():
        if intact(path):
            _count("hits")
            return True
        logger.warning("compile cache: %s is torn; rebuilding", path)
        _count("torn")
        try:
            path.unlink()
        except OSError:
            pass
    return False


def stored(path: Path) -> None:
    """Count one compiler run that wrote ``path`` (a miss)."""
    _count("misses")
