"""Process-runtime primitives shared by every layer (a copy of
`dask_sql_tpu/runtime/__init__.py`).

This package sits below observability, serving and resilience in the import
graph (stdlib-only imports at module scope), so the lock sanitizer can
wrap the metrics registry's own lock without a cycle.
"""
from . import locks  # noqa: F401
from .locks import (DECLARED_RANKS, LockOrderError, NamedLock,  # noqa: F401
                    named_condition, named_lock)
