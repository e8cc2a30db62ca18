"""Result cache: LRU-by-bytes of result Tables.
(A copy of `dask_sql_tpu/serving/cache.py`.)

The plan cache removes planning from a repeated query; the kernels still
run again.  For serving traffic (dashboards, retried requests) the result
itself is the hot object, so this cache keys the result Table on (the
plan's family fingerprint and parameter values, the versions of the
tables it reads, the config) and drops an entry when a table it read
changes (`invalidate_tables`: an append, a replace, a drop).

Eviction is by resident bytes (a result Table pins card buffers), a
per-entry cap keeps one huge result from evicting the working set, and a
TTL bounds staleness.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Hashable, Iterable, Optional, Tuple


def table_nbytes(table) -> int:
    """Resident bytes of a port Table: each column's buffers (data,
    validity, RLE lengths, DICT values, host dictionaries: the codes of an
    encoded column are its data) through `encodings.encoded_nbytes`, the
    rule the estimator's scan bounds use too.  (The reference also counts
    a padded table's ``row_valid`` mask; a port Table is never padded.)"""
    from ..columnar.encodings import encoded_nbytes

    return sum(encoded_nbytes(col) for col in table.columns.values())


@dataclass
class _Entry:
    value: Any
    nbytes: int
    created: float
    hits: int = 0
    #: (schema, table) pairs this result was computed from — the epoch-scoped
    #: invalidation scope: an append/replace of one table drops exactly the
    #: entries depending on it (`invalidate_tables`), never the whole cache
    deps: FrozenSet[Tuple[str, str]] = frozenset()


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    expirations: int = 0
    oversize_rejects: int = 0
    bytes: int = 0
    entries: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class ResultCache:
    """LRU-by-bytes cache with TTL and a per-entry byte cap.

    Thread-safe; a cached Table is never written to (an append builds a
    new Table, and invalidation drops the entries that read the old one),
    so one instance is shared by every query and worker thread.
    """

    def __init__(self, max_bytes: int = 256 << 20,
                 max_entry_bytes: int = 64 << 20,
                 ttl_s: Optional[float] = 300.0,
                 metrics=None,
                 clock=time.monotonic):
        self.max_bytes = int(max_bytes)
        self.max_entry_bytes = int(max_entry_bytes)
        self.ttl_s = ttl_s
        self.metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        self.stats = CacheStats()

    # ------------------------------------------------------------------ ops
    def get(self, key: Hashable) -> Optional[Any]:
        now = self._clock()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and self.ttl_s is not None \
                    and now - entry.created > self.ttl_s:
                self._drop_locked(key, entry)
                self.stats.expirations += 1
                entry = None
            if entry is None:
                self.stats.misses += 1
                self._mark("query.cache.miss")
                return None
            entry.hits += 1
            self.stats.hits += 1
            self._entries.move_to_end(key)
            self._mark("query.cache.hit")
            return entry.value

    def put(self, key: Hashable, value: Any,
            nbytes: Optional[int] = None,
            deps: Optional[Iterable[Tuple[str, str]]] = None) -> bool:
        """Insert (or refresh) an entry; returns False when the value is
        over the per-entry cap and was not cached.  ``deps`` is the set of
        (schema, table) names the result was computed from — the scope
        `invalidate_tables` drops on a targeted DML/DDL invalidation."""
        if nbytes is None:
            nbytes = table_nbytes(value)
        nbytes = int(nbytes)
        if nbytes > self.max_entry_bytes or nbytes > self.max_bytes:
            with self._lock:
                self.stats.oversize_rejects += 1
            self._mark("query.cache.oversize")
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.stats.bytes -= old.nbytes
                self.stats.entries -= 1
            self._entries[key] = _Entry(value, nbytes, self._clock(),
                                        deps=frozenset(deps or ()))
            self.stats.bytes += nbytes
            self.stats.entries += 1
            self.stats.inserts += 1
            while self.stats.bytes > self.max_bytes and len(self._entries) > 1:
                k, e = next(iter(self._entries.items()))
                self._drop_locked(k, e)
                self.stats.evictions += 1
                self._mark("query.cache.evicted")
        return True

    def reclaim_bytes(self, bytes_needed: Optional[int] = None) -> int:
        """Pressure reclaim (resilience/pressure.py tier 1): evict
        LRU-coldest entries until at least ``bytes_needed`` are freed
        (``None`` = drain everything); returns bytes actually freed.
        Every result here is re-computable, so under HBM pressure cold
        cache is the cheapest memory on the device."""
        freed = 0
        with self._lock:
            while self._entries and (bytes_needed is None
                                     or freed < bytes_needed):
                key, entry = next(iter(self._entries.items()))
                self._drop_locked(key, entry)
                self.stats.evictions += 1
                freed += entry.nbytes
                self._mark("query.cache.evicted")
        return freed

    def invalidate_all(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.stats.bytes = 0
            self.stats.entries = 0
        return n

    def invalidate_tables(self, tables: Iterable[Tuple[str, str]]) -> int:
        """Drop exactly the entries whose deps intersect ``tables`` —
        the epoch-scoped invalidation an append/replace of one table
        triggers.  Entries inserted without deps (legacy callers, direct
        test puts) are dropped too: an unknown provenance must never
        survive a catalog change it might depend on."""
        targets = set(tables)
        if not targets:
            return 0
        with self._lock:
            doomed = [(k, e) for k, e in self._entries.items()
                      if not e.deps or (e.deps & targets)]
            for k, e in doomed:
                self._drop_locked(k, e)
        return len(doomed)

    # ------------------------------------------------------------- helpers
    def _drop_locked(self, key, entry) -> None:
        # caller holds the lock (self-lint DSQL201 *_locked convention)
        self._entries.pop(key, None)
        self.stats.bytes -= entry.nbytes
        self.stats.entries -= 1

    def _mark(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = self.stats.as_dict()
        total = out["hits"] + out["misses"]
        out["hitRate"] = round(out["hits"] / total, 4) if total else 0.0
        out["maxBytes"] = self.max_bytes
        out["maxEntryBytes"] = self.max_entry_bytes
        out["ttlSeconds"] = self.ttl_s
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
