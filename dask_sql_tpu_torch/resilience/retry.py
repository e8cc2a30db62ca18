"""The per-(plan family, rung) circuit breaker of the degradation ladder.

Copied from `dask_sql_tpu/resilience/retry.py`, the breaker only: the
ladder (`ladder.attempt`) consults it and SHOW METRICS reads its
`snapshot`.  The reference's retry with backoff (`BackoffPolicy`,
`retry_call`), its `resilience.retry.*` keys and the breaker's persistence
come with their callers, the serving worker and its checkpoints
(ROADMAP.md Queue 1 item 8b).

A plan fingerprint whose compiled rung failed `threshold` consecutive
times skips that rung for `cooldown_s` and goes straight to its known-good
rung, instead of paying the failure again on every submission.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Tuple


class CircuitBreaker:
    """Per-key consecutive-failure breaker with cooldown.

    Keys are (plan fingerprint, rung name) tuples from the degradation
    ladder.  After `threshold` consecutive failures `allow` returns False
    until `cooldown_s` has elapsed, after which ONE trial is admitted
    (half-open); its outcome closes or re-opens the circuit.  Admitting the
    trial re-arms the cooldown clock rather than setting a sticky flag, so
    a trial that never settles (the rung *declines* instead of succeeding
    or failing) costs one more cooldown, not a permanently-open circuit."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 max_keys: int = 1024,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.max_keys = int(max_keys)
        self._clock = clock
        self._lock = threading.Lock()
        #: key -> [consecutive_failures, opened_at or None]
        self._state: dict = {}

    @classmethod
    def from_config(cls, config) -> "CircuitBreaker":
        return cls(
            threshold=int(config.get("resilience.breaker.threshold", 3)),
            cooldown_s=float(config.get("resilience.breaker.cooldown_s", 30.0)),
        )

    def allow(self, key: Tuple) -> bool:
        with self._lock:
            st = self._state.get(key)
            if st is None or st[1] is None:
                return True
            if self._clock() - st[1] >= self.cooldown_s:
                # admit one half-open trial and re-arm the cooldown: peers
                # stay blocked for another window, and a trial that never
                # settles (rung declined) simply waits out one more cooldown
                st[1] = self._clock()
                return True
            return False

    def record_failure(self, key: Tuple) -> bool:
        """Count a failure; returns True when this call TRIPS the breaker
        (transition closed -> open), so callers can emit the trip metric
        exactly once."""
        with self._lock:
            st = self._state.setdefault(key, [0, None])
            st[0] += 1
            tripped = st[1] is None and st[0] >= self.threshold
            if st[0] >= self.threshold:
                st[1] = self._clock()
            self._evict_locked()
            return tripped

    def record_success(self, key: Tuple) -> bool:
        """Clear the key's failure state; returns True when this success
        closed an OPEN circuit (the half-open trial passed), so callers
        can record the restore exactly once."""
        with self._lock:
            st = self._state.pop(key, None)
            return bool(st is not None and st[1] is not None)

    def is_open(self, key: Tuple) -> bool:
        with self._lock:
            st = self._state.get(key)
            return bool(st and st[1] is not None)

    def snapshot(self) -> dict:
        with self._lock:
            open_keys = sum(1 for st in self._state.values()
                            if st[1] is not None)
            return {"keys": len(self._state), "open": open_keys,
                    "threshold": self.threshold,
                    "cooldownSeconds": self.cooldown_s}

    def _evict_locked(self) -> None:
        # bounded memory: drop oldest entries past the cap (dict preserves
        # insertion order; breaker state is advisory, losing one is safe)
        while len(self._state) > self.max_keys:
            self._state.pop(next(iter(self._state)))
