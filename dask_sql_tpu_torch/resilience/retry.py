"""Bounded retry with exponential backoff and jitter, and the per-(plan
family, rung) circuit breaker.  Copied from
`dask_sql_tpu/resilience/retry.py`; the breaker's open verdicts ride a
checkpoint (`snapshot_state`/`load_state`, checkpoint.py).

Retry runs at the serving worker (serving/runtime.py wraps each admitted
query in `retry_call`): only errors the taxonomy marks `retryable` are
retried, the backoff respects the ticket's deadline (never sleeps past
it) and its cancellation flag.  Jitter is deterministic given (seed,
attempt) so test runs reproduce.

The breaker protects the degradation ladder (`ladder.attempt`): a plan
fingerprint whose compiled rung failed `threshold` consecutive times
skips that rung for `cooldown_s` and goes straight to its known-good
rung, instead of paying the failure again on every submission.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional, Tuple, TypeVar

from .errors import classify

logger = logging.getLogger(__name__)

T = TypeVar("T")


class BackoffPolicy:
    """Exponential backoff: base * multiplier^attempt, capped, jittered.

    `max_attempts` counts total tries (1 = no retry).  Jitter multiplies
    each delay by a factor drawn uniformly from [1-jitter, 1+jitter] using
    a PRNG seeded per-policy, so retries desynchronize across workers while
    a fixed seed reproduces the exact schedule."""

    def __init__(self, max_attempts: int = 3, base_s: float = 0.05,
                 multiplier: float = 2.0, max_s: float = 2.0,
                 jitter: float = 0.5, seed: Optional[int] = None):
        self.max_attempts = max(1, int(max_attempts))
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.max_s = float(max_s)
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self._rng = random.Random(seed)

    @classmethod
    def from_config(cls, config) -> "BackoffPolicy":
        # the jitter PRNG is pinned to the inject seed ONLY while fault
        # injection is active (reproducible tests); in production it must
        # stay unseeded, or every replica would draw the identical jitter
        # sequence and retries would re-synchronize instead of spreading
        seed = config.get("resilience.inject.seed") \
            if config.get("resilience.inject") else None
        return cls(
            max_attempts=int(config.get("resilience.retry.max_attempts", 3)),
            base_s=float(config.get("resilience.retry.base_s", 0.05)),
            multiplier=float(config.get("resilience.retry.multiplier", 2.0)),
            max_s=float(config.get("resilience.retry.max_s", 2.0)),
            jitter=float(config.get("resilience.retry.jitter", 0.5)),
            seed=seed,
        )

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number `attempt` (1-based)."""
        raw = min(self.max_s, self.base_s * (self.multiplier ** (attempt - 1)))
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, raw)


def retry_call(fn: Callable[[], T], policy: BackoffPolicy,
               ticket=None, metrics=None,
               sleep: Callable[[float], None] = time.sleep) -> T:
    """Run `fn`, retrying taxonomy-retryable failures with backoff.

    Non-retryable errors (user errors, cancels, deadline expiry, permanent
    execution failures) propagate on the first throw.  A retryable error is
    re-raised once attempts are exhausted or the ticket's deadline cannot
    absorb the next backoff sleep."""
    attempt = 1
    while True:
        try:
            result = fn()
        except BaseException as exc:  # dsql: allow-broad-except — classified below
            err = classify(exc)
            if not err.retryable or attempt >= policy.max_attempts:
                raise
            delay = policy.delay_s(attempt)
            if ticket is not None:
                remaining = ticket.remaining_s()
                if remaining is not None and delay >= remaining:
                    # the backoff alone would blow the deadline: surface the
                    # original failure now, with time left to report it
                    if metrics is not None:
                        metrics.inc("resilience.retry.deadline_abort")
                    raise
            if metrics is not None:
                metrics.inc("resilience.retry.attempts")
                metrics.observe("resilience.retry.backoff_ms", delay * 1000.0)
            logger.debug("retrying after %s (attempt %d/%d, backoff %.3fs)",
                         err.code, attempt, policy.max_attempts, delay)
            sleep(delay)
            if ticket is not None:
                ticket.checkpoint()  # cancel/deadline during backoff
            attempt += 1
            continue
        if attempt > 1 and metrics is not None:
            metrics.inc("resilience.retry.recovered")
        return result




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

    # ------------------------------------------------------- persistence
    def snapshot_state(self) -> dict:
        """JSON-ready snapshot of the OPEN circuits (checkpoint.py writes
        this as breaker.json): a restarted process should not re-prove
        rungs this one already proved bad.  Only open verdicts persist —
        sub-threshold failure streaks are too cheap to be worth staleness.
        Ages are relative (monotonic clocks do not survive a process), and
        `saved_at` wall time lets the loader add the downtime on top."""
        now = self._clock()
        with self._lock:
            entries = [
                {"key": list(key), "failures": int(st[0]),
                 "open_age_s": round(now - st[1], 3)}
                for key, st in self._state.items() if st[1] is not None
            ]
        return {"version": 1, "saved_at": time.time(), "open": entries}

    def load_state(self, data: dict, ttl_s: float) -> int:
        """Restore open circuits younger than `ttl_s` (open age at save
        plus the wall-clock downtime since).  Bounded staleness: the data
        that tripped a breaker may be gone after a restart, so verdicts
        expire instead of sticking forever; a restored circuit whose
        cooldown already elapsed simply admits its half-open trial on
        first use.  Returns the number of circuits restored."""
        if not data:
            return 0
        stale_s = max(0.0, time.time() - float(data.get("saved_at") or 0.0))
        now = self._clock()
        restored = 0
        with self._lock:
            for e in data.get("open") or []:
                try:
                    key = tuple(e["key"])
                    age = float(e.get("open_age_s") or 0.0) + stale_s
                    failures = int(e.get("failures", self.threshold))
                except (KeyError, TypeError, ValueError):
                    continue  # malformed entry: skip, never fail the load
                if age >= ttl_s:
                    continue
                self._state[key] = [max(failures, self.threshold), now - age]
                restored += 1
            self._evict_locked()
        return restored

    def _evict_locked(self) -> None:
        # bounded memory: drop oldest entries past the cap (dict preserves
        # insertion order; breaker state is advisory, losing one is safe)
        while len(self._state) > self.max_keys:
            self._state.pop(next(iter(self._state)))
