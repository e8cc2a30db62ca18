"""Deterministic fault injection, config-keyed.

``resilience.inject`` holds a comma-separated spec of ``site:mode`` pairs:

    resilience.inject = "compile:0.5,oom:once,execute:2"

- ``once``       fail the first arm() at that site, then never again;
- ``always``     fail every time;
- an integer N   fail the first N arms;
- ``atK``        fail exactly the K-th arm (1-based), once — positions a
                 fault MID-SEQUENCE (``partition:at2`` fails the second
                 partition launch of a streamed scan, proving that the
                 resume re-runs nothing already completed);
- a float p<1    fail with probability p from a seeded PRNG
                 (``resilience.inject.seed``), so a given (seed, spec)
                 produces the same failure sequence every run.

Copied from `dask_sql_tpu/resilience/faults.py`, with the sites the port
fires (each raises the matching taxonomy error); any other name is
refused:

    compile     entry of each compiled rung: compiled_select,
                compiled_join_aggregate, compiled_aggregate (CompileError)
    predict     entry of the fused-inference rung only (compiled_predict,
                physical/compiled_predict.py): proves the fused -> host
                predict step down without touching the select rungs
                (ResourceExhaustedError)
    oom         inside a compiled rung, just before its device execution
                (physical/compiled.py, compiled_join.py, compiled_select.py;
                ResourceExhaustedError)
    exec_oom    the interpreted per-op walk (ResourceExhaustedError: proves
                the step down to the CPU rung on a CPU Context)
    execute     executor entry (TransientExecutionError, retryable)
    d2h         the packed device-to-host transfer (columnar/pack.py;
                TransientExecutionError: retryable, never a charge on the
                rung breaker nor a step down)
    partition   one streamed partition launch (streaming/runner.py;
                ResourceExhaustedError: the mid-stream OOM recovery halves
                the partition and resumes)
    checkpoint  checkpoint.save_state after the snapshot is written and
                before the atomic CURRENT repoint (ExecutionError)
    compile_hang  a HANG, not an error: a pipeline build or a watched
                partition launch sleeps ``resilience.inject.hang_s`` inside
                the watchdog's helper thread (`hang_duration`)

    spmd        the entry of the sharded rungs only (spmd_select /
                spmd_aggregate / spmd_join_aggregate; ResourceExhaustedError):
                proves the step down to the one-device rung

The injector is rebuilt whenever the spec string changes, so tests can flip
faults on and off through plain config scopes.  When the key is unset the
fast path is one dict lookup + a falsy check — nothing to disable in
production builds.
"""
from __future__ import annotations

import logging
import random
import threading
from typing import Dict, Optional, Tuple

from .errors import (
    CompileError,
    ExecutionError,
    InjectedFault,
    ResourceExhaustedError,
    TransientExecutionError,
)

logger = logging.getLogger(__name__)

CONFIG_KEY = "resilience.inject"
SEED_KEY = "resilience.inject.seed"


class InjectedCompileError(InjectedFault, CompileError):
    code = "INJECTED_COMPILE_ERROR"


class InjectedOomError(InjectedFault, ResourceExhaustedError):
    code = "INJECTED_RESOURCE_EXHAUSTED"


class InjectedTransientError(InjectedFault, TransientExecutionError):
    code = "INJECTED_TRANSIENT_ERROR"


class InjectedWriteError(InjectedFault, ExecutionError):
    code = "INJECTED_WRITE_ERROR"


#: site -> error class raised when the site arms
SITE_ERRORS = {
    "compile": InjectedCompileError,
    "predict": InjectedOomError,
    "spmd": InjectedOomError,
    "oom": InjectedOomError,
    "exec_oom": InjectedOomError,
    "execute": InjectedTransientError,
    "d2h": InjectedTransientError,
    "partition": InjectedOomError,
    "checkpoint": InjectedWriteError,
}

#: sites that model a HANG rather than an error: arming one yields a sleep
#: of ``resilience.inject.hang_s`` inside the watched region instead of
#: raising
HANG_SITES = frozenset({"compile_hang"})
HANG_SECONDS_KEY = "resilience.inject.hang_s"


class _SiteRule:
    __slots__ = ("mode", "budget", "probability", "fired", "at_index",
                 "arms")

    def __init__(self, mode: str):
        self.mode = mode
        self.budget: Optional[int] = None
        self.probability: Optional[float] = None
        self.at_index: Optional[int] = None
        self.fired = 0
        self.arms = 0
        if mode == "once":
            self.budget = 1
        elif mode == "always":
            self.budget = None
        elif mode.startswith("at") and mode[2:].isdigit():
            # fire exactly the K-th arm (1-based), once: places the fault
            # mid-sequence so resume paths are testable
            self.at_index = int(mode[2:])
            if self.at_index < 1:
                raise ValueError(f"atK index must be >= 1, got {mode!r}")
        else:
            try:
                self.budget = int(mode)
            except ValueError:
                self.probability = float(mode)
                if not 0.0 <= self.probability <= 1.0:
                    raise ValueError(
                        f"fault probability must be in [0, 1], got {mode!r}")

    def arm(self, rng: random.Random) -> bool:
        self.arms += 1
        if self.probability is not None:
            hit = rng.random() < self.probability
        elif self.at_index is not None:
            hit = self.arms == self.at_index
        else:
            hit = self.budget is None or self.fired < self.budget
        if hit:
            self.fired += 1
        return hit


class FaultInjector:
    """One parsed ``resilience.inject`` spec with per-site firing state."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._rules: Dict[str, _SiteRule] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            site, _, mode = part.partition(":")
            site = site.strip()
            if site not in SITE_ERRORS and site not in HANG_SITES:
                raise ValueError(
                    f"unknown fault site {site!r} in {CONFIG_KEY}; known "
                    f"sites: {sorted(SITE_ERRORS) + sorted(HANG_SITES)}")
            self._rules[site] = _SiteRule(mode.strip() or "once")

    def arm(self, site: str) -> bool:
        """True when the fault at `site` should fire now (consumes budget)."""
        rule = self._rules.get(site)
        if rule is None:
            return False
        with self._lock:
            return rule.arm(self._rng)

    def check(self, site: str) -> None:
        """Raise the site's taxonomy error if the fault fires."""
        if self.arm(site):
            err = SITE_ERRORS[site](
                f"injected fault at site {site!r} ({CONFIG_KEY}={self.spec!r})")
            logger.debug("fault injection firing: %s", err)
            raise err

    def fired(self, site: str) -> int:
        rule = self._rules.get(site)
        return rule.fired if rule is not None else 0


_lock = threading.Lock()
#: (spec, seed) -> live injector.  A dict, not a single slot: concurrent
#: threads under different thread-local inject scopes must each keep their
#: own firing state — a single slot would rebuild on every alternation and
#: silently re-arm the other thread's already-spent `once` budgets.
_injectors: Dict[Tuple[str, int], FaultInjector] = {}
_INJECTOR_CAP = 64


def get_injector(config) -> Optional[FaultInjector]:
    """The process-global injector for the (spec, seed) this thread's
    config sees.

    Firing state is intentionally retained while (spec, seed) stays the
    same (an ``oom:once`` stays spent across queries); changing either —
    or calling reset() — re-arms the budgets."""
    spec = config.get(CONFIG_KEY)
    if not spec:
        return None
    key = (str(spec), int(config.get(SEED_KEY, 0) or 0))
    with _lock:
        inj = _injectors.get(key)
        if inj is None:
            if len(_injectors) >= _INJECTOR_CAP:
                _injectors.clear()  # test-only state; bound it crudely
            inj = _injectors[key] = FaultInjector(*key)
        return inj


def reset() -> None:
    """Forget every active injector (tests: re-arm `once` budgets)."""
    with _lock:
        _injectors.clear()


def maybe_inject(site: str, config) -> None:
    """Hot-path hook: no-op unless ``resilience.inject`` is set."""
    inj = get_injector(config)
    if inj is not None:
        inj.check(site)



def hang_duration(site: str, config) -> float:
    """Seconds a HANG-site fault should sleep now, 0.0 when not armed.
    Resolved on the calling thread (config overlays are thread-local); the
    watchdog passes the duration into its helper thread, which sleeps."""
    inj = get_injector(config)
    if inj is None or not inj.arm(site):
        return 0.0
    return float(config.get(HANG_SECONDS_KEY, 30.0) or 0.0)
