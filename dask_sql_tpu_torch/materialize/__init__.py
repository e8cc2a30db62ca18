"""Semantic result reuse: the tiers above the exact-match result cache.

The serving result cache (serving/cache.py) answers only byte-identical
repeats: same family, same parameter values, same catalog state.  Real
dashboard traffic is near-identical instead — the same scan->filter stem
under many different downstream shapes, the same filter family with
progressively tighter literals, the same aggregates over a table that only
ever grows by appends.  This package answers those:

- `manager.MaterializationManager` (``context.materialize``) — sub-plan
  materialization: hot plan prefixes (stems, `families.compute_stem`) are
  pinned as device-resident tables charged to the HBM ledger's
  ``materialized`` component, and matching plans are rewritten to scan the
  pinned stem instead of the base table;
- `subsume` — subsumption answering: a cached result serves a tighter
  query of the same family when parameter-interval containment is
  PROVABLE (analysis/estimator.py interval algebra), by re-filtering the
  cached rows;
- `incremental` — incremental maintenance: `Context.append_rows` bumps a
  per-table delta epoch and folds only the appended chunk through stored
  streamed-combine partial states, instead of invalidating wholesale and
  rescanning history.

The port's copy of `dask_sql_tpu/materialize/`: every tier answers on the
Context's device (materialize/manager.py, subsume.py, incremental.py say
how).

Config: ``serving.materialize.*`` and ``serving.reuse.*`` (config.py);
observability: ``serving.materialize.*`` / ``serving.reuse.*`` metrics and
``materialize.store/hit/evict/refresh`` flight events; SQL surface:
``SHOW MATERIALIZED`` and ``INSERT INTO``.
"""
from __future__ import annotations

from .incremental import IncrementalStates
from .manager import CATALOG_RESOLVING_RUNGS, MaterializationManager
from .subsume import SubsumeSpec, analyze, contains, serve

__all__ = [
    "CATALOG_RESOLVING_RUNGS",
    "IncrementalStates",
    "MaterializationManager",
    "SubsumeSpec",
    "analyze",
    "contains",
    "serve",
]
