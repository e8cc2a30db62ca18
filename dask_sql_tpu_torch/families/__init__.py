"""Parameterized plan families.

Counterpart of `dask_sql_tpu/families/__init__.py`, with the parts the
planning and compiled paths use: a *family* is the set of queries that
differ only in literal values (``WHERE d <= DATE '1998-09-02'`` and
``WHERE d <= DATE '1998-08-01'``).  `family_of` gives a planned query its
family identity, `compute_stem` its scan->filter prefix's (the stem
`materialize/` pins); the compiled pipelines (physical/compiled*.py) rewrite
their expressions with `pipeline_parameterizer`, key their caches on the
parameterized expressions and take the values at run time, so one
pipeline serves the whole family (``families.hit``).  Under the serving
runtime the family batcher (`batcher.py`, `batcher_of`) answers
concurrently admitted members of one family with one stacked launch.
"""
from __future__ import annotations

import logging
from typing import Optional

from .batcher import FamilyBatcher
from .parameterize import (
    FamilyInfo,
    Parameterizer,
    StemInfo,
    compute_family,
    compute_stem,
    full_width_stem,
    normalize_in_values,
    pow2_bucket,
    stem_of,
)

logger = logging.getLogger(__name__)

__all__ = [
    "FamilyBatcher",
    "FamilyInfo",
    "Parameterizer",
    "StemInfo",
    "batcher_of",
    "compute_family",
    "compute_stem",
    "enabled",
    "family_of",
    "full_width_stem",
    "normalize_in_values",
    "pipeline_parameterizer",
    "pow2_bucket",
    "stem_of",
]


def enabled(config) -> bool:
    mode = str(config.get("families.enabled", True)).lower()
    return mode not in ("off", "false", "0", "none")


def family_of(plan, config, metrics=None) -> Optional[FamilyInfo]:
    """The `FamilyInfo` of a planned query, computed once and memoized on
    the plan object (plans are cached per SQL text, so their literals are
    fixed).  None for custom statements, with families disabled, or when
    the pass fails (``families.internal_error``): parameterization is
    advisory and never blocks a query."""
    from ..planner import plan as p

    if plan is None or isinstance(plan, p.CustomNode):
        return None
    if not enabled(config):
        return None
    info = getattr(plan, "_dsql_family", None)
    if info is not None:
        return info
    try:
        info = compute_family(plan)
        plan._dsql_family = info
        return info
    except Exception:  # dsql: allow-broad-except — advisory analysis: an
        # unparameterizable plan simply keeps its literal-baked identity
        if metrics is not None:
            metrics.inc("families.internal_error")
        logger.debug("family parameterization failed; using literal plan "
                     "identity", exc_info=True)
        return None


def pipeline_parameterizer(config) -> Parameterizer:
    """The rewrite pass the compiled pipelines run on their extracted
    expression lists (no subplan recursion: subquery expressions decline
    in the pipelines anyway)."""
    return Parameterizer(enabled=enabled(config), recurse_subplans=False)


def batcher_of(context) -> Optional[FamilyBatcher]:
    """The serving runtime's family batcher, when one is attached and
    batching is on: the compiled aggregate consults this before it
    launches."""
    runtime = getattr(context, "serving", None)
    batcher = getattr(runtime, "batcher", None)
    if batcher is None or batcher.max_queries <= 1:
        return None
    return batcher
