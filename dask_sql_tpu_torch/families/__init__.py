"""Parameterized plan families.

Counterpart of `dask_sql_tpu/families/__init__.py`, with the parts the
planning and compiled paths use: a *family* is the set of queries that
differ only in literal values (``WHERE d <= DATE '1998-09-02'`` and
``WHERE d <= DATE '1998-08-01'``).  `family_of` gives a planned query its
family identity; the compiled pipelines (physical/compiled*.py) rewrite
their expressions with `pipeline_parameterizer`, key their caches on the
parameterized expressions and take the values at run time, so one
pipeline serves the whole family (``families.hit``).  The family batcher
(`families/batcher.py`, serving) is not in the port yet.
"""
from __future__ import annotations

import logging
from typing import Optional

from .parameterize import (
    FamilyInfo,
    Parameterizer,
    compute_family,
    normalize_in_values,
    pow2_bucket,
    stack_params,
)

logger = logging.getLogger(__name__)

__all__ = [
    "FamilyInfo",
    "Parameterizer",
    "compute_family",
    "enabled",
    "family_of",
    "normalize_in_values",
    "pipeline_parameterizer",
    "pow2_bucket",
    "stack_params",
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
    except Exception:
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
