"""Optimizer rule driver (parity: reference optimizer.rs rule list + observe
tracing, optimizer.rs:132-138).

Copied from `dask_sql_tpu/planner/optimizer/driver.py`; only import paths differ.
"""
from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

_RULES = None


def _load_rules():
    global _RULES
    if _RULES is None:
        from . import rules

        # Order matters (parity: optimizer.rs:53-98)
        _RULES = [
            rules.SimplifyExpressions(),
            rules.UnwrapCastInComparison(),
            rules.DecorrelateSubqueries(),
            rules.SimplifyExpressions(),
            rules.RewriteDisjunctivePredicate(),
            rules.EliminateCrossJoin(),
            rules.EliminateLimit(),
            rules.FilterNullJoinKeys(),
            rules.EliminateOuterJoin(),
            rules.PushDownLimit(),
            rules.PushDownFilter(),
            rules.SimplifyExpressions(),
            rules.UnwrapCastInComparison(),
            rules.PushDownProjection(),
            rules.PushDownLimit(),
        ]
    return _RULES


def optimize_core(plan, config, catalog):
    """The structural rule loop (2 x 15 slots).  The native planner
    (native/binder.cpp Optimizer) runs this same loop in C++; this Python
    twin is the fallback and the differential-test reference."""
    rules = _load_rules()
    verbose = bool(config.get("sql.optimizer.verbose", False))
    # two passes: pushdowns expose new opportunities (e.g. cross-join
    # elimination after filters sink) — parity with the reference pipeline
    # repeating SimplifyExpressions/PushDownLimit (optimizer.rs:53-98)
    for _ in range(2):
        for rule in rules:
            new_plan = rule.apply(plan, config, catalog)
            if new_plan is not None:
                if verbose and new_plan is not plan:
                    logger.info("After %s:\n%s", type(rule).__name__, new_plan.explain())
                plan = new_plan
    return plan


def optimize_post(plan, config, catalog, context=None, skip_reorder=False):
    """Statistics/data-driven passes after the structural loop: join
    reordering (needs row counts; skipped when the native planner already
    reordered), dynamic partition pruning (reads data at plan time), and
    the embedded-subquery pipeline."""
    from . import join_reorder, rules

    if not skip_reorder:
        plan = join_reorder.maybe_reorder(plan, config, catalog)
    if config.get("sql.dynamic_partition_pruning", True):
        from . import dpp

        plan = dpp.apply(plan, config, catalog, context)
    # reorder/DPP introduce projections and filters of their own — prune again
    plan = rules.PushDownProjection().apply(plan, config, catalog)
    plan = _optimize_embedded_subqueries(plan, config, catalog, context)
    return plan


def optimize_plan(plan, config, catalog, context=None):
    plan = optimize_core(plan, config, catalog)
    return optimize_post(plan, config, catalog, context)


def _optimize_embedded_subqueries(plan, config, catalog, context):
    """Run the full pipeline on plans embedded INSIDE expressions.

    Uncorrelated subqueries that decorrelation leaves as runtime expressions
    (scalar subquery broadcast, IN/EXISTS probes) carry whole plan trees the
    node-walking rules never see — q23's max_store_sales CTE executed as a
    three-way CROSS join (182M rows at 1000-row scale) because its equijoin
    predicates were never pushed.  Correlated remnants (carrying _OuterRef,
    the reference-xfail shapes) are left untouched: pushdown's column
    remapping must not rewrite outer indices."""
    from dataclasses import replace as _dc_replace

    from ..binder import _OuterRef
    from ..expressions import (
        ExistsExpr,
        InSubqueryExpr,
        ScalarSubqueryExpr,
        transform,
        walk,
    )
    from . import rules as R

    def subplan_correlated(sub) -> bool:
        found = [False]

        def check(e):
            for x in walk(e):
                if isinstance(x, _OuterRef):
                    found[0] = True
                # walk() stops at expression boundaries — a correlated
                # remnant one subquery level deeper must also fence off
                # this whole subtree (its outer refs point into OUR schema)
                if (isinstance(x, (ScalarSubqueryExpr, InSubqueryExpr,
                                   ExistsExpr))
                        and getattr(x, "plan", None) is not None
                        and subplan_correlated(x.plan)):
                    found[0] = True
            return e

        def go(node):
            R._map_node_exprs(node, check)
            for k in node.inputs():
                go(k)

        go(sub)
        return found[0]

    def fix_expr(e):
        def fn(x):
            if (isinstance(x, (ScalarSubqueryExpr, InSubqueryExpr, ExistsExpr))
                    and getattr(x, "plan", None) is not None
                    and not subplan_correlated(x.plan)):
                new = optimize_plan(x.plan, config, catalog, context)
                if new is not x.plan:
                    return _dc_replace(x, plan=new)
            return x

        return transform(e, fn)

    def go(node):
        node = R._rewrite_children(node, go)
        return R._map_node_exprs(node, fix_expr)

    return go(plan)
