"""Optimizer rules.

Copied from `dask_sql_tpu/planner/optimizer/rules.py`; only import paths differ.

Role parity: the reference's DataFusion rule pipeline (optimizer.rs:53-98):
SimplifyExpressions, DecorrelateWhereExists/In (decorrelate_where_*.rs),
EliminateCrossJoin, EliminateLimit, FilterNullJoinKeys, PushDownLimit,
PushDownFilter, PushDownProjection/EliminateProjection.  Implemented over our
plan IR; each rule returns a (possibly) new plan.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Set, Tuple

from ...columnar.dtypes import SqlType
from .. import plan as p
from ..binder import _OuterRef, split_join_condition
from ..expressions import (
    AggExpr,
    CaseExpr,
    Cast,
    ColumnRef,
    ExistsExpr,
    Expr,
    Field,
    InListExpr,
    InSubqueryExpr,
    Literal,
    ScalarFunc,
    ScalarSubqueryExpr,
    SortKey,
    WindowExpr,
    referenced_columns,
    remap_columns,
    shift_columns,
    transform,
    walk,
)


class Rule:
    def apply(self, plan, config, catalog):
        return self.rewrite(plan, config, catalog)

    def rewrite(self, plan, config, catalog):
        return None


def _rewrite_children(plan, fn):
    kids = plan.inputs()
    if not kids:
        return plan
    new_kids = [fn(k) for k in kids]
    if all(a is b for a, b in zip(kids, new_kids)):
        return plan
    return plan.with_inputs(new_kids)


# ---------------------------------------------------------------------------
# SimplifyExpressions: constant folding + boolean simplification
# ---------------------------------------------------------------------------
_FOLDABLE = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
}


def simplify_expr(e: Expr) -> Expr:
    def fn(x: Expr) -> Expr:
        if isinstance(x, ScalarFunc):
            args = x.args
            if x.op in ("and", "or") and len(args) == 2:
                a, b = args
                if isinstance(a, Literal) and isinstance(a.value, bool):
                    if x.op == "and":
                        return b if a.value else Literal(False, SqlType.BOOLEAN)
                    return Literal(True, SqlType.BOOLEAN) if a.value else b
                if isinstance(b, Literal) and isinstance(b.value, bool):
                    if x.op == "and":
                        return a if b.value else Literal(False, SqlType.BOOLEAN)
                    return Literal(True, SqlType.BOOLEAN) if b.value else a
            if x.op == "not" and isinstance(args[0], Literal) and isinstance(args[0].value, bool):
                return Literal(not args[0].value, SqlType.BOOLEAN)
            if x.op == "not" and isinstance(args[0], ScalarFunc) and args[0].op == "not":
                return args[0].args[0]
            if (x.op in _FOLDABLE and len(args) == 2
                    and all(isinstance(a, Literal) and a.value is not None
                            and not isinstance(a.value, str) for a in args)):
                try:
                    val = _FOLDABLE[x.op](args[0].value, args[1].value)
                    return Literal(val, x.sql_type)
                except (ArithmeticError, ValueError, TypeError):
                    return x  # unfoldable literal pair: leave for runtime
        if isinstance(x, Cast) and isinstance(x.arg, Literal):
            from ..binder import _cast_literal

            try:
                if x.arg.value is None:
                    return Literal(None, x.sql_type)
                lit = _cast_literal(Literal(x.arg.value, x.arg.sql_type), x.sql_type)
                return Literal(lit.value, x.sql_type)
            except (ArithmeticError, ValueError, TypeError, KeyError):
                return x  # uncastable literal: leave the CAST for runtime
        if isinstance(x, Cast) and x.arg.sql_type == x.sql_type:
            return x.arg
        return x

    return transform(e, fn)


def _map_node_exprs(plan, fn):
    """Apply fn to every expression held by this node (not recursive)."""
    if isinstance(plan, p.Projection):
        return p.Projection(plan.input, [fn(e) for e in plan.exprs], plan.schema)
    if isinstance(plan, p.Filter):
        return p.Filter(plan.input, fn(plan.predicate), plan.schema)
    if isinstance(plan, p.Join):
        on = [(fn(l), fn(r)) for l, r in plan.on]
        filt = fn(plan.filter) if plan.filter is not None else None
        return p.Join(plan.left, plan.right, plan.join_type, on, filt,
                      plan.schema, plan.null_aware)
    if isinstance(plan, p.Aggregate):
        return p.Aggregate(plan.input, [fn(e) for e in plan.group_exprs],
                           [fn(e) for e in plan.agg_exprs], plan.schema)
    if isinstance(plan, p.Sort):
        keys = [replace(k, expr=fn(k.expr)) for k in plan.keys]
        return p.Sort(plan.input, keys, plan.schema, plan.fetch)
    if isinstance(plan, p.Window):
        return p.Window(plan.input, [fn(e) for e in plan.window_exprs], plan.schema)
    if isinstance(plan, p.TableScan) and plan.filters:
        return p.TableScan(plan.schema_name, plan.table_name, plan.schema,
                           plan.projection, [fn(f) for f in plan.filters])
    return plan


class SimplifyExpressions(Rule):
    def apply(self, plan, config, catalog):
        def go(node):
            node = _rewrite_children(node, go)
            return _map_node_exprs(node, simplify_expr)

        return go(plan)


# ---------------------------------------------------------------------------
# EliminateCrossJoin (parity: DataFusion rule; enables TPC-H comma joins)
# ---------------------------------------------------------------------------
class EliminateCrossJoin(Rule):
    def apply(self, plan, config, catalog):
        def go(node):
            node = _rewrite_children(node, go)
            if isinstance(node, p.Filter) and isinstance(node.input, p.CrossJoin):
                cj = node.input
                nleft = len(cj.left.schema)
                on, residual = split_join_condition(node.predicate, nleft)
                if on:
                    join = p.Join(cj.left, cj.right, "INNER", on, None, cj.schema)
                    if residual is not None:
                        return p.Filter(join, residual, join.schema)
                    return join
            if isinstance(node, p.Filter) and isinstance(node.input, p.Join) \
                    and node.input.join_type == "INNER":
                # promote further equi conjuncts into the join keys
                j = node.input
                nleft = len(j.left.schema)
                on, residual = split_join_condition(node.predicate, nleft)
                if on:
                    join = p.Join(j.left, j.right, "INNER", list(j.on) + on,
                                  j.filter, j.schema)
                    if residual is not None:
                        return p.Filter(join, residual, join.schema)
                    return join
            return node

        return go(plan)


# ---------------------------------------------------------------------------
# EliminateLimit
# ---------------------------------------------------------------------------
class EliminateLimit(Rule):
    def apply(self, plan, config, catalog):
        def go(node):
            node = _rewrite_children(node, go)
            if isinstance(node, p.Limit) and node.fetch is None and not node.skip:
                return node.input
            if isinstance(node, p.Limit) and isinstance(node.input, p.Limit):
                inner = node.input
                skip = inner.skip + node.skip
                fetches = [f for f in (
                    None if inner.fetch is None else max(inner.fetch - node.skip, 0),
                    node.fetch) if f is not None]
                fetch = min(fetches) if fetches else None
                return p.Limit(inner.input, skip, fetch, node.schema)
            return node

        return go(plan)


# ---------------------------------------------------------------------------
# PushDownLimit: LIMIT into Sort.fetch / through projections
# ---------------------------------------------------------------------------
class PushDownLimit(Rule):
    def apply(self, plan, config, catalog):
        def go(node):
            node = _rewrite_children(node, go)
            if isinstance(node, p.Limit) and node.fetch is not None:
                want = node.skip + node.fetch
                child = node.input
                if isinstance(child, p.Sort):
                    if child.fetch is None or child.fetch > want:
                        child = p.Sort(child.input, child.keys, child.schema, want)
                        return p.Limit(child, node.skip, node.fetch, node.schema)
                if isinstance(child, p.Projection):
                    pushed = p.Limit(child.input, 0, want, child.input.schema)
                    proj = p.Projection(pushed, child.exprs, child.schema)
                    return p.Limit(proj, node.skip, node.fetch, node.schema)
                if isinstance(child, p.Union) and child.all:
                    kids = [p.Limit(c, 0, want, c.schema) for c in child.children]
                    u = p.Union(kids, True, child.schema)
                    return p.Limit(u, node.skip, node.fetch, node.schema)
            return node

        return go(plan)


# ---------------------------------------------------------------------------
# PushDownFilter
# ---------------------------------------------------------------------------
def _conjuncts(e: Expr) -> List[Expr]:
    if isinstance(e, ScalarFunc) and e.op == "and":
        out = []
        for a in e.args:
            out.extend(_conjuncts(a))
        return out
    return [e]


def _conjoin(parts: List[Expr]) -> Optional[Expr]:
    if not parts:
        return None
    out = parts[0]
    for x in parts[1:]:
        out = ScalarFunc("and", (out, x), SqlType.BOOLEAN)
    return out


def _is_volatile(e: Expr) -> bool:
    return any(isinstance(x, ScalarFunc) and x.op in ("rand", "rand_integer")
               for x in walk(e))


def _has_subquery(e: Expr) -> bool:
    return any(isinstance(x, (ScalarSubqueryExpr, InSubqueryExpr, ExistsExpr))
               for x in walk(e))


class PushDownFilter(Rule):
    def apply(self, plan, config, catalog):
        def go(node):
            node = _rewrite_children(node, go)
            if not isinstance(node, p.Filter):
                return node
            child = node.input
            parts = _conjuncts(node.predicate)

            if isinstance(child, p.Filter):
                merged = _conjoin(parts + _conjuncts(child.predicate))
                return go(p.Filter(child.input, merged, child.schema))

            if isinstance(child, p.Projection):
                pushable, kept = [], []
                for c in parts:
                    if _is_volatile(c) or _has_subquery(c):
                        kept.append(c)
                        continue
                    cols = referenced_columns(c)
                    if all(isinstance(child.exprs[i], (ColumnRef, Literal, Cast,
                                                       ScalarFunc, CaseExpr))
                           and not isinstance(child.exprs[i], AggExpr)
                           for i in cols) and not any(
                               isinstance(child.exprs[i], WindowExpr) or
                               any(isinstance(w, (AggExpr, WindowExpr))
                                   for w in walk(child.exprs[i]))
                               for i in cols):
                        pushable.append(c)
                    else:
                        kept.append(c)
                if pushable:
                    def subst(e):
                        def fn(x):
                            if isinstance(x, ColumnRef) and type(x) is ColumnRef:
                                return child.exprs[x.index]
                            return x
                        return transform(e, fn)

                    pushed_pred = _conjoin([subst(c) for c in pushable])
                    new_input = go(p.Filter(child.input, pushed_pred, child.input.schema))
                    proj = p.Projection(new_input, child.exprs, child.schema)
                    if kept:
                        return p.Filter(proj, _conjoin(kept), child.schema)
                    return proj
                return node

            if isinstance(child, p.SubqueryAlias):
                inner = p.Filter(child.input, node.predicate, child.input.schema)
                return p.SubqueryAlias(go(inner), child.alias, child.schema)

            if isinstance(child, p.Sort):
                inner = go(p.Filter(child.input, node.predicate, child.input.schema))
                return p.Sort(inner, child.keys, child.schema, child.fetch)

            if isinstance(child, (p.Join, p.CrossJoin)):
                nleft = len(child.inputs()[0].schema)
                jt = child.join_type if isinstance(child, p.Join) else "CROSS"
                left_parts, right_parts, kept = [], [], []
                for c in parts:
                    if _is_volatile(c) or _has_subquery(c):
                        kept.append(c)
                        continue
                    cols = referenced_columns(c)
                    if cols and max(cols) < nleft and jt in ("INNER", "LEFT", "CROSS",
                                                            "LEFTSEMI", "LEFTANTI",
                                                            "LEFTMARK"):
                        left_parts.append(c)
                    elif cols and min(cols) >= nleft and jt in ("INNER", "RIGHT", "CROSS"):
                        right_parts.append(shift_columns(c, -nleft))
                    else:
                        kept.append(c)
                if left_parts or right_parts:
                    l, r = child.inputs()
                    if left_parts:
                        l = go(p.Filter(l, _conjoin(left_parts), l.schema))
                    if right_parts:
                        r = go(p.Filter(r, _conjoin(right_parts), r.schema))
                    new_child = child.with_inputs([l, r])
                    if kept:
                        return p.Filter(new_child, _conjoin(kept), node.schema)
                    return new_child
                return node

            if isinstance(child, p.Union):
                kids = [go(p.Filter(c, node.predicate, c.schema)) for c in child.children]
                return p.Union(kids, child.all, child.schema)

            if isinstance(child, p.Aggregate):
                ngroups = len(child.group_exprs)
                pushable, kept = [], []
                for c in parts:
                    cols = referenced_columns(c)
                    if cols and max(cols) < ngroups and not _is_volatile(c) \
                            and not _has_subquery(c):
                        pushable.append(c)
                    else:
                        kept.append(c)
                if pushable:
                    def subst(e):
                        def fn(x):
                            if isinstance(x, ColumnRef) and type(x) is ColumnRef:
                                return child.group_exprs[x.index]
                            return x
                        return transform(e, fn)

                    inner = go(p.Filter(child.input, _conjoin([subst(c) for c in pushable]),
                                        child.input.schema))
                    agg = p.Aggregate(inner, child.group_exprs, child.agg_exprs, child.schema)
                    if kept:
                        return p.Filter(agg, _conjoin(kept), child.schema)
                    return agg
                return node

            if isinstance(child, p.TableScan) and config.get("sql.predicate_pushdown", True):
                ok, kept = [], []
                for c in parts:
                    if _is_volatile(c) or _has_subquery(c):
                        kept.append(c)
                    else:
                        ok.append(c)
                if ok:
                    scan = p.TableScan(child.schema_name, child.table_name, child.schema,
                                       child.projection, list(child.filters) + ok)
                    if kept:
                        return p.Filter(scan, _conjoin(kept), child.schema)
                    return scan
                return node
            return node

        return go(plan)


# ---------------------------------------------------------------------------
# FilterNullJoinKeys: no-op here — the join kernel drops NULL keys natively
# (ops/join.py sentinel gids), which is the semantic this rule protects.
# ---------------------------------------------------------------------------
class FilterNullJoinKeys(Rule):
    def apply(self, plan, config, catalog):
        return plan


# ---------------------------------------------------------------------------
# PushDownProjection: column pruning down to TableScan.projection
# ---------------------------------------------------------------------------
class PushDownProjection(Rule):
    def apply(self, plan, config, catalog):
        required = set(range(len(plan.schema)))
        new_plan, mapping = _prune(plan, required)
        # top level must keep all columns in order
        if mapping != {i: i for i in required}:
            exprs = []
            fields = []
            for i in sorted(required):
                f = plan.schema[i]
                exprs.append(ColumnRef(mapping[i], f.name, f.sql_type, f.nullable))
                fields.append(f)
            return p.Projection(new_plan, exprs, fields)
        return new_plan


def _node_exprs(plan) -> List[Expr]:
    if isinstance(plan, p.Projection):
        return list(plan.exprs)
    if isinstance(plan, p.Filter):
        return [plan.predicate]
    if isinstance(plan, p.Sort):
        return [k.expr for k in plan.keys]
    if isinstance(plan, p.Aggregate):
        return list(plan.group_exprs) + list(plan.agg_exprs)
    if isinstance(plan, p.Window):
        return list(plan.window_exprs)
    if isinstance(plan, p.DistributeBy):
        return list(plan.keys)
    return []


def _prune(plan, required: Set[int]) -> Tuple[p.LogicalPlan, Dict[int, int]]:
    """Prune unused columns bottom-up.  Returns (new_plan, old->new index map)."""
    ident = {i: i for i in range(len(plan.schema))}

    if isinstance(plan, p.TableScan):
        # scan filters may reference pruned columns — those must stay readable
        fcols = set()
        for f in plan.filters:
            fcols |= referenced_columns(f)
        keep = sorted(set(required) | fcols)
        if len(keep) == len(plan.schema) and plan.projection is None:
            return plan, ident
        mapping = {old: new for new, old in enumerate(keep)}
        fields = [plan.schema[i] for i in keep]
        names = [f.name for f in fields]
        filters = [remap_columns(f, mapping) for f in plan.filters]
        scan = p.TableScan(plan.schema_name, plan.table_name, fields, names, filters)
        return scan, mapping

    if isinstance(plan, p.Projection):
        keep = sorted(required)
        child_req = set()
        for i in keep:
            child_req |= referenced_columns(plan.exprs[i])
        new_child, cmap = _prune(plan.input, child_req)
        mapping = {old: new for new, old in enumerate(keep)}
        exprs = [remap_columns(plan.exprs[i], cmap) for i in keep]
        fields = [plan.schema[i] for i in keep]
        return p.Projection(new_child, exprs, fields), mapping

    if isinstance(plan, p.Filter):
        child_req = set(required) | referenced_columns(plan.predicate)
        new_child, cmap = _prune(plan.input, child_req)
        pred = remap_columns(plan.predicate, cmap)
        mapping = {old: cmap[old] for old in child_req}
        f = p.Filter(new_child, pred, list(new_child.schema))
        return f, mapping

    if isinstance(plan, p.Join) and plan.join_type == "LEFTMARK":
        kids = plan.inputs()
        new_kids = [_prune(k, set(range(len(k.schema))))[0] for k in kids]
        if any(a is not b for a, b in zip(kids, new_kids)):
            plan = plan.with_inputs(new_kids)
        return plan, {i: i for i in range(len(plan.schema))}

    if isinstance(plan, p.Join):
        nleft = len(plan.left.schema)
        need = set(required)
        for l, r in plan.on:
            need |= referenced_columns(l) | referenced_columns(r)
        if plan.filter is not None:
            need |= referenced_columns(plan.filter)
        lreq = {i for i in need if i < nleft}
        rreq = {i - nleft for i in need if i >= nleft}
        if plan.join_type in ("LEFTSEMI", "LEFTANTI"):
            pass
        new_left, lmap = _prune(plan.left, lreq)
        new_right, rmap = _prune(plan.right, rreq)
        new_nleft = len(new_left.schema)
        cmap = {}
        for old in lreq:
            cmap[old] = lmap[old]
        for old in rreq:
            cmap[old + nleft] = rmap[old] + new_nleft
        on = [(remap_columns(l, cmap), remap_columns(r, cmap)) for l, r in plan.on]
        filt = remap_columns(plan.filter, cmap) if plan.filter is not None else None
        if plan.join_type in ("LEFTSEMI", "LEFTANTI"):
            fields = list(new_left.schema)
            mapping = {old: lmap[old] for old in required}
        else:
            keep = sorted(cmap)
            fields_all = list(new_left.schema) + list(new_right.schema)
            fields = fields_all
            mapping = {old: cmap[old] for old in required}
        j = p.Join(new_left, new_right, plan.join_type, on, filt, fields,
                   plan.null_aware)
        return j, mapping

    if isinstance(plan, p.CrossJoin):
        nleft = len(plan.left.schema)
        lreq = {i for i in required if i < nleft}
        rreq = {i - nleft for i in required if i >= nleft}
        new_left, lmap = _prune(plan.left, lreq)
        new_right, rmap = _prune(plan.right, rreq)
        new_nleft = len(new_left.schema)
        mapping = {}
        for old in lreq:
            mapping[old] = lmap[old]
        for old in rreq:
            mapping[old + nleft] = rmap[old] + new_nleft
        fields = list(new_left.schema) + list(new_right.schema)
        return p.CrossJoin(new_left, new_right, fields), {o: mapping[o] for o in required}

    if isinstance(plan, p.Aggregate):
        ngroups = len(plan.group_exprs)
        keep_aggs = sorted({i - ngroups for i in required if i >= ngroups})
        child_req = set()
        for g in plan.group_exprs:
            child_req |= referenced_columns(g)
        for i in keep_aggs:
            child_req |= referenced_columns(plan.agg_exprs[i])
        new_child, cmap = _prune(plan.input, child_req)
        groups = [remap_columns(g, cmap) for g in plan.group_exprs]
        aggs = [remap_columns(plan.agg_exprs[i], cmap) for i in keep_aggs]
        fields = ([plan.schema[i] for i in range(ngroups)]
                  + [plan.schema[ngroups + i] for i in keep_aggs])
        mapping = {}
        for i in required:
            if i < ngroups:
                mapping[i] = i
            else:
                mapping[i] = ngroups + keep_aggs.index(i - ngroups)
        return p.Aggregate(new_child, groups, aggs, fields), mapping

    if isinstance(plan, (p.Sort, p.DistributeBy)):
        exprs = _node_exprs(plan)
        child_req = set(required)
        for e in exprs:
            child_req |= referenced_columns(e)
        new_child, cmap = _prune(plan.input, child_req)
        if isinstance(plan, p.Sort):
            keys = [replace(k, expr=remap_columns(k.expr, cmap)) for k in plan.keys]
            fields = list(new_child.schema)
            mapping = {old: cmap[old] for old in required}
            return p.Sort(new_child, keys, fields, plan.fetch), mapping
        keys = [remap_columns(k, cmap) for k in plan.keys]
        mapping = {old: cmap[old] for old in required}
        return p.DistributeBy(new_child, keys, list(new_child.schema)), mapping

    if isinstance(plan, p.Limit):
        new_child, cmap = _prune(plan.input, set(required))
        mapping = {old: cmap[old] for old in required}
        return p.Limit(new_child, plan.skip, plan.fetch, list(new_child.schema)), mapping

    if isinstance(plan, p.SubqueryAlias):
        new_child, cmap = _prune(plan.input, set(required))
        mapping = {old: cmap[old] for old in required}
        return p.SubqueryAlias(new_child, plan.alias,
                               list_fields(plan, new_child, cmap)), mapping

    # default: this node's own schema stays intact, but children still get a
    # pruning pass with full requirements (lets scans below Union/Window/
    # Distinct/Explain drop unused columns via their own chains)
    kids = plan.inputs()
    if kids:
        new_kids = [
            _prune(k, set(range(len(k.schema))))[0] for k in kids
        ]
        if any(a is not b for a, b in zip(kids, new_kids)):
            plan = plan.with_inputs(new_kids)
    return plan, ident


def list_fields(plan, new_child, cmap):
    # SubqueryAlias keeps child schema order; rebuild names from the alias schema
    inv = {v: k for k, v in cmap.items()}
    out = []
    for new_idx in range(len(new_child.schema)):
        old = inv.get(new_idx)
        if old is not None and old < len(plan.schema):
            out.append(plan.schema[old])
        else:
            out.append(new_child.schema[new_idx])
    return out


# ---------------------------------------------------------------------------
# Subquery decorrelation (parity: decorrelate_where_exists.rs / _where_in.rs)
# ---------------------------------------------------------------------------
class DecorrelateSubqueries(Rule):
    def apply(self, plan, config, catalog):
        def go_expr(e: Expr) -> Expr:
            """Recurse into subquery plans embedded in expressions."""
            def fn(x):
                if isinstance(x, (ScalarSubqueryExpr, InSubqueryExpr, ExistsExpr)):
                    from dataclasses import replace as _rp

                    return _rp(x, plan=go(x.plan))
                return x

            return transform(e, fn)

        def go(node):
            node = _rewrite_children(node, go)
            node = _map_node_exprs(node, go_expr)
            if not isinstance(node, p.Filter):
                return node
            # factor common conjuncts out of disjunctions FIRST: q41's
            # correlation hides as (corr AND a) OR (corr AND b), which
            # factors to corr AND (a OR b) — only then is the equality
            # extractable.  (RewriteDisjunctivePredicate can't reach
            # filters inside expr-embedded subquery plans; this walk can.)
            factored = _rewrite_disjunction(node.predicate)
            parts = _conjuncts(factored)
            child = node.input
            orig_width = len(child.schema)
            orig_schema = list(child.schema)
            changed = False
            kept: List[Expr] = []
            for c in parts:
                new_child = self._try_rewrite(c, child)
                if new_child is not None:
                    child = new_child
                    changed = True
                    continue
                res = self._rewrite_scalar(c, child)
                if res is not None:
                    child, new_c = res
                    kept.append(new_c)
                    changed = True
                    continue
                res = self._rewrite_marks(c, child)
                if res is not None:
                    child, new_c = res
                    kept.append(new_c)
                    changed = True
                    continue
                kept.append(c)
            if not changed:
                if factored == node.predicate:
                    return node
                # keep the factored form: the OUTER query's scalar-subquery
                # extraction walks this filter and needs the correlation as
                # its own conjunct
                return p.Filter(child, factored, node.schema)
            out = p.Filter(child, _conjoin(kept), child.schema) if kept else child
            if len(out.schema) != orig_width:
                # scalar rewrites widened the row; project back
                refs = [ColumnRef(i, f.name, f.sql_type, f.nullable)
                        for i, f in enumerate(orig_schema)]
                out = p.Projection(out, refs, orig_schema)
            return out

        return go(plan)

    def _rewrite_scalar(self, conjunct: Expr, child):
        """`expr <op> (SELECT agg FROM ... WHERE inner = outer)` ->
        LEFT join against the per-key aggregated subquery.
        Parity: DataFusion's ScalarSubqueryToJoin in the reference pipeline."""
        subqs = [x for x in walk(conjunct) if isinstance(x, ScalarSubqueryExpr)]
        if len(subqs) != 1:
            return None
        sq = subqs[0]
        node = sq.plan
        while isinstance(node, p.SubqueryAlias):
            node = node.input
        if not isinstance(node, p.Projection) or len(node.exprs) != 1:
            return None
        agg = node.input
        if not isinstance(agg, p.Aggregate) or agg.group_exprs:
            return None
        core = agg.input
        pairs: List[Tuple[Expr, Expr]] = []
        kept: List[Expr] = []
        while isinstance(core, p.Filter):
            for c in _conjuncts(core.predicate):
                pr = _outer_eq_pair(c)
                if pr is not None:
                    pairs.append(pr)
                elif any(isinstance(x, _OuterRef) for x in walk(c)):
                    return None
                else:
                    kept.append(c)
            core = core.input
        if not pairs:
            return None  # uncorrelated: evaluated directly
        for e in _all_exprs_below(core) + list(agg.agg_exprs):
            if any(isinstance(x, _OuterRef) for x in walk(e)):
                return None
        if kept:
            core = p.Filter(core, _conjoin(kept), core.schema)
        key_exprs = [inner for _, inner in pairs]
        ngroups = len(key_exprs)
        agg_fields = ([Field(f"__sckey{i}", e.sql_type, True)
                       for i, e in enumerate(key_exprs)]
                      + [Field(f"__scagg{j}", a.sql_type, True)
                         for j, a in enumerate(agg.agg_exprs)])
        agg2 = p.Aggregate(core, key_exprs, list(agg.agg_exprs), agg_fields)
        # join the RAW aggregates (not the projected expression): the
        # subquery's projection is re-evaluated post-join, where COUNT-like
        # refs get COALESCE(.., 0) — their empty-input value — so unmatched
        # outer rows see COUNT()=0 even inside larger expressions
        # (DataFusion's ScalarSubqueryToJoin behaves the same way).
        naggs = len(agg.agg_exprs)
        sub_fields = ([Field(f"__scagg{j}", a.sql_type, True)
                       for j, a in enumerate(agg.agg_exprs)]
                      + [Field(f"__sckey{i}", e.sql_type, True)
                         for i, e in enumerate(key_exprs)])
        sub_exprs = ([ColumnRef(ngroups + j, f"__scagg{j}", a.sql_type, True)
                      for j, a in enumerate(agg.agg_exprs)]
                     + [ColumnRef(i, f"__sckey{i}", key_exprs[i].sql_type, True)
                        for i in range(ngroups)])
        sub = p.Projection(agg2, sub_exprs, sub_fields)
        nleft = len(child.schema)
        on = [(_outer_to_local(outer),
               ColumnRef(nleft + naggs + i, f"__sckey{i}",
                         key_exprs[i].sql_type, True))
              for i, (outer, _) in enumerate(pairs)]
        join_fields = list(child.schema) + sub_fields
        join = p.Join(child, sub, "LEFT", on, None, join_fields)
        count_like = {"count", "count_star", "regr_count"}

        def remap_agg_ref(x):
            if isinstance(x, ColumnRef):
                j = x.index
                a = agg.agg_exprs[j]
                ref: Expr = ColumnRef(nleft + j, f"__scagg{j}", a.sql_type, True)
                if a.func in count_like:
                    return ScalarFunc("coalesce",
                                      (ref, Literal(0, a.sql_type)), a.sql_type)
                return ref
            return x

        val_expr = transform(node.exprs[0], remap_agg_ref)

        def fn(x):
            if x is sq or x == sq:
                return val_expr
            return x

        new_conjunct = transform(conjunct, fn)
        return join, new_conjunct

    def _rewrite_marks(self, conjunct: Expr, child):
        """Correlated EXISTS that conjunct-wise rewriting can't reach (under
        OR / mixed boolean logic — TPC-DS q10/q35, which the reference
        xfails): each one becomes a MARK JOIN — a semi-join that APPENDS a
        boolean matched column instead of filtering — and the subquery
        expression is replaced by a reference to that column, so the
        disjunction evaluates as ordinary boolean arithmetic.  Returns
        (new_child, rewritten_conjunct) or None."""
        marks = [x for x in walk(conjunct) if isinstance(x, ExistsExpr)
                 and any(isinstance(y, _OuterRef)
                         for e in _all_exprs_below(x.plan) for y in walk(e))]
        if not marks:
            return None
        # plans are immutable, so a mid-loop decline just discards the
        # locally-built chain — no up-front validation pass needed
        replacements: Dict[int, Expr] = {}
        for sub in marks:
            mark_join = self._rewrite_exists(sub, child, anti=False,
                                             mark=True)
            if mark_join is None:
                return None
            nleft = len(child.schema)
            child = mark_join
            ref: Expr = ColumnRef(nleft, "__mark", SqlType.BOOLEAN, False)
            if sub.negated:
                ref = ScalarFunc("not", (ref,), SqlType.BOOLEAN)
            replacements[id(sub)] = ref

        def fn(x):
            return replacements.get(id(x), x)

        return child, transform(conjunct, fn)

    def _try_rewrite(self, pred: Expr, child) -> Optional[p.LogicalPlan]:
        # EXISTS / NOT EXISTS
        if isinstance(pred, ExistsExpr):
            return self._rewrite_exists(pred, child, anti=pred.negated)
        if isinstance(pred, ScalarFunc) and pred.op == "not" \
                and isinstance(pred.args[0], ExistsExpr):
            inner = pred.args[0]
            return self._rewrite_exists(inner, child, anti=not inner.negated)
        # IN subquery (correlated or not)
        if isinstance(pred, InSubqueryExpr):
            return self._rewrite_in(pred, child, anti=pred.negated)
        if isinstance(pred, ScalarFunc) and pred.op == "not" \
                and isinstance(pred.args[0], InSubqueryExpr):
            inner = pred.args[0]
            return self._rewrite_in(inner, child, anti=not inner.negated)
        return None

    def _extract_correlation(self, sub):
        """Decompose the subplan as [Alias?] Projection -> Filter* -> core and
        pull outer-ref conjuncts out of those filters.

        Returns (core_with_residual_filters, proj_exprs, pairs, corr_residuals)
        where proj_exprs / pairs / corr_residuals are bound against the core's
        schema (filters preserve positions); corr_residuals are non-equality
        correlated conjuncts (still containing _OuterRef markers).  Returns
        (None, None, [], []) when the shape doesn't match.
        """
        node = sub
        while isinstance(node, (p.SubqueryAlias, p.Distinct)):
            node = node.inputs()[0]
        if not isinstance(node, p.Projection):
            return None, None, [], []
        proj_exprs = list(node.exprs)
        pairs: List[Tuple[Expr, Expr]] = []
        corr_residuals: List[Expr] = []
        kept: List[Expr] = []
        core = node.input
        while isinstance(core, p.Filter):
            for c in _conjuncts(core.predicate):
                pr = _outer_eq_pair(c)
                if pr is not None:
                    pairs.append(pr)
                elif any(isinstance(x, _OuterRef) for x in walk(c)):
                    if _has_subquery(c):
                        return None, None, [], []
                    corr_residuals.append(c)
                else:
                    kept.append(c)
            core = core.input
        # nothing below the filters may reference the outer query
        for e in _all_exprs_below(core) + proj_exprs:
            if any(isinstance(x, _OuterRef) for x in walk(e)):
                return None, None, [], []
        if kept:
            core = p.Filter(core, _conjoin(kept), core.schema)
        return core, proj_exprs, pairs, corr_residuals

    def _rewrite_exists(self, pred: ExistsExpr, child, anti: bool,
                        mark: bool = False) -> Optional[p.LogicalPlan]:
        core, _, pairs, corr_residuals = self._extract_correlation(pred.plan)
        if core is None or not (pairs or corr_residuals):
            return None  # uncorrelated EXISTS is evaluated directly (cheap)
        nleft = len(child.schema)
        # subquery output := correlation keys + inner columns the residual needs
        key_exprs = [inner for _, inner in pairs]
        resid_inner = sorted({
            x.index for r in corr_residuals for x in walk(r)
            if isinstance(x, ColumnRef) and not isinstance(x, _OuterRef)})
        out_exprs = list(key_exprs) + [
            ColumnRef(i, core.schema[i].name, core.schema[i].sql_type,
                      core.schema[i].nullable) for i in resid_inner]
        fields = [Field(f"__ckey{i}", e.sql_type, True) for i, e in enumerate(out_exprs)]
        sub = p.Projection(core, out_exprs, fields)
        on = [(_outer_to_local(outer), ColumnRef(nleft + i, fields[i].name,
                                                 key_exprs[i].sql_type, True))
              for i, (outer, _) in enumerate(pairs)]
        # residuals: outer refs stay local (< nleft); inner refs point at the
        # projected copies (>= nleft)
        inner_pos = {idx: nleft + len(key_exprs) + j for j, idx in enumerate(resid_inner)}

        def fix_residual(r: Expr) -> Expr:
            def fn(x):
                if isinstance(x, _OuterRef):
                    return ColumnRef(x.index, x.name, x.sql_type, x.nullable)
                if isinstance(x, ColumnRef):
                    from dataclasses import replace as _rp

                    return _rp(x, index=inner_pos[x.index])
                return x

            return transform(r, fn)

        jfilter = _conjoin([fix_residual(r) for r in corr_residuals]) if corr_residuals else None
        if mark:
            fields = list(child.schema) + [Field("__mark", SqlType.BOOLEAN,
                                                 False)]
            return p.Join(child, sub, "LEFTMARK", on, jfilter, fields)
        jt = "LEFTANTI" if anti else "LEFTSEMI"
        return p.Join(child, sub, jt, on, jfilter, list(child.schema))

    def _rewrite_in(self, pred: InSubqueryExpr, child, anti: bool) -> Optional[p.LogicalPlan]:
        core, proj_exprs, pairs, corr_residuals = self._extract_correlation(pred.plan)
        if core is None or corr_residuals:
            return None
        # NOT IN with nullable keys has 3VL semantics a plain anti-join
        # breaks — rewrite to a *null-aware* anti join instead (the physical
        # layer implements the empty-set / NULL-in-set / NULL-arg cases; the
        # reference rewrites this shape in decorrelate_where_in.rs:267)
        null_aware = anti and (pred.plan.schema[0].nullable
                               or _nullable_expr(pred.arg))
        # uncorrelated IN -> semi join below; nullable args need no special
        # handling there (NULL arg rows simply drop, matching WHERE
        # semantics: a NULL predicate filters out)
        nleft = len(child.schema)
        out_exprs = [proj_exprs[0]] + [inner for _, inner in pairs]
        fields = [Field(f"__ckey{i}", e.sql_type, True) for i, e in enumerate(out_exprs)]
        sub = p.Projection(core, out_exprs, fields)
        on = [(pred.arg, ColumnRef(nleft, fields[0].name, out_exprs[0].sql_type, True))]
        for i, (outer, _) in enumerate(pairs):
            on.append((_outer_to_local(outer),
                       ColumnRef(nleft + 1 + i, fields[1 + i].name,
                                 out_exprs[1 + i].sql_type, True)))
        jt = "LEFTANTI" if anti else "LEFTSEMI"
        return p.Join(child, sub, jt, on, None, list(child.schema), null_aware)


class _CannotDecorrelate(Exception):
    pass


def _outer_eq_pair(c: Expr) -> Optional[Tuple[Expr, Expr]]:
    """Match `outer_col = inner_expr` (either side)."""
    if not (isinstance(c, ScalarFunc) and c.op == "eq"):
        return None
    a, b = c.args
    a_outer = all(isinstance(x, _OuterRef) for x in walk(a) if isinstance(x, ColumnRef))
    b_outer = all(isinstance(x, _OuterRef) for x in walk(b) if isinstance(x, ColumnRef))
    a_has = any(isinstance(x, _OuterRef) for x in walk(a))
    b_has = any(isinstance(x, _OuterRef) for x in walk(b))
    if a_has and a_outer and not b_has:
        return (a, b)
    if b_has and b_outer and not a_has:
        return (b, a)
    return None


def _outer_to_local(e: Expr) -> Expr:
    def fn(x):
        if isinstance(x, _OuterRef):
            return ColumnRef(x.index, x.name, x.sql_type, x.nullable)
        return x

    return transform(e, fn)


def _nullable_expr(e: Expr) -> bool:
    for x in walk(e):
        if isinstance(x, ColumnRef) and x.nullable:
            return True
        if isinstance(x, Literal) and x.value is None:
            return True
    return False


def _all_exprs_below(plan) -> List[Expr]:
    out = []
    for node in p.walk_plan(plan):
        out.extend(_node_exprs(node))
    return out


# ---------------------------------------------------------------------------
# UnwrapCastInComparison (parity: DataFusion rule in the reference pipeline,
# optimizer.rs:56,88): CAST(col) <op> literal  ->  col <op> literal-in-col-type
# when the literal round-trips losslessly.  Unwrapped comparisons become
# pushdown-eligible (plain column refs reach the TableScan DNF filters).
# ---------------------------------------------------------------------------
_COMPARISONS = {"eq", "ne", "lt", "le", "gt", "ge"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}

#: integer widths for the injectivity check
_INT_RANK = {SqlType.TINYINT: 8, SqlType.SMALLINT: 16, SqlType.INTEGER: 32,
             SqlType.BIGINT: 64}
_INT_RANGE = {SqlType.TINYINT: (-2**7, 2**7 - 1),
              SqlType.SMALLINT: (-2**15, 2**15 - 1),
              SqlType.INTEGER: (-2**31, 2**31 - 1),
              SqlType.BIGINT: (-2**63, 2**63 - 1)}


def _cast_is_injective_monotone(src: SqlType, dst: SqlType) -> bool:
    """True only for value-preserving widenings, where
    `CAST(col AS dst) <op> lit`  <=>  `col <op> downcast(lit)` for every col.
    Truncating casts (TIMESTAMP->DATE, DOUBLE->INT, any ->VARCHAR) must NOT
    be unwrapped: they map many column values onto one compared value."""
    if src in _INT_RANK and dst in _INT_RANK:
        return _INT_RANK[src] <= _INT_RANK[dst]
    if src in _INT_RANK and dst == SqlType.DOUBLE:
        return _INT_RANK[src] <= 32  # float64 mantissa covers int32
    if src in _INT_RANK and dst == SqlType.FLOAT:
        return _INT_RANK[src] <= 16  # float32 mantissa covers int16
    if src == SqlType.FLOAT and dst == SqlType.DOUBLE:
        return True
    if src == SqlType.DATE and dst == SqlType.TIMESTAMP:
        return True
    return False


def _try_unwrap_cast(op: str, cast: Cast, lit: Literal):
    from ..binder import _cast_literal

    if lit.value is None:
        return None
    src_type = cast.arg.sql_type
    if not _cast_is_injective_monotone(src_type, cast.sql_type):
        return None
    try:
        down = _cast_literal(Literal(lit.value, lit.sql_type), src_type)
        back = _cast_literal(Literal(down.value, src_type), lit.sql_type)
    except (ArithmeticError, ValueError, TypeError, KeyError):
        return None
    if back.value != lit.value:
        return None  # lossy literal: e.g. 3.5 compared against an INT column
    if src_type in _INT_RANGE:
        lo, hi = _INT_RANGE[src_type]
        try:
            if not (lo <= int(down.value) <= hi):
                return None  # literal overflows the column type
        except (TypeError, ValueError):
            return None
    return ScalarFunc(op, (cast.arg, Literal(down.value, src_type)),
                      SqlType.BOOLEAN)


def _unwrap_cast_expr(e: Expr) -> Expr:
    def fn(x: Expr) -> Expr:
        if isinstance(x, ScalarFunc) and x.op in _COMPARISONS and len(x.args) == 2:
            a, b = x.args
            if isinstance(a, Cast) and isinstance(b, Literal):
                out = _try_unwrap_cast(x.op, a, b)
                if out is not None:
                    return out
            if isinstance(b, Cast) and isinstance(a, Literal):
                out = _try_unwrap_cast(_FLIP[x.op], b, a)
                if out is not None:
                    # keep operand order: literal <op> col == col <flip op> lit
                    return out
        return x

    return transform(e, fn)


class UnwrapCastInComparison(Rule):
    def apply(self, plan, config, catalog):
        def go(node):
            node = _rewrite_children(node, go)
            return _map_node_exprs(node, _unwrap_cast_expr)

        return go(plan)


# ---------------------------------------------------------------------------
# RewriteDisjunctivePredicate (parity: DataFusion rule, optimizer.rs:63):
# (a AND b) OR (a AND c)  ->  a AND (b OR c) — exposes `a` to pushdown.
# ---------------------------------------------------------------------------
def _disjuncts(e: Expr) -> List[Expr]:
    if isinstance(e, ScalarFunc) and e.op == "or":
        out: List[Expr] = []
        for a in e.args:
            out.extend(_disjuncts(a))
        return out
    return [e]


def _disjoin(parts: List[Expr]) -> Expr:
    out = parts[0]
    for x in parts[1:]:
        out = ScalarFunc("or", (out, x), SqlType.BOOLEAN)
    return out


def _rewrite_disjunction(e: Expr) -> Expr:
    def fn(x: Expr) -> Expr:
        if not (isinstance(x, ScalarFunc) and x.op == "or"):
            return x
        branches = [_conjuncts(d) for d in _disjuncts(x)]
        if len(branches) < 2:
            return x
        common = [c for c in branches[0]
                  if all(any(c == c2 for c2 in b) for b in branches[1:])]
        if not common:
            return x
        residuals = []
        for b in branches:
            rem = [c for c in b if not any(c == cm for cm in common)]
            residuals.append(rem)
        if any(not rem for rem in residuals):
            # one branch is exactly the common part: OR collapses to it
            return _conjoin(common)
        parts = common + [_disjoin([_conjoin(rem) for rem in residuals])]
        return _conjoin(parts)

    return transform(e, fn)


class RewriteDisjunctivePredicate(Rule):
    def apply(self, plan, config, catalog):
        def go(node):
            node = _rewrite_children(node, go)
            if isinstance(node, p.Filter):
                return p.Filter(node.input, _rewrite_disjunction(node.predicate),
                                node.schema)
            return node

        return go(plan)


# ---------------------------------------------------------------------------
# EliminateOuterJoin (parity: DataFusion rule, optimizer.rs:70): a filter
# above an outer join that rejects NULLs of the padded side turns the join
# INNER (feeding JoinReorder, which handles inner joins only).
# ---------------------------------------------------------------------------
_NULL_PROP_OPS = _COMPARISONS | {
    "add", "sub", "mul", "div", "mod", "neg", "not", "like", "ilike",
    "similar", "between",
}


def _strong(e: Expr) -> bool:
    """NULL-propagating: any NULL input makes the result NULL."""
    if isinstance(e, (ColumnRef, Literal)):
        return True
    if isinstance(e, Cast):
        return _strong(e.arg)
    if isinstance(e, ScalarFunc) and e.op in _NULL_PROP_OPS:
        return all(_strong(a) for a in e.args)
    return False


def _refs_in_range(e: Expr, lo: int, hi: int) -> bool:
    return any(isinstance(x, ColumnRef) and lo <= x.index < hi for x in walk(e))


def _rejects_nulls(e: Expr, lo: int, hi: int) -> bool:
    """True when `e` cannot evaluate to TRUE if all columns in [lo, hi)
    are NULL (so the filter drops the outer join's padded rows)."""
    if isinstance(e, ScalarFunc):
        if e.op == "and":
            return any(_rejects_nulls(a, lo, hi) for a in e.args)
        if e.op == "or":
            return all(_rejects_nulls(a, lo, hi) for a in e.args)
        if e.op in ("is_not_null", "isnotnull"):
            return _strong(e.args[0]) and _refs_in_range(e.args[0], lo, hi)
        if e.op in _NULL_PROP_OPS:
            return (all(_strong(a) for a in e.args)
                    and _refs_in_range(e, lo, hi))
    return False


class EliminateOuterJoin(Rule):
    def apply(self, plan, config, catalog):
        def go(node):
            node = _rewrite_children(node, go)
            if not (isinstance(node, p.Filter) and isinstance(node.input, p.Join)):
                return node
            join = node.input
            if join.join_type not in ("LEFT", "RIGHT", "FULL"):
                return node
            nleft = len(join.left.schema)
            total = len(join.schema)
            rej_left = rej_right = False
            for c in _conjuncts(node.predicate):
                rej_left = rej_left or _rejects_nulls(c, 0, nleft)
                rej_right = rej_right or _rejects_nulls(c, nleft, total)
            jt = join.join_type
            new_jt = None
            if jt == "LEFT" and rej_right:
                new_jt = "INNER"
            elif jt == "RIGHT" and rej_left:
                new_jt = "INNER"
            elif jt == "FULL":
                # rej_left drops the rows whose LEFT side is padded — the
                # unmatched-right rows — leaving a LEFT join (and vice versa)
                if rej_left and rej_right:
                    new_jt = "INNER"
                elif rej_left:
                    new_jt = "LEFT"
                elif rej_right:
                    new_jt = "RIGHT"
            if new_jt is None:
                return node
            new_join = p.Join(join.left, join.right, new_jt, join.on,
                              join.filter, join.schema, join.null_aware)
            return p.Filter(new_join, node.predicate, node.schema)

        return go(plan)
