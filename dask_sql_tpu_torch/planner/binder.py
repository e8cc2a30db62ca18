"""Binder: AST -> typed LogicalPlan.

Copied from `dask_sql_tpu/planner/binder.py`; only import paths differ.

Role parity: DataFusion's SqlToRel as driven by the reference
(`logical_relational_algebra`, src/sql.rs:586 / statement_to_plan sql.rs:674),
including the custom-statement lowering of sql.rs:668-814 and the dialect
rewrites of src/dialect.rs (CEIL..TO, TIMESTAMPADD, FILTER(WHERE..) aggs).
Name resolution, type inference/coercion, aggregate/window extraction and
subquery binding all happen here, producing positional `ColumnRef`s.
"""
from __future__ import annotations

import re
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..columnar.dtypes import (
    DATETIME_TYPES,
    INTEGER_TYPES,
    INTERVAL_TYPES,
    NUMERIC_TYPES,
    STRING_TYPES,
    SqlType,
    parse_sql_type,
    promote,
    similar_type,
)
from . import plan as p
from . import sqlast as a
from .catalog import Catalog
from .expressions import (
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
    UdfExpr,
    WindowExpr,
    WindowFrameBound,
    WindowSpec,
    transform,
    walk,
)
from .functions import (
    AGGREGATE_FUNCTIONS,
    SCALAR_FUNCTIONS,
    WINDOW_FUNCTIONS,
    resolve_type,
)
from ..resilience.errors import BindingError
from .parser import ParsingException


class BindError(BindingError):
    """Name/type resolution failure; taxonomy code BIND_ERROR (USER_ERROR),
    still a ValueError through BindingError for historical callers."""


_CMP_OPS = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}
_ARITH_OPS = {"+": "add", "-": "sub", "*": "mul", "/": "div", "%": "mod"}

_INTERVAL_NS = {
    "NANOSECOND": 1,
    "MICROSECOND": 1_000,
    "MILLISECOND": 1_000_000,
    "SECOND": 1_000_000_000,
    "MINUTE": 60 * 1_000_000_000,
    "HOUR": 3600 * 1_000_000_000,
    "DAY": 86400 * 1_000_000_000,
    "WEEK": 7 * 86400 * 1_000_000_000,
}
_INTERVAL_MONTHS = {"MONTH": 1, "QUARTER": 3, "YEAR": 12}


class Scope:
    """Name-resolution scope: (qualifier, field) pairs over a flat positional schema."""

    def __init__(self, entries: List[Tuple[Optional[str], Field]], parent: Optional["Scope"] = None,
                 case_sensitive: bool = True):
        self.entries = entries
        self.parent = parent
        self.case_sensitive = case_sensitive

    @property
    def fields(self) -> List[Field]:
        return [f for _, f in self.entries]

    def _match_name(self, a_: str, b: str) -> bool:
        return a_ == b if self.case_sensitive else a_.lower() == b.lower()

    def resolve(self, parts: List[str]) -> Optional[ColumnRef]:
        if len(parts) == 1:
            qualifier, name = None, parts[0]
        else:
            qualifier, name = parts[-2], parts[-1]
        matches = []
        for i, (q, f) in enumerate(self.entries):
            if not self._match_name(f.name, name):
                continue
            if qualifier is not None and (q is None or not self._match_name(q, qualifier)):
                continue
            matches.append((i, f))
        if not matches:
            return None
        if len(matches) > 1 and qualifier is None:
            # exact-case match disambiguates in case-insensitive mode
            exact = [(i, f) for i, f in matches if f.name == name]
            if len(exact) == 1:
                matches = exact
            else:
                raise BindError(f"Ambiguous column reference {'.'.join(parts)!r}")
        i, f = matches[0]
        return ColumnRef(i, f.name, f.sql_type, f.nullable)


class Binder:
    def __init__(self, catalog: Catalog, case_sensitive: bool = True):
        self.catalog = catalog
        self.case_sensitive = case_sensitive
        self._cte_stack: List[Dict[str, p.LogicalPlan]] = []

    # ------------------------------------------------------------------ API
    def bind_statement(self, stmt: a.Statement) -> p.LogicalPlan:
        if isinstance(stmt, a.QueryStatement):
            plan, _ = self.bind_query(stmt.query)
            return plan
        if isinstance(stmt, a.ExplainStatement):
            plan, _ = self.bind_query(stmt.query)
            lint = getattr(stmt, "lint", False)
            estimate = getattr(stmt, "estimate", False)
            fmt_json = getattr(stmt, "fmt_json", False)
            col = "LINT" if lint else "ESTIMATE" if estimate else "PLAN"
            return p.Explain(plan, [Field(col, SqlType.VARCHAR)],
                             stmt.analyze, lint, estimate, fmt_json)
        if isinstance(stmt, a.CreateTableWith):
            return p.CreateTableNode([], stmt.name, stmt.kwargs, stmt.if_not_exists, stmt.or_replace)
        if isinstance(stmt, a.CreateTableAs):
            inner, _ = self.bind_query(stmt.query)
            return p.CreateMemoryTableNode([], stmt.name, inner, stmt.persist,
                                           stmt.if_not_exists, stmt.or_replace)
        if isinstance(stmt, a.DropTable):
            return p.DropTableNode([], stmt.name, stmt.if_exists)
        if isinstance(stmt, a.CreateSchema):
            return p.CreateSchemaNode([], stmt.name, stmt.if_not_exists, stmt.or_replace)
        if isinstance(stmt, a.DropSchema):
            return p.DropSchemaNode([], stmt.name, stmt.if_exists)
        if isinstance(stmt, a.UseSchema):
            return p.UseSchemaNode([], stmt.name)
        if isinstance(stmt, a.AlterSchema):
            return p.AlterSchemaNode([], stmt.old_name, stmt.new_name)
        if isinstance(stmt, a.AlterTable):
            return p.AlterTableNode([], stmt.old_name, stmt.new_name, stmt.if_exists)
        if isinstance(stmt, a.ShowSchemas):
            return p.ShowSchemasNode([Field("Schema", SqlType.VARCHAR)], stmt.like)
        if isinstance(stmt, a.ShowTables):
            return p.ShowTablesNode([Field("Table", SqlType.VARCHAR)], stmt.schema)
        if isinstance(stmt, a.ShowColumns):
            fields = [Field("Column", SqlType.VARCHAR), Field("Type", SqlType.VARCHAR),
                      Field("Extra", SqlType.VARCHAR), Field("Comment", SqlType.VARCHAR)]
            return p.ShowColumnsNode(fields, stmt.table)
        if isinstance(stmt, a.ShowModels):
            return p.ShowModelsNode([Field("Model", SqlType.VARCHAR)], stmt.schema)
        if isinstance(stmt, a.ShowMetrics):
            return p.ShowMetricsNode(
                [Field("Metric", SqlType.VARCHAR), Field("Value", SqlType.VARCHAR)],
                stmt.like)
        if isinstance(stmt, a.ShowProfiles):
            return p.ShowProfilesNode(
                [Field("Fingerprint", SqlType.VARCHAR),
                 Field("Metric", SqlType.VARCHAR),
                 Field("Value", SqlType.VARCHAR)],
                stmt.like)
        if isinstance(stmt, a.ShowQueries):
            return p.ShowQueriesNode(
                [Field("Qid", SqlType.VARCHAR),
                 Field("Field", SqlType.VARCHAR),
                 Field("Value", SqlType.VARCHAR)],
                stmt.like)
        if isinstance(stmt, a.ShowMaterialized):
            return p.ShowMaterializedNode(
                [Field("Kind", SqlType.VARCHAR),
                 Field("Fingerprint", SqlType.VARCHAR),
                 Field("Table", SqlType.VARCHAR),
                 Field("Rows", SqlType.VARCHAR),
                 Field("Bytes", SqlType.VARCHAR),
                 Field("Hits", SqlType.VARCHAR),
                 Field("Epoch", SqlType.VARCHAR)],
                stmt.like)
        if isinstance(stmt, a.ShowReplicas):
            return p.ShowReplicasNode(
                [Field("Replica", SqlType.VARCHAR),
                 Field("State", SqlType.VARCHAR),
                 Field("Band", SqlType.VARCHAR),
                 Field("Headroom", SqlType.VARCHAR),
                 Field("Routed", SqlType.VARCHAR)],
                stmt.like)
        if isinstance(stmt, a.InsertInto):
            inner, _ = self.bind_query(stmt.query)
            return p.InsertIntoNode([Field("Inserted", SqlType.VARCHAR)],
                                    stmt.table, inner)
        if isinstance(stmt, a.CancelQuery):
            return p.CancelQueryNode(
                [Field("Qid", SqlType.VARCHAR),
                 Field("Cancelled", SqlType.VARCHAR)],
                stmt.qid)
        if isinstance(stmt, a.AnalyzeTable):
            return p.AnalyzeTableNode([], stmt.table, stmt.columns)
        if isinstance(stmt, a.CreateModel):
            inner, _ = self.bind_query(stmt.query)
            return p.CreateModelNode([], stmt.name, stmt.kwargs, inner,
                                     stmt.if_not_exists, stmt.or_replace)
        if isinstance(stmt, a.DropModel):
            return p.DropModelNode([], stmt.name, stmt.if_exists)
        if isinstance(stmt, a.DescribeModel):
            fields = [Field("Params", SqlType.VARCHAR), Field("Value", SqlType.VARCHAR)]
            return p.DescribeModelNode(fields, stmt.name)
        if isinstance(stmt, a.ExportModel):
            return p.ExportModelNode([], stmt.name, stmt.kwargs)
        if isinstance(stmt, a.CreateExperiment):
            inner, _ = self.bind_query(stmt.query)
            return p.CreateExperimentNode([], stmt.name, stmt.kwargs, inner,
                                          stmt.if_not_exists, stmt.or_replace)
        raise BindError(f"Cannot bind statement {type(stmt).__name__}")

    # ---------------------------------------------------------------- query
    def bind_query(self, q: a.Select, outer: Optional[Scope] = None) -> Tuple[p.LogicalPlan, Scope]:
        ctes = {}
        if q.ctes:
            for name, sub in q.ctes:
                self._cte_stack.append(ctes)
                try:
                    sub_plan, _ = self.bind_query(sub, outer)
                finally:
                    self._cte_stack.pop()
                ctes[name] = p.SubqueryAlias(sub_plan, name, [
                    Field(f.name, f.sql_type, f.nullable) for f in sub_plan.schema
                ])
        self._cte_stack.append(ctes)
        try:
            if q.set_op is None and q.values is None:
                plan, scope = self._bind_select_core(q, outer, order_by=q.order_by)
            else:
                plan, scope = self._bind_set_expr(q, outer)
                if q.order_by:
                    plan = self._bind_order_by_output(plan, q.order_by, scope)
            if q.limit is not None or q.offset is not None:
                plan = p.Limit(plan, q.offset or 0, q.limit, plan.schema)
            return plan, scope
        finally:
            self._cte_stack.pop()

    def _bind_set_expr(self, q: a.Select, outer: Optional[Scope]) -> Tuple[p.LogicalPlan, Scope]:
        left, scope = self._bind_select_core(q, outer)
        if q.set_op is None:
            return left, scope
        op, all_, rhs_ast = q.set_op
        right, _ = self.bind_query(rhs_ast, outer) if (rhs_ast.ctes or rhs_ast.order_by or rhs_ast.limit is not None) else self._bind_set_expr(rhs_ast, outer)
        if len(left.schema) != len(right.schema):
            raise BindError(f"{op} requires equal column counts "
                            f"({len(left.schema)} vs {len(right.schema)})")
        fields = []
        for lf, rf in zip(left.schema, right.schema):
            fields.append(Field(lf.name, promote(lf.sql_type, rf.sql_type),
                                lf.nullable or rf.nullable))
        if op == "UNION":
            out = p.Union([left, right], all_, fields)
            if not all_:
                out = p.Distinct(out, fields)
        elif op == "INTERSECT":
            out = p.Intersect(left, right, all_, fields)
        else:
            out = p.Except(left, right, all_, fields)
        return out, Scope([(None, f) for f in fields], outer, self.case_sensitive)

    # ---------------------------------------------------------- select core
    def _bind_select_core(self, q: a.Select, outer: Optional[Scope],
                          order_by: Optional[List[a.OrderItem]] = None) -> Tuple[p.LogicalPlan, Scope]:
        # named windows are per-SELECT; nested subquery binds must not clobber
        prev_windows = getattr(self, "_named_windows", {})
        try:
            return self._bind_select_core_inner(q, outer, order_by)
        finally:
            self._named_windows = prev_windows

    def _bind_select_core_inner(self, q: a.Select, outer: Optional[Scope],
                                order_by: Optional[List[a.OrderItem]] = None) -> Tuple[p.LogicalPlan, Scope]:
        if q.values is not None:
            return self._bind_values(q)
        # FROM
        if q.from_ is None:
            plan: p.LogicalPlan = p.EmptyRelation([], produce_one_row=True)
            scope = Scope([], outer, self.case_sensitive)
        else:
            plan, scope = self._bind_table_ref(q.from_, outer)
        # WHERE
        from .expressions import GroupingExpr

        if q.where is not None:
            pred = self._coerce_bool(self.bind_expr(q.where, scope))
            if any(isinstance(x, GroupingExpr) for x in walk(pred)):
                raise BindError("GROUPING is not allowed in WHERE")
            plan = p.Filter(plan, pred, plan.schema)
        self._named_windows = dict(q.named_windows or {})
        # select-alias ASTs, visible to GROUPING() arg binding (saved/restored
        # so nested subselects don't clobber the outer map)
        prev_alias_asts = getattr(self, "_select_alias_asts", None)
        self._select_alias_asts = {
            (item.alias if self.case_sensitive else item.alias.lower()): item.expr
            for item in q.projections
            if getattr(item, "alias", None) and not isinstance(item.expr, a.Wildcard)
        }
        # bind select items (pre-aggregate binding; aggs collected after)
        proj_exprs: List[Expr] = []
        proj_names: List[str] = []
        for item in q.projections:
            if isinstance(item.expr, a.Wildcard):
                wc: a.Wildcard = item.expr
                for i, (qual, f) in enumerate(scope.entries):
                    if wc.qualifier is not None and (qual is None or qual != wc.qualifier[-1]):
                        continue
                    proj_exprs.append(ColumnRef(i, f.name, f.sql_type, f.nullable))
                    proj_names.append(f.name)
                continue
            e = self.bind_expr(item.expr, scope)
            proj_exprs.append(e)
            if item.alias:
                proj_names.append(item.alias)
            elif isinstance(e, ColumnRef):
                # preserve the table's column spelling (matters when
                # identifiers are matched case-insensitively)
                proj_names.append(e.name)
            else:
                proj_names.append(self._derive_name(item.expr))
        having_ast = q.having
        if having_ast is not None:
            # HAVING may reference a select alias (commonly of an aggregate);
            # table columns win over aliases per engine convention
            alias_map = {}
            for item in q.projections:
                if getattr(item, "alias", None) and not isinstance(item.expr, a.Wildcard):
                    key = item.alias if self.case_sensitive else item.alias.lower()
                    alias_map.setdefault(key, item.expr)
            if alias_map:
                fold = (lambda s: s) if self.case_sensitive else str.lower
                having_ast = _subst_select_aliases(
                    having_ast, alias_map,
                    lambda ident: scope.resolve(ident.parts) is None, fold)
        having_expr = self.bind_expr(having_ast, scope) if having_ast is not None else None

        # ORDER BY items: positions / select aliases resolve to outputs, the
        # rest bind against the pre-projection scope (participating in the
        # aggregate rewrite below, so ORDER BY SUM(x) works).  Per SQL, a
        # bare identifier names the OUTPUT column first (a select alias wins
        # over a same-named source column — TPC-DS q33/q56/q60/q71 rely on
        # `SUM(total_sales) AS total_sales ... ORDER BY total_sales`); inside
        # larger ORDER BY expressions aliases substitute textually (q36/q70/
        # q86 use `CASE WHEN lochierarchy = 0 ...` over a GROUPING alias).
        fold_ident = (lambda s: s) if self.case_sensitive else str.lower
        order_specs: List[Tuple[str, object, a.OrderItem]] = []
        for item in order_by or []:
            e = item.expr
            if isinstance(e, a.Literal) and isinstance(e.value, int):
                idx = e.value - 1
                if idx < 0 or idx >= len(proj_exprs):
                    raise BindError(f"ORDER BY position {e.value} out of range")
                order_specs.append(("pos", idx, item))
                continue
            if isinstance(e, a.Identifier) and len(e.parts) == 1:
                # proj_names is alias-or-derived-name, aligned with proj_exprs
                # (wildcard-expanded, unlike q.projections)
                matches = [i for i, n in enumerate(proj_names)
                           if fold_ident(n) == fold_ident(e.parts[0])]
                if len(matches) == 1:
                    order_specs.append(("pos", matches[0], item))
                    continue
            if self._select_alias_asts:
                e = _subst_select_aliases(
                    e, self._select_alias_asts,
                    lambda ident: scope.resolve(ident.parts) is None, fold_ident)
            order_specs.append(("expr", self.bind_expr(e, scope), item))
        self._select_alias_asts = prev_alias_asts
        order_exprs = [s[1] for s in order_specs if s[0] == "expr"]

        # aggregate context?
        agg_calls: List[AggExpr] = []
        for e in proj_exprs + order_exprs + ([having_expr] if having_expr is not None else []):
            agg_calls.extend(x for x in walk(e) if isinstance(x, AggExpr))
        if q.group_by or agg_calls:
            plan, rewritten, having_expr, scope_post = self._bind_aggregate(
                q, plan, scope, proj_exprs + order_exprs, having_expr
            )
            proj_exprs = rewritten[: len(proj_exprs)]
            order_exprs = rewritten[len(proj_exprs):]
        else:
            all_post = proj_exprs + order_exprs + (
                [having_expr] if having_expr is not None else [])
            if any(isinstance(x, GroupingExpr) for e in all_post for x in walk(e)):
                raise BindError("GROUPING requires a GROUP BY context")
            scope_post = scope
        if having_expr is not None:
            plan = p.Filter(plan, self._coerce_bool(having_expr), plan.schema)
            having_expr = None

        # window functions (computed after grouping, SQL semantics)
        all_exprs = proj_exprs + order_exprs
        win_calls = [x for e in all_exprs for x in walk(e) if isinstance(x, WindowExpr)]
        if win_calls:
            plan, all_exprs = self._bind_window(plan, all_exprs)
            proj_exprs = all_exprs[: len(proj_exprs)]
            order_exprs = all_exprs[len(proj_exprs):]

        # final projection
        fields = [Field(n, e.sql_type, _nullable(e)) for n, e in zip(proj_names, proj_exprs)]
        # sort keys: reuse an output column when the order expr matches one
        sort_keys: List[SortKey] = []
        extra_exprs: List[Expr] = []
        it_order = iter(order_exprs)
        for kind, val, item in order_specs:
            if kind == "pos":
                idx = val
            else:
                bound = next(it_order)
                idx = None
                for i, pe in enumerate(proj_exprs):
                    if pe == bound:
                        idx = i
                        break
                if idx is None:
                    if q.distinct:
                        raise BindError(
                            "For SELECT DISTINCT, ORDER BY expressions must appear in the select list")
                    idx = len(fields) + len(extra_exprs)
                    extra_exprs.append(bound)
            f = (fields + [Field(f"__sort{j}", x.sql_type, _nullable(x))
                           for j, x in enumerate(extra_exprs)])[idx]
            sort_keys.append(SortKey(ColumnRef(idx, f.name, f.sql_type, f.nullable),
                                     item.ascending, item.nulls_first))

        if extra_exprs:
            ext_fields = fields + [Field(f"__sort{j}", x.sql_type, _nullable(x))
                                   for j, x in enumerate(extra_exprs)]
            plan = p.Projection(plan, proj_exprs + extra_exprs, ext_fields)
            plan = p.Sort(plan, sort_keys, ext_fields)
            final_refs = [ColumnRef(i, f.name, f.sql_type, f.nullable)
                          for i, f in enumerate(fields)]
            plan = p.Projection(plan, final_refs, fields)
        else:
            plan = p.Projection(plan, proj_exprs, fields)
            if q.distinct:
                plan = p.Distinct(plan, fields)
            if sort_keys:
                plan = p.Sort(plan, sort_keys, fields)
        scope_out = Scope([(None, f) for f in fields], outer, self.case_sensitive)
        if q.distribute_by:
            keys = [self.bind_expr(e, scope_out) for e in q.distribute_by]
            plan = p.DistributeBy(plan, keys, plan.schema)
        return plan, scope_out

    def _bind_values(self, q: a.Select) -> Tuple[p.LogicalPlan, Scope]:
        empty = Scope([], None, self.case_sensitive)
        rows = [[self.bind_expr(e, empty) for e in row] for row in q.values]
        ncols = len(rows[0])
        fields = []
        for i in range(ncols):
            t = rows[0][i].sql_type
            for r in rows[1:]:
                t = promote(t, r[i].sql_type)
            fields.append(Field(f"column{i + 1}", t))
        rows = [[e if e.sql_type == fields[i].sql_type else Cast(e, fields[i].sql_type)
                 for i, e in enumerate(r)] for r in rows]
        plan = p.Values(rows, fields)
        return plan, Scope([(None, f) for f in fields], None, self.case_sensitive)

    # ------------------------------------------------------------ FROM refs
    def _bind_table_ref(self, ref: a.TableRef, outer: Optional[Scope]) -> Tuple[p.LogicalPlan, Scope]:
        if isinstance(ref, a.NamedTable):
            plan, scope = self._bind_named_table(ref, outer)
            if ref.sample is not None:
                method, frac, seed = ref.sample
                plan = p.Sample(plan, method, frac, seed, plan.schema)
            return plan, scope
        if isinstance(ref, a.DerivedTable):
            sub, _ = self.bind_query(ref.subquery, outer)
            alias, col_aliases = _split_alias(ref.alias)
            fields = list(sub.schema)
            if col_aliases:
                fields = [Field(col_aliases[i] if i < len(col_aliases) else f.name,
                                f.sql_type, f.nullable) for i, f in enumerate(fields)]
            if alias:
                sub = p.SubqueryAlias(sub, alias, fields)
            scope = Scope([(alias, f) for f in fields], outer, self.case_sensitive)
            return sub, scope
        if isinstance(ref, a.TableFunction):
            sub, _ = self.bind_query(ref.subquery, outer)
            fields = list(sub.schema) + [Field("target", SqlType.DOUBLE)]
            node = p.PredictModelNode(fields, ref.model_name, sub)
            alias, _ = _split_alias(ref.alias)
            scope = Scope([(alias, f) for f in fields], outer, self.case_sensitive)
            return node, scope
        if isinstance(ref, a.Join):
            return self._bind_join(ref, outer)
        raise BindError(f"Unsupported table reference {type(ref).__name__}")

    def _bind_named_table(self, ref: a.NamedTable, outer) -> Tuple[p.LogicalPlan, Scope]:
        alias, col_aliases = _split_alias(ref.alias)
        # CTE lookup first (innermost wins)
        if len(ref.parts) == 1:
            for frame in reversed(self._cte_stack):
                if ref.parts[0] in frame:
                    sub = frame[ref.parts[0]]
                    fields = list(sub.schema)
                    if col_aliases:
                        fields = [Field(col_aliases[i] if i < len(col_aliases) else f.name,
                                        f.sql_type, f.nullable) for i, f in enumerate(fields)]
                    name = alias or ref.parts[0]
                    scope = Scope([(name, f) for f in fields], outer, self.case_sensitive)
                    return sub, scope
        table = self.catalog.resolve_table(ref.parts)
        fields = list(table.fields)
        scan = p.TableScan(table.schema_name, table.name, fields)
        if col_aliases:
            fields = [Field(col_aliases[i] if i < len(col_aliases) else f.name,
                            f.sql_type, f.nullable) for i, f in enumerate(fields)]
        name = alias or table.name
        scope = Scope([(name, f) for f in fields], outer, self.case_sensitive)
        return scan, scope

    def _bind_join(self, ref: a.Join, outer) -> Tuple[p.LogicalPlan, Scope]:
        left, lscope = self._bind_table_ref(ref.left, outer)
        right, rscope = self._bind_table_ref(ref.right, outer)
        nleft = len(lscope.entries)
        combined_entries = list(lscope.entries) + [
            (q, f) for q, f in rscope.entries
        ]
        jt = ref.join_type
        # outer joins make the other side nullable
        def _mk_fields():
            out = []
            for i, (q, f) in enumerate(combined_entries):
                nullable = f.nullable
                if jt in ("LEFT", "FULL") and i >= nleft:
                    nullable = True
                if jt in ("RIGHT", "FULL") and i < nleft:
                    nullable = True
                out.append(Field(f.name, f.sql_type, nullable))
            return out

        scope = Scope(combined_entries, outer, self.case_sensitive)
        if jt == "CROSS":
            fields = _mk_fields()
            plan = p.CrossJoin(left, right, fields)
            return plan, scope
        using = ref.using
        if using is not None and not using:  # NATURAL JOIN: shared names
            lnames = {f.name for _, f in lscope.entries}
            using = [f.name for _, f in rscope.entries if f.name in lnames]
        if using is not None:
            on = []
            for name in using:
                lref = lscope.resolve([name])
                rref = rscope.resolve([name])
                if lref is None or rref is None:
                    raise BindError(f"USING column {name!r} not present on both sides")
                on.append((lref, replace(rref, index=rref.index + nleft)))
            fields = _mk_fields()
            plan = p.Join(left, right, jt, on, None, fields)
            return plan, scope
        cond = self.bind_expr(ref.condition, scope) if ref.condition is not None else Literal(True, SqlType.BOOLEAN)
        on, residual = split_join_condition(cond, nleft)
        fields = _mk_fields()
        if jt in ("LEFTSEMI", "LEFTANTI"):
            fields = fields[:nleft]
            scope = Scope(combined_entries[:nleft], outer, self.case_sensitive)
        plan = p.Join(left, right, jt, on, residual, fields)
        return plan, scope

    # ------------------------------------------------------------ aggregate
    def _bind_aggregate(self, q, plan, scope, proj_exprs, having_expr):
        # GROUPING SETS / ROLLUP / CUBE expand into a union of aggregates
        # (parity: aggregate.rs getGroupSets — the reference surfaces group
        # sets from DataFusion; we lower them during binding)
        plain_asts: List[a.Expr] = []
        construct = None
        for ge in q.group_by:
            if isinstance(ge, (a.GroupingSets, a.Rollup, a.Cube)):
                construct = ge
            else:
                plain_asts.append(ge)
        sets: Optional[List[List[int]]] = None
        if construct is not None:
            n_plain = len(plain_asts)
            if isinstance(construct, a.Rollup):
                extra = list(construct.exprs)
                raw_sets = [list(range(k)) for k in range(len(extra), -1, -1)]
            elif isinstance(construct, a.Cube):
                extra = list(construct.exprs)
                m = len(extra)
                raw_sets = [[i for i in range(m) if mask & (1 << i)]
                            for mask in range(2 ** m - 1, -1, -1)]
            else:
                # GROUPING SETS: dedupe expressions structurally via binding
                extra = []
                raw_sets = []
                bound_cache = {}
                for s in construct.sets:
                    idxs = []
                    for e in s:
                        b = self.bind_expr(e, scope)
                        if b not in bound_cache:
                            bound_cache[b] = len(extra)
                            extra.append(e)
                        idxs.append(bound_cache[b])
                    raw_sets.append(idxs)
            q = a.Select(**{**q.__dict__, "group_by": plain_asts + extra})
            sets = [list(range(n_plain)) + [n_plain + i for i in s] for s in raw_sets]
        group_exprs: List[Expr] = []
        for ge in q.group_by:
            if isinstance(ge, a.Literal) and isinstance(ge.value, int):
                idx = ge.value - 1
                if idx < 0 or idx >= len(proj_exprs):
                    raise BindError(f"GROUP BY position {ge.value} out of range")
                group_exprs.append(proj_exprs[idx])
                continue
            if isinstance(ge, a.Identifier) and len(ge.parts) == 1 and scope.resolve(ge.parts) is None:
                # alias of a select item
                matched = False
                for item, bound in zip(q.projections, proj_exprs):
                    if item.alias == ge.parts[0]:
                        group_exprs.append(bound)
                        matched = True
                        break
                if matched:
                    continue
            group_exprs.append(self.bind_expr(ge, scope))
        # collect aggregates from all post-group expressions
        agg_calls: List[AggExpr] = []
        seen = {}
        def _collect(e):
            for x in walk(e):
                if isinstance(x, AggExpr) and x not in seen:
                    seen[x] = len(agg_calls)
                    agg_calls.append(x)
        for e in proj_exprs:
            _collect(e)
        if having_expr is not None:
            _collect(having_expr)

        group_fields = [Field(self._derive_name_expr(e, i), e.sql_type, _nullable(e))
                        for i, e in enumerate(group_exprs)]
        agg_fields = [Field(f"__agg{i}", x.sql_type, True) for i, x in enumerate(agg_calls)]
        out_fields = group_fields + agg_fields

        # GROUPING(...) markers: constant 0 for a plain GROUP BY; for
        # grouping sets, a per-branch bitmask materialized as extra union
        # output columns (leftmost arg = most significant bit)
        from .expressions import GroupingExpr

        grouping_exprs: List[GroupingExpr] = []
        for e in list(proj_exprs) + ([having_expr] if having_expr is not None else []):
            for x in walk(e):
                if isinstance(x, GroupingExpr) and x not in grouping_exprs:
                    grouping_exprs.append(x)
        # GROUPING may not hide where the post-agg rewrite can't reach it
        for ac in agg_calls:
            for x in list(ac.args) + ([ac.filter] if ac.filter is not None else []):
                if any(isinstance(s_, GroupingExpr) for s_ in walk(x)):
                    raise BindError("GROUPING cannot appear inside an aggregate")
        for ge_ in group_exprs:
            if any(isinstance(s_, GroupingExpr) for s_ in walk(ge_)):
                raise BindError("GROUPING cannot appear in GROUP BY")
        grouping_map: Dict[Expr, Expr] = {}

        def _grouping_value(g: GroupingExpr, s: List[int]) -> int:
            val = 0
            for arg in g.args:
                try:
                    gi = group_exprs.index(arg)
                except ValueError:
                    raise BindError(
                        "GROUPING argument must be a grouping expression")
                val = (val << 1) | (0 if gi in s else 1)
            return val

        if sets is None:
            for g in grouping_exprs:
                _grouping_value(g, list(range(len(group_exprs))))  # validate
                grouping_map[g] = Literal(0, SqlType.INTEGER)
            agg_plan = p.Aggregate(plan, group_exprs, agg_calls, out_fields)
        else:
            # union of one aggregate per grouping set, NULL-padded to the full
            # group layout
            out_fields = ([Field(f.name, f.sql_type, True) for f in group_fields]
                          + agg_fields
                          + [Field(f"__grouping{j}", SqlType.INTEGER, False)
                             for j in range(len(grouping_exprs))])
            branches = []
            for s in sets:
                sub_groups = [group_exprs[i] for i in s]
                sub_fields = ([group_fields[i] for i in s] + agg_fields)
                sub_agg = p.Aggregate(plan, sub_groups, agg_calls, sub_fields)
                proj = []
                for gi, gf in enumerate(group_fields):
                    if gi in s:
                        pos = s.index(gi)
                        proj.append(ColumnRef(pos, gf.name, gf.sql_type, True))
                    else:
                        proj.append(Cast(Literal(None, SqlType.NULL), gf.sql_type))
                for ai, af in enumerate(agg_fields):
                    proj.append(ColumnRef(len(s) + ai, af.name, af.sql_type, True))
                for g in grouping_exprs:
                    proj.append(Literal(_grouping_value(g, s), SqlType.INTEGER))
                branches.append(p.Projection(sub_agg, proj, out_fields))
            agg_plan = p.Union(branches, True, out_fields)
            base = len(group_fields) + len(agg_fields)
            for j, g in enumerate(grouping_exprs):
                grouping_map[g] = ColumnRef(base + j, f"__grouping{j}",
                                            SqlType.INTEGER, False)

        # rewrite post-agg expressions: replace group-expr / agg subtrees with refs
        mapping: Dict[Expr, ColumnRef] = {}
        for i, ge in enumerate(group_exprs):
            mapping.setdefault(ge, ColumnRef(i, group_fields[i].name, ge.sql_type, _nullable(ge)))
        for i, ac in enumerate(agg_calls):
            mapping[ac] = ColumnRef(len(group_exprs) + i, agg_fields[i].name, ac.sql_type, True)

        def _rewrite(e: Expr) -> Expr:
            if isinstance(e, GroupingExpr):
                return grouping_map[e]
            if e in mapping:
                return mapping[e]
            kids = e.children()
            if not kids:
                if isinstance(e, ColumnRef):
                    raise BindError(
                        f"Column {e.name!r} must appear in the GROUP BY clause or be used in an aggregate function"
                    )
                return e
            return e.with_children([_rewrite(c) for c in kids])

        proj_exprs = [_rewrite(e) for e in proj_exprs]
        if having_expr is not None:
            having_expr = _rewrite(having_expr)
        scope_post = Scope([(None, f) for f in out_fields], scope.parent, self.case_sensitive)
        return agg_plan, proj_exprs, having_expr, scope_post

    # -------------------------------------------------------------- window
    def _bind_window(self, plan, proj_exprs):
        win_calls: List[WindowExpr] = []
        seen = {}
        for e in proj_exprs:
            for x in walk(e):
                if isinstance(x, WindowExpr) and x not in seen:
                    seen[x] = len(win_calls)
                    win_calls.append(x)
        base = len(plan.schema)
        fields = list(plan.schema) + [
            Field(f"__win{i}", w.sql_type, True) for i, w in enumerate(win_calls)
        ]
        win_plan = p.Window(plan, win_calls, fields)
        mapping = {w: ColumnRef(base + i, f"__win{i}", w.sql_type, True)
                   for i, w in enumerate(win_calls)}

        def _rewrite(e: Expr) -> Expr:
            if e in mapping:
                return mapping[e]
            kids = e.children()
            if not kids:
                return e
            return e.with_children([_rewrite(c) for c in kids])

        return win_plan, [_rewrite(e) for e in proj_exprs]

    # ------------------------------------------------------------ ORDER BY
    def _bind_order_by_output(self, plan, order_by: List[a.OrderItem], scope: Scope):
        """ORDER BY over a set-operation result: positions and output names only."""
        keys: List[SortKey] = []
        fields = list(plan.schema)
        for item in order_by:
            e = item.expr
            if isinstance(e, a.Literal) and isinstance(e.value, int):
                idx = e.value - 1
                if idx < 0 or idx >= len(fields):
                    raise BindError(f"ORDER BY position {e.value} out of range")
                f = fields[idx]
                keys.append(SortKey(ColumnRef(idx, f.name, f.sql_type, f.nullable),
                                    item.ascending, item.nulls_first))
                continue
            bound = self.bind_expr(e, scope)
            keys.append(SortKey(bound, item.ascending, item.nulls_first))
        return p.Sort(plan, keys, plan.schema)

    # ---------------------------------------------------------- expressions
    def bind_expr(self, e: a.Expr, scope: Scope) -> Expr:
        if isinstance(e, a.Literal):
            return _bind_literal(e)
        if isinstance(e, a.IntervalLiteral):
            return _bind_interval(e)
        if isinstance(e, a.Identifier):
            ref = scope.resolve(e.parts)
            if ref is None:
                # fall back: maybe a no-paren function (CURRENT_TIMESTAMP)
                up = e.parts[-1].upper()
                if len(e.parts) == 1 and up in SCALAR_FUNCTIONS and SCALAR_FUNCTIONS[up][2] == 0:
                    op, rt, _, _ = SCALAR_FUNCTIONS[up]
                    return ScalarFunc(op, (), resolve_type(rt, []))
                outer_ref = scope.parent.resolve(e.parts) if scope.parent is not None else None
                if outer_ref is not None:
                    from .expressions import ColumnRef as CR

                    return _OuterRef(outer_ref.index, outer_ref.name, outer_ref.sql_type,
                                     outer_ref.nullable)
                raise BindError(f"Column {'.'.join(e.parts)!r} not found")
            return ref
        if isinstance(e, a.UnaryOp):
            arg = self.bind_expr(e.operand, scope)
            if e.op == "NOT":
                return ScalarFunc("not", (self._coerce_bool(arg),), SqlType.BOOLEAN)
            if e.op == "-":
                return ScalarFunc("neg", (arg,), arg.sql_type)
            return arg
        if isinstance(e, a.BinaryOp):
            return self._bind_binary(e, scope)
        if isinstance(e, a.Cast):
            arg = self.bind_expr(e.operand, scope)
            return Cast(arg, parse_sql_type(e.type_name), e.safe)
        if isinstance(e, a.Case):
            return self._bind_case(e, scope)
        if isinstance(e, a.FunctionCall):
            return self._bind_function(e, scope)
        if isinstance(e, a.Between):
            arg = self.bind_expr(e.operand, scope)
            low = self.bind_expr(e.low, scope)
            high = self.bind_expr(e.high, scope)
            if e.symmetric:
                # bounds may arrive in either order; bound exprs are shared so
                # embedded subquery plans stay single-execution (executor memo)
                t = promote(low.sql_type, high.sql_type)
                low, high = (ScalarFunc("least", (low, high), t),
                             ScalarFunc("greatest", (low, high), t))
            arg_l, low = self._coerce_pair(arg, low)
            arg_h, high = self._coerce_pair(arg, high)
            cond = ScalarFunc("and", (
                ScalarFunc("ge", (arg_l, low), SqlType.BOOLEAN),
                ScalarFunc("le", (arg_h, high), SqlType.BOOLEAN),
            ), SqlType.BOOLEAN)
            if e.negated:
                return ScalarFunc("not", (cond,), SqlType.BOOLEAN)
            return cond
        if isinstance(e, a.InList):
            arg = self.bind_expr(e.operand, scope)
            items = []
            for it in e.items:
                b = self.bind_expr(it, scope)
                _, b = self._coerce_pair(arg, b)
                items.append(b)
            return InListExpr(arg, tuple(items), e.negated)
        if isinstance(e, a.InSubquery):
            arg = self.bind_expr(e.operand, scope)
            sub, _ = self.bind_query(e.subquery, scope)
            if len(sub.schema) != 1:
                raise BindError("IN subquery must return exactly one column")
            return InSubqueryExpr(arg, sub, e.negated)
        if isinstance(e, a.Exists):
            sub, _ = self.bind_query(e.subquery, scope)
            return ExistsExpr(sub, e.negated)
        if isinstance(e, a.ScalarSubquery):
            sub, _ = self.bind_query(e.subquery, scope)
            if len(sub.schema) != 1:
                raise BindError("Scalar subquery must return exactly one column")
            return ScalarSubqueryExpr(sub, sub.schema[0].sql_type)
        if isinstance(e, a.Like):
            arg = self.bind_expr(e.operand, scope)
            pattern = self.bind_expr(e.pattern, scope)
            op = "similar" if e.similar else ("ilike" if e.case_insensitive else "like")
            args = (arg, pattern) if e.escape is None else (arg, pattern, Literal(e.escape, SqlType.VARCHAR))
            out = ScalarFunc(op, args, SqlType.BOOLEAN)
            if e.negated:
                return ScalarFunc("not", (out,), SqlType.BOOLEAN)
            return out
        if isinstance(e, a.IsNull):
            arg = self.bind_expr(e.operand, scope)
            return ScalarFunc("is_not_null" if e.negated else "is_null", (arg,), SqlType.BOOLEAN)
        if isinstance(e, a.IsBool):
            arg = self._coerce_bool(self.bind_expr(e.operand, scope))
            op = {(True, False): "is_true", (True, True): "is_not_true",
                  (False, False): "is_false", (False, True): "is_not_false"}[(e.value, e.negated)]
            return ScalarFunc(op, (arg,), SqlType.BOOLEAN)
        if isinstance(e, a.IsDistinctFrom):
            left = self.bind_expr(e.left, scope)
            right = self.bind_expr(e.right, scope)
            left, right = self._coerce_pair(left, right)
            op = "is_not_distinct_from" if e.negated else "is_distinct_from"
            return ScalarFunc(op, (left, right), SqlType.BOOLEAN)
        if isinstance(e, a.Extract):
            arg = self.bind_expr(e.operand, scope)
            return ScalarFunc(f"extract_{e.unit.lower()}", (arg,), SqlType.BIGINT)
        if isinstance(e, a.Substring):
            arg = self.bind_expr(e.operand, scope)
            start = self.bind_expr(e.start, scope) if e.start is not None else Literal(1, SqlType.BIGINT)
            args = [arg, start]
            if e.length is not None:
                args.append(self.bind_expr(e.length, scope))
            return ScalarFunc("substring", tuple(args), SqlType.VARCHAR)
        if isinstance(e, a.Trim):
            arg = self.bind_expr(e.operand, scope)
            op = {"BOTH": "btrim", "LEADING": "ltrim", "TRAILING": "rtrim"}[e.where]
            args = [arg]
            if e.chars is not None:
                args.append(self.bind_expr(e.chars, scope))
            return ScalarFunc(op, tuple(args), SqlType.VARCHAR)
        if isinstance(e, a.Position):
            needle = self.bind_expr(e.needle, scope)
            hay = self.bind_expr(e.haystack, scope)
            return ScalarFunc("position", (needle, hay), SqlType.INTEGER)
        if isinstance(e, a.Overlay):
            args = [self.bind_expr(e.operand, scope), self.bind_expr(e.replacement, scope),
                    self.bind_expr(e.start, scope)]
            if e.length is not None:
                args.append(self.bind_expr(e.length, scope))
            return ScalarFunc("overlay", tuple(args), SqlType.VARCHAR)
        if isinstance(e, a.CeilFloorTo):
            arg = self.bind_expr(e.operand, scope)
            op = "datetime_ceil" if e.func == "CEIL" else "datetime_floor"
            return ScalarFunc(op, (arg, Literal(e.unit, SqlType.VARCHAR)), arg.sql_type)
        if isinstance(e, a.Wildcard):
            raise BindError("Wildcard not allowed here")
        raise BindError(f"Cannot bind expression {type(e).__name__}")

    def _bind_binary(self, e: a.BinaryOp, scope: Scope) -> Expr:
        if e.op in ("AND", "OR"):
            left = self._coerce_bool(self.bind_expr(e.left, scope))
            right = self._coerce_bool(self.bind_expr(e.right, scope))
            return ScalarFunc(e.op.lower(), (left, right), SqlType.BOOLEAN)
        left = self.bind_expr(e.left, scope)
        right = self.bind_expr(e.right, scope)
        if e.op == "||":
            return ScalarFunc("concat", (left, right), SqlType.VARCHAR)
        if e.op in _CMP_OPS:
            left, right = self._coerce_pair(left, right)
            return ScalarFunc(_CMP_OPS[e.op], (left, right), SqlType.BOOLEAN)
        if e.op in _ARITH_OPS:
            return self._bind_arith(e.op, left, right)
        raise BindError(f"Unknown binary operator {e.op}")

    def _bind_arith(self, op: str, left: Expr, right: Expr) -> Expr:
        lt, rt = left.sql_type, right.sql_type
        # datetime arithmetic
        if lt in DATETIME_TYPES or rt in DATETIME_TYPES:
            if op == "-" and lt in DATETIME_TYPES and rt in DATETIME_TYPES:
                return ScalarFunc("datetime_sub", (left, right), SqlType.INTERVAL_DAY_TIME)
            if lt in DATETIME_TYPES and rt in INTERVAL_TYPES:
                return ScalarFunc("datetime_add" if op == "+" else "datetime_sub_interval",
                                  (left, right), lt)
            if rt in DATETIME_TYPES and lt in INTERVAL_TYPES and op == "+":
                return ScalarFunc("datetime_add", (right, left), rt)
            # Timestamp +- Int: reference preoptimizer datetime_coercion
            # (src/sql/preoptimizer.rs:10-21) treats the int as days
            if lt in DATETIME_TYPES and rt in INTEGER_TYPES:
                iv = ScalarFunc("int_to_interval_days", (right,), SqlType.INTERVAL_DAY_TIME)
                return ScalarFunc("datetime_add" if op == "+" else "datetime_sub_interval",
                                  (left, iv), lt)
            if rt in DATETIME_TYPES and lt in INTEGER_TYPES and op == "+":
                iv = ScalarFunc("int_to_interval_days", (left,), SqlType.INTERVAL_DAY_TIME)
                return ScalarFunc("datetime_add", (right, iv), rt)
        if lt in INTERVAL_TYPES or rt in INTERVAL_TYPES:
            if op in ("+", "-") and lt in INTERVAL_TYPES and rt in INTERVAL_TYPES:
                return ScalarFunc(_ARITH_OPS[op], (left, right), lt)
            if op == "*":
                return ScalarFunc("mul", (left, right), lt if lt in INTERVAL_TYPES else rt)
        left, right = self._coerce_pair(left, right)
        result = promote(left.sql_type, right.sql_type)
        if op == "/":
            # SQL division: int/int stays int (truncating) — reference
            # SQLDivisionOperator call.py:165
            return ScalarFunc("div", (left, right), result)
        return ScalarFunc(_ARITH_OPS[op], (left, right), result)

    def _bind_case(self, e: a.Case, scope: Scope) -> Expr:
        whens = []
        if e.operand is not None:
            operand = self.bind_expr(e.operand, scope)
            for cond, res in e.whens:
                c = self.bind_expr(cond, scope)
                o2, c2 = self._coerce_pair(operand, c)
                whens.append((ScalarFunc("eq", (o2, c2), SqlType.BOOLEAN),
                              self.bind_expr(res, scope)))
        else:
            for cond, res in e.whens:
                whens.append((self._coerce_bool(self.bind_expr(cond, scope)),
                              self.bind_expr(res, scope)))
        else_ = self.bind_expr(e.else_, scope) if e.else_ is not None else None
        # result type: promote all branches
        rtypes = [r.sql_type for _, r in whens] + ([else_.sql_type] if else_ is not None else [])
        rt = rtypes[0]
        for t in rtypes[1:]:
            rt = promote(rt, t)
        whens = tuple((c, r if r.sql_type == rt else Cast(r, rt)) for c, r in whens)
        if else_ is not None and else_.sql_type != rt:
            else_ = Cast(else_, rt)
        return CaseExpr(whens, else_, rt)

    def _bind_function(self, e: a.FunctionCall, scope: Scope) -> Expr:
        name = e.name.upper()
        if name == "GROUPING" and e.over is None:
            # bound before the generic arg loop so a select alias can serve
            # as a GROUPING argument (same leniency GROUP BY itself has)
            if not e.args or any(isinstance(x, a.Wildcard) for x in e.args):
                raise BindError("GROUPING requires column arguments")
            from .expressions import GroupingExpr

            bound = []
            amap = getattr(self, "_select_alias_asts", None) or {}
            for arg in e.args:
                try:
                    bound.append(self.bind_expr(arg, scope))
                except BindError:
                    if isinstance(arg, a.Identifier) and len(arg.parts) == 1:
                        key = (arg.parts[0] if self.case_sensitive
                               else arg.parts[0].lower())
                        ast2 = amap.get(key)
                        if ast2 is not None:
                            bound.append(self.bind_expr(ast2, scope))
                            continue
                    raise
            return GroupingExpr(tuple(bound), SqlType.INTEGER)
        args = []
        for arg in e.args:
            if isinstance(arg, a.Wildcard):
                args.append(None)  # COUNT(*)
            else:
                args.append(self.bind_expr(arg, scope))
        # window function?
        if e.over is not None:
            return self._bind_window_call(name, args, e, scope)
        # aggregate?
        if name in AGGREGATE_FUNCTIONS:
            return self._make_agg(name, args, e, scope)
        # UDF / user aggregation (reference call.py:1193-1199 fallback)
        fns = self.catalog.resolve_function(e.name) or self.catalog.resolve_function(e.name.lower())
        if fns:
            fd = _pick_overload(fns, args)
            if fd.aggregation:
                return AggExpr("udaf:" + fd.name, tuple(args), fd.return_type, e.distinct,
                               self._bind_filter(e, scope))
            cast_args = tuple(
                arg if i >= len(fd.parameters) or arg.sql_type == fd.parameters[i][1]
                else Cast(arg, fd.parameters[i][1])
                for i, arg in enumerate(args)
            )
            return UdfExpr(fd.name, cast_args, fd.return_type, fd.row_udf)
        if name in SCALAR_FUNCTIONS:
            op, rt, lo, hi = SCALAR_FUNCTIONS[name]
            if not (lo <= len(args) <= hi):
                raise BindError(f"{name} expects {lo}..{hi} args, got {len(args)}")
            return ScalarFunc(op, tuple(args), resolve_type(rt, [x.sql_type for x in args]))
        raise BindError(f"Unknown function {e.name!r}")

    def _bind_filter(self, e: a.FunctionCall, scope: Scope) -> Optional[Expr]:
        if e.filter is None:
            return None
        return self._coerce_bool(self.bind_expr(e.filter, scope))

    def _make_agg(self, name: str, args, e: a.FunctionCall, scope: Scope) -> AggExpr:
        op, rt = AGGREGATE_FUNCTIONS[name]
        filt = self._bind_filter(e, scope)
        if name == "COUNT" and (not args or args[0] is None):
            return AggExpr("count_star", (), SqlType.BIGINT, e.distinct, filt)
        if any(arg is None for arg in args):
            raise BindError(f"* argument only allowed in COUNT")
        arg_types = [x.sql_type for x in args]
        return AggExpr(op, tuple(args), resolve_type(rt, arg_types), e.distinct, filt)

    def _bind_window_call(self, name, args, e: a.FunctionCall, scope: Scope) -> WindowExpr:
        spec = e.over
        if isinstance(spec, str):
            named = getattr(self, "_named_windows", {})
            if spec in named:
                spec = named[spec]
            elif not self.case_sensitive and spec.lower() in {
                    k.lower() for k in named}:
                spec = next(v for k, v in named.items() if k.lower() == spec.lower())
            else:
                raise BindError(f"Unknown window name {spec!r}")
        partition = tuple(self.bind_expr(x, scope) for x in spec.partition_by)
        order = tuple(
            SortKey(self.bind_expr(it.expr, scope), it.ascending, it.nulls_first)
            for it in spec.order_by
        )
        if name in WINDOW_FUNCTIONS:
            rt = WINDOW_FUNCTIONS[name]
            func = name.lower()
            sql_type = resolve_type(rt, [x.sql_type for x in args if x is not None])
        elif name in AGGREGATE_FUNCTIONS:
            op, rt = AGGREGATE_FUNCTIONS[name]
            if name == "COUNT" and (not args or args[0] is None):
                func, sql_type = "count_star", SqlType.BIGINT
                args = []
            else:
                func = op
                sql_type = resolve_type(rt, [x.sql_type for x in args])
        else:
            raise BindError(f"Unknown window function {name!r}")
        if spec.frame is not None:
            units = spec.frame.units
            start = _bind_bound(spec.frame.start, units)
            end = _bind_bound(spec.frame.end, units)
            wspec = WindowSpec(partition, order, units, start, end, True)
        else:
            # default frame: RANGE UNBOUNDED PRECEDING..CURRENT ROW when ordered,
            # else the whole partition
            if order:
                wspec = WindowSpec(partition, order, "RANGE",
                                   WindowFrameBound("UNBOUNDED_PRECEDING"),
                                   WindowFrameBound("CURRENT_ROW"), False)
            else:
                wspec = WindowSpec(partition, order, "ROWS",
                                   WindowFrameBound("UNBOUNDED_PRECEDING"),
                                   WindowFrameBound("UNBOUNDED_FOLLOWING"), False)
        return WindowExpr(func, tuple(a_ for a_ in args if a_ is not None), wspec,
                          sql_type, e.ignore_nulls)

    # ------------------------------------------------------------- coercion
    def _coerce_bool(self, e: Expr) -> Expr:
        if e.sql_type == SqlType.BOOLEAN:
            return e
        if e.sql_type in NUMERIC_TYPES:
            return Cast(e, SqlType.BOOLEAN)
        if e.sql_type == SqlType.NULL:
            return Cast(e, SqlType.BOOLEAN)
        raise BindError(f"Expected boolean expression, got {e.sql_type}")

    def _coerce_pair(self, left: Expr, right: Expr) -> Tuple[Expr, Expr]:
        lt, rt = left.sql_type, right.sql_type
        if lt == rt:
            return left, right
        # string literal vs datetime/numeric: cast the literal
        if isinstance(right, Literal) and rt in STRING_TYPES and lt not in STRING_TYPES:
            return left, _cast_literal(right, lt)
        if isinstance(left, Literal) and lt in STRING_TYPES and rt not in STRING_TYPES:
            return _cast_literal(left, rt), right
        try:
            target = promote(lt, rt)
        except NotImplementedError:
            raise BindError(f"Cannot compare {lt} with {rt}")
        l2 = left if lt == target else Cast(left, target)
        r2 = right if rt == target else Cast(right, target)
        return l2, r2

    # ----------------------------------------------------------------- misc
    def _derive_name(self, e: a.Expr) -> str:
        if isinstance(e, a.Identifier):
            return e.parts[-1]
        if isinstance(e, a.FunctionCall):
            return e.name
        if isinstance(e, a.Cast):
            return self._derive_name(e.operand)
        if isinstance(e, a.Literal):
            return str(e.value)
        if isinstance(e, a.Extract):
            return "EXTRACT"
        if isinstance(e, a.Case):
            return "CASE"
        return "EXPR"

    def _derive_name_expr(self, e: Expr, i: int) -> str:
        if isinstance(e, ColumnRef):
            return e.name
        return f"__group{i}"


class _OuterRef(ColumnRef):
    """Correlated reference to the immediately-enclosing query's scope.

    Parity: the correlated columns DataFusion's decorrelation rules track
    (optimizer/decorrelate_where_*.rs in the reference).
    """


def _subst_select_aliases(node, alias_map, should_subst, fold=lambda s: s):
    """Rewrite single-part Identifiers matching a select alias with that
    item's AST expression (HAVING may reference select aliases of
    aggregates, as the reference planner's SqlToRel resolves — VERDICT r2
    missing #5).  `fold` case-folds lookups to match the binder's identifier
    matching mode.  Does not descend into subqueries (own scopes)."""
    import dataclasses

    if isinstance(node, a.Identifier):
        if len(node.parts) == 1:
            target = alias_map.get(fold(node.parts[0]))
            if target is not None and should_subst(node):
                return target
        return node
    if isinstance(node, a.Select) or not dataclasses.is_dataclass(node):
        return node

    def walk_val(v):
        if isinstance(v, a.Expr):
            return _subst_select_aliases(v, alias_map, should_subst, fold)
        if isinstance(v, list):
            return [walk_val(x) for x in v]
        if isinstance(v, tuple):
            return tuple(walk_val(x) for x in v)
        return v

    kw = {f.name: walk_val(getattr(node, f.name))
          for f in dataclasses.fields(node)}
    return type(node)(**kw)


def _pick_overload(fns, args):
    """Choose the registered overload whose arity matches (parity: the
    reference's DaskFunction signature map, function.rs)."""
    n = len(args)
    exact = [fd for fd in fns if len(fd.parameters) == n]
    if exact:
        # prefer type-compatible signatures
        for fd in exact:
            if all(similar_type(a.sql_type, p_[1]) for a, p_ in zip(args, fd.parameters)):
                return fd
        return exact[0]
    return fns[0]


def _split_alias(alias):
    if alias is None:
        return None, None
    if isinstance(alias, tuple):
        return alias[0], alias[1]
    return alias, None


def _bind_bound(bound, units: str) -> WindowFrameBound:
    kind, offset = bound
    off = None
    if offset is not None:
        if isinstance(offset, a.IntervalLiteral):
            if units != "RANGE":
                raise BindError("Interval frame offsets require RANGE frames")
            lit = _bind_interval(offset)
            if lit.sql_type == SqlType.INTERVAL_YEAR_MONTH:
                raise BindError(
                    "Year-month intervals are not supported as RANGE offsets; "
                    "use day-time intervals (e.g. INTERVAL '30' DAY)")
            off = lit.value  # day-time interval: nanoseconds
        elif isinstance(offset, a.Literal) and isinstance(offset.value, (int, float)):
            if units == "ROWS" and not isinstance(offset.value, int):
                raise BindError("ROWS frame offsets must be integer literals")
            off = offset.value
        else:
            raise BindError("Window frame offsets must be numeric or interval literals")
    return WindowFrameBound(kind, off)


def _bind_literal(e: a.Literal) -> Literal:
    v = e.value
    if e.type_name == "DATE":
        ns = np.datetime64(v, "ns").astype(np.int64)
        ns = (ns // 86_400_000_000_000) * 86_400_000_000_000
        return Literal(int(ns), SqlType.DATE)
    if e.type_name in ("TIMESTAMP", "TIME"):
        return Literal(int(np.datetime64(v, "ns").astype(np.int64)), SqlType.TIMESTAMP)
    if v is None:
        return Literal(None, SqlType.NULL)
    if isinstance(v, bool):
        return Literal(v, SqlType.BOOLEAN)
    if isinstance(v, int):
        t = SqlType.INTEGER if -(2**31) <= v < 2**31 else SqlType.BIGINT
        return Literal(v, t)
    if isinstance(v, float):
        return Literal(v, SqlType.DOUBLE)
    if isinstance(v, str):
        return Literal(v, SqlType.VARCHAR)
    raise BindError(f"Cannot bind literal {v!r}")


def _cast_literal(lit: Literal, target: SqlType) -> Literal:
    v = lit.value
    if target in DATETIME_TYPES:
        if lit.sql_type in DATETIME_TYPES:
            # already epoch nanoseconds
            ns = int(v)
        else:
            ns = int(np.datetime64(str(v).strip(), "ns").astype(np.int64))
        if target == SqlType.DATE:
            ns = (ns // 86_400_000_000_000) * 86_400_000_000_000
        return Literal(int(ns), target)
    if lit.sql_type in DATETIME_TYPES or lit.sql_type in INTERVAL_TYPES:
        if target in INTEGER_TYPES:
            return Literal(int(v), target)
        return lit
    if target in INTEGER_TYPES:
        return Literal(int(v), target)
    if target in (SqlType.FLOAT, SqlType.DOUBLE, SqlType.DECIMAL, SqlType.REAL):
        return Literal(float(v), target)
    if target == SqlType.BOOLEAN:
        return Literal(str(v).strip().lower() in ("true", "t", "1", "yes"), target)
    return lit


def _bind_interval(e: a.IntervalLiteral) -> Literal:
    unit = e.unit.split(" TO ")[0]
    text = e.value.strip()
    if unit in _INTERVAL_MONTHS and re.fullmatch(r"-?\d+", text):
        months = int(text) * _INTERVAL_MONTHS[unit]
        return Literal(months, SqlType.INTERVAL_YEAR_MONTH)
    # day-time intervals, possibly compound '1 02:03:04.5'
    total_ns = 0
    neg = text.startswith("-")
    if neg:
        text = text[1:]
    if re.fullmatch(r"\d+(\.\d+)?", text):
        total_ns = int(float(text) * _INTERVAL_NS.get(unit, 1_000_000_000))
    else:
        m = re.fullmatch(r"(?:(\d+)\s+)?(\d+):(\d+)(?::(\d+(?:\.\d+)?))?", text)
        if not m:
            raise BindError(f"Bad interval literal {e.value!r}")
        days = int(m.group(1) or 0)
        h, mi = int(m.group(2)), int(m.group(3))
        s = float(m.group(4) or 0)
        total_ns = int(((days * 24 + h) * 3600 + mi * 60 + s) * 1_000_000_000)
    if neg:
        total_ns = -total_ns
    return Literal(total_ns, SqlType.INTERVAL_DAY_TIME)


def _nullable(e: Expr) -> bool:
    if isinstance(e, Literal):
        return e.value is None
    if isinstance(e, ColumnRef):
        return e.nullable
    return True


# ---------------------------------------------------------------------------
# Join-condition analysis (parity: reference join.py:250 _split_join_condition)
# ---------------------------------------------------------------------------
def split_join_condition(cond: Expr, nleft: int):
    """Split a bound join condition into equi-key pairs + residual filter.

    Key pairs are (left_expr, right_expr) where left refers only to columns
    < nleft and right only to columns >= nleft (right exprs keep combined
    indices; the physical layer re-bases them).
    """
    from .expressions import referenced_columns

    conjuncts = _flatten_and(cond)
    on, residual = [], []
    for c in conjuncts:
        if isinstance(c, Literal) and c.value is True:
            continue
        if isinstance(c, ScalarFunc) and c.op == "eq":
            l, r = c.args
            lcols, rcols = referenced_columns(l), referenced_columns(r)
            if lcols and rcols:
                if max(lcols) < nleft and min(rcols) >= nleft:
                    on.append((l, r))
                    continue
                if max(rcols) < nleft and min(lcols) >= nleft:
                    on.append((r, l))
                    continue
        residual.append(c)
    resid = None
    if residual:
        resid = residual[0]
        for c in residual[1:]:
            resid = ScalarFunc("and", (resid, c), SqlType.BOOLEAN)
    return on, resid


def _flatten_and(e: Expr) -> List[Expr]:
    if isinstance(e, ScalarFunc) and e.op == "and":
        out = []
        for c in e.args:
            out.extend(_flatten_and(c))
        return out
    return [e]
