"""Static plan verifier: re-infer every node's output schema and cross-check.

Counterpart of `dask_sql_tpu/analysis/verifier.py`, a copy on the port's
planner, dtypes, `ops/grouping.py` `RADIX_DOMAIN_LIMIT` and the evaluator's
op names.  An independent walk of the bound logical plan re-derives what
each node must produce (field count, dtype category, nullability, an
estimated power-of-two shape bucket) from the catalog and the type rules
of `planner/functions.py`, and cross-checks it against what the plan
*declares*, which is what `physical/compiled*.py` and the rel plugins
emit.

Outcomes, in decreasing severity:

- ``error`` findings (dtype category mismatch, column index out of range,
  an op the evaluator has no implementation for, set-op arity mismatch)
  would surface mid-execution as a wrong-dtype kernel or a failure:
  `verify_and_apply` raises a taxonomy ``PlanError`` at bind time instead.
- ``warn`` findings mark compiled rungs that are statically *doomed*: the
  mixed-radix group-id domain provably exceeding the ``1 << 22`` gate of
  `physical/compiled.py` / `physical/compiled_join.py`, which those rungs
  would otherwise find out only after the host syncs that resolve their
  key bounds.  The verdict is attached to the plan node
  (``_dsql_skip_rungs``) and the degradation ladder skips those rungs
  without attempting them (``analysis.rung_skip.*``).  Under
  ``analysis.verify = strict`` they raise like errors.
- ``info`` findings are advisory: shapes that key a new pipeline or run
  eagerly on a new shape (``recompile-hazard``; the reference's XLA
  recompiles have no counterpart in the port, so each message says what
  the port pays), per-scan shape buckets and encodings.  ``EXPLAIN LINT``
  shows all three levels.

Unlike the reference, nothing here reads a lazy parquet table's rows
(`datacontainer.LazyParquetContainer.table` loads the whole location):
its row count comes from the footers, and a string key over it has an
unknown radix, the sound answer for a lower bound.  A scan of a sharded
table adds the ``spmd`` advisory (its mesh's width in shards, the bytes a
shard holds, whether a sharded rung may run).
"""
from __future__ import annotations

import functools
import logging
from typing import Dict, List, Optional, Tuple

from ..columnar.dtypes import (
    DATETIME_TYPES,
    FLOAT_TYPES,
    INTEGER_TYPES,
    INTERVAL_TYPES,
    STRING_TYPES,
    SqlType,
)
from ..planner import plan as p
from ..planner.expressions import (
    AggExpr,
    CaseExpr,
    Cast,
    ColumnRef,
    Expr,
    ExistsExpr,
    Field,
    GroupingExpr,
    InArrayExpr,
    InListExpr,
    InSubqueryExpr,
    Literal,
    ScalarFunc,
    ScalarSubqueryExpr,
    UdfExpr,
    WindowExpr,
    walk,
)
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARN, sort_findings

logger = logging.getLogger(__name__)

#: the mixed-radix group-id domain gate, imported from the radix planners'
#: shared home (ops/grouping.py) so the bind-time verdict and the
#: compile-time gate in physical/compiled*.py can never drift silently
from ..ops.grouping import RADIX_DOMAIN_LIMIT  # noqa: E402

#: rungs a radix-domain overflow dooms (both planners share the gate)
_RADIX_RUNGS = frozenset({"compiled_aggregate", "compiled_join_aggregate"})


# ---------------------------------------------------------------------------
# type-rule tables (mirrors of planner/functions.py + the binder's operators)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _scalar_result_rules() -> Dict[str, str]:
    """Canonical kernel op -> result-type rule, rebuilt from the binder's
    own signature table so the two can't diverge; ops bound directly by
    the binder (operators) are appended by hand."""
    from ..planner.functions import SCALAR_FUNCTIONS

    rules: Dict[str, str] = {}
    for op, rule, _, _ in SCALAR_FUNCTIONS.values():
        if rules.setdefault(op, rule) != rule:  # conflicting rule: no claim
            rules[op] = "?"
    rules.update({
        "add": "promote", "sub": "promote", "mul": "?", "neg": "arg0",
        "div": "?", "mod": "promote",
        "eq": "boolean", "ne": "boolean", "lt": "boolean", "le": "boolean",
        "gt": "boolean", "ge": "boolean",
        "is_distinct_from": "boolean", "is_not_distinct_from": "boolean",
        "and": "boolean", "or": "boolean", "not": "boolean",
        "is_null": "boolean", "is_not_null": "boolean",
        "is_true": "boolean", "is_false": "boolean",
        "is_not_true": "boolean", "is_not_false": "boolean",
        "like": "boolean", "ilike": "boolean", "similar": "boolean",
        # datetime arithmetic result types depend on operand roles: no claim
        "datetime_add": "?", "datetime_sub": "?", "datetime_sub_interval": "?",
        "int_to_interval_days": "?",
    })
    return {k: v for k, v in rules.items() if v != "?"}


@functools.lru_cache(maxsize=1)
def _agg_result_rules() -> Dict[str, str]:
    from ..planner.functions import AGGREGATE_FUNCTIONS

    rules: Dict[str, str] = {}
    for op, rule in AGGREGATE_FUNCTIONS.values():
        if rules.setdefault(op, rule) != rule:
            rules[op] = "?"
    rules["count_star"] = "bigint"
    return {k: v for k, v in rules.items() if v != "?"}


@functools.lru_cache(maxsize=1)
def _known_ops() -> Optional[frozenset]:
    """Every op name the evaluator implements: its core (`CORE_OPS`) and
    the registry of `OPERATION_MAPPING`."""
    try:
        from ..physical.rex.operations import CORE_OPS, OPERATION_MAPPING

        return frozenset(OPERATION_MAPPING) | CORE_OPS
    except Exception:  # dsql: allow-broad-except — the op table is optional
        # here
        return None


def _cat(t: Optional[SqlType]) -> Optional[str]:
    """Device-representation category: two SQL types in the same category
    share a kernel domain; a cross-category mismatch means the physical
    layer will materialize a different buffer than the plan declares."""
    if t is None:
        return None
    if t in INTEGER_TYPES:
        return "int"
    if t in FLOAT_TYPES:
        return "float"
    if t in STRING_TYPES:
        return "string"
    if t in DATETIME_TYPES:
        return "datetime"
    if t in INTERVAL_TYPES:
        return "interval"
    if t is SqlType.BOOLEAN:
        return "bool"
    return None  # NULL / ANY / BINARY: no claim


def _pow2_bucket(n: Optional[int]) -> Optional[int]:
    if n is None or n <= 0:
        return None
    return 1 << (int(n) - 1).bit_length()


class PlanVerdict:
    """Outcome of one verification walk."""

    def __init__(self, findings: List[Finding], node_rungs=()):
        self.findings = sort_findings(findings)
        #: [(plan node, rungs proven doomed)] — verify_and_apply attaches
        #: these to the nodes for the degradation ladder
        self.node_rungs = list(node_rungs)
        #: subtrees skipped because the verifier itself crashed there
        self.internal_errors = 0

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_WARN]

    def skip_rungs(self) -> Dict[str, frozenset]:
        """node label -> rungs proven doomed (for display/metrics)."""
        out: Dict[str, frozenset] = {}
        for f in self.findings:
            if f.rungs:
                out[f.node] = out.get(f.node, frozenset()) | f.rungs
        return out

    def format_rows(self) -> List[str]:
        if not self.findings:
            return ["ok: plan verified clean (0 findings)"]
        rows = [f.format() for f in self.findings]
        rows.append(
            f"summary: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s), "
            f"{len(self.findings) - len(self.errors) - len(self.warnings)} "
            f"info")
        return rows


class _Verifier:
    def __init__(self, context=None, collect_info: bool = True):
        self.context = context
        self.collect_info = collect_info
        self.findings: List[Finding] = []
        self.internal_errors = 0
        self.scalar_rules = _scalar_result_rules()
        self.agg_rules = _agg_result_rules()
        self.known_ops = _known_ops()
        #: (plan node) -> rungs to skip, applied by verify_and_apply
        self.node_rungs: List[Tuple[p.LogicalPlan, frozenset]] = []

    # ------------------------------------------------------------- findings
    def add(self, rule: str, severity: str, node: p.LogicalPlan, message: str,
            rungs: frozenset = frozenset()) -> None:
        if severity == SEV_INFO and not self.collect_info:
            return
        self.findings.append(
            Finding(rule, severity, node._label(), message, rungs))
        if rungs:
            self.node_rungs.append((node, rungs))

    # --------------------------------------------------------- entry points
    def verify(self, plan: p.LogicalPlan) -> None:
        if isinstance(plan, p.Explain):
            plan = plan.input
        self._walk(plan)

    def _walk(self, node: p.LogicalPlan) -> Optional[int]:
        """Verify one node (children first); returns the node's estimated
        row count (None = unknown) for shape-bucket propagation."""
        child_rows = [self._walk(c) for c in node.inputs()]
        try:
            return self._check(node, child_rows)
        except Exception:  # dsql: allow-broad-except — a verifier bug must
            # never block planning: the subtree goes unverified, counted in
            # analysis.verifier_internal
            self.internal_errors += 1
            logger.debug("plan verifier failed on %s; subtree unverified",
                         node.node_type, exc_info=True)
            self.add("verifier-internal", SEV_INFO, node,
                     "verification skipped (internal error)")
            return None

    # ----------------------------------------------------------- node rules
    def _check(self, node: p.LogicalPlan, child_rows: List[Optional[int]]
               ) -> Optional[int]:
        rows: Optional[int] = child_rows[0] if child_rows else None
        if isinstance(node, p.TableScan):
            rows = self._check_scan(node)
        elif isinstance(node, p.Projection):
            self._check_projection(node)
        elif isinstance(node, p.Filter):
            self._check_filter(node)
            rows = None  # selectivity unknown; bucketing absorbs it
        elif isinstance(node, p.Join):
            self._check_join(node)
            rows = None
        elif isinstance(node, p.CrossJoin):
            self._cmp_schemas(
                node, list(node.left.schema) + list(node.right.schema),
                node.schema)
            l, r = child_rows
            rows = l * r if (l is not None and r is not None) else None
        elif isinstance(node, p.Aggregate):
            rows = self._check_aggregate(node)
        elif isinstance(node, p.Window):
            self._check_window(node)
        elif isinstance(node, (p.Sort, p.Distinct, p.DistributeBy,
                               p.SubqueryAlias)):
            self._check_passthrough(node)
            if isinstance(node, p.Sort) and node.fetch is not None:
                rows = min(rows, node.fetch) if rows is not None else node.fetch
        elif isinstance(node, p.Limit):
            self._check_passthrough(node)
            self._check_limit_bucket(node)
            rows = node.fetch
        elif isinstance(node, p.Sample):
            self._check_passthrough(node)
            self.add("recompile-hazard", SEV_INFO, node,
                     "sampled row count changes across runs; the operators "
                     "above run eagerly on each new shape, with no "
                     "pipeline rebuilt for it")
            rows = None
        elif isinstance(node, (p.Union, p.Intersect, p.Except)):
            self._check_setop(node)
            if isinstance(node, p.Union):
                rows = (sum(child_rows)  # type: ignore[arg-type]
                        if all(r is not None for r in child_rows) else None)
            else:
                rows = None
        elif isinstance(node, p.Values):
            self._check_values(node)
            rows = len(node.rows)
        elif isinstance(node, p.EmptyRelation):
            rows = 1 if node.produce_one_row else 0
        elif isinstance(node, p.Explain):
            pass
        elif isinstance(node, p.CustomNode):
            pass  # DDL/ML statements: schemas are synthesized, not derived
        self._check_in_array_buckets(node)
        return rows

    # ------------------------------------------------------ per-node checks
    def _check_scan(self, node: p.TableScan) -> Optional[int]:
        fields = self._catalog_fields(node.schema_name, node.table_name)
        rows = self._table_rows(node.schema_name, node.table_name)
        if self.collect_info and rows is not None:
            self.add("shape-bucket", SEV_INFO, node,
                     f"rows={rows} bucket={_pow2_bucket(rows)}")
        if self.collect_info:
            self._scan_encoding_info(node)
            self._scan_spmd_info(node)
        if fields is None:
            return rows
        by_name = {f.name: f for f in fields}
        names = (node.projection if node.projection is not None
                 else [f.name for f in fields])
        if len(names) != len(node.schema):
            self.add("schema-arity", SEV_ERROR, node,
                     f"scan reads {len(names)} column(s) but declares "
                     f"{len(node.schema)} output field(s)")
            return rows
        for declared, name in zip(node.schema, names):
            src = by_name.get(name)
            if src is None:
                self.add("unknown-column", SEV_ERROR, node,
                         f"column {name!r} not present in "
                         f"{node.schema_name}.{node.table_name}")
                continue
            self._cmp_types(node, declared.name, src.sql_type,
                            declared.sql_type)
            if not declared.nullable and src.nullable:
                self.add("nullability", SEV_INFO, node,
                         f"{declared.name} declared NOT NULL but source "
                         f"column is nullable")
        for f in node.filters:
            self._require_boolean(node, f, "pushed-down filter")
            self._expr_type(f, node.schema, node)
        return rows

    def _scan_encoding_info(self, node: p.TableScan) -> None:
        """ENCODING advisory per scan (the EXPLAIN LINT encoding column):
        which compressed encoding each projected column is stored under and
        the encoded-vs-decoded byte ratio — only when anything is actually
        encoded, so PLAIN catalogs lint unchanged."""
        from ..columnar.encodings import (Encoding, resolve_encoded_scan,
                                          scan_bytes)

        got = resolve_encoded_scan(self.context, node)
        if got is None:
            return
        table, names = got
        parts = []
        for n in names:
            c = table.columns[n]
            tag = c.encoding.value
            if c.encoding is Encoding.DICT:
                tag += f"({len(c.enc_values)})"
            parts.append(f"{n}={tag}")
        enc_b, dec_b = scan_bytes(table, names)
        ratio = enc_b / dec_b if dec_b else 1.0
        self.add("encoding", SEV_INFO, node,
                 " ".join(parts) + f"; encoded={enc_b}B decoded={dec_b}B "
                 f"ratio={ratio:.2f}")

    def _scan_spmd_info(self, node: p.TableScan) -> None:
        """The sharding advisory of a scan over a sharded table: its mesh's
        width (shards), the resident bytes a shard holds, and whether a
        sharded rung may run, or why not.  An unsharded table lints as
        before."""
        ctx = self.context
        if ctx is None:
            return
        from ..columnar.encodings import Encoding, encoded_nbytes
        from ..spmd.core import resolve_sharded_scan, spmd_enabled

        got = resolve_sharded_scan(ctx, node)
        if got is None:
            return
        table, mesh = got
        ndev = int(mesh.size)
        total = sum(encoded_nbytes(c) for c in table.columns.values())
        per_dev = -(-total // ndev)
        config = getattr(ctx, "config", None)
        if config is not None and not spmd_enabled(config):
            why = "spmd rungs disabled (parallel.spmd=off)"
        elif any(c.encoding is Encoding.RLE for c in table.columns.values()):
            why = "rle-encoded column blocks the compiled rungs"
        else:
            why = "spmd rungs eligible"
        self.add("spmd", SEV_INFO, node,
                 f"sharded devices={ndev} per_device_bytes={per_dev}; "
                 f"{why}")

    def _check_projection(self, node: p.Projection) -> None:
        if len(node.exprs) != len(node.schema):
            self.add("schema-arity", SEV_ERROR, node,
                     f"{len(node.exprs)} expression(s) vs "
                     f"{len(node.schema)} declared field(s)")
            return
        for e, f in zip(node.exprs, node.schema):
            inferred = self._expr_type(e, node.input.schema, node)
            self._cmp_types(node, f.name, inferred, f.sql_type)
            if (not f.nullable and isinstance(e, ColumnRef) and e.nullable):
                self.add("nullability", SEV_INFO, node,
                         f"{f.name} declared NOT NULL from a nullable "
                         f"column reference")

    def _check_filter(self, node: p.Filter) -> None:
        self._require_boolean(node, node.predicate, "predicate")
        self._expr_type(node.predicate, node.input.schema, node)
        self._cmp_schemas(node, node.input.schema, node.schema)

    def _check_join(self, node: p.Join) -> None:
        jt = node.join_type.upper()
        if jt in ("LEFTSEMI", "LEFTANTI"):
            expected = list(node.left.schema)
        elif jt == "LEFTMARK":
            # mark join (EXISTS-under-OR decorrelation): left fields plus
            # one appended BOOLEAN matched flag (optimizer/rules.py:891)
            expected = list(node.left.schema) + [
                Field("__mark", SqlType.BOOLEAN, False)]
        else:
            expected = list(node.left.schema) + list(node.right.schema)
        if len(expected) != len(node.schema):
            self.add("schema-arity", SEV_ERROR, node,
                     f"join of {len(node.left.schema)}+"
                     f"{len(node.right.schema)} field(s) declares "
                     f"{len(node.schema)}")
        else:
            self._cmp_schemas(node, expected, node.schema)
        # right-side key exprs index the COMBINED schema; the physical layer
        # shifts them by -len(left.schema) before evaluating on the right
        # input (physical/rel/logical/join.py:71)
        combined = list(node.left.schema) + list(node.right.schema)
        for lk, rk in node.on:
            lt = self._expr_type(lk, node.left.schema, node)
            rt = self._expr_type(rk, combined, node)
            lc, rc = _cat(lt), _cat(rt)
            if lc is not None and rc is not None and lc != rc:
                sev = (SEV_WARN if {lc, rc} <= {"int", "float"}
                       else SEV_ERROR)
                self.add("join-key-mismatch", sev, node,
                         f"equi-join key pair {lk} = {rk} compares "
                         f"{lt} against {rt}")
        if node.filter is not None:
            self._require_boolean(node, node.filter, "residual filter")
            self._expr_type(node.filter, combined, node)

    def _check_aggregate(self, node: p.Aggregate) -> Optional[int]:
        in_schema = node.input.schema
        expected: List[Optional[SqlType]] = []
        for g in node.group_exprs:
            expected.append(self._expr_type(g, in_schema, node))
        for a in node.agg_exprs:
            expected.append(self._agg_type(a, in_schema, node))
        if len(expected) != len(node.schema):
            self.add("schema-arity", SEV_ERROR, node,
                     f"{len(node.group_exprs)} group + "
                     f"{len(node.agg_exprs)} agg expression(s) vs "
                     f"{len(node.schema)} declared field(s)")
            return None
        for t, f in zip(expected, node.schema):
            self._cmp_types(node, f.name, t, f.sql_type)
        domain, all_known = self._radix_domain(node)
        if domain is not None and domain > RADIX_DOMAIN_LIMIT:
            self.add(
                "radix-overflow", SEV_WARN, node,
                f"static group-key domain >= {domain} exceeds the "
                f"1<<22 radix gate; compiled rungs are skipped without "
                f"being attempted ({', '.join(sorted(_RADIX_RUNGS))})",
                rungs=_RADIX_RUNGS)
        # the domain bounds output rows only when every key was sized
        return domain if (all_known and domain is not None
                          and domain <= RADIX_DOMAIN_LIMIT) else None

    def _check_window(self, node: p.Window) -> None:
        expected = [f.sql_type for f in node.input.schema]
        for w in node.window_exprs:
            expected.append(self._window_type(w, node.input.schema, node))
        if len(expected) != len(node.schema):
            self.add("schema-arity", SEV_ERROR, node,
                     f"input {len(node.input.schema)} + "
                     f"{len(node.window_exprs)} window expression(s) vs "
                     f"{len(node.schema)} declared field(s)")
            return
        for t, f in zip(expected, node.schema):
            self._cmp_types(node, f.name, t, f.sql_type)

    def _check_passthrough(self, node: p.LogicalPlan) -> None:
        (inp,) = node.inputs() or (None,)
        if inp is not None:
            self._cmp_schemas(node, inp.schema, node.schema)

    def _check_limit_bucket(self, node: p.Limit) -> None:
        if node.fetch is None:
            return
        window = node.fetch + (node.skip or 0)
        if window > 0 and window & (window - 1):
            self.add("recompile-hazard", SEV_INFO, node,
                     f"scan window {window} is not a power of two; each "
                     f"distinct window size keys its own compiled-select "
                     f"pipeline, planned and trial-run on its first query "
                     f"(survivor counts share pow2 buckets)")

    def _check_setop(self, node: p.LogicalPlan) -> None:
        width = len(node.schema)
        for child in node.inputs():
            if len(child.schema) != width:
                self.add("schema-arity", SEV_ERROR, node,
                         f"set-op child emits {len(child.schema)} "
                         f"column(s), expected {width}")
                continue
            for cf, f in zip(child.schema, node.schema):
                cc, oc = _cat(cf.sql_type), _cat(f.sql_type)
                if cc is None or oc is None or cc == oc:
                    continue
                if {cc, oc} <= {"int", "float"}:
                    continue  # numeric promotion inserts device casts
                self.add("dtype-mismatch", SEV_ERROR, node,
                         f"set-op child column {cf.name!r} is "
                         f"{cf.sql_type}, not promotable to declared "
                         f"{f.sql_type}")

    def _check_values(self, node: p.Values) -> None:
        width = len(node.schema)
        for i, row in enumerate(node.rows):
            if len(row) != width:
                self.add("schema-arity", SEV_ERROR, node,
                         f"VALUES row {i} has {len(row)} expression(s), "
                         f"expected {width}")
                continue
            for e, f in zip(row, node.schema):
                if isinstance(e, Literal) and e.value is not None:
                    self._cmp_types(node, f.name, e.sql_type, f.sql_type)

    def _check_in_array_buckets(self, node: p.LogicalPlan) -> None:
        if not self.collect_info:
            return
        exprs: List[Expr] = []
        if isinstance(node, p.Filter):
            exprs = [node.predicate]
        elif isinstance(node, p.TableScan):
            exprs = list(node.filters)
        elif isinstance(node, p.Projection):
            exprs = list(node.exprs)
        for e in exprs:
            for sub in walk(e):
                if isinstance(sub, InArrayExpr):
                    n = len(sub.values)
                    if n > 0 and n & (n - 1):
                        self.add(
                            "recompile-hazard", SEV_INFO, node,
                            f"membership array of {n} value(s) is not a "
                            f"power of two; the lookup runs eagerly at any "
                            f"length, and each distinct array keys its own "
                            f"compiled pipeline")

    # --------------------------------------------------------- expressions
    def _expr_type(self, e: Expr, fields: List[Field],
                   node: p.LogicalPlan) -> Optional[SqlType]:
        """Bottom-up re-inference; returns None wherever no confident claim
        can be made (every downstream check then stays silent)."""
        if isinstance(e, ColumnRef):
            if e.index < 0 or e.index >= len(fields):
                self.add("column-out-of-range", SEV_ERROR, node,
                         f"column reference #{e.index} ({e.name}) is out "
                         f"of range for a {len(fields)}-column input")
                return None
            src = fields[e.index]
            self._cmp_types(node, f"#{e.index} {e.name}", src.sql_type,
                            e.sql_type)
            return src.sql_type
        if isinstance(e, Literal):
            return e.sql_type if e.value is not None else None
        if isinstance(e, Cast):
            self._expr_type(e.arg, fields, node)
            return e.sql_type
        if isinstance(e, CaseExpr):
            results = [self._expr_type(r, fields, node) for _, r in e.whens]
            for c, _ in e.whens:
                self._expr_type(c, fields, node)
            if e.else_ is not None:
                results.append(self._expr_type(e.else_, fields, node))
            return self._promote_all(results)
        if isinstance(e, (InListExpr, InArrayExpr, InSubqueryExpr,
                          ExistsExpr)):
            if isinstance(e, (InListExpr, InArrayExpr, InSubqueryExpr)):
                self._expr_type(e.arg, fields, node)
            return SqlType.BOOLEAN
        if isinstance(e, ScalarFunc):
            arg_types = [self._expr_type(a, fields, node) for a in e.args]
            if self.known_ops is not None and e.op not in self.known_ops:
                self.add("unknown-op", SEV_ERROR, node,
                         f"op {e.op!r} has no kernel in "
                         f"physical.rex.operations.OPERATION_MAPPING")
                return None
            rule = self.scalar_rules.get(e.op)
            if rule is None or any(t is None for t in arg_types):
                return None
            return self._resolve(rule, arg_types)
        if isinstance(e, (UdfExpr, ScalarSubqueryExpr, GroupingExpr)):
            return e.sql_type  # declared is authoritative for these
        return None

    def _agg_type(self, a: AggExpr, fields: List[Field],
                  node: p.LogicalPlan) -> Optional[SqlType]:
        arg_types = [self._expr_type(x, fields, node) for x in a.args]
        if a.filter is not None:
            self._require_boolean(node, a.filter, f"FILTER of {a.func}")
            self._expr_type(a.filter, fields, node)
        if a.func.startswith("udaf:"):
            return a.sql_type
        rule = self.agg_rules.get(a.func)
        if rule is None:
            self.add("unknown-op", SEV_ERROR, node,
                     f"aggregate {a.func!r} has no result-type rule or "
                     f"kernel")
            return None
        if rule in ("arg0", "promote", "sum") and any(
                t is None for t in arg_types):
            return None
        return self._resolve(rule, arg_types)

    def _window_type(self, w: WindowExpr, fields: List[Field],
                     node: p.LogicalPlan) -> Optional[SqlType]:
        from ..planner.functions import WINDOW_FUNCTIONS

        arg_types = [self._expr_type(x, fields, node) for x in w.args]
        for part in w.spec.partition_by:
            self._expr_type(part, fields, node)
        for k in w.spec.order_by:
            self._expr_type(k.expr, fields, node)
        rule = (WINDOW_FUNCTIONS.get(w.func.upper())
                or self.agg_rules.get(w.func))
        if rule is None:
            return None
        if rule in ("arg0", "promote", "sum") and any(
                t is None for t in arg_types):
            return None
        return self._resolve(rule, arg_types)

    def _resolve(self, rule: str, arg_types) -> Optional[SqlType]:
        from ..planner.functions import resolve_type

        try:
            return resolve_type(rule, arg_types)
        except Exception:  # dsql: allow-broad-except — no claim on failure
            return None

    def _promote_all(self, types) -> Optional[SqlType]:
        from ..columnar.dtypes import promote

        known = [t for t in types if t is not None]
        if len(known) != len(list(types)) or not known:
            return None
        t = known[0]
        try:
            for u in known[1:]:
                t = promote(t, u)
        except Exception:  # dsql: allow-broad-except — no claim on failure
            return None
        return t

    # ----------------------------------------------------------- helpers
    def _require_boolean(self, node: p.LogicalPlan, e: Expr,
                         what: str) -> None:
        t = getattr(e, "sql_type", None)
        c = _cat(t)
        if c is not None and c != "bool":
            self.add("dtype-mismatch", SEV_ERROR, node,
                     f"{what} has type {t}, expected BOOLEAN")

    def _cmp_types(self, node: p.LogicalPlan, name: str,
                   inferred: Optional[SqlType],
                   declared: Optional[SqlType]) -> None:
        ic, dc = _cat(inferred), _cat(declared)
        if ic is None or dc is None or ic == dc:
            return
        if {ic, dc} <= {"int", "float"} and not isinstance(
                node, (p.Projection, p.Aggregate, p.Window)):
            # numeric width/kind differences outside expression-producing
            # nodes come from promotion layers; only expression outputs
            # must match their declaration exactly
            return
        self.add("dtype-mismatch", SEV_ERROR, node,
                 f"{name} declared {declared} but the physical layer "
                 f"will emit {inferred}")

    def _cmp_schemas(self, node: p.LogicalPlan, src: List[Field],
                     declared: List[Field]) -> None:
        if len(src) != len(declared):
            self.add("schema-arity", SEV_ERROR, node,
                     f"input has {len(src)} field(s) but node declares "
                     f"{len(declared)}")
            return
        for s, d in zip(src, declared):
            sc, dc = _cat(s.sql_type), _cat(d.sql_type)
            if sc is not None and dc is not None and sc != dc:
                self.add("dtype-mismatch", SEV_ERROR, node,
                         f"pass-through field {d.name!r} declared "
                         f"{d.sql_type} but input provides {s.sql_type}")

    # ------------------------------------------------- catalog / shape info
    def _container(self, schema_name: str, table_name: str):
        ctx = self.context
        if ctx is None:
            return None
        container = getattr(ctx, "schema", {}).get(schema_name)
        if container is None:
            return None
        dc = container.tables.get(table_name)
        if dc is None and not bool(
                ctx.config.get("sql.identifier.case_sensitive", True)):
            lowered = {k.lower(): v for k, v in container.tables.items()}
            dc = lowered.get(table_name.lower())
        return dc

    def _catalog_fields(self, schema_name: str,
                        table_name: str) -> Optional[List[Field]]:
        dc = self._container(schema_name, table_name)
        if dc is None:
            return None
        from ..datacontainer import LazyParquetContainer

        if isinstance(dc, LazyParquetContainer):
            return list(dc.fields)
        return [Field(name, col.sql_type,
                      col.validity is not None
                      or col.sql_type in (SqlType.FLOAT, SqlType.DOUBLE))
                for name, col in dc.table.columns.items()]

    def _table_rows(self, schema_name: str,
                    table_name: str) -> Optional[int]:
        ctx = self.context
        if ctx is None:
            return None
        container = getattr(ctx, "schema", {}).get(schema_name)
        if container is not None:
            stats = container.statistics.get(table_name)
            if stats is not None and stats.row_count is not None:
                return int(stats.row_count)
        dc = self._container(schema_name, table_name)
        if dc is None:
            return None
        from ..datacontainer import LazyParquetContainer

        if isinstance(dc, LazyParquetContainer):
            # the footers' count: `dc.table` would load the location
            rows = (dc.statistics or {}).get("num-rows")
            return int(rows) if rows is not None else None
        return dc.table.num_rows

    def _radix_domain(self, agg: p.Aggregate
                      ) -> Tuple[Optional[int], bool]:
        """(lower bound on the mixed-radix group-id domain, all keys sized)
        from host-side metadata only (dictionary sizes, BOOLEAN): mirrors
        the radix planning in CompiledAggregate.__init__ / _plan_radix
        without touching device buffers.  Unknown keys contribute factor 1,
        so the product is a provable lower bound: exceeding the gate is
        certain, staying under it is not."""
        if not agg.group_exprs:
            return 1, True
        product = 1
        any_known = False
        all_known = True
        for g in agg.group_exprs:
            radix = None
            if isinstance(g, ColumnRef):
                radix = self._origin_radix(agg.input, g.index)
            if radix is not None:
                any_known = True
                product *= radix
            else:
                all_known = False
        return (product if any_known else None), all_known

    def _origin_radix(self, node: p.LogicalPlan,
                      index: int) -> Optional[int]:
        """Trace a column position through identity-preserving nodes down
        to its TableScan column and size its radix from host metadata."""
        while True:
            if isinstance(node, p.TableScan):
                fields = node.schema
                if index >= len(fields):
                    return None
                f = fields[index]
                if f.sql_type is SqlType.BOOLEAN:
                    return 3  # two values + one NULL slot
                if f.sql_type in STRING_TYPES:
                    from ..datacontainer import LazyParquetContainer

                    dc = self._container(node.schema_name, node.table_name)
                    if dc is None or isinstance(dc, LazyParquetContainer):
                        # no dictionary without loading the location: the
                        # radix is unknown, a sound lower-bound factor
                        return None
                    col = dc.table.columns.get(f.name)
                    dictionary = getattr(col, "dictionary", None)
                    if dictionary is not None:
                        return len(dictionary) + 1  # + NULL sentinel
                return None
            if isinstance(node, p.Projection):
                if index >= len(node.exprs):
                    return None
                e = node.exprs[index]
                if not isinstance(e, ColumnRef):
                    return None
                index = e.index
                node = node.input
                continue
            if isinstance(node, (p.Filter, p.Sort, p.Limit, p.Distinct,
                                 p.Sample, p.DistributeBy,
                                 p.SubqueryAlias)):
                node = node.inputs()[0]
                continue
            if isinstance(node, (p.Join, p.CrossJoin)):
                left = node.left
                if index < len(left.schema):
                    node = left
                    continue
                jt = (node.join_type.upper()
                      if isinstance(node, p.Join) else "INNER")
                if jt == "LEFTMARK":
                    # output is left + appended BOOLEAN __mark, never
                    # right-side columns
                    return 3 if index == len(left.schema) else None
                if jt in ("LEFTSEMI", "LEFTANTI"):
                    return None  # output is left-only; index is corrupt
                index -= len(left.schema)
                node = node.right
                continue
            return None


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def verify_plan(plan, context=None, collect_info: bool = True) -> PlanVerdict:
    """Walk a bound logical plan and return every finding (no raising)."""
    v = _Verifier(context=context, collect_info=collect_info)
    v.verify(plan)
    verdict = PlanVerdict(v.findings, v.node_rungs)
    verdict.internal_errors = v.internal_errors
    return verdict


def check_plan(plan, context=None) -> PlanVerdict:
    """Verify and raise a taxonomy ``PlanError`` on error findings."""
    verdict = verify_plan(plan, context=context, collect_info=False)
    _raise_if(verdict.errors)
    return verdict


def _raise_if(findings) -> None:
    if not findings:
        return
    from ..resilience.errors import PlanError

    head = findings[0]
    more = f" (+{len(findings) - 1} more)" if len(findings) > 1 else ""
    raise PlanError(
        f"plan verification failed: {head.format()}{more}",
        code="PLAN_VERIFY_ERROR", error_type="INTERNAL_ERROR")


def verify_and_apply(plan, context, strict: bool = False) -> PlanVerdict:
    """Bind-time entry (Context._get_ral): verify, record ``analysis.*``
    metrics, attach doomed-rung verdicts to plan nodes for the ladder,
    and raise ``PlanError`` for error findings (plus warn findings under
    ``analysis.verify = strict``)."""
    verdict = verify_plan(plan, context=context, collect_info=False)
    metrics = getattr(context, "metrics", None)
    if metrics is not None:
        metrics.inc("analysis.verify.runs")
        for f in verdict.findings:
            metrics.inc(f"analysis.findings.{f.rule}")
        if verdict.errors:
            metrics.inc("analysis.plan_error")
        if verdict.internal_errors:
            metrics.inc("analysis.verifier_internal", verdict.internal_errors)
    # plain EXPLAIN / EXPLAIN LINT must report findings, never refuse to
    # explain them; EXPLAIN ANALYZE *executes* its input, so it raises
    # like any executing plan
    raising = not (isinstance(plan, p.Explain) and not plan.analyze)
    if raising:
        _raise_if(verdict.errors + (verdict.warnings if strict else []))
    for node, rungs in verdict.node_rungs:
        existing = getattr(node, "_dsql_skip_rungs", frozenset())
        node._dsql_skip_rungs = frozenset(existing) | rungs
    return verdict
