"""Post-optimize parameterization: lift literals out of a plan into a
runtime parameter vector.

Copied from `dask_sql_tpu/families/parameterize.py`, its stem section
(`stem_of`, `compute_stem`, `full_width_stem`: the identity of the
scan->filter prefix that `materialize/` pins) included; only import paths
differ.  In the port a parameter stays a host numpy value: the pipelines'
evaluator moves it to the device, and code-space compares search the host
dictionary with it.

Every query with a different literal used to be a different plan
fingerprint — its own XLA compile, its own result-cache / breaker /
estimator / profile entry — so a serving workload of `WHERE user_id = ?`
re-paid compilation per user id.  This pass rewrites eligible `Literal`
expressions to `ParamRef` placeholders (and all-literal ``IN`` lists to
`InParamExpr` vectors padded to a power-of-two bucket), producing

- a literal-stripped plan copy whose repr is the *family* identity
  (two queries differing only in parameterized literals stringify
  identically), and
- the ordered parameter values the stripped slots refer to.

The compiled pipelines (physical/compiled*.py) run the same rewrite on
their extracted expression lists, key their caches on the parameterized
strings, and take the values as traced runtime arguments — one XLA
executable per family, compile-once-run-many (Flare, arXiv:1703.08219;
TQP, arXiv:2203.01877).

Eligibility is deliberately conservative — a literal stays baked whenever
the compiled evaluators consume it at *trace* time:

- string literals (dictionary lookup tables are built per value at
  compile time), and NULL literals (validity shape is structural);
- LIKE / ILIKE / SIMILAR patterns and escapes (host-compiled regexes);
- DATE_TRUNC / CEIL unit arguments (static truncation unit);
- plan-node integer fields (LIMIT windows, sort fetch, sample fraction,
  window frames) — these change static shapes or host-side slicing, so
  each distinct value is its own family;
- IN lists keep their *bucket*: the value vector pads to the next power
  of two, so lists of 5..8 values share one family and one kernel while
  a 9th value starts a new bucket.

Numeric, boolean, datetime (int64 epoch-ns) and interval (int64
ns / months) scalars in filter predicates, projection expressions and
aggregate arguments all parameterize.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Any, List, Optional, Tuple

import numpy as np

from ..columnar.dtypes import (
    DATETIME_TYPES,
    INTERVAL_TYPES,
    NUMERIC_TYPES,
    SqlType,
    sql_to_np,
)
from ..planner import plan as p
from ..planner.expressions import (
    AggExpr,
    ExistsExpr,
    Expr,
    InListExpr,
    InParamExpr,
    InSubqueryExpr,
    Literal,
    ParamRef,
    ScalarFunc,
    ScalarSubqueryExpr,
)

logger = logging.getLogger(__name__)

#: SQL types whose literals are representable as runtime scalars of the
#: device dtype (strings need compile-time dictionaries; NULL is structural)
_PARAM_TYPES = frozenset(
    NUMERIC_TYPES | DATETIME_TYPES | INTERVAL_TYPES | {SqlType.BOOLEAN,
                                                       SqlType.DECIMAL})

#: ops whose TRAILING arguments the compiled evaluators read at trace time
#: (regex compilation, truncation units) — only args[0] may parameterize
_STATIC_TAIL_OPS = frozenset({"like", "ilike", "similar",
                              "datetime_floor", "datetime_ceil"})


def normalize_in_values(col_dtype: np.dtype,
                        values: List[Any]) -> Optional[np.ndarray]:
    """Host-normalize an IN value list to the comparison domain the kernel
    searches in: drop NULLs, reduce float lists against integer columns to
    their integral members (mirrors ops/membership.sorted_membership), sort.
    Returns None when the list is not parameterizable (empty, strings)."""
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    try:
        arr = np.asarray(vals)
    except (ValueError, TypeError):
        return None
    if arr.dtype.kind not in "iufb":
        return None
    if col_dtype.kind in "iu" and arr.dtype.kind == "f":
        integral = arr == np.floor(arr)
        arr = arr[integral & (np.abs(arr) < 2.0 ** 63)].astype(np.int64)
        if not len(arr):
            return None
    cmp = np.result_type(col_dtype, arr.dtype)
    return np.sort(arr.astype(cmp, copy=False))


def pow2_bucket(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


class Parameterizer:
    """One rewrite pass collecting parameter values as it strips literals.

    ``enabled=False`` makes every rewrite the identity (zero params), so
    call sites need no branching.  ``recurse_subplans`` is on for the
    plan-level family fingerprint (subquery literals join the family) and
    off for the compiled pipelines (subquery expressions decline at trace
    time anyway — their values would only bloat the kernel arguments)."""

    def __init__(self, enabled: bool = True, recurse_subplans: bool = False):
        self.enabled = enabled
        self.recurse_subplans = recurse_subplans
        #: jit-ready values, one per slot: 0-d numpy scalars of the slot's
        #: device dtype, or sorted padded vectors for IN buckets
        self.values: List[np.ndarray] = []
        #: hashable mirror of `values` for result-cache keys
        self.key_values: List[Any] = []

    @property
    def params(self) -> Tuple[np.ndarray, ...]:
        return tuple(self.values)

    # -------------------------------------------------------- expressions
    def rewrite(self, expr: Expr) -> Expr:
        if not self.enabled or expr is None:
            return expr
        return self._rewrite(expr)

    def _rewrite(self, e: Expr) -> Expr:
        if isinstance(e, Literal):
            return self._maybe_param(e)
        if isinstance(e, InListExpr):
            return self._rewrite_in_list(e)
        if isinstance(e, ScalarFunc) and e.op in _STATIC_TAIL_OPS and e.args:
            # pattern / unit arguments are compile-time constants
            return dataclasses.replace(
                e, args=(self._rewrite(e.args[0]),) + tuple(e.args[1:]))
        if isinstance(e, (ScalarSubqueryExpr, InSubqueryExpr, ExistsExpr)):
            if not self.recurse_subplans:
                return e
            out = e
            if getattr(e, "plan", None) is not None:
                out = dataclasses.replace(out, plan=self.rewrite_plan(e.plan))
            if isinstance(out, InSubqueryExpr):
                out = dataclasses.replace(out, arg=self._rewrite(out.arg))
            return out
        kids = e.children()
        if not kids:
            return e
        return e.with_children([self._rewrite(c) for c in kids])

    def _maybe_param(self, lit: Literal) -> Expr:
        if lit.value is None or lit.sql_type not in _PARAM_TYPES:
            return lit
        if isinstance(lit.value, str) or not isinstance(
                lit.value, (int, float, bool, np.integer, np.floating,
                            np.bool_)):
            return lit
        dtype = sql_to_np(lit.sql_type)
        try:
            value = np.asarray(lit.value, dtype=dtype)
        except (ValueError, TypeError, OverflowError):
            return lit
        index = len(self.values)
        self.values.append(value)
        self.key_values.append(value.item())
        return ParamRef(index, lit.sql_type)

    def _rewrite_in_list(self, e: InListExpr) -> Expr:
        from ..columnar.dtypes import STRING_TYPES

        arg = self._rewrite(e.arg)
        if e.arg.sql_type in STRING_TYPES \
                or not all(isinstance(it, Literal) for it in e.items):
            # string membership (dictionary LUT) and computed items stay
            # baked; items must remain Literals for the trace evaluator
            return dataclasses.replace(e, arg=arg)
        if any(it.value is None for it in e.items):
            # a NULL member changes the list's three-valued-logic semantics
            # on the eager path (`x NOT IN (v, NULL)` is never TRUE) —
            # normalizing it away would give `IN (v, NULL)` and `IN (v)`
            # one family identity and ONE result-cache key while their
            # results differ.  Keep the whole list baked: the NULL stays in
            # the family repr and the cache key.
            return dataclasses.replace(e, arg=arg)
        col_dtype = sql_to_np(e.arg.sql_type)
        norm = normalize_in_values(col_dtype, [it.value for it in e.items])
        if norm is None:
            return dataclasses.replace(e, arg=arg)
        bucket = pow2_bucket(len(norm))
        # pad by repeating the (sorted) maximum — membership is unchanged
        padded = np.concatenate(
            [norm, np.repeat(norm[-1:], bucket - len(norm))])
        index = len(self.values)
        self.values.append(padded)
        self.key_values.append(tuple(padded.tolist()))
        return InParamExpr(arg, index, bucket, str(padded.dtype), e.negated)

    # --------------------------------------------------------------- plans
    #: node type -> expression-bearing fields the pass rewrites.  Fields
    #: not listed (sort keys, window frames, VALUES rows, join keys, LIMIT
    #: windows) keep their literals: they steer static shapes, host-side
    #: slicing or converter-time decisions, so each value is its own family.
    _NODE_FIELDS = {
        "Filter": ("predicate",),
        "Projection": ("exprs",),
        "TableScan": ("filters",),
        "Aggregate": ("agg_exprs",),
        "Join": ("filter",),
    }

    def rewrite_plan(self, node: p.LogicalPlan) -> p.LogicalPlan:
        """Literal-stripped copy of `node` (bottom-up; the input plan is
        never mutated — placeholders exist only in the copy)."""
        if not self.enabled:
            return node
        kids = [self.rewrite_plan(c) for c in node.inputs()]
        if kids:
            node = node.with_inputs(kids)
        fields = self._NODE_FIELDS.get(node.node_type)
        if not fields:
            return node
        updates = {}
        for name in fields:
            v = getattr(node, name, None)
            if v is None:
                continue
            if isinstance(v, (list, tuple)):
                updates[name] = [self.rewrite_agg(x) if isinstance(x, AggExpr)
                                 else self._rewrite(x) for x in v]
            elif isinstance(v, Expr):
                updates[name] = self._rewrite(v)
        if not updates:
            return node
        return dataclasses.replace(node, **updates)

    def rewrite_agg(self, a: AggExpr) -> AggExpr:
        if not self.enabled:
            return a
        return dataclasses.replace(
            a, args=tuple(self._rewrite(x) for x in a.args),
            filter=self._rewrite(a.filter) if a.filter is not None else None)


# ---------------------------------------------------------------------------
# family identity
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FamilyInfo:
    """The family identity of one planned query: the literal-stripped plan
    repr (collision-grade identity, same property the result cache's
    repr(plan) keys relied on), its 16-hex-char fingerprint, and this
    query's parameter values in slot order (hashable — IN vectors are
    tuples)."""

    fingerprint: str
    family_repr: str
    key_values: Tuple[Any, ...]
    n_params: int


def compute_family(plan: p.LogicalPlan) -> FamilyInfo:
    """Parameterize a copy of `plan` and derive its family identity.
    Deterministic: traversal order fixes slot numbering, so the same SQL
    shape always maps to the same fingerprint across processes."""
    pz = Parameterizer(enabled=True, recurse_subplans=True)
    stripped = pz.rewrite_plan(plan)
    family_repr = repr(stripped)
    fingerprint = hashlib.sha1(family_repr.encode()).hexdigest()[:16]
    return FamilyInfo(fingerprint, family_repr, tuple(pz.key_values),
                      len(pz.values))


# ---------------------------------------------------------------------------
# plan-prefix (stem) identity — sub-plan materialization
# ---------------------------------------------------------------------------
def stem_of(plan: p.LogicalPlan) -> Optional[p.LogicalPlan]:
    """The plan's materializable *stem*: the maximal contiguous Filter
    chain sitting directly on the plan's single TableScan (the shared
    scan->filter prefix a dashboard's sibling queries re-execute).  None
    when the plan scans zero or several tables, or when the scan carries
    no filtering work at all (materializing a bare scan would just copy
    the registered table).  Returns the topmost node of the stem subtree —
    the SAME object inside ``plan``, so callers can substitute it by
    identity."""
    scans = [n for n in p.walk_plan(plan) if isinstance(n, p.TableScan)]
    if len(scans) != 1:
        return None
    scan = scans[0]

    def find(node: p.LogicalPlan) -> Optional[p.LogicalPlan]:
        # preorder: the first Filter whose chain bottoms at the scan is the
        # topmost one — the maximal prefix
        if isinstance(node, p.Filter):
            cur: p.LogicalPlan = node.input
            while isinstance(cur, p.Filter):
                cur = cur.input
            if cur is scan:
                return node
        for child in node.inputs():
            got = find(child)
            if got is not None:
                return got
        return None

    stem = find(plan)
    if stem is None and scan.filters:
        # no Filter node, but pushed-down scan filters still do per-query
        # work a pinned stem would skip
        stem = scan
    return stem


@dataclasses.dataclass(frozen=True)
class StemInfo:
    """A plan's materializable scan->filter prefix and its identity.

    ``stem``/``scan`` are the ORIGINAL objects inside the plan (substitute
    by identity); ``preds`` are the Filter-chain predicates bottom-to-top
    (excluding the scan's pushed-down ``filters``); ``info`` is the
    PROJECTION-AGNOSTIC family identity — see `compute_stem`."""

    stem: p.LogicalPlan
    scan: p.TableScan
    preds: Tuple[Any, ...]
    info: FamilyInfo


def rewrite_column_indexes(expr, index_of) -> Any:
    """Structural copy of a (frozen-dataclass) expression tree with every
    `ColumnRef.index` replaced by ``index_of(name)``.  Raises ValueError
    for shapes whose identity or remapping is not trustworthy: exprs
    carrying nested plans (their column refs bind elsewhere) and
    `InArrayExpr` (ndarray reprs truncate, so repr is not identity-grade).
    Shared by the stem canonicalizer (``index_of`` = constant -1) and the
    full-width stem builder (``index_of`` = table column position)."""
    from ..planner.expressions import ColumnRef, InArrayExpr

    if isinstance(expr, ColumnRef):
        return dataclasses.replace(expr, index=int(index_of(expr.name)))
    if isinstance(expr, (InArrayExpr, ExistsExpr, InSubqueryExpr,
                         ScalarSubqueryExpr)) or hasattr(expr, "plan"):
        raise ValueError(f"unremappable expression {type(expr).__name__}")

    def value_of(v):
        if isinstance(v, Expr):
            return rewrite_column_indexes(v, index_of)
        if isinstance(v, tuple):
            return tuple(value_of(x) for x in v)
        return v

    if dataclasses.is_dataclass(expr) and isinstance(expr, Expr):
        kw = {f.name: value_of(getattr(expr, f.name))
              for f in dataclasses.fields(expr)}
        return dataclasses.replace(expr, **kw)
    return expr


def compute_stem(plan: p.LogicalPlan) -> Optional[StemInfo]:
    """The plan's materializable scan->filter prefix identity, or None.

    The identity must be PROJECTION-AGNOSTIC: column pruning bakes each
    sibling's projection (and the pruned column indexes) into its
    TableScan, so fingerprinting the literal stem subtree would give
    `SELECT a ...` and `SELECT b ...` over the same WHERE different stems.
    Instead the fingerprint is computed over a canonical form — projection
    and schemas stripped, every ColumnRef keyed by NAME (index -1) — so
    sibling queries sharing the prefix map to one stem fingerprint,
    whatever they project or aggregate above it.  A concrete
    materialization is keyed on ``(fingerprint, key_values)`` since pinned
    rows are literal-specific."""
    stem = stem_of(plan)
    if stem is None:
        return None
    preds: List[Any] = []
    cur = stem
    while isinstance(cur, p.Filter):
        preds.append(cur.predicate)
        cur = cur.input
    assert isinstance(cur, p.TableScan)
    scan = cur
    preds.reverse()
    try:
        nameize = lambda e: rewrite_column_indexes(e, lambda name: -1)
        node: p.LogicalPlan = dataclasses.replace(
            scan, schema=[], projection=None,
            filters=[nameize(f) for f in scan.filters])
        for pred in preds:
            node = p.Filter(node, nameize(pred), [])
    except (ValueError, TypeError):
        return None
    return StemInfo(stem, scan, tuple(preds), compute_family(node))


def full_width_stem(si: StemInfo, table) -> Optional[p.LogicalPlan]:
    """An EXECUTABLE copy of the stem reading every column of ``table``
    (a columnar Table) in registration order — the form a materialization
    pins, so any sibling's projection can be served from the pinned rows.
    Filter column indexes remap from the sibling's pruned scan schema to
    full-table positions by name; None when a referenced column is gone
    or an expression shape cannot be remapped."""
    from ..columnar.dtypes import SqlType
    from ..planner.expressions import Field

    pos = {name: i for i, name in enumerate(table.columns)}
    fields = [
        Field(name, col.sql_type,
              col.validity is not None
              or col.sql_type in (SqlType.FLOAT, SqlType.DOUBLE))
        for name, col in table.columns.items()
    ]
    try:
        remap = lambda e: rewrite_column_indexes(e, pos.__getitem__)
        node: p.LogicalPlan = p.TableScan(
            si.scan.schema_name, si.scan.table_name, fields,
            projection=None, filters=[remap(f) for f in si.scan.filters])
        for pred in si.preds:
            node = p.Filter(node, remap(pred), fields)
    except (KeyError, ValueError, TypeError):
        return None
    return node
