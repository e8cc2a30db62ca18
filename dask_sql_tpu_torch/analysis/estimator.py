"""Static cost and memory abstract interpreter over bound plans.

Counterpart of `dask_sql_tpu/analysis/estimator.py`, a copy on the port's
imports.  The shapes, dtypes and pad buckets of a query are known before
it runs, so a **bottom-up walk** of the bound logical plan propagates, per
node,

- a **cardinality interval** ``[rows_lo, rows_hi]`` seeded from catalog
  ``statistics.row_count`` (exact at registration, versioned into every
  cache key), narrowed by LIMIT / Sample / aggregate-domain clamps and
  widened by joins; filters and joins give a *zero* lower bound, since
  selectivity is unknowable statically;
- a **byte-footprint interval** for the node's output table, from the
  device width of each declared column dtype (``columnar/dtypes.py``;
  strings are int32 dictionary codes): the lower bound uses the exact row
  count and data buffers only, the upper bound the padded power-of-two
  bucket plus a one-byte validity mask per nullable column (a mask exists
  only when nulls occur, so it is never provable).

The whole-plan verdict (`PlanEstimate`) carries:

- ``peak_bytes.lo``, a **provable lower bound** on peak device bytes: the
  referenced base tables are resident and the root result must
  materialize, whatever rung executes;
- ``peak_bytes.hi``, a **conservative upper bound** on the port's peak
  device bytes: the executor keeps every node's output until the query
  completes, so it sums every node's padded output plus its transient
  buffers: sort scratch, and on a node a compiled rung runs the larger of
  the reference's charge (the aggregate's domain-sized packed matrix,
  capped by the shared ``1 << 22`` radix gate, and its gid) and the port's
  fused program at its peak (`fused.py`: decoded columns, expression
  temporaries, masks, gid, the select's survivor bucket).  ``None`` means
  unbounded.  Where a compiled rung runs, ``hi`` is therefore at least the
  reference's, a deliberate divergence (ROADMAP.md Queue 3).  Nothing in
  the port acts on it.

Consumers in the port: ``EXPLAIN ESTIMATE <query>``, and the degradation
ladder: an Aggregate whose compiled intermediate-buffer *lower* bound
cannot fit ``analysis.estimate.device_budget_bytes`` has its compiled
rungs pre-skipped (``_dsql_skip_rungs``, ``analysis.rung_skip.*``).  The
admission byte gate, result-cache admission and partitioned streaming
(streaming/plan.py, on ``scan_bytes_lo``) read the verdict, and the
profile store's feedback (`apply_feedback`) tightens its upper bounds from
a family's observed history, above the fused programs' charge.  A scan
of a sharded table budgets one shard's block as its lower bound (the
``mesh:`` row) and a sharded aggregate charges its exchange buffers, as
in the reference.  A PREDICT node charges the
model's params and the larger of the reference's per-row charge and the
port's eager tree walk at its peak (`inference.predict_scratch_bytes`),
plus, on the fused rung, its input chain's compiled select (`fused.py`),
and renders a ``model:`` row.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..columnar.dtypes import SqlType, sql_to_np
from ..planner import plan as p
from ..planner.expressions import (
    ExistsExpr,
    Expr,
    Field,
    InSubqueryExpr,
    ScalarSubqueryExpr,
    SortKey,
    walk,
)
from ..ops.grouping import RADIX_DOMAIN_LIMIT
from .verifier import _pow2_bucket, _Verifier

logger = logging.getLogger(__name__)

#: compiled rungs a too-big aggregate intermediate buffer dooms (the same
#: pair the radix-domain proof skips — both planners share the packed
#: domain-sized output matrix)
_AGG_RUNGS = frozenset({"compiled_aggregate", "compiled_join_aggregate"})

#: bytes per packed-matrix row slot (outputs ride one f64 matrix,
#: physical/compiled.py pack_flat)
_PACKED_SLOT_BYTES = 8


# ---------------------------------------------------------------------------
# interval lattice
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Interval:
    """Closed integer interval ``[lo, hi]``; ``hi is None`` = unbounded.

    The lattice is the usual interval domain: lo is always a provable
    lower bound, hi a conservative upper bound or None when no finite
    claim can be made.  All arithmetic saturates None."""

    lo: int
    hi: Optional[int]

    @staticmethod
    def exact(n: int) -> "Interval":
        return Interval(int(n), int(n))

    @staticmethod
    def unknown() -> "Interval":
        return Interval(0, None)

    def __add__(self, other: "Interval") -> "Interval":
        hi = None if self.hi is None or other.hi is None \
            else self.hi + other.hi
        return Interval(self.lo + other.lo, hi)

    def __mul__(self, other: "Interval") -> "Interval":
        hi = None if self.hi is None or other.hi is None \
            else self.hi * other.hi
        return Interval(self.lo * other.lo, hi)

    def clamp_hi(self, cap: Optional[int]) -> "Interval":
        """Tighten the upper bound to ``cap`` (lo is clamped along so the
        interval stays well-formed, e.g. LIMIT under a known row count)."""
        if cap is None:
            return self
        hi = cap if self.hi is None else min(self.hi, cap)
        return Interval(min(self.lo, hi), hi)

    def drop_lo(self) -> "Interval":
        """Selectivity unknown: keep the upper bound, lower goes to 0."""
        return Interval(0, self.hi)

    def fmt(self) -> str:
        hi = "unbounded" if self.hi is None else str(self.hi)
        return f"[{self.lo}, {hi}]"


ZERO = Interval(0, 0)


def _dtype_width(t: SqlType) -> int:
    """Device bytes per value for one SQL type (strings are int32 codes;
    the host dictionary is not device memory and is not counted)."""
    try:
        return int(sql_to_np(t).itemsize)
    except Exception:  # dsql: allow-broad-except — an exotic type: the widest
        # claim
        return 8


def _row_bytes(fields: List[Field]) -> Tuple[int, int]:
    """``(lo, hi)`` device bytes per row of a schema.  Data buffers always
    count; the 1-byte validity mask of a nullable column counts only in
    ``hi`` — columnar/column.py materializes a mask only when nulls
    actually occur, so a nullable *declaration* proves nothing and the
    lower bound (which admission sheds on) must not charge it."""
    data = sum(_dtype_width(f.sql_type) for f in fields)
    masks = sum(1 for f in fields if f.nullable)
    return data, data + masks


def _table_bytes(fields: List[Field], rows: Interval) -> Interval:
    """Output-table bytes for ``rows`` of ``fields``: lo = exact rows x
    mask-free width, hi = padded pow2 bucket (the shape the compiled paths
    actually allocate) x mask-inclusive width."""
    lo_row, hi_row = _row_bytes(fields)
    hi = None if rows.hi is None else (_pow2_bucket(rows.hi) or 0) * hi_row
    return Interval(rows.lo * lo_row, hi)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------
@dataclass
class NodeEstimate:
    label: str
    rows: Interval
    out_bytes: Interval
    #: transient device buffers beyond the output (sort scratch, packed
    #: aggregate matrix); lo stays 0 — which buffers exist depends on which
    #: rung runs, so nothing transient is provable
    scratch_hi: Optional[int] = 0


@dataclass
class PlanEstimate:
    """Whole-plan verdict of one estimation walk."""

    rows: Interval              # root cardinality
    result_bytes: Interval      # d2h bytes of the materialized root table
    peak_bytes: Interval        # peak device bytes (see module docstring)
    nodes: List[NodeEstimate]
    #: [(Aggregate node, rungs, intermediate lower bound)] proofs attached
    #: by apply() — compiled rungs whose buffers provably cannot fit
    rung_proofs: List[Tuple[p.LogicalPlan, frozenset, int]]
    #: provable floor of the RESIDENT base-table scans alone (the scan part
    #: of ``peak_bytes.lo``): the streaming partitioner (streaming/plan.py)
    #: divides this by the partition count to derive the per-chunk floor —
    #: the non-scan remainder (materialized root, per-device exchange) does
    #: not shrink with partitioning and must stay whole
    scan_bytes_lo: int = 0
    #: the mesh width backing the estimate: above 1 when a scanned table
    #: is sharded, and the resident-scan LOWER bounds are then per shard
    #: (the admission gate budgets one shard's device), upper bounds stay
    #: global
    devices: int = 1
    #: True when profile feedback tightened the UPPER bounds
    #: (`apply_feedback`): they are then predictions from the family's
    #: observed history, and the lower bounds stay provable
    feedback: bool = False
    #: the transient bytes every node charges (``scratch_hi``, the larger
    #: of the reference's charge and the port's fused program at its peak,
    #: `fused.py`) summed, or None when one is unbounded: the floor
    #: feedback never lowers ``peak_bytes.hi`` below, over ``lo``
    scratch_hi: Optional[int] = 0
    #: one ``model: ...`` line per PREDICT node (inference/): serving tier,
    #: device-resident param bytes, feature width and per-row floor —
    #: rendered by EXPLAIN ESTIMATE so admission decisions over inference
    #: plans are explainable
    model_rows: List[str] = None

    def format_rows(self) -> List[str]:
        rows = [
            "estimate: rows_lo={} rows_hi={} bytes_lo={} bytes_hi={}".format(
                self.rows.lo,
                "unbounded" if self.rows.hi is None else self.rows.hi,
                self.peak_bytes.lo,
                "unbounded" if self.peak_bytes.hi is None
                else self.peak_bytes.hi),
            f"result: bytes={self.result_bytes.fmt()} (d2h transfer)",
        ]
        if self.devices > 1:
            rows.insert(1, f"mesh: devices={self.devices} "
                           "(sharded scans budgeted per device)")
        if self.feedback:
            rows.insert(1, "feedback: upper bounds tightened from observed "
                           "family history (lower bounds stay provable)")
        for n in self.nodes:
            if n.scratch_hi is None:
                # the node whose transients made bytes_hi unbounded must be
                # findable in the listing, not look scratch-free
                scratch = " scratch_hi=unbounded"
            elif n.scratch_hi:
                scratch = f" scratch_hi={n.scratch_hi}"
            else:
                scratch = ""
            rows.append(f"node {n.label}: rows={n.rows.fmt()} "
                        f"bytes={n.out_bytes.fmt()}{scratch}")
        rows.extend(self.model_rows or [])
        for node, rungs, lo in self.rung_proofs:
            rows.append(
                f"proof {node._label()}: compiled intermediate >= {lo} "
                f"bytes cannot fit the device budget; rungs pre-skipped "
                f"({', '.join(sorted(rungs))})")
        return rows


# ---------------------------------------------------------------------------
# the abstract interpreter
# ---------------------------------------------------------------------------
class _Estimator:
    def __init__(self, context=None):
        self.context = context
        # the verifier owns the catalog lookups and the radix-domain proof;
        # reuse them so the two walks can never disagree about metadata
        self._v = _Verifier(context=context, collect_info=False)
        self.nodes: List[NodeEstimate] = []
        self.agg_intermediates: List[Tuple[p.Aggregate, int]] \
            = []  # (node, packed-matrix lower bound)
        self._memo: Dict[int, Tuple[Interval, Interval]] = {}
        self._scan_lo: Dict[Tuple[str, str], int] = {}
        #: id(TableScan) -> exact resident bytes when the scanned table is
        #: registered with compressed encodings (columnar/encodings.py)
        self._scan_actual: Dict[int, int] = {}
        self.model_rows: List[str] = []
        #: mesh width: the most shards any scanned sharded table spans
        self.devices: int = 1

    # ------------------------------------------------------------- walking
    def estimate(self, node: p.LogicalPlan) -> Tuple[Interval, Interval]:
        """(rows, out_bytes) of one node; memoized so shared CTE subtrees
        are counted once (matching the executor's own memoization)."""
        key = id(node)
        if key in self._memo:
            return self._memo[key]
        rows, out_bytes, scratch_hi = self._node(node)
        self._memo[key] = (rows, out_bytes)
        self.nodes.append(NodeEstimate(_short_label(node), rows, out_bytes,
                                       scratch_hi))
        return rows, out_bytes

    def _node(self, node: p.LogicalPlan
              ) -> Tuple[Interval, Interval, Optional[int]]:
        child = [self.estimate(c) for c in node.inputs()]
        for sub in _nested_plans(node):
            # subquery plans execute too: their outputs join the footprint
            self.estimate(sub)
        rows = self._rows(node, [r for r, _ in child])
        actual = self._scan_actual.get(id(node))
        if actual is not None:
            # a registered table with compressed encodings: the scan's
            # output IS the stored buffers, whose bytes are exact — both
            # bounds tighten to the encoded widths, which is how encodings
            # shrink peak_bytes.hi and admit bigger working sets
            out_bytes = Interval(actual, actual)
        else:
            out_bytes = _table_bytes(list(node.schema), rows)
        scratch_hi: Optional[int] = 0
        if isinstance(node, p.Aggregate):
            scratch_hi = self._aggregate_scratch(node, child)
            fused = self._fused_aggregate_scratch(node)
            if fused is not None and scratch_hi is not None:
                scratch_hi = max(scratch_hi, fused)
        elif isinstance(node, p.PredictModelNode):
            scratch_hi = self._predict_scratch(node, rows)
        elif isinstance(node, (p.Sort, p.Distinct, p.Window)):
            # sort-based paths keep permutation indices + a key copy: bound
            # by 2x the input's padded bytes
            in_hi = child[0][1].hi if child else 0
            scratch_hi = None if in_hi is None else 2 * in_hi
        return rows, out_bytes, scratch_hi

    # ---------------------------------------------------------- cardinality
    def _rows(self, node: p.LogicalPlan,
              child_rows: List[Interval]) -> Interval:
        if isinstance(node, p.TableScan):
            n = self._v._table_rows(node.schema_name, node.table_name)
            if n is None:
                return Interval.unknown()
            # the base table is resident at its FULL row count whatever
            # the scan's pushed filters keep — its projected columns are a
            # provable part of peak device bytes.  When the stored table
            # carries compressed encodings, its ACTUAL (encoded) bytes are
            # both the provable floor and the exact output size.
            key = (node.schema_name, node.table_name)
            actual = self._scan_actual_bytes(node)
            if actual is not None:
                self._scan_actual[id(node)] = actual
                scan_lo = actual
            else:
                scan_lo = int(n) * _row_bytes(list(node.schema))[0]
            ndev = self._scan_mesh_devices(node)
            if ndev > 1:
                # a sharded table: each shard holds its block of the scan,
                # so the per-shard provable floor (what admission sheds on)
                # divides; upper bounds stay global (conservative)
                scan_lo = -(-scan_lo // ndev)
                self.devices = max(self.devices, ndev)
            self._scan_lo[key] = max(self._scan_lo.get(key, 0), scan_lo)
            rows = Interval.exact(int(n))
            if node.filters:
                rows = rows.drop_lo()  # pushed-down filters: selectivity 0..1
            return rows
        if isinstance(node, p.Filter):
            return child_rows[0].drop_lo()
        if isinstance(node, p.Projection):
            return child_rows[0]
        if isinstance(node, p.Join):
            l, r = child_rows
            jt = node.join_type.upper()
            if jt in ("LEFTSEMI", "LEFTANTI"):
                return Interval(0, l.hi)
            if jt == "LEFTMARK":
                return l  # left rows + an appended BOOLEAN flag
            unknown = l.hi is None or r.hi is None
            if jt == "LEFT":
                # every left row survives even against an empty right side
                hi = None if unknown else l.hi * max(r.hi, 1)
                return Interval(l.lo, hi)
            if jt == "RIGHT":
                hi = None if unknown else r.hi * max(l.hi, 1)
                return Interval(r.lo, hi)
            if jt == "FULL":
                # matched pairs + unmatched left rows + unmatched right rows
                hi = None if unknown else l.hi * max(r.hi, 1) + r.hi
                return Interval(max(l.lo, r.lo), hi)
            hi = None if unknown else l.hi * r.hi
            return Interval(0, hi)  # INNER: can be empty
        if isinstance(node, p.CrossJoin):
            return child_rows[0] * child_rows[1]
        if isinstance(node, p.Aggregate):
            if not node.group_exprs:
                return Interval.exact(1)
            inp = child_rows[0]
            lo = 1 if inp.lo > 0 else 0
            domain, all_known = self._v._radix_domain(node)
            hi = inp.hi
            if all_known and domain is not None:
                hi = domain if hi is None else min(hi, domain)
            return Interval(lo, hi)
        if isinstance(node, p.Window):
            return child_rows[0]
        if isinstance(node, p.Sort):
            rows = child_rows[0]
            return rows.clamp_hi(node.fetch) if node.fetch is not None \
                else rows
        if isinstance(node, p.Limit):
            rows = child_rows[0].clamp_hi(node.fetch)
            return rows.drop_lo() if node.skip else rows
        if isinstance(node, p.Distinct):
            rows = child_rows[0]
            return Interval(min(rows.lo, 1), rows.hi)
        if isinstance(node, p.Sample):
            return child_rows[0].drop_lo()
        if isinstance(node, p.Union):
            total = ZERO
            for r in child_rows:
                total = total + r
            if not getattr(node, "all", True):
                total = Interval(min(total.lo, 1), total.hi)  # dedup
            return total
        if isinstance(node, (p.Intersect, p.Except)):
            return Interval(0, child_rows[0].hi)
        if isinstance(node, p.Values):
            return Interval.exact(len(node.rows))
        if isinstance(node, p.EmptyRelation):
            return Interval.exact(1 if node.produce_one_row else 0)
        if isinstance(node, p.Explain):
            # plain EXPLAIN/LINT/ESTIMATE renders text, never executes its
            # input; EXPLAIN ANALYZE executes, so it inherits the input walk
            # (already folded in through child_rows' side effects)
            return Interval(1, None)
        if isinstance(node, (p.SubqueryAlias, p.DistributeBy)):
            return child_rows[0]
        if isinstance(node, p.PredictModelNode):
            # PREDICT appends one column per input row — cardinality is the
            # input's, so inference plans get FINITE bounds and admission /
            # packing / streaming see them like any other operator
            return child_rows[0] if child_rows else Interval.unknown()
        if isinstance(node, p.CustomNode):
            return Interval(0, None)
        return child_rows[0] if child_rows else Interval.unknown()

    def _scan_actual_bytes(self, node: p.TableScan) -> Optional[int]:
        """Exact resident bytes of the scan's projected columns when the
        registered table carries compressed encodings; None keeps the
        declared-width formula (byte-identical estimates for PLAIN tables).
        Encoded widths are what the compiled paths actually read, so both
        peak bounds tighten — the admission gate sheds less and the
        device-budget rung proofs skip fewer rungs."""
        from ..columnar.encodings import encoded_nbytes, resolve_encoded_scan

        got = resolve_encoded_scan(self.context, node)
        if got is None:
            return None
        table, names = got
        return sum(encoded_nbytes(table.columns[n]) for n in names)

    # --------------------------------------------------------- intermediates
    def _aggregate_scratch(self, node: p.Aggregate,
                           child) -> Optional[int]:
        """The reference's worst-case transient bytes of the aggregate
        (`_fused_aggregate_scratch` adds the port's fused program), and
        (side effect) the compiled packed-matrix *lower* bound for the rung
        proof.

        The compiled rungs allocate one f64 matrix of
        ``(len(agg_exprs) + 1) x domain`` (physical/compiled.py pack_flat;
        row 0 is the group-present indicator) plus an int32 gid per input
        row.  The radix-domain lower bound (dictionary sizes + BOOLEAN=3,
        unknown keys contribute factor 1) makes the matrix bound provable;
        the gate caps the domain at ``1 << 22``, which caps the upper
        bound even when the true domain is unknown."""
        domain, all_known = self._v._radix_domain(node)
        slots = len(node.agg_exprs) + 1
        cap_hi = RADIX_DOMAIN_LIMIT * slots * _PACKED_SLOT_BYTES
        if domain is not None and all_known:
            # every key sized (a global aggregate's domain is exactly 1):
            # the gate cap tightens to the true matrix size
            cap_hi = min(domain, RADIX_DOMAIN_LIMIT) * slots \
                * _PACKED_SLOT_BYTES
        if domain is not None and node.group_exprs:
            matrix_lo = domain * slots * _PACKED_SLOT_BYTES
            self.agg_intermediates.append((node, matrix_lo))
        in_rows_hi = child[0][0].hi if child else 0
        gid_hi = None if in_rows_hi is None \
            else (_pow2_bucket(in_rows_hi) or 0) * 4
        if gid_hi is None:
            return None
        return cap_hi + gid_hi + self._exchange_scratch(node, domain,
                                                        all_known)

    def _scan_mesh_devices(self, node: p.TableScan) -> int:
        """The width of the mesh the scanned table is sharded over, or 1
        (one device, lazy, unknown): the rule the rungs share
        (`spmd.core.resolve_sharded_scan`)."""
        from ..spmd.core import resolve_sharded_scan

        got = resolve_sharded_scan(self.context, node)
        return int(got[1].size) if got is not None else 1

    def _exchange_scratch(self, node: p.Aggregate, domain, all_known) -> int:
        """A shard's exchange bytes on the sharded aggregation paths: the
        send and receive blocks of the six-state layout, sized at the
        capacity-ladder rung the group domain lands on
        (`parallel/dist_plan.py`'s GROUP and PEER ladders).  Zero on a
        one-device plan and for an aggregate whose own input is unsharded,
        so their estimates are unchanged."""
        ndev = self.devices
        if ndev <= 1:
            return 0
        from ..parallel.dist_plan import (
            GROUP_CAPACITY_LADDER,
            N_FSTATE,
            N_ISTATE,
            PEER_CAPACITY_LADDER,
            _ladder_at_least,
            plan_has_sharded_scan,
        )

        inputs = node.inputs()
        if self.context is None or not inputs or \
                not plan_has_sharded_scan(inputs[0], self.context):
            return 0
        need = domain if (domain is not None and all_known) \
            else RADIX_DOMAIN_LIMIT
        cap = _ladder_at_least(GROUP_CAPACITY_LADDER,
                               min(need, RADIX_DOMAIN_LIMIT))
        cpeer = _ladder_at_least(PEER_CAPACITY_LADDER,
                                 min(2 * cap // ndev + 256, cap))
        nk = max(len(node.group_exprs), 1)
        nv = max(len(node.agg_exprs), 1)
        width = (nk + nv * (N_ISTATE + N_FSTATE) + 1) * 8
        return 2 * ndev * cpeer * width

    def _compiles(self, key: str) -> bool:
        config = getattr(self.context, "config", None)
        return config is None or bool(config.get(key, True))

    def _fused_aggregate_scratch(self, node: p.Aggregate) -> Optional[int]:
        """The port's fused aggregate at its peak (`fused.py`): the scan
        chain's `compiled_aggregate` or the join chain's
        `compiled_join_aggregate`, when the config lets it run; None when
        neither takes the node."""
        from . import fused

        if not self._compiles("sql.compile"):
            return None
        domain, all_known = self._v._radix_domain(node)
        domain = domain if all_known else None
        from ..physical.compiled import _extract_chain

        chain = _extract_chain(node)
        if chain is not None:
            scan = chain[0]
            return fused.aggregate_scratch(
                node, self._v._table_rows(scan.schema_name, scan.table_name),
                domain, self.context)
        if not self._compiles("sql.compile.join_pipeline"):
            return None
        from ..physical.compiled_join import _extract

        got = _extract(node)
        if got is None:
            return None
        ext = got[0]
        build_rows = [self._memo[id(j["plan"])][0].hi
                      if id(j["plan"]) in self._memo else None
                      for j in ext.joins]
        return fused.join_aggregate_scratch(
            node, self._v._table_rows(ext.scan.schema_name,
                                      ext.scan.table_name),
            build_rows, domain, self.context)

    def _predict_scratch(self, node: p.PredictModelNode,
                         rows: Interval) -> Optional[int]:
        """Transient device bytes of one PREDICT node, and (side effect)
        the ``model:`` EXPLAIN ESTIMATE row.

        The fused rung (physical/compiled_predict.py) materializes the
        feature matrix and, for tree programs, (rows, trees)-shaped
        navigation buffers over the survivor bucket, inside its input
        chain's compiled select; the host tier materializes the feature
        matrix host-side but the estimate charges it identically
        (conservative).  Model params feed the UPPER bound only: they are
        device-resident only IF the fused rung serves this plan, which
        per-plan eligibility (lazy or view scans, nullable or string
        features) can deny — so charging them to the provable floor could
        shed a host-served plan.  Actual committed bytes are the ledger's
        job (``serving.ledger.model_bytes``)."""
        program = None
        param_bytes = 0
        tier = "host"
        label = "?"
        n_features = max(len(node.schema) - 1, 1)
        # the fused rung is what makes params device-resident: with it
        # disabled every PREDICT serves host-side
        fused_on = self._compiles("sql.compile.predict") \
            and self._compiles("sql.compile")
        try:
            ctx = self.context
            if ctx is not None:
                schema_name, name = ctx._table_schema_name(node.model_name)
                label = name
                model, cols = ctx.get_model(schema_name, name)
                n_features = max(len(cols), 1)
                from ..inference import program_for

                program, _reason = program_for(ctx, schema_name, name,
                                               model)
                if program is not None and fused_on:
                    param_bytes = program.param_bytes
                    tier = "compiled"
        except Exception:  # dsql: allow-broad-except — estimation is
            # advisory; an unresolvable model keeps the host-tier claim
            logger.debug("predict estimate model lookup failed",
                         exc_info=True)
        from ..inference import predict_scratch_bytes

        per_row = predict_scratch_bytes(program, n_features)
        self.model_rows.append(
            f"model: name={label} tier={tier} param_bytes={param_bytes} "
            f"features={n_features} row_floor={per_row}")
        if rows.hi is None:
            return None
        scratch = param_bytes + (_pow2_bucket(rows.hi) or 0) * per_row
        if tier == "compiled":
            # the input chain's two programs run on the fused rung too
            from . import fused
            from ..physical.compiled_select import _extract

            got = _extract(node.input)
            if got is not None:
                chain = fused.select_scratch(
                    node.input, self._v._table_rows(got[0].schema_name,
                                                    got[0].table_name),
                    self.context)
                if chain is None:
                    return None
                scratch += chain
        return scratch

    def fused_select_scratch(self, root: p.LogicalPlan) -> Optional[int]:
        """The port's compiled root select at its peak (`fused.py`), when
        the config lets it run; None when the root is no such chain."""
        from . import fused
        from ..physical.compiled_select import _extract

        if not (self._compiles("sql.compile")
                and self._compiles("sql.compile.select")):
            return None
        got = _extract(root)
        if got is None:
            return None
        scan = got[0]
        return fused.select_scratch(
            root, self._v._table_rows(scan.schema_name, scan.table_name),
            self.context)

    # -------------------------------------------------------------- verdict
    def finish(self, root: p.LogicalPlan, root_rows: Interval,
               root_bytes: Interval) -> PlanEstimate:
        # provable lower bound: resident base tables + the materialized
        # root result (compiled fusion may never materialize anything else,
        # and a column-aliasing root shares the scan's buffers outright)
        peak_lo = sum(self._scan_lo.values())
        if not _aliases_scan(root):
            peak_lo += root_bytes.lo
        # the reference's model bound (module docstring): the executor
        # memoizes every node output until the query completes, plus the
        # reference's transient buffers
        peak_hi: Optional[int] = 0
        for n in self.nodes:
            if peak_hi is None:
                break
            if n.out_bytes.hi is None or n.scratch_hi is None:
                peak_hi = None
            else:
                peak_hi += n.out_bytes.hi + n.scratch_hi
        if peak_hi is not None:
            peak_hi = max(peak_hi, peak_lo)
        scratch: Optional[int] = 0
        for n in self.nodes:
            scratch = None if n.scratch_hi is None or scratch is None \
                else scratch + n.scratch_hi
        return PlanEstimate(
            rows=root_rows,
            result_bytes=root_bytes,
            peak_bytes=Interval(peak_lo, peak_hi),
            nodes=list(reversed(self.nodes)),  # root first for display
            rung_proofs=[],
            scan_bytes_lo=sum(self._scan_lo.values()),
            scratch_hi=scratch,
            model_rows=list(self.model_rows),
            devices=self.devices,
        )


def _aliases_scan(node: p.LogicalPlan) -> bool:
    """True when the node's output provably *can* share a base table's
    device buffers (identity projections / aliases over a scan): its
    materialization must then not be double-counted on top of the resident
    table in the peak lower bound."""
    from ..planner.expressions import ColumnRef

    while True:
        if isinstance(node, p.TableScan):
            return True
        if isinstance(node, p.SubqueryAlias):
            node = node.input
            continue
        if isinstance(node, p.Projection) and all(
                isinstance(e, ColumnRef) for e in node.exprs):
            node = node.input
            continue
        return False


def _short_label(node: p.LogicalPlan) -> str:
    label = node._label()
    return label if len(label) <= 64 else label[:61] + "..."


def _nested_plans(node: p.LogicalPlan) -> List[p.LogicalPlan]:
    """Subquery plans hanging off one node's expressions (they execute as
    part of this node, so their footprint belongs to the estimate)."""
    import dataclasses

    out: List[p.LogicalPlan] = []
    if not dataclasses.is_dataclass(node):
        return out

    def exprs_of(v):
        if isinstance(v, Expr):
            yield v
        elif isinstance(v, SortKey):
            yield v.expr
        elif isinstance(v, (list, tuple)):
            for item in v:
                yield from exprs_of(item)

    for f in dataclasses.fields(node):
        for e in exprs_of(getattr(node, f.name, None)):
            for x in walk(e):
                if isinstance(x, (ScalarSubqueryExpr, InSubqueryExpr,
                                  ExistsExpr)) and x.plan is not None:
                    out.append(x.plan)
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def estimate_plan(plan: p.LogicalPlan, context=None) -> PlanEstimate:
    """Walk a bound plan bottom-up and return its `PlanEstimate`."""
    target = plan
    if isinstance(target, p.Explain):
        # estimate what EXPLAIN reports on (and, for EXPLAIN ANALYZE, what
        # actually executes) — never the text render, whose trivial output
        # would otherwise force every bound to unbounded
        target = target.input
    est = _Estimator(context=context)
    rows, out_bytes = est.estimate(target)
    if target is plan:
        # a plan root runs the compiled select first (executor.execute_root;
        # EXPLAIN ANALYZE walks its input without it)
        fused = est.fused_select_scratch(target)
        root = est.nodes[-1]
        if fused is not None and root.scratch_hi is not None:
            root.scratch_hi = max(root.scratch_hi, fused)
    verdict = est.finish(target, rows, out_bytes)
    verdict._agg_intermediates = est.agg_intermediates  # for apply()
    return verdict


def device_budget_bytes(config) -> Optional[int]:
    """The device byte budget the rung proofs compare against:
    ``analysis.estimate.device_budget_bytes`` when set, else None (no
    proof — admission uses its own ``serving.admission`` budget)."""
    from ..config import parse_byte_budget

    return parse_byte_budget(config.get("analysis.estimate.device_budget_bytes"))


def collect_rung_proofs(verdict: PlanEstimate, budget: Optional[int]
                        ) -> List[Tuple[p.LogicalPlan, frozenset, int]]:
    """``[(Aggregate node, doomed rungs, intermediate lower bound)]`` for
    compiled intermediates whose lower bound provably cannot fit ``budget``
    (None = no budget, no proofs).  Pure — callers decide whether to act
    (`estimate_and_apply` marks the nodes; EXPLAIN ESTIMATE only reports)."""
    if budget is None:
        return []
    return [(node, _AGG_RUNGS, matrix_lo)
            for node, matrix_lo in getattr(verdict, "_agg_intermediates", [])
            if matrix_lo > budget]


def _tighten(iv: Interval, pred_hi: int) -> Interval:
    """One feedback-tightened interval: the upper bound drops to the
    prediction but never below the lower bound, which is untouched."""
    hi = pred_hi if iv.hi is None else min(iv.hi, pred_hi)
    return Interval(iv.lo, max(iv.lo, hi))


def apply_feedback(verdict: PlanEstimate, profile: Optional[dict],
                   config, metrics=None) -> PlanEstimate:
    """Profile-feedback priors (``analysis.estimate.feedback``), the
    reference's: with at least ``feedback.min_obs`` observed executions,
    ``rows.hi`` and ``result_bytes.hi`` drop to ``margin x`` the largest
    observed rows and result bytes, and ``peak_bytes.hi`` drops to the
    provable floor plus ``margin x`` the observed result bytes.  Lower
    bounds are copied untouched, and an upper bound never drops below its
    lower bound, so the admission gate and the rung proofs (both on
    ``lo``) are unaffected.  Returns a new estimate; the family's memoized
    one stays as it was.

    Divergence from the reference (ROADMAP.md Queue 3): the port's
    ``peak_bytes.hi`` bounds the card, the resident tables plus each
    node's transients (`fused.py`), so feedback applies only above that
    charge: the prediction is ``lo + scratch_hi + margin x`` the observed
    result bytes, and with an unbounded scratch ``hi`` is kept."""
    if profile is None or not config.get("analysis.estimate.feedback", True):
        return verdict
    min_obs = max(1, int(config.get("analysis.estimate.feedback.min_obs", 2)))
    margin = max(1.0, float(
        config.get("analysis.estimate.feedback.margin", 2.0)))
    obs_rows = profile.get("rows") or []
    obs_bytes = profile.get("result_bytes") or []
    rows = verdict.rows
    result_bytes = verdict.result_bytes
    peak = verdict.peak_bytes
    changed = False
    if len(obs_rows) >= min_obs:
        tightened = _tighten(rows, int(margin * max(obs_rows)))
        changed = changed or tightened != rows
        rows = tightened
    if len(obs_bytes) >= min_obs:
        pred_result = int(margin * max(obs_bytes))
        tightened = _tighten(result_bytes, pred_result)
        changed = changed or tightened != result_bytes
        result_bytes = tightened
        if verdict.scratch_hi is not None:
            tightened = _tighten(
                peak, peak.lo + verdict.scratch_hi + pred_result)
            changed = changed or tightened != peak
            peak = tightened
    if not changed:
        return verdict
    if metrics is not None:
        metrics.inc("analysis.estimate.feedback")
    import dataclasses

    out = dataclasses.replace(verdict, rows=rows, result_bytes=result_bytes,
                              peak_bytes=peak, feedback=True)
    agg = getattr(verdict, "_agg_intermediates", None)
    if agg is not None:
        out._agg_intermediates = agg
    return out


def estimate_and_apply(plan: p.LogicalPlan, context) -> PlanEstimate:
    """Bind-time entry (Context._get_ral): estimate, record the
    ``analysis.estimate.*`` metrics, attach the verdict to the plan
    (``_dsql_estimate``) for the admission gate and result cache, and
    pre-skip compiled aggregate rungs whose intermediate-buffer lower
    bound provably cannot fit the device budget (``_dsql_skip_rungs`` —
    the ladder records ``analysis.rung_skip.*`` with no breaker charge)."""
    verdict = estimate_plan(plan, context=context)
    metrics = getattr(context, "metrics", None)
    if metrics is not None:
        metrics.inc("analysis.estimate.runs")
        metrics.observe("analysis.estimate.bytes_lo", verdict.peak_bytes.lo)
        if verdict.peak_bytes.hi is not None:
            metrics.observe("analysis.estimate.bytes_hi",
                            verdict.peak_bytes.hi)
        if verdict.rows.hi is not None:
            metrics.observe("analysis.estimate.rows_hi", verdict.rows.hi)
    for node, rungs, matrix_lo in collect_rung_proofs(
            verdict, device_budget_bytes(context.config)):
        existing = getattr(node, "_dsql_skip_rungs", frozenset())
        node._dsql_skip_rungs = frozenset(existing) | rungs
        verdict.rung_proofs.append((node, rungs, matrix_lo))
        if metrics is not None:
            metrics.inc("analysis.estimate.rung_proof")
    plan._dsql_estimate = verdict
    return verdict


# ---------------------------------------------------------------------------
# provable predicate-interval algebra (semantic reuse / subsumption)
# ---------------------------------------------------------------------------
#: comparator ops a single ParamRef predicate maps onto a value interval.
#: ``eq`` included: an equality slot subsumes only the identical value.
COMPARATOR_OPS = frozenset({"lt", "le", "gt", "ge", "eq"})

#: mirror op when the comparison is written ``literal OP column`` —
#: normalizing to column-on-the-left so one interval table covers both
MIRRORED_OPS = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


@dataclass(frozen=True)
class PredInterval:
    """The value set ``{x : x OP v}`` of one comparator predicate as an
    interval over the column domain.  ``None`` bound = unbounded on that
    side; ``*_open`` marks a strict (exclusive) endpoint.  This is the
    *predicate* lattice the subsumption check reasons in — distinct from
    the cardinality/byte `Interval` above, which is always closed."""

    lo: Optional[float]
    hi: Optional[float]
    lo_open: bool = False
    hi_open: bool = False


def pred_interval(op: str, value) -> Optional[PredInterval]:
    """The interval of column values ``column OP value`` selects, or None
    when ``op`` is not a plain comparator (the slot then declines
    subsumption entirely)."""
    if op not in COMPARATOR_OPS:
        return None
    # keep the native scalar: Python's int/float comparisons are exact
    # (coercing int64 through float would lose precision past 2**53)
    v = int(value) if isinstance(value, bool) else value
    if op == "lt":
        return PredInterval(None, v, hi_open=True)
    if op == "le":
        return PredInterval(None, v)
    if op == "gt":
        return PredInterval(v, None, lo_open=True)
    if op == "ge":
        return PredInterval(v, None)
    return PredInterval(v, v)  # eq


def _bound_contains(outer_v, outer_open: bool, inner_v, inner_open: bool,
                    side: str, float_domain: bool) -> bool:
    """Does the outer interval's ``side`` bound admit the inner's?  PROOF
    ONLY: returns False whenever the decision rests on exact endpoint
    equality in a float domain — host-side equality of the two parameter
    values does not prove the device-cast (e.g. float64 -> float32 column
    dtype) boundary semantics coincide, so equal float endpoints decline
    rather than guess."""
    if outer_v is None:
        return True      # outer unbounded on this side: anything fits
    if inner_v is None:
        return False     # inner unbounded where outer is not
    if side == "lo":
        if outer_v < inner_v:
            return True
        if outer_v > inner_v:
            return False
    else:
        if outer_v > inner_v:
            return True
        if outer_v < inner_v:
            return False
    # endpoints exactly equal on the host: the decision IS the boundary
    if float_domain:
        return False
    return (not outer_open) or inner_open


def interval_contains(outer: PredInterval, inner: PredInterval,
                      float_domain: bool = False) -> bool:
    """PROVABLE containment ``inner ⊆ outer`` — the subsumption oracle.
    True only when every row the inner predicate selects is provably a row
    the outer predicate selected; never heuristic.  ``float_domain`` marks
    a float column or parameter dtype: any containment that would be
    decided by endpoint *equality* then declines (see `_bound_contains`)."""
    return (_bound_contains(outer.lo, outer.lo_open, inner.lo,
                            inner.lo_open, "lo", float_domain)
            and _bound_contains(outer.hi, outer.hi_open, inner.hi,
                                inner.hi_open, "hi", float_domain))


def param_slot_contains(op: str, cached_value, new_value,
                        float_domain: bool = False) -> bool:
    """One family parameter slot's containment verdict: does the cached
    execution's ``column OP cached_value`` provably cover the incoming
    ``column OP new_value``?  Both predicates share the op (same family),
    so this reduces to interval containment of the two value sets."""
    outer = pred_interval(op, cached_value)
    inner = pred_interval(op, new_value)
    if outer is None or inner is None:
        return False
    return interval_contains(outer, inner, float_domain=float_domain)
