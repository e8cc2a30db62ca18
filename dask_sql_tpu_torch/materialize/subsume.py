"""Subsumption answering: serve a tighter query by re-filtering a cached
result — when containment is PROVABLE, never heuristically.

Copied from `dask_sql_tpu/materialize/subsume.py`; the analysis and the
containment verdict are the reference's, and `serve` re-filters on the
result's own device: the new value is put into the column's stored
representation (dates and timestamps as int64 ns, integers and the
float32 and float64 domains in the dtype numpy promotes the column and
the parameter to, as the reference's compare does), then one compare per
``cmp`` slot and one gather (`Table.filter`) where the cached rows lie.
A card Context serves only rows on the card (`servable_on`).

A family (families/parameterize.py) fixes everything about a query except
its parameter values, so when ``price < 100`` has a cached result and
``price < 50`` arrives, the only semantic difference between the two is
one interval endpoint.  If every parameter slot's new predicate provably
selects a subset of the cached predicate's rows (the interval algebra in
analysis/estimator.py: `param_slot_contains`), the answer is the cached
result re-filtered by the new predicates — no scan, no compile, no
executor walk.

The analysis half (`analyze`) runs once per distinct SQL text (memoized on
the cached plan object): it re-derives the literal-stripped family plan —
the Parameterizer's traversal is deterministic, so slot numbering matches
`FamilyInfo.key_values` exactly — and classifies each parameter slot:

- ``cmp``: the slot is the comparison value of a top-level AND conjunct
  ``column OP ?slot`` (OP in lt/le/gt/ge/eq) over a NON-nullable column
  whose value survives to the result (bare-ColumnRef projection lineage).
  Serving re-applies the conjunct with the NEW value on the result column;
  admissibility is interval containment of new-vs-cached values.
- ``exact``: any other slot position (nullable column, no lineage into the
  result, non-comparator conjunct).  Admissible only when the cached and
  new values are equal — the two predicates are then literally identical,
  so no re-filtering is needed for that slot.

Anything outside the supported plan shape — TableScan / Filter chains /
one bare-ColumnRef Projection / SubqueryAlias wrappers — declines
entirely: aggregates and sorts are not row-subset-stable, joins and
limits change row multiplicity.  NULL-able filter columns and float
boundary equality decline inside the algebra (three-valued logic and
device-cast boundary semantics are not provable from host values).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..analysis.estimator import COMPARATOR_OPS, MIRRORED_OPS, \
    param_slot_contains
from ..columnar.column import numpy_dtype, torch_dtype
from ..columnar.dtypes import sql_to_np
from ..columnar.encodings import Encoding
from ..columnar.table import Table
from ..families.parameterize import Parameterizer
from ..planner import plan as p
from ..planner.expressions import ColumnRef, ParamRef, ScalarFunc, walk

logger = logging.getLogger(__name__)

#: memoization attribute on the plan object (plans are cached per SQL
#: text, so the family-level analysis is stable for the plan's lifetime)
_ATTR = "_dsql_subsume_spec"

#: sentinel distinguishing "analyzed: ineligible" from "not yet analyzed"
_INELIGIBLE = "ineligible"


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """One parameter slot's serving classification (see module doc)."""

    index: int
    kind: str                  # "cmp" | "exact"
    op: str = ""               # comparator, column-on-the-left (cmp only)
    result_pos: int = -1       # column position in the result table (cmp)
    float_domain: bool = False
    np_dtype: str = ""         # parameter device dtype (cmp only)


@dataclasses.dataclass(frozen=True)
class SubsumeSpec:
    slots: Tuple[SlotSpec, ...]


def _conjuncts(expr) -> List:
    """Flatten a top-level AND tree into its conjunct list."""
    if isinstance(expr, ScalarFunc) and expr.op == "and":
        out: List = []
        for a in expr.args:
            out.extend(_conjuncts(a))
        return out
    return [expr]


def _param_indices(expr) -> List[int]:
    return [e.index for e in walk(expr) if isinstance(e, ParamRef)]


def _comparator_slot(conj) -> Optional[Tuple[str, ColumnRef, ParamRef]]:
    """``(op, column, param)`` normalized column-on-the-left, or None when
    the conjunct is not a plain single-param comparison."""
    if not (isinstance(conj, ScalarFunc) and conj.op in COMPARATOR_OPS
            and len(conj.args) == 2):
        return None
    a, b = conj.args
    if type(a) is ColumnRef and isinstance(b, ParamRef):
        return conj.op, a, b
    if isinstance(a, ParamRef) and type(b) is ColumnRef:
        return MIRRORED_OPS[conj.op], b, a
    return None


def analyze(plan: p.LogicalPlan, family) -> Optional[SubsumeSpec]:
    """The plan's subsumption spec, or None when ineligible.  Memoized on
    the plan object; `family` is its `FamilyInfo` (slot count oracle)."""
    spec = getattr(plan, _ATTR, None)
    if spec is not None:
        return None if spec is _INELIGIBLE else spec
    spec = _analyze(plan, family)
    try:
        setattr(plan, _ATTR, spec if spec is not None else _INELIGIBLE)
    except AttributeError:  # exotic node without a writable __dict__
        pass
    return spec


def _analyze(plan: p.LogicalPlan, family) -> Optional[SubsumeSpec]:
    if family is None or family.n_params == 0:
        return None
    # deterministic re-parameterization: slot numbering matches
    # family.key_values (same traversal that produced the fingerprint)
    pz = Parameterizer(enabled=True, recurse_subplans=True)
    fam_plan = pz.rewrite_plan(plan)
    if len(pz.values) != family.n_params:
        return None

    # ---- supported shape: Alias* -> [Projection] -> Filter* -> TableScan
    node = fam_plan
    while isinstance(node, p.SubqueryAlias):
        node = node.input
    proj: Optional[p.Projection] = None
    if isinstance(node, p.Projection):
        if not all(type(e) is ColumnRef for e in node.exprs):
            return None  # computed outputs: no row-value lineage
        proj = node
        node = node.input
    filters: List = []
    while isinstance(node, p.Filter):
        filters.append(node.predicate)
        node = node.input
    if not isinstance(node, p.TableScan):
        return None  # aggregates / sorts / joins are not subset-stable
    scan = node
    filters.extend(scan.filters)

    # ---- classify every parameter slot ---------------------------------
    slots: List[SlotSpec] = []
    seen: set = set()
    for conj in [c for f in filters for c in _conjuncts(f)]:
        idxs = _param_indices(conj)
        if not idxs:
            continue  # literal-free conjunct: identical across the family
        cmp = _comparator_slot(conj) if len(idxs) == 1 else None
        if cmp is None:
            for i in idxs:
                slots.append(SlotSpec(i, "exact"))
                seen.add(i)
            continue
        op, col, param = cmp
        field = scan.schema[col.index]
        pos = col.index
        if proj is not None:
            pos = next((j for j, e in enumerate(proj.exprs)
                        if e.index == col.index), -1)
        col_dtype = sql_to_np(field.sql_type)
        par_dtype = sql_to_np(param.sql_type)
        if field.nullable or col.nullable or pos < 0:
            # NULL-able column (three-valued logic is not re-provable from
            # the result rows alone) or the filter column was projected
            # away: the slot degrades to exact-value matching
            slots.append(SlotSpec(param.index, "exact"))
        else:
            slots.append(SlotSpec(
                param.index, "cmp", op=op, result_pos=pos,
                float_domain=(col_dtype.kind == "f"
                              or par_dtype.kind == "f"),
                np_dtype=str(par_dtype)))
        seen.add(param.index)
    if seen != set(range(family.n_params)):
        # a slot lives outside the filter conjuncts (nested subquery plan,
        # unsupported position): no provable claim about it — decline
        return None
    return SubsumeSpec(tuple(sorted(slots, key=lambda s: s.index)))


def contains(spec: SubsumeSpec, cached_values: Tuple, new_values: Tuple
             ) -> bool:
    """PROVABLE verdict: does the cached execution's parameter vector cover
    the new one?  Per-slot interval containment for ``cmp`` slots, exact
    equality for ``exact`` slots; any doubt is False."""
    if len(cached_values) != len(spec.slots) \
            or len(new_values) != len(spec.slots):
        return False
    for slot in spec.slots:
        cv, nv = cached_values[slot.index], new_values[slot.index]
        if slot.kind == "exact":
            if not (type(cv) is type(nv) and cv == nv):
                return False
        elif not param_slot_contains(slot.op, cv, nv,
                                     float_domain=slot.float_domain):
            return False
    return True


_OP_FNS = {
    "lt": lambda d, v: d < v,
    "le": lambda d, v: d <= v,
    "gt": lambda d, v: d > v,
    "ge": lambda d, v: d >= v,
    "eq": lambda d, v: d == v,
}


def _compare_operands(data: torch.Tensor, value: np.ndarray):
    """``(column, scalar)`` in one comparison domain: the numpy promotion
    of the column's dtype and the parameter's (a datetime parameter as its
    int64 ns, the port's storage of dates and timestamps).  The scalar is
    a Python number of that domain, so the compare runs on the column's
    device with no transfer."""
    if value.dtype.kind in "Mm":
        value = value.astype("datetime64[ns]" if value.dtype.kind == "M"
                             else "timedelta64[ns]").view(np.int64)
    col_np = numpy_dtype(data.dtype)
    common = np.result_type(col_np, value.dtype)
    if common != col_np:
        data = data.to(torch_dtype(common))
    return data, value.astype(common).item()


def servable_on(device: torch.device, result: Table) -> bool:
    """May a Context on ``device`` re-filter ``result``?  Only where the
    rows lie on that device: a card Context's compiled select leaves its
    rows on the host (its one transfer), and re-filtering them there
    would answer a card query from the host, so it runs afresh."""
    return device.type == "cpu" or result.device.type != "cpu"


def serve(result: Table, spec: SubsumeSpec, new_values: Tuple
          ) -> Optional[Table]:
    """Re-filter the cached result with the new parameter values — the
    subsumption answer.  Returns None when the result's physical layout
    breaks the proof (encoded or masked columns: the comparison domain
    would differ from the cold path's decoded values).  The mask is built
    on the result's device and applied with one gather."""
    cols = list(result.columns.values())
    mask = None
    for slot in spec.slots:
        if slot.kind != "cmp":
            continue
        if slot.result_pos >= len(cols):
            return None
        col = cols[slot.result_pos]
        if col.encoding is not Encoding.PLAIN or col.validity is not None \
                or col.dictionary is not None:
            return None
        data, value = _compare_operands(
            col.data, np.asarray(new_values[slot.index],
                                 dtype=np.dtype(slot.np_dtype)))
        m = _OP_FNS[slot.op](data, value)
        mask = m if mask is None else (mask & m)
    if mask is None:
        # every slot was exact-matched: the queries are identical
        return result
    return result.filter(mask)
