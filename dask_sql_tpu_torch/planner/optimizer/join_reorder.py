"""Join reordering (parity: reference src/sql/optimizer/join_reorder.rs — the
fact/dimension heuristic of "Improving Join Reordering for Large Scale
Distributed Computing").

Copied from `dask_sql_tpu/planner/optimizer/join_reorder.py`; only import paths differ.

Algorithm (join_reorder.rs:74-188):
- flatten a filter-free pure-INNER-join subtree into leaf relations + a set
  of column-equality join conditions (bushy trees supported),
- classify leaves by catalog row counts: `size/largest > fact_dimension_ratio`
  => fact table, else dimension (unknown stats assume 100 rows),
- bail when facts or dims are empty or #facts > `max_fact_tables`,
- order dimensions: filtered dims (scaled by `filter_selectivity`) sorted by
  size; unfiltered dims keep user order unless `preserve_user_order=False`
  (then size-sorted); the two lists merge greedily smallest-first,
- build a left-deep tree per fact table (dimension-first), join the fact
  trees, and bail to the original plan if any condition or dimension cannot
  be placed.

Positional note: our plan uses positional ColumnRefs, so the rebuilt tree is
wrapped in a Projection restoring the original column order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import plan as p
from ..expressions import ColumnRef, Expr


def _table_rows(node, catalog) -> Optional[float]:
    """Row-count bound for the base table feeding this subtree, if simple.

    Walks through every unary operator whose output row count is bounded by
    its input (Filter/Projection/Alias pass rows through; Aggregate, Window
    partitions, Limit, Distinct only shrink), so opaque leaves like a CTE's
    aggregate still get a real upper bound instead of the unknown-stats
    default."""
    while isinstance(node, (p.Filter, p.SubqueryAlias, p.Projection,
                            p.Aggregate, p.Window, p.Limit, p.Distinct)):
        node = node.inputs()[0]
    if isinstance(node, p.TableScan):
        try:
            t = catalog.schemas[node.schema_name].tables[node.table_name]
            return t.statistics.row_count
        except KeyError:
            return None
    return None


def _is_not_null_pred(e: Expr) -> bool:
    from ..expressions import ScalarFunc

    return isinstance(e, ScalarFunc) and e.op in ("is_not_null", "isnotnull")


def _has_real_filter(node) -> bool:
    """Filters beyond join-key IS NOT NULL guards (join_reorder.rs:217-238)."""
    from .rules import _conjuncts

    if isinstance(node, p.Filter):
        if any(not _is_not_null_pred(c) for c in _conjuncts(node.predicate)):
            return True
        return _has_real_filter(node.inputs()[0])
    if isinstance(node, p.TableScan):
        return any(not _is_not_null_pred(f) for f in node.filters)
    return any(_has_real_filter(k) for k in node.inputs())




def _single_col(e: Expr):
    """(column index, wrapper-or-None) when the join key is one column,
    bare or under casts (q64: ss_store_sk = CAST(s_store_sk AS DOUBLE));
    None when the key is a computed expression."""
    from ..expressions import Cast

    wrap = None
    x = e
    while isinstance(x, Cast):
        wrap = e
        x = x.arg
    if isinstance(x, ColumnRef) and type(x) is ColumnRef:
        return x.index, wrap
    return None


def _rewrap(wrap, ref: ColumnRef) -> Expr:
    """Re-point a (possibly nested) cast chain at a new column position."""
    from dataclasses import replace

    from ..expressions import Cast

    if wrap is None:
        return ref
    if isinstance(wrap, Cast):
        return replace(wrap, arg=_rewrap(wrap.arg, ref))
    return ref


@dataclass
class _Leaf:
    plan: object
    start: int       # column offset in the original flattened schema
    width: int
    size: float
    filtered: bool


def _flatten(node, base: int, leaves: List[_Leaf],
             conds: List[Tuple[int, int, object, object]], catalog) -> bool:
    """Collect leaves (in user order) and global-position equality conds.

    Single structural walk (the flatten-through test and the leaf test are
    one and the same): INNER equijoins and CrossJoins flatten — a CrossJoin
    is an INNER join whose conditions live higher in the chain (q64's d2/d3
    date_dim aliases) — and every other node becomes an opaque leaf,
    placeable only when join conditions connect it.  Each cond is
    (left_pos, right_pos, left_cast_wrapper, right_cast_wrapper).  Returns
    False when a join key is a computed expression (beyond a cast chain)."""
    if isinstance(node, p.Join) and node.join_type == "INNER" and node.filter is None:
        nleft = len(node.left.schema)
        if not _flatten(node.left, base, leaves, conds, catalog):
            return False
        if not _flatten(node.right, base + nleft, leaves, conds, catalog):
            return False
        for l, r in node.on:
            lc = _single_col(l)
            rc = _single_col(r)
            if lc is None or rc is None:
                return False
            conds.append((base + lc[0], base + rc[0], lc[1], rc[1]))
        return True
    if isinstance(node, p.CrossJoin):
        nleft = len(node.left.schema)
        return (_flatten(node.left, base, leaves, conds, catalog)
                and _flatten(node.right, base + nleft, leaves, conds, catalog))
    size = _table_rows(node, catalog)
    leaves.append(_Leaf(node, base, len(node.schema),
                        100.0 if size is None else float(size),
                        _has_real_filter(node)))
    return True


def maybe_reorder(plan, config, catalog):
    ratio = float(config.get("sql.optimizer.fact_dimension_ratio", 0.7))
    max_facts = int(config.get("sql.optimizer.max_fact_tables", 2))
    preserve = bool(config.get("sql.optimizer.preserve_user_order", True))
    selectivity = float(config.get("sql.optimizer.filter_selectivity", 1.0))

    def go(node, parent_is_chain: bool):
        # CrossJoin deliberately does NOT propagate in_chain: an INNER-join
        # subtree under a CrossJoin reorders as its own (well-conditioned)
        # chain first, and the outer chain then places it as one leaf —
        # measured faster on q64 than flattening the whole 18-table chain
        # into a single reorder problem over default-stat leaves
        in_chain = (isinstance(node, p.Join) and node.join_type == "INNER"
                    and node.filter is None)
        is_chain_head = in_chain and not parent_is_chain
        kids = [go(k, in_chain) for k in node.inputs()]
        node = node.with_inputs(kids) if kids else node
        if is_chain_head:
            new = _reorder_chain(node, ratio, max_facts, preserve, selectivity,
                                 catalog)
            if new is not None:
                return new
        return node

    return go(plan, False)


def _reorder_chain(join, ratio, max_facts, preserve, selectivity, catalog):
    leaves: List[_Leaf] = []
    conds: List[Tuple[int, int, object, object]] = []
    if not _flatten(join, 0, leaves, conds, catalog):
        return None
    if len(leaves) < 3:
        return None  # nothing to reorder; the executor picks the build side

    largest = max(l.size for l in leaves)
    facts = [i for i, l in enumerate(leaves) if l.size / max(largest, 1e-9) > ratio]
    dims = [i for i, l in enumerate(leaves) if i not in facts]
    if not facts or not dims or len(facts) > max_facts:
        return None

    # order the dimensions (join_reorder.rs:122-167)
    unfiltered = [i for i in dims if not leaves[i].filtered]
    if not preserve:
        unfiltered.sort(key=lambda i: leaves[i].size)
    filtered = sorted((i for i in dims if leaves[i].filtered),
                      key=lambda i: leaves[i].size * selectivity)
    ordered: List[int] = []
    fi = ui = 0
    while fi < len(filtered) or ui < len(unfiltered):
        if fi < len(filtered) and (
                ui >= len(unfiltered)
                or leaves[filtered[fi]].size * selectivity
                < leaves[unfiltered[ui]].size):
            ordered.append(filtered[fi]); fi += 1
        else:
            ordered.append(unfiltered[ui]); ui += 1

    # global position -> (leaf index, offset)
    pos_to_leaf: Dict[int, Tuple[int, int]] = {}
    for li, leaf in enumerate(leaves):
        for off in range(leaf.width):
            pos_to_leaf[leaf.start + off] = (li, off)
    remaining = [(pos_to_leaf[a] + (wa,), pos_to_leaf[b] + (wb,))
                 for a, b, wa, wb in conds]

    builder = _TreeBuilder(leaves, remaining)
    unused = list(ordered)
    trees = []
    for f in facts:
        builder.start(f)
        # two passes so snowflake dims can attach through other dims
        for _ in range(2):
            still = []
            for d in unused:
                if not builder.try_join(d):
                    still.append(d)
            unused = still
            if not unused:
                break
        trees.append(builder.finish())
    if unused:
        return None
    tree = trees[0]
    for t in trees[1:]:
        tree = builder.join_trees(tree, t)
        if tree is None:
            return None
    if builder.remaining:
        return None  # a condition could not be placed; keep the user plan

    # restore the original column order
    new_pos: Dict[Tuple[int, int], int] = {}
    off = 0
    for li in tree.leaf_order:
        for o in range(leaves[li].width):
            new_pos[(li, o)] = off + o
        off += leaves[li].width
    exprs = []
    out_fields = list(join.schema)
    for i, f in enumerate(out_fields):
        exprs.append(ColumnRef(new_pos[pos_to_leaf[i]], f.name, f.sql_type,
                               f.nullable))
    return p.Projection(tree.plan, exprs, out_fields)


class _Tree:
    def __init__(self, plan, leaf_order: List[int]):
        self.plan = plan
        self.leaf_order = leaf_order


class _TreeBuilder:
    def __init__(self, leaves: List[_Leaf], conds):
        self.leaves = leaves
        #: [((leaf, off, cast_wrap), (leaf, off, cast_wrap))]
        self.remaining = list(conds)
        self._cur: Optional[_Tree] = None

    # -- helpers ------------------------------------------------------------
    def _offset_of(self, tree: _Tree, leaf_idx: int) -> int:
        off = 0
        for li in tree.leaf_order:
            if li == leaf_idx:
                return off
            off += self.leaves[li].width
        raise KeyError(leaf_idx)

    def _conds_between(self, in_tree, leaf_set):
        found, rest = [], []
        for (la, oa, wa), (lb, ob, wb) in self.remaining:
            if la in in_tree and lb in leaf_set:
                found.append(((la, oa, wa), (lb, ob, wb)))
            elif lb in in_tree and la in leaf_set:
                found.append(((lb, ob, wb), (la, oa, wa)))
            else:
                rest.append(((la, oa, wa), (lb, ob, wb)))
        return found, rest

    def _make_join(self, tree: _Tree, other: _Tree, pairs) -> _Tree:
        lwidth = sum(self.leaves[li].width for li in tree.leaf_order)
        on = []
        for (ll, lo, lw), (rl, ro, rw) in pairs:
            lf = self.leaves[ll].plan.schema[lo]
            rf = self.leaves[rl].plan.schema[ro]
            lpos = self._offset_of(tree, ll) + lo
            rpos = lwidth + self._offset_of(other, rl) + ro
            on.append((
                _rewrap(lw, ColumnRef(lpos, lf.name, lf.sql_type, lf.nullable)),
                _rewrap(rw, ColumnRef(rpos, rf.name, rf.sql_type, rf.nullable)),
            ))
        fields = list(tree.plan.schema) + list(other.plan.schema)
        plan = p.Join(tree.plan, other.plan, "INNER", on, None, fields)
        return _Tree(plan, tree.leaf_order + other.leaf_order)

    # -- build API ----------------------------------------------------------
    def start(self, leaf_idx: int):
        self._cur = _Tree(self.leaves[leaf_idx].plan, [leaf_idx])

    def try_join(self, leaf_idx: int) -> bool:
        tree = self._cur
        pairs, rest = self._conds_between(set(tree.leaf_order), {leaf_idx})
        if not pairs:
            return False
        self.remaining = rest
        self._cur = self._make_join(tree, _Tree(self.leaves[leaf_idx].plan,
                                                [leaf_idx]), pairs)
        return True

    def finish(self) -> _Tree:
        t = self._cur
        self._cur = None
        return t

    def join_trees(self, a: _Tree, b: _Tree) -> Optional[_Tree]:
        pairs, rest = self._conds_between(set(a.leaf_order), set(b.leaf_order))
        if not pairs:
            return None
        self.remaining = rest
        return self._make_join(a, b, pairs)
