"""Fused scan->aggregate pipeline of the PyTorch port.

Counterpart of the `compiled_aggregate` rung of
`dask_sql_tpu/physical/compiled.py`, for PLAIN columns: a
`TableScan -> [Filter/Projection]* -> Aggregate` subtree runs as one pass of
tensor operations on the table's device.  Selection is deferred as in the
reference: the filter never compacts rows, its mask is ANDed into every
aggregate's validity, and only the tiny group table reaches the host, in
ONE transfer of one packed float64 matrix.  PyTorch runs eagerly, so there
is no trace to compile: `_TraceEval` evaluates on real tensors.
"""
from __future__ import annotations

from dataclasses import replace
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.dtypes import (
    DATETIME_TYPES,
    FLOAT_TYPES,
    INTEGER_TYPES,
    STRING_TYPES,
    SqlType,
    sql_to_np,
)
from ..columnar.table import Table
from ..ops import segsum as segsum_ops
from ..ops.membership import dictionary_membership, sorted_membership
from ..planner import plan as p
from ..planner.expressions import (
    AggExpr,
    Cast,
    ColumnRef,
    Expr,
    InArrayExpr,
    Literal,
    ScalarFunc,
    transform,
    walk,
)

_SUPPORTED_AGGS = {"sum", "count", "avg", "min", "max", "count_star",
                   "var_samp", "var_pop", "stddev_samp", "stddev_pop"}

_NUMERIC_BINOPS = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
}

#: above this domain the device compacts to the present groups before the
#: pull; below it the whole packed matrix rides one transfer
HOST_PULL_DOMAIN = 1 << 16


class _Unsupported(Exception):
    pass


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dt))).dtype


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dt).numpy().dtype


def check_no_rle(table) -> None:
    """Run-length-encoded columns are run-aligned, so the row-positional
    pipelines decline them (raises _Unsupported).  The port's columns are
    PLAIN until its encodings arrive; the guard holds the reference's
    contract for them."""
    for c in table.columns.values():
        if getattr(c, "encoding", "PLAIN") == "RLE":
            raise _Unsupported("rle-encoded column in compiled pipeline")


def check_agg_static_support(agg_exprs):
    """Plan-only aggregate eligibility — raises _Unsupported."""
    for a in agg_exprs:
        if a.func not in _SUPPORTED_AGGS or a.distinct:
            raise _Unsupported(f"agg {a.func}")
        if a.args and a.args[0].sql_type in STRING_TYPES:
            raise _Unsupported("string-typed aggregate argument")
        for x in list(a.args) + ([a.filter] if a.filter is not None else []):
            for sub in walk(x):
                if isinstance(sub, AggExpr) and sub is not x:
                    raise _Unsupported("nested agg")


def pack_flat(flat, tags_sink: List) -> torch.Tensor:
    """Pack every (domain,)-sized output into ONE float64 matrix so the host
    pulls the whole result in a single transfer.  64-bit ints ride a
    lossless bitcast (``view``); everything narrower is exact in f64.  The
    (kind, numpy dtype) tag per row lands in `tags_sink`."""
    tags_sink.clear()
    packed = []
    for x in flat:
        dt = numpy_dtype(x.dtype)
        if x.dtype == torch.float64:
            packed.append(x)
            tags_sink.append(("as", dt))
        elif x.dtype == torch.int64:
            packed.append(x.view(torch.float64))
            tags_sink.append(("bits", dt))
        else:  # bool, f32/f16, ints <= 32 bits: exact in f64
            packed.append(x.to(torch.float64))
            tags_sink.append(("as", dt))
    return torch.stack(packed, dim=0)


def fetch_packed(packed: torch.Tensor, domain: int) -> Tuple[np.ndarray, np.ndarray]:
    """One-transfer host fetch of a packed output matrix.

    Returns (host_matrix[:, present], present) as numpy arrays; row 0 of the
    matrix is the group-present indicator."""
    from ..utils import count_d2h

    if domain <= HOST_PULL_DOMAIN:
        count_d2h()
        host = packed.cpu().numpy()
        present = np.nonzero(host[0] != 0.0)[0]
        return host[:, present], present
    present_dev = torch.nonzero(packed[0] != 0.0).flatten()
    # the present ids ride the same transfer as an extra row (exact in f64:
    # domain <= RADIX_DOMAIN_LIMIT)
    both = torch.cat([packed[:, present_dev],
                      present_dev.to(torch.float64)[None, :]])
    count_d2h()
    host = both.cpu().numpy()
    return host[:-1], host[-1].astype(np.int64)


def unpack_row(host: np.ndarray, i: int, tags) -> np.ndarray:
    """Recover output row i of a fetched pack in its original dtype."""
    kind, dt = tags[i]
    row = np.ascontiguousarray(host[i])
    if kind == "bits":
        return row.view(dt)
    return row.astype(dt) if row.dtype != dt else row


class SegmentReducer:
    """Batched segment reductions for one pipeline run.

    Counts and float sums are collected and reduced together: in 'kernel'
    and 'plain' modes each count and float sum becomes one typed column
    (data, mask) of ONE `ops.segsum.segsum_typed` call, read where it lies
    (a count is its bool mask; a float32 or float64 sum is its data under
    its mask, other floats cast to float32), with float64 output: counts
    exact, float error bounded by MATMUL_FLOAT_REL_ERR_BOUND.  'scatter'
    reduces each one on its own with ``index_add_`` (float64 sums, integer
    counts).  Integer sums always use an exact int64 ``index_add_``;
    min/max use ``scatter_reduce``.

    Usage: register reductions (count / sum_float / sum_int / seg_min /
    seg_max), call finish(), then resolve handles via get()."""

    def __init__(self, gid: torch.Tensor, domain: int, mode: str, n_rows: int):
        self.gid = gid.to(torch.int32)
        self.domain = domain
        self.mode = mode
        self.n_rows = n_rows
        self._cnt_dtype = torch.int32 if n_rows < (1 << 31) else torch.int64
        self._columns: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        self._fdedup: Dict[Tuple[int, int], Tuple] = {}
        self._cnt_dedup: Dict[int, Tuple] = {}
        self._out: Optional[torch.Tensor] = None
        # id()-keyed dedup is only sound while the keyed tensors stay alive
        self._keepalive: List = []

    def _zeros(self, dtype):
        return torch.zeros(self.domain, dtype=dtype, device=self.gid.device)

    def _scatter(self, x: torch.Tensor) -> torch.Tensor:
        return self._zeros(x.dtype).index_add_(0, self.gid, x)

    @property
    def _batched(self) -> bool:
        return self.mode in ("kernel", "plain")

    # -- registrations -------------------------------------------------------
    def count(self, mask: torch.Tensor):
        """Segment count of True rows; deduped by mask identity."""
        h = self._cnt_dedup.get(id(mask))
        if h is None:
            if self._batched:
                h = self._push(mask, None)
            else:
                h = ("done", self._scatter(mask.to(self._cnt_dtype)))
            self._cnt_dedup[id(mask)] = h
            self._keepalive.append(mask)
        return h

    def sum_float(self, data: torch.Tensor, mask: torch.Tensor):
        """Segment sum of a float column (rows where mask is False ignored)."""
        key = (id(data), id(mask))
        h = self._fdedup.get(key)
        if h is not None:
            return h
        if not self._batched:
            masked = torch.where(mask, data, torch.zeros((), dtype=data.dtype,
                                                         device=data.device))
            h = ("done", self._scatter(masked.to(torch.float64)))
        elif data.dtype in (torch.float32, torch.float64):
            h = self._push(data, mask)
        else:
            h = self._push(data.to(torch.float32), mask)
        self._fdedup[key] = h
        self._keepalive.append((data, mask))
        return h

    def sum_int(self, data: torch.Tensor, mask: torch.Tensor):
        """Exact integer segment sum (always int64 scatter)."""
        acc = torch.where(mask, data.to(torch.int64),
                          torch.zeros((), dtype=torch.int64, device=data.device))
        return ("done", self._scatter(acc))

    def seg_min(self, contrib: torch.Tensor):
        """Segment min of pre-filled contributions (absent rows carry the
        identity fill)."""
        return ("done", self._reduce(contrib, "amin"))

    def seg_max(self, contrib: torch.Tensor):
        return ("done", self._reduce(contrib, "amax"))

    def _reduce(self, contrib: torch.Tensor, how: str) -> torch.Tensor:
        dt = contrib.dtype
        if dt.is_floating_point:
            fill = float("inf") if how == "amin" else float("-inf")
        else:
            info = torch.iinfo(dt)
            fill = info.max if how == "amin" else info.min
        init = torch.full((self.domain,), fill, dtype=dt, device=contrib.device)
        return init.scatter_reduce_(0, self.gid.to(torch.int64), contrib, how,
                                    include_self=True)

    def _push(self, data: torch.Tensor, mask: Optional[torch.Tensor]):
        """One typed column over every row: a literal or a constant mask
        broadcasts to [n] (the kernel reads contiguous rows)."""
        n = self.gid.shape[0]
        data = data.expand(n).contiguous()
        if mask is not None:
            mask = mask.expand(n).contiguous()
        self._columns.append((data, mask))
        return ("f", len(self._columns) - 1)

    # -- execution -----------------------------------------------------------
    def finish(self):
        if self._columns:
            self._out = segsum_ops.segsum_typed(self.gid, self._columns,
                                                self.domain)

    def get(self, h):
        if h[0] == "done":
            return h[1]
        return self._out[:, h[1]]


def agg_argument(ev, slots, a: AggExpr, sel, cache: Dict[Tuple, Tuple]):
    """One aggregate's ``(argument_or_None, validity)`` pair: the row
    selection ANDed with the FILTER clause and the argument's own validity
    (floats additionally drop NaNs — pandas dropna parity).  Deduped by
    (arg, filter) repr in ``cache`` so identical masks register once."""
    key = (str(a.args[0]) if a.args else "*",
           str(a.filter) if a.filter is not None else None)
    got = cache.get(key)
    if got is not None:
        return got
    valid = sel
    if a.filter is not None:
        fd, fv = ev.eval(a.filter, slots)
        valid = valid & (fd if fv is None else (fd & fv))
    if not a.args:
        got = (None, valid)
    else:
        ad, av = ev.eval(a.args[0], slots)
        v = valid if av is None else (valid & av)
        if ad.is_floating_point():
            v = v & ~torch.isnan(ad)
        got = (ad, v)
    cache[key] = got
    return got


def segment_agg_outputs(ev, slots, agg_exprs, sel, gid, domain, reducer):
    """Per-aggregate segment reductions.  Returns one
    (values[domain], validity_or_None[domain]) pair per AggExpr; `sel` is
    the row-selection mask (deferred filters — nothing compacts).

    Two-phase: every aggregate registers its reductions on `reducer`
    (deduping identical (arg, filter) masks), one batched reduction runs,
    then outputs assemble.  Count/sum semantics match pandas NULL handling
    (sum `min_count=1`, dropna-style counts)."""
    arg_cache: Dict[Tuple, Tuple] = {}

    plans = []
    for a in agg_exprs:
        ad, v = agg_argument(ev, slots, a, sel, arg_cache)
        cnt_h = reducer.count(v)
        if a.func in ("count", "count_star"):
            plans.append(("count", cnt_h))
            continue
        if a.func in ("sum", "avg"):
            if ad.dtype == torch.bool:
                h = reducer.sum_int(ad.to(torch.int32), v)
            elif not ad.is_floating_point():
                h = reducer.sum_int(ad, v)
            else:
                h = reducer.sum_float(ad, v)
            plans.append((a.func, h, cnt_h))
            continue
        if a.func in ("min", "max"):
            if ad.dtype == torch.bool:
                ad = ad.to(torch.int32)
            if ad.is_floating_point():
                fill = float("inf") if a.func == "min" else float("-inf")
            else:
                info = torch.iinfo(ad.dtype)
                fill = info.max if a.func == "min" else info.min
            contrib = torch.where(v, ad, torch.full((), fill, dtype=ad.dtype,
                                                    device=ad.device))
            h = (reducer.seg_min if a.func == "min"
                 else reducer.seg_max)(contrib)
            plans.append(("minmax", h, cnt_h))
            continue
        # variance family
        x = ad.to(torch.float64)
        h1 = reducer.sum_float(x, v)
        h2 = reducer.sum_float(x * x, v)
        plans.append((a.func, h1, h2, cnt_h))

    reducer.finish()

    outs = []
    for plan in plans:
        kind = plan[0]
        if kind == "count":
            outs.append((reducer.get(plan[1]), None))
        elif kind == "sum":
            s, cnt = reducer.get(plan[1]), reducer.get(plan[2])
            outs.append((s, cnt > 0))
        elif kind == "avg":
            s, cnt = reducer.get(plan[1]), reducer.get(plan[2])
            outs.append((s.to(torch.float64) / torch.clamp(cnt, min=1),
                         cnt > 0))
        elif kind == "minmax":
            red, cnt = reducer.get(plan[1]), reducer.get(plan[2])
            outs.append((torch.where(cnt > 0, red, torch.zeros_like(red)),
                         cnt > 0))
        else:
            s1 = reducer.get(plan[1]).to(torch.float64)
            s2 = reducer.get(plan[2]).to(torch.float64)
            cnt = reducer.get(plan[3])
            ddof = 1 if kind.endswith("samp") else 0
            mean = s1 / torch.clamp(cnt, min=1)
            var = (torch.clamp(s2 - cnt * mean * mean, min=0.0)
                   / torch.clamp(cnt - ddof, min=1))
            out = torch.sqrt(var) if kind.startswith("stddev") else var
            outs.append((out, cnt > ddof))
    return outs


def global_row_of_nothing(host: np.ndarray, agg_exprs):
    """SQL: a global aggregate over zero input rows still yields one row,
    COUNT 0 and the other aggregates NULL (their count > 0 validity).
    Returns the fetched pack and present ids of that row."""
    host = np.zeros((host.shape[0], 1), dtype=np.float64)
    for i, a in enumerate(agg_exprs):
        if a.func in ("count", "count_star"):
            host[2 + 2 * i] = 1.0  # COUNT stays valid (= 0), not NULL
    return host, np.zeros(1, dtype=np.int64)


def decode_radix_keys(present: np.ndarray, keys) -> List[Column]:
    """Host decode of the group-key columns from the present mixed-radix
    ids; `keys` holds (column, radix, offset) per key, most significant
    first, the radix's last code standing for NULL."""
    keys = list(keys)
    out = []
    stride = 1
    for _, r, _ in keys:
        stride *= r
    for col, r, off in keys:
        stride //= r
        code = (present // stride) % r
        is_null = code == (r - 1)
        validity = ~is_null if bool(is_null.any()) else None
        code = np.minimum(code, r - 2)
        if col.sql_type in STRING_TYPES:
            out.append(Column.from_parts(code.astype(np.int32), validity,
                                         col.dictionary, col.sql_type))
        elif col.data.dtype == torch.bool:
            out.append(Column.from_parts(code == 1, validity, None,
                                         col.sql_type))
        else:
            out.append(Column.from_parts(
                (code + off).astype(numpy_dtype(col.data.dtype)), validity,
                None, col.sql_type))
    return out


def decode_agg_columns(host: np.ndarray, tags, agg_exprs) -> List[Column]:
    """Host decode of the aggregates' (value, validity) rows of a fetched
    pack (rows 1 and 2 for the first aggregate, then on in pairs)."""
    out = []
    for i, a in enumerate(agg_exprs):
        d = unpack_row(host, 1 + 2 * i, tags)
        v = unpack_row(host, 2 + 2 * i, tags) != 0.0
        target = sql_to_np(a.sql_type)
        d = d.astype(target) if d.dtype != target else d
        out.append(Column.from_parts(d, None if bool(v.all()) else v, None,
                                     a.sql_type))
    return out


def group_table(agg: p.Aggregate, cols: List[Column],
                present: np.ndarray) -> Table:
    """The aggregate's host result: its columns under the plan's names."""
    from .rel.base import unique_names

    names = unique_names([f.name for f in agg.schema])
    return Table(dict(zip(names, cols)), int(present.shape[0]), "cpu")


class _TraceEval:
    """Expression evaluator over (data, valid_or_None) pairs.

    String columns appear as their int32 dictionary codes; a string
    comparison against a literal is a lookup table over the column's host
    dictionary, gathered by the codes.  Literals become 0-dim tensors on
    the table's device and broadcast.  `table` is a Table or any object
    with its ``columns``, ``column_names`` and ``device``."""

    def __init__(self, table: Table):
        self.table = table
        self.names = table.column_names
        self.device = table.device

    def col(self, index: int) -> Column:
        return self.table.columns[self.names[index]]

    def eval(self, expr: Expr, slots):
        if isinstance(expr, ColumnRef) and type(expr) is ColumnRef:
            return slots[expr.index]
        if isinstance(expr, Literal):
            if expr.value is None:
                return (torch.zeros((), dtype=torch.float64, device=self.device),
                        torch.zeros((), dtype=torch.bool, device=self.device))
            if expr.sql_type in STRING_TYPES:
                raise _Unsupported("free string literal")
            dtype = torch_dtype(sql_to_np(expr.sql_type))
            return (torch.tensor(expr.value, dtype=dtype, device=self.device),
                    None)
        if isinstance(expr, Cast):
            d, v = self.eval(expr.arg, slots)
            src, dst = expr.arg.sql_type, expr.sql_type
            if dst in STRING_TYPES or src in STRING_TYPES:
                raise _Unsupported("string cast")
            if src in FLOAT_TYPES and dst in INTEGER_TYPES:
                d = torch.nan_to_num(torch.trunc(d))
            if src in DATETIME_TYPES and dst == SqlType.DATE:
                # truncate epoch-ns to midnight
                ns_per_day = 86_400_000_000_000
                d = torch.div(d, ns_per_day, rounding_mode="floor") * ns_per_day
            if dst == SqlType.BOOLEAN:
                return (d != 0, v)
            return (d.to(torch_dtype(sql_to_np(dst))), v)
        if isinstance(expr, InArrayExpr):
            return self._in_array(expr, slots)
        if isinstance(expr, ScalarFunc):
            return self._call(expr, slots)
        raise _Unsupported(f"expr {type(expr).__name__}")

    def _string_source(self, expr: Expr) -> Optional[Column]:
        if isinstance(expr, ColumnRef) and type(expr) is ColumnRef:
            c = self.col(expr.index)
            if c.sql_type in STRING_TYPES:
                return c
        return None

    def _in_array(self, expr: InArrayExpr, slots):
        src = self._string_source(expr.arg)
        if src is not None:
            codes, valid = slots[expr.arg.index]
            hit = dictionary_membership(codes, src.dictionary, expr.values)
            return (~hit if expr.negated else hit, valid)
        ad, av = self.eval(expr.arg, slots)
        hit = sorted_membership(ad, expr.values)
        return (~hit if expr.negated else hit, av)

    def _call(self, expr: ScalarFunc, slots):
        op = expr.op
        args = expr.args
        if op in ("eq", "ne") and len(args) == 2:
            src = self._string_source(args[0])
            lit = args[1]
            if src is not None and isinstance(lit, Literal) \
                    and isinstance(lit.value, str):
                d = src.dictionary if src.dictionary is not None \
                    else np.array([""], dtype=object)
                lut = torch.from_numpy(d.astype(str) == lit.value)
                codes, valid = slots[args[0].index]
                hit = lut.to(codes.device)[torch.clamp(codes, 0, len(d) - 1)]
                return (~hit if op == "ne" else hit, valid)
        vals = [self.eval(a, slots) for a in args]
        if op in _NUMERIC_BINOPS:
            (ad, av), (bd, bv) = vals
            if args[0].sql_type in STRING_TYPES or args[1].sql_type in STRING_TYPES:
                raise _Unsupported(f"string {op}")
            dt = torch.promote_types(ad.dtype, bd.dtype)
            return (_NUMERIC_BINOPS[op](ad.to(dt), bd.to(dt)),
                    _and_valid(av, bv))
        if op in ("and", "or"):
            (ad, av), (bd, bv) = vals
            a_t = ad if av is None else (ad & av)
            b_t = bd if bv is None else (bd & bv)
            av_ = torch.ones_like(ad) if av is None else av
            bv_ = torch.ones_like(bd) if bv is None else bv
            if op == "and":
                value = a_t & b_t
                known = (av_ & bv_) | (av_ & ~ad) | (bv_ & ~bd)
            else:
                value = a_t | b_t
                known = (av_ & bv_) | (av_ & ad) | (bv_ & bd)
            return (value, known)
        if op == "not":
            (ad, av) = vals[0]
            return (~ad, av)
        raise _Unsupported(f"op {op}")


def _and_valid(*vs):
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def _extract_chain(agg: p.Aggregate):
    """Substitute projections so group/agg/filter exprs are all over the scan
    schema.  Returns (scan, filters, group_exprs, agg_exprs) or None."""
    chain: List[p.LogicalPlan] = []
    node = agg.input
    while True:
        if isinstance(node, p.Projection):
            if any(isinstance(x, AggExpr) for e in node.exprs for x in walk(e)):
                return None
            chain.append(node)
            node = node.input
        elif isinstance(node, (p.Filter, p.SubqueryAlias)):
            chain.append(node)
            node = node.input
        elif isinstance(node, p.TableScan):
            break
        else:
            return None
    scan = node

    def subst_below(expr: Expr, pos: int) -> Expr:
        """Rewrite an expression bound at chain[pos]'s *input* onto the scan
        schema by folding in every projection below that point."""
        for lower in chain[pos:]:
            if not isinstance(lower, p.Projection):
                continue

            def fn(x, proj=lower):
                if isinstance(x, ColumnRef) and type(x) is ColumnRef:
                    return proj.exprs[x.index]
                return x

            expr = transform(expr, fn)
        return expr

    filters: List[Expr] = []
    for i, n_ in enumerate(chain):
        if isinstance(n_, p.Filter):
            filters.append(subst_below(n_.predicate, i + 1))
    group_exprs = [subst_below(e, 0) for e in agg.group_exprs]
    agg_exprs = []
    for a in agg.agg_exprs:
        new_args = tuple(subst_below(x, 0) for x in a.args)
        new_filter = subst_below(a.filter, 0) if a.filter is not None else None
        agg_exprs.append(replace(a, args=new_args, filter=new_filter))
    filters = filters + list(scan.filters)
    return scan, filters, group_exprs, agg_exprs


class CompiledAggregate:
    """One scan->aggregate pipeline bound to a concrete input table."""

    def __init__(self, agg: p.Aggregate, table: Table, filters, group_exprs,
                 agg_exprs, config):
        from ..ops.grouping import RADIX_DOMAIN_LIMIT, resolve_int_bounds

        self.agg = agg
        self.filters = filters
        self.group_exprs = group_exprs
        self.agg_exprs = agg_exprs
        ev = _TraceEval(table)

        # radix group-id plan: dictionary/bool/small-int group keys
        radices: List[Optional[int]] = []
        offsets: List[Optional[int]] = []
        gcols: List[Column] = []
        pending = []  # (slot, device min, device max): ONE pull for all keys
        for e in group_exprs:
            if not (isinstance(e, ColumnRef) and type(e) is ColumnRef):
                raise _Unsupported("non-column group key")
            c = ev.col(e.index)
            if c.sql_type in STRING_TYPES and c.dictionary is not None:
                radices.append(len(c.dictionary) + 1)
                offsets.append(0)
            elif c.data.dtype == torch.bool:
                radices.append(3)
                offsets.append(0)
            elif not c.data.is_floating_point() and len(c):
                pending.append((len(radices), c.data.min(), c.data.max()))
                radices.append(None)
                offsets.append(None)
            else:
                raise _Unsupported("non-dictionary group key")
            gcols.append(c)
        spans = resolve_int_bounds(pending, RADIX_DOMAIN_LIMIT)
        if spans is None:
            raise _Unsupported("integer key range too large")
        for slot, (span, lo) in spans.items():
            radices[slot] = span + 1
            offsets[slot] = lo
        domain = 1
        for r in radices:
            domain *= r
        if domain > RADIX_DOMAIN_LIMIT:
            raise _Unsupported("group domain too large")
        self.domain = max(domain, 1)
        self.radices = radices
        self.offsets = offsets
        self.gcols = gcols
        check_agg_static_support(agg_exprs)
        self.segsum_mode = segsum_ops.choose_segsum_impl(config, self.domain,
                                                         table.device)

    def _prelude(self, ev: _TraceEval, table: Table):
        """Slot table, deferred filter-mask fold and the radix group id.
        Returns ``(slots, sel, gid, nr)``."""
        datas = [table.columns[n].data for n in table.column_names]
        valids = [table.columns[n].validity for n in table.column_names]
        slots = {i: (datas[i], valids[i]) for i in range(len(datas))}
        nr = table.num_rows
        mask = None
        for f in self.filters:
            d, v = ev.eval(f, slots)
            m = d if v is None else (d & v)
            mask = m if mask is None else (mask & m)
        # 32-bit radix gid: the domain is capped at 2^22, so int32 is exact
        gid = None
        for e, r, off in zip(self.group_exprs, self.radices, self.offsets):
            codes, valid = slots[e.index]
            # widen sub-int32 keys first, subtract the offset in that dtype,
            # then narrow: the result is in [0, span], which fits int32
            if codes.dtype == torch.bool or codes.element_size() < 4:
                codes = codes.to(torch.int32)
            if off:
                codes = codes - off
            codes = torch.clamp(codes.to(torch.int32), 0, r - 2)
            if valid is not None:
                codes = torch.where(valid, codes, r - 1)
            gid = codes if gid is None else gid * r + codes
        if gid is None:
            gid = torch.zeros(nr, dtype=torch.int32, device=table.device)
        if mask is None:
            sel = torch.ones(nr, dtype=torch.bool, device=table.device)
        else:
            sel = mask.expand(nr) if mask.dim() == 0 else mask
        return slots, sel, gid, nr

    def run(self, table: Table) -> Table:
        ev = _TraceEval(table)
        slots, sel, gid, nr = self._prelude(ev, table)
        reducer = SegmentReducer(gid, self.domain, self.segsum_mode, nr)
        hit_h = reducer.count(sel)
        outs = segment_agg_outputs(ev, slots, self.agg_exprs, sel, gid,
                                   self.domain, reducer)
        hit = reducer.get(hit_h) > 0
        flat = [hit]
        for d, v in outs:
            flat.append(d)
            flat.append(v if v is not None else torch.ones_like(hit))
        tags: List[Tuple[str, np.dtype]] = []
        packed = pack_flat(flat, tags)
        host, present = fetch_packed(packed, self.domain)
        return self._decode(host, present, tags)

    def _decode(self, host: np.ndarray, present: np.ndarray, tags) -> Table:
        if not self.gcols and present.shape[0] == 0:
            host, present = global_row_of_nothing(host, self.agg_exprs)
        # group keys decode from the radix id on the host: the result table
        # is tiny and the operators above it run there
        cols = (decode_radix_keys(present, zip(self.gcols, self.radices,
                                               self.offsets))
                + decode_agg_columns(host, tags, self.agg_exprs))
        return group_table(self.agg, cols, present)


def singleflight_get_or_build(cache: "OrderedDict", key: Tuple, build):
    """The miss protocol of the compiled-pipeline caches: look up (LRU
    touch) or build.  ``build()`` constructs, inserts into `cache` and
    returns the pipeline.  Returns (pipeline, built_here).  The port plans
    and runs on one thread, so no construction waits for another."""
    compiled = cache.get(key)
    if compiled is not None:
        cache.move_to_end(key)
        return compiled, False
    return build(), True


def try_compiled_aggregate(rel: p.Aggregate, executor) -> Table:
    """Run an Aggregate subtree as one fused pipeline.  Raises
    NotImplementedError, naming the reason, for a plan it does not take.

    A scan under filters and projections is read in place, its filters
    deferred as a mask.  Any other input (a join that the join pipeline
    declined) runs through the eager plugins first, and the pipeline
    reduces the table they produce as its scan."""
    if not executor.config.get("sql.compile", True):
        raise NotImplementedError(
            "sql.compile is off, and the eager aggregate is not in the port yet")
    chain = _extract_chain(rel)
    if chain is None:
        table = executor.execute(rel.input)
        filters, group_exprs, agg_exprs = [], list(rel.group_exprs), \
            list(rel.agg_exprs)
    else:
        scan, filters, group_exprs, agg_exprs = chain
        table = executor.get_table(scan.schema_name, scan.table_name)
        if scan.projection is not None:
            table = table.select(scan.projection)
    try:
        compiled = CompiledAggregate(rel, table, filters, group_exprs,
                                     agg_exprs, executor.config)
        return compiled.run(table)
    except _Unsupported as e:
        raise NotImplementedError(f"compiled aggregate declined the plan: {e}") from e
