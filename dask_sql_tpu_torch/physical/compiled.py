"""Fused scan->aggregate pipeline of the PyTorch port.

Counterpart of the `compiled_aggregate` rung of
`dask_sql_tpu/physical/compiled.py`: a
`TableScan -> [Filter/Projection]* -> Aggregate` subtree runs as one pass of
tensor operations on the table's device.  Selection is deferred as in the
reference: the filter never compacts rows, its mask is ANDed into every
aggregate's validity, and only the tiny group table reaches the host, in
ONE transfer of one packed float64 matrix.  PyTorch runs eagerly, so there
is no trace to compile: `_TraceEval` evaluates on real tensors.

Encoded columns (columnar/encodings.py) are read as codes: a comparison of
a DICT column with a literal runs in code space (`_encoded_compare`), a
DICT or FOR column decodes where an expression reads its values
(`_decode_slot`), DICT group keys take their codes as radix digits, and
only the group table's rows decode, on the host.
"""
from __future__ import annotations

import logging
import re
from dataclasses import replace
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.column import Column, numpy_dtype, torch_dtype
from ..columnar.dtypes import (
    DATETIME_TYPES,
    FLOAT_TYPES,
    INTEGER_TYPES,
    STRING_TYPES,
    SqlType,
    sql_to_np,
)
from ..columnar.encodings import (
    FLIP_CMP,
    Encoding,
    decode_for,
    dict_literal_bounds,
    dict_lut,
    gather_codes,
)
from ..columnar.table import Table
from ..ops import datetime as dt_ops
from ..ops import segsum as segsum_ops
from ..ops import strings as str_ops
from ..ops.membership import dictionary_membership, sorted_membership
from ..planner import plan as p
from ..planner.expressions import (
    AggExpr,
    CaseExpr,
    Cast,
    ColumnRef,
    Expr,
    ExistsExpr,
    InArrayExpr,
    InListExpr,
    InParamExpr,
    InSubqueryExpr,
    Literal,
    ParamRef,
    ScalarFunc,
    ScalarSubqueryExpr,
    transform,
    walk,
)

logger = logging.getLogger(__name__)

_SUPPORTED_AGGS = {"sum", "count", "avg", "min", "max", "count_star",
                   "var_samp", "var_pop", "stddev_samp", "stddev_pop"}

_NUMERIC_BINOPS = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
}

_MATH_UNARY = {
    "abs": torch.abs, "neg": torch.neg, "sqrt": torch.sqrt, "exp": torch.exp,
    "ln": torch.log, "log10": torch.log10, "log2": torch.log2,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "floor": torch.floor, "ceil": torch.ceil, "sign": torch.sign,
}

#: the slots key of a run's parameter values (families/parameterize.py): a
#: tuple of host numpy values, one per ParamRef / InParamExpr index
PARAMS_SLOT = "__params__"

#: the slots key prefix of a subquery's result (`rex/convert.py` runs the
#: subquery plans and hands their results to the evaluator by id)
SUBQUERY_SLOT = "__subquery__"

#: above this domain the device compacts to the present groups before the
#: pull; below it the whole packed matrix rides one transfer
HOST_PULL_DOMAIN = 1 << 16


class _Unsupported(Exception):
    pass


def check_no_rle(table) -> None:
    """Run-length-encoded columns are run-aligned (storage at rest), so the
    row-positional pipelines decline them and the eager scan decodes them
    once (raises _Unsupported)."""
    for c in table.columns.values():
        if c.encoding is Encoding.RLE:
            raise _Unsupported("rle-encoded column in compiled pipeline")


def has_encoded(table) -> bool:
    """Any column of `table` stored encoded (the late-materialization and
    code-space counters apply)."""
    return any(c.encoding is not Encoding.PLAIN
               for c in table.columns.values())


def count_codespace_predicates(exprs, table) -> int:
    """Predicates a pipeline over `table` evaluates in CODE space (a
    comparison or IN against a raw DICT-column ref): the
    ``columnar.encoding.codespace_pred`` count, taken from the plan."""
    ev = _TraceEval(table)
    n = 0
    for e in exprs:
        if e is None:
            continue
        for sub in walk(e):
            if isinstance(sub, ScalarFunc) and sub.op in (
                    "eq", "ne", "lt", "le", "gt", "ge") \
                    and len(sub.args) == 2:
                a, b = sub.args
                for colarg, litarg in ((a, b), (b, a)):
                    try:
                        c = ev._dict_source(colarg)
                    except (IndexError, KeyError):
                        c = None
                    if c is not None and isinstance(litarg,
                                                    (Literal, ParamRef)):
                        n += 1
                        break
            elif isinstance(sub, (InListExpr, InArrayExpr)):
                try:
                    if ev._dict_source(sub.arg) is not None:
                        n += 1
                except (IndexError, KeyError):
                    pass
    return n


def check_no_subquery(exprs) -> None:
    """The fused pipelines decline a subquery expression (raises
    _Unsupported) before they are cached, as the reference's evaluator
    does at trace time; the eager operators run the subquery plans."""
    for e in exprs:
        if e is None:
            continue
        for sub in walk(e):
            if isinstance(sub, (ScalarSubqueryExpr, InSubqueryExpr,
                                ExistsExpr)):
                raise _Unsupported(f"expr {type(sub).__name__}")


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
    reduces each one on its own: float64 sums group by group over ids
    sorted once (`ops.segsum.SortedSegments`, the same bits on every run),
    integer counts with ``index_add_``.  Integer sums always use an exact
    int64 ``index_add_``; min/max use ``scatter_reduce``.

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
        self._segments: Optional[segsum_ops.SortedSegments] = None
        # id()-keyed dedup is only sound while the keyed tensors stay alive
        self._keepalive: List = []

    def _scatter(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_floating_point():  # integer adds are exact in any order
            return torch.zeros(self.domain, dtype=x.dtype,
                               device=x.device).index_add_(0, self.gid, x)
        if self._segments is None:
            self._segments = segsum_ops.SortedSegments(self.gid, self.domain)
        return self._segments.sum(x)

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


def decode_radix_group_key(col, code: np.ndarray, off,
                           validity) -> Column:
    """Host decode of one radix group-key column (shared by the scan- and
    join-aggregate pipelines): `code` is the extracted radix digit, clamped
    below the NULL slot, `col` the key's column or `_ColMeta`.  Encoded
    keys map codes back through their dictionary or affine."""
    if col.sql_type in STRING_TYPES:
        return Column.from_parts(code.astype(np.int32), validity,
                                 col.dictionary, col.sql_type)
    enc = col.encoding
    if enc is Encoding.DICT:
        vals = col.enc_values[np.minimum(code, len(col.enc_values) - 1)]
        return Column.from_parts(vals, validity, None, col.sql_type)
    if col.data.dtype == torch.bool:
        return Column.from_parts(code == 1, validity, None, col.sql_type)
    raw = code + off
    if enc is Encoding.FOR:
        vals = (raw.astype(np.int64) * col.enc_scale + col.enc_ref).astype(
            sql_to_np(col.sql_type))
        return Column.from_parts(vals, validity, None, col.sql_type)
    return Column.from_parts(raw.astype(numpy_dtype(col.data.dtype)),
                             validity, None, col.sql_type)


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
        out.append(decode_radix_group_key(col, code, off, validity))
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


class _ColMeta:
    """A column's type, string dictionary, dtype and encoding metadata,
    without its device buffers: a cached pipeline must not pin the tables
    it was built on."""

    __slots__ = ("sql_type", "dictionary", "data", "_len", "encoding",
                 "enc_values", "enc_ref", "enc_scale")

    def __init__(self, col: Column):
        self.sql_type = col.sql_type
        self.dictionary = col.dictionary
        self.data = torch.empty(0, dtype=col.data.dtype)
        self._len = len(col)
        self.encoding = col.encoding
        self.enc_values = col.enc_values
        self.enc_ref = col.enc_ref
        self.enc_scale = col.enc_scale

    def __len__(self):
        return self._len


class _TableMeta:
    """Column-metadata view of a Table (or of a pipeline's slot space), the
    evaluator's table in a cached pipeline."""

    def __init__(self, table=None, device=None, columns=None, names=None):
        if table is not None:
            names = list(table.column_names)
            columns = [_ColMeta(table.columns[n]) for n in names]
            device = table.device
        self.column_names = list(names)
        self.columns = dict(zip(self.column_names, columns))
        self.device = device


class _TraceEval:
    """Expression evaluator over (data, valid_or_None) pairs.

    String columns appear as their int32 dictionary codes; a string
    comparison against a literal is a lookup table over the column's host
    dictionary, gathered by the codes.  DICT and FOR columns appear as
    their codes: a comparison or IN of a DICT column against literals runs
    on the codes, and any other read decodes (`_decode_slot`).  Literals
    become 0-dim tensors on the table's device and broadcast.  `table` is
    a Table or a `_TableMeta`.

    `eager` marks the evaluator of the eager operators (`rex/convert.py`),
    which also takes SUBSTRING with constant offsets over a string column
    (a new dictionary, the codes mapped through it) and the results of
    subquery plans it is handed in the slots; the fused pipelines decline
    both, as the reference's do."""

    def __init__(self, table, eager: bool = False):
        self.table = table
        self.names = table.column_names
        self.device = table.device
        self.eager = eager
        #: lookup tables on the device, kept with the pipeline: DICT value
        #: arrays by slot, string predicates by (operand, op, literal),
        #: SUBSTRING maps by (operand, start, length)
        self._luts: Dict[object, torch.Tensor] = {}

    def col(self, index: int) -> Column:
        return self.table.columns[self.names[index]]

    def eval(self, expr: Expr, slots):
        if isinstance(expr, ColumnRef) and type(expr) is ColumnRef:
            return self._decode_slot(expr.index, slots)
        if self.eager and expr.sql_type in STRING_TYPES:
            # a string-valued expression reads as its codes (IS NULL, ...)
            got = self.string_operand(expr, slots)
            if got is not None:
                return got[0], got[1]
        if isinstance(expr, ParamRef):
            # a runtime parameter of the family: the host value moves to
            # the device as the literal it stands for would
            v = np.array(slots[PARAMS_SLOT][expr.index])  # 0-dim, owned
            return torch.from_numpy(v).to(self.device), None
        if isinstance(expr, InParamExpr):
            return self._in_param(expr, slots)
        if isinstance(expr, (ScalarSubqueryExpr, InSubqueryExpr, ExistsExpr)):
            # the eager converter ran the subquery plan and left its result
            # (data, validity) here; a fused pipeline has none and declines
            got = slots.get((SUBQUERY_SLOT, id(expr)))
            if got is None:
                raise _Unsupported(f"expr {type(expr).__name__}")
            return got
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
        if isinstance(expr, CaseExpr):
            return self._case(expr, slots)
        if isinstance(expr, InListExpr):
            return self._in_list(expr, slots)
        if isinstance(expr, InArrayExpr):
            return self._in_array(expr, slots)
        if isinstance(expr, ScalarFunc):
            return self._call(expr, slots)
        raise _Unsupported(f"expr {type(expr).__name__}")

    def _case(self, expr: CaseExpr, slots):
        """CASE: the branches fold from the last WHEN to the first, each
        taking the rows its condition holds for (a NULL condition does not
        hold); no ELSE gives NULL."""
        if expr.sql_type in STRING_TYPES:
            raise _Unsupported("string-valued CASE")
        out_d = torch.zeros((), dtype=torch_dtype(sql_to_np(expr.sql_type)),
                            device=self.device)
        out_v = torch.zeros((), dtype=torch.bool, device=self.device)
        if expr.else_ is not None:
            out_d, out_v = self.eval(expr.else_, slots)
        for cond, val in reversed(expr.whens):
            cd, cv = self.eval(cond, slots)
            take = cd if cv is None else (cd & cv)
            vd, vv = self.eval(val, slots)
            out_d = _where(take, vd, out_d)
            if vv is None and out_v is None:
                out_v = None
            else:
                vv_ = torch.ones_like(take) if vv is None else vv
                ov_ = torch.ones_like(take) if out_v is None else out_v
                out_v = torch.where(take, vv_, ov_)
        return (out_d, out_v)

    # -- compressed-domain column access ------------------------------------
    def _decode_slot(self, index: int, slots):
        """A slot's VALUES: DICT gathers through its (tiny) value table, FOR
        applies its affine; the read was the narrow code array.  PLAIN and
        string codes (their dictionary is the representation) pass
        through.  A decoded slot is kept in `slots` for the run."""
        d, v = slots[index]
        c = self.col(index)
        enc = c.encoding
        if enc is Encoding.PLAIN or c.sql_type in STRING_TYPES:
            return (d, v)
        key = ("decoded", index)
        got = slots.get(key)
        if got is not None:
            return got
        if enc is Encoding.DICT:
            lut = self._luts.get(index)
            if lut is None or lut.device != d.device:
                lut = self._luts[index] = dict_lut(c.enc_values, d.device)
            d = gather_codes(lut, d)
        elif enc is Encoding.FOR:
            d = decode_for(d, c.sql_type, c.enc_ref, c.enc_scale)
        else:
            raise _Unsupported("rle-encoded column in compiled pipeline")
        slots[key] = (d, v)
        return (d, v)

    def _dict_source(self, expr: Expr):
        """The column (meta) when `expr` is a raw ref to a numeric
        DICT-encoded column: the code-space predicate target."""
        if isinstance(expr, ColumnRef) and type(expr) is ColumnRef:
            c = self.col(expr.index)
            if c.encoding is Encoding.DICT \
                    and c.sql_type not in STRING_TYPES:
                return c
        return None

    def _encoded_compare(self, op: str, args, slots):
        """``dict_col CMP literal`` (or a family parameter) rewritten into
        CODE space.  The dictionary is sorted, so the predicate becomes a
        bound on the codes, found on the host by `dict_literal_bounds`; a
        parameter's value is a host scalar, so its bound is a host search
        each run and moves nothing off the device.  Both sides are taken
        in the dtype the value-space compare would use (torch's promotion of
        the column's and the literal's dtypes), so the answer is the same
        bit for bit, for a parameter and for the literal baked in.  None
        when the shape does not match, or when that dtype would merge
        dictionary values or the literal is NaN (the caller compares
        values)."""
        a, b = args
        for colarg, litarg, o in ((a, b, op), (b, a, FLIP_CMP[op])):
            c = self._dict_source(colarg)
            if c is None:
                continue
            value = _scalar_operand(litarg, slots)
            if value is None:
                continue
            lit_dt = torch_dtype(sql_to_np(litarg.sql_type))
            cmp_dt = numpy_dtype(torch.promote_types(
                torch_dtype(c.enc_values.dtype), lit_dt))
            try:
                lit = np.asarray(value,
                                 dtype=numpy_dtype(lit_dt)).astype(cmp_dt)
            except (OverflowError, ValueError):
                return None
            vals = c.enc_values.astype(cmp_dt, copy=False)
            if (cmp_dt.kind == "f" and np.isnan(lit)) or (
                    len(vals) > 1 and not bool(np.all(vals[1:] > vals[:-1]))):
                return None
            codes, valid = slots[colarg.index]
            kind, code = dict_literal_bounds(vals, o, lit[()])
            if kind == "lt":
                hit = codes < code
            elif kind == "ge":
                hit = codes >= code
            elif kind == "eq":
                hit = codes == code
            elif kind == "ne":
                hit = codes != code
            else:
                hit = torch.full(codes.shape, kind == "all", dtype=torch.bool,
                                 device=codes.device)
            return (hit, valid)
        return None

    def _dict_membership(self, arg: Expr, slots, values):
        """IN over a numeric DICT column: the value list maps through the
        sorted dictionary on the host (absent values drop out) and the codes
        are tested on the device.  (hit, validity), or None when `arg` is
        not such a column or the list is not numeric."""
        c = self._dict_source(arg)
        if c is None:
            return None
        code_list = []
        for v in values:
            if not _is_number(v):
                return None
            i = int(np.searchsorted(c.enc_values, v))
            if i < len(c.enc_values) and c.enc_values[i] == v:
                code_list.append(i)
        codes, valid = slots[arg.index]
        if code_list:
            hit = sorted_membership(codes, np.asarray(code_list,
                                                      dtype=np.int32))
        else:
            hit = torch.zeros(codes.shape, dtype=torch.bool,
                              device=codes.device)
        return (hit, valid)

    def _membership(self, arg: Expr, values, slots):
        """(hit, validity) of ``arg IN values``: a string column tests its
        codes against the dictionary's members, a numeric DICT column its
        codes against the values mapped into code space, anything else its
        values."""
        src = self.string_operand(arg, slots)
        if src is not None:
            codes, valid, dictionary, _ = src
            return dictionary_membership(codes, dictionary, values), valid
        got = self._dict_membership(arg, slots, values)
        if got is not None:
            return got
        ad, valid = self.eval(arg, slots)
        if (values.dtype.kind in "iuf" if isinstance(values, np.ndarray)
                else all(_is_number(v) for v in values)):
            # exact for int columns against float items
            return sorted_membership(ad, np.asarray(values)), valid
        hit = torch.zeros(ad.shape, dtype=torch.bool, device=ad.device)
        for v in values:
            hit = hit | (ad == torch.tensor(v, device=ad.device))
        return hit, valid

    def string_operand(self, expr: Expr, slots):
        """``(codes, validity, dictionary, key)`` of a string-valued operand
        (a string column, or in the eager evaluator SUBSTRING of one with
        constant offsets), or None.  `key` names the operand for the
        evaluator's lookup tables."""
        if isinstance(expr, ColumnRef) and type(expr) is ColumnRef:
            c = self.col(expr.index)
            if c.sql_type not in STRING_TYPES:
                return None
            codes, valid = slots[expr.index]
            return codes, valid, c.dictionary, ("col", expr.index)
        if not self.eager:
            return None
        if isinstance(expr, Literal) and (expr.sql_type in STRING_TYPES
                                          or isinstance(expr.value, str)):
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            if expr.value is None:
                return (zero, torch.zeros((), dtype=torch.bool,
                                          device=self.device),
                        np.array([""], dtype=object), ("null",))
            return (zero, None, np.array([str(expr.value)], dtype=object),
                    ("lit", str(expr.value)))
        if isinstance(expr, Cast) and expr.sql_type in STRING_TYPES:
            if expr.arg.sql_type in STRING_TYPES or (
                    isinstance(expr.arg, Literal) and expr.arg.value is None):
                return self.string_operand(expr.arg, slots)
            return None
        if isinstance(expr, CaseExpr) and expr.sql_type in STRING_TYPES:
            return self._string_case(expr, slots)
        if not isinstance(expr, ScalarFunc):
            return None
        if expr.op == "substring":
            return self._substring(expr, slots)
        if expr.op in _STRING_MAPS:
            src = self._require_string(expr.args[0], slots, expr.op)
            return self._mapped(src, _STRING_MAPS[expr.op], (expr.op,))
        if expr.op == "concat":
            out = self._require_string(expr.args[0], slots, "CONCAT")
            for a in expr.args[1:]:
                out = self._concat(out, self._require_string(a, slots,
                                                             "CONCAT"))
            return out
        if expr.op == "coalesce" and expr.sql_type in STRING_TYPES:
            return self._string_coalesce(expr, slots)
        return None

    def _require_string(self, expr: Expr, slots, what: str):
        src = self.string_operand(expr, slots)
        if src is None:
            raise _Unsupported(f"{what} of {expr}")
        return src

    def _mapped(self, src, fn, tag):
        """A string operand mapped value by value through `fn` on the host
        dictionary, re-encoded (sorted, unique); the codes gather through
        the map on the device.  The map is kept by (tag, operand)."""
        codes, valid, dictionary, skey = src
        key = tag + (skey,)
        got = self._luts.get(key)
        if got is None:
            d = dictionary if dictionary is not None and len(dictionary) \
                else np.array([""], dtype=object)
            mapped = np.array([fn(str(x)) for x in d], dtype=object)
            uniq, inverse = np.unique(mapped.astype(str), return_inverse=True)
            lut = torch.from_numpy(inverse.astype(np.int32)).to(self.device)
            got = self._luts[key] = (lut, uniq.astype(object))
        lut, new_dictionary = got
        new_codes = lut.to(codes.device)[torch.clamp(codes, 0,
                                                     lut.shape[0] - 1)]
        return new_codes, valid, new_dictionary, key

    def _substring(self, expr: ScalarFunc, slots):
        """SUBSTRING(s FROM start [FOR length]) with constant offsets, a
        map of the host dictionary (`_mapped`)."""
        offsets = expr.args[1:]
        if not offsets or not all(
                isinstance(a, Literal) and _is_number(a.value)
                for a in offsets):
            raise _Unsupported("SUBSTRING with computed offsets")
        src = self._require_string(expr.args[0], slots, "SUBSTRING")
        start = int(offsets[0].value)
        length = int(offsets[1].value) if len(offsets) > 1 else None
        return self._mapped(
            src, lambda x: str_ops.substring(x, start, length),
            ("substring", start, length))

    def _concat(self, a, b):
        """``a || b``: the distinct code pairs the rows hold, found on the
        device and brought to the host in one transfer, joined there and
        re-encoded (sorted, unique).  NULL if either side is."""
        from ..utils import count_d2h

        (ca, va, da, ka), (cb, vb, db, kb) = a, b
        da = da if da is not None and len(da) else np.array([""], dtype=object)
        db = db if db is not None and len(db) else np.array([""], dtype=object)
        ca, cb = torch.broadcast_tensors(
            torch.clamp(ca, 0, len(da) - 1).to(torch.int64),
            torch.clamp(cb, 0, len(db) - 1).to(torch.int64))
        pairs, inverse = torch.unique(ca.reshape(-1) * len(db) + cb.reshape(-1),
                                      return_inverse=True)
        if pairs.device.type != "cpu":
            count_d2h()
        host = pairs.cpu().numpy()
        joined = np.array([str(da[x // len(db)]) + str(db[x % len(db)])
                           for x in host], dtype=object).astype(str)
        uniq, lut = np.unique(joined, return_inverse=True)
        codes = torch.from_numpy(lut.astype(np.int32)).to(ca.device)[inverse]
        return (codes.reshape(ca.shape), _and_valid(va, vb),
                uniq.astype(object), ("concat", ka, kb))

    def _string_coalesce(self, expr: ScalarFunc, slots):
        """COALESCE of strings: the operands in one merged dictionary, then
        folded from the last fallback toward the first."""
        ops = [self._require_string(a, slots, "COALESCE") for a in expr.args]
        dictionary, codes = _merged(ops)
        out_c, out_v = codes[-1], ops[-1][1]
        for c, (_, v, _, _) in reversed(list(zip(codes[:-1], ops[:-1]))):
            if v is None:
                out_c, out_v = c, None
                continue
            base = torch.ones_like(v) if out_v is None else out_v
            out_c, out_v = torch.where(v, c, out_c), v | base
        return out_c, out_v, dictionary, ("coalesce",) + tuple(
            k for _, _, _, k in ops)

    def _string_case(self, expr: CaseExpr, slots):
        """A string-valued CASE: the branch values in one merged
        dictionary, folded as `_case` folds numbers; no ELSE gives NULL."""
        values = [self._require_string(v, slots, "CASE") for _, v in expr.whens]
        if expr.else_ is not None:
            values.append(self._require_string(expr.else_, slots, "CASE"))
        dictionary, codes = _merged(values)
        if expr.else_ is not None:
            out_c, out_v = codes[-1], values[-1][1]
        else:
            out_c = torch.zeros((), dtype=torch.int32, device=self.device)
            out_v = torch.zeros((), dtype=torch.bool, device=self.device)
        for (cond, _), c, (_, v, _, _) in reversed(list(zip(
                expr.whens, codes, values))):
            cd, cv = self.eval(cond, slots)
            take = cd if cv is None else (cd & cv)
            out_c = torch.where(take, c, out_c)
            if v is not None or out_v is not None:
                vv = torch.ones_like(take) if v is None else v
                ov = torch.ones_like(take) if out_v is None else out_v
                out_v = torch.where(take, vv, ov)
        return out_c, out_v, dictionary, ("case", id(expr))

    @staticmethod
    def _round(expr: ScalarFunc, vals):
        """ROUND(x [, digits]): half away from zero, in float64, then in
        the type of x (an integer without digits as it stands)."""
        (ad, av) = vals[0]
        if len(vals) == 1 and not (ad.is_floating_point()
                                   or ad.dtype == torch.bool):
            return ad, av
        factor = torch.tensor(1.0, dtype=torch.float64, device=ad.device)
        dv = None
        if len(vals) > 1:
            dd, dv = vals[1]
            factor = torch.pow(10.0, dd.to(torch.float64))
        x = ad.to(torch.float64) * factor
        out = torch.sign(x) * torch.floor(torch.abs(x) + 0.5) / factor
        return (out.to(torch_dtype(sql_to_np(expr.sql_type))),
                _and_valid(av, dv))

    def _in_list(self, expr: InListExpr, slots):
        """IN (literal, ...).  A NULL item makes every row without a hit
        NULL (SQL's three-valued IN, as the reference's eager evaluator has
        it; its fused evaluator drops NULL items, so there
        ``x NOT IN (1, NULL)`` keeps rows)."""
        if not all(isinstance(it, Literal) for it in expr.items):
            raise _Unsupported("non-literal IN list")
        values = [it.value for it in expr.items if it.value is not None]
        hit, valid = self._membership(expr.arg, values, slots)
        if len(values) < len(expr.items):
            valid = hit if valid is None else (valid & hit)
        return (~hit if expr.negated else hit, valid)

    def _pattern_lut(self, op: str, skey, dictionary, args) -> torch.Tensor:
        """The bool lookup table of `op` (eq, ne, like, ilike, similar)
        against a literal over a string operand's host dictionary (`skey`
        names the operand): one regex match per dictionary entry, kept with
        the evaluator (so a cached pipeline builds it once)."""
        pattern = args[1].value
        esc = None
        if len(args) > 2 and isinstance(args[2], Literal):
            esc = args[2].value
        key = ("str", skey, op, pattern, esc)
        lut = self._luts.get(key)
        if lut is not None:
            return lut
        d = dictionary if dictionary is not None \
            else np.array([""], dtype=object)
        if op in ("eq", "ne"):
            hits = d.astype(str) == pattern
        else:
            rx = (str_ops.similar_to_regex(pattern, esc) if op == "similar"
                  else str_ops.like_to_regex(pattern, esc))
            match = re.compile(rx, re.IGNORECASE if op == "ilike" else 0).match
            hits = np.array([match(str(x)) is not None for x in d], dtype=bool)
        if not len(hits):
            hits = np.zeros(1, dtype=bool)
        lut = self._luts[key] = torch.from_numpy(hits).to(self.device)
        return lut

    def _in_array(self, expr: InArrayExpr, slots):
        hit, valid = self._membership(expr.arg, np.asarray(expr.values), slots)
        return (~hit if expr.negated else hit, valid)

    def _in_param(self, expr: InParamExpr, slots):
        """IN against a family's parameter vector (sorted, padded to its
        pow2 bucket by repeating the maximum): the same membership as the
        literal list, so lists of one bucket share a pipeline."""
        values = np.asarray(slots[PARAMS_SLOT][expr.index])
        hit, valid = self._membership(expr.arg, values, slots)
        return (~hit if expr.negated else hit, valid)

    def _call(self, expr: ScalarFunc, slots):
        op = expr.op
        args = expr.args
        # string comparisons and patterns against a literal: a lookup table
        # over the column's host dictionary, gathered by the codes
        if op in ("eq", "ne", "like", "ilike", "similar") and len(args) >= 2 \
                and isinstance(args[1], Literal) \
                and isinstance(args[1].value, str):
            src = self.string_operand(args[0], slots)
            if src is not None:
                codes, valid, dictionary, skey = src
                lut = self._pattern_lut(op, skey, dictionary, args)
                hit = lut.to(codes.device)[torch.clamp(codes, 0,
                                                       lut.shape[0] - 1)]
                return (~hit if op == "ne" else hit, valid)
        # numeric comparisons against DICT-encoded columns run on the codes
        if op in ("eq", "ne", "lt", "le", "gt", "ge") and len(args) == 2:
            got = self._encoded_compare(op, args, slots)
            if got is not None:
                return got
        if op in ("datetime_floor", "datetime_ceil"):
            # the unit is a string literal: read from the plan, not evaluated
            unit = args[1].value if isinstance(args[1], Literal) else None
            if unit is None:
                raise _Unsupported("dynamic truncation unit")
            ad, av = self.eval(args[0], slots)
            fn = dt_ops.truncate if op == "datetime_floor" else dt_ops.ceil_to
            return (fn(str(unit), ad), av)
        if op in ("eq", "ne", "lt", "le", "gt", "ge") and len(args) == 2 \
                and self.eager and args[0].sql_type in STRING_TYPES \
                and args[1].sql_type in STRING_TYPES:
            # two string operands: both in one merged dictionary, whose code
            # order is string order
            ops = [self._require_string(a, slots, f"string {op}")
                   for a in args]
            _, (ca, cb) = _merged(ops)
            return (_NUMERIC_BINOPS[op](ca, cb), _and_valid(ops[0][1],
                                                            ops[1][1]))
        vals = [self.eval(a, slots) for a in args]
        if op == "round" and self.eager:
            # the eager evaluator's, as in the reference
            return self._round(expr, vals)
        if op in _NUMERIC_BINOPS:
            (ad, av), (bd, bv) = vals
            if args[0].sql_type in STRING_TYPES or args[1].sql_type in STRING_TYPES:
                raise _Unsupported(f"string {op}")
            ad, bd = _promote_pair(ad, bd)
            return (_NUMERIC_BINOPS[op](ad, bd), _and_valid(av, bv))
        if op in ("div", "mod"):
            # integers: division truncates toward zero and the remainder
            # takes the dividend's sign; a zero divisor gives NULL
            (ad, av), (bd, bv) = vals
            ad, bd = _promote_pair(ad, bd)
            if ad.is_floating_point() or ad.dtype == torch.bool:
                out = ad / bd if op == "div" else torch.fmod(ad, bd)
                return (out, _and_valid(av, bv))
            safe = torch.where(bd == 0, torch.ones_like(bd), bd)
            if op == "div":
                q = torch.div(torch.abs(ad), torch.abs(safe),
                              rounding_mode="floor")
                out = torch.where((ad < 0) ^ (bd < 0), -q, q)
            else:
                out = torch.fmod(ad, safe)
            return (out, _and_valid(av, bv, bd != 0))
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
        if op in ("is_null", "is_not_null"):
            (ad, av) = vals[0]
            base = (torch.zeros(ad.shape, dtype=torch.bool, device=ad.device)
                    if av is None else ~av)
            if ad.is_floating_point():
                base = base | torch.isnan(ad)
            return (base if op == "is_null" else ~base, None)
        if op in ("is_true", "is_false", "is_not_true", "is_not_false"):
            (ad, av) = vals[0]
            av_ = torch.ones_like(ad) if av is None else av
            t = ad & av_
            f = ~ad & av_
            out = {"is_true": t, "is_false": f,
                   "is_not_true": ~t, "is_not_false": ~f}[op]
            return (out, None)
        if op in _MATH_UNARY:
            (ad, av) = vals[0]
            x = ad if op in ("abs", "neg", "sign") else ad.to(torch.float64)
            return (_MATH_UNARY[op](x), av)
        if op.startswith("extract_"):
            (ad, av) = vals[0]
            return (dt_ops.extract(op[8:], ad), av)
        if op in ("datetime_add", "datetime_sub_interval"):
            (ad, av), (bd, bv) = vals
            if op == "datetime_sub_interval":
                bd = -bd
            if args[1].sql_type == SqlType.INTERVAL_YEAR_MONTH:
                return (dt_ops.add_months(ad, bd), _and_valid(av, bv))
            return (ad + bd, _and_valid(av, bv))
        if op == "datetime_sub":
            (ad, av), (bd, bv) = vals
            return (ad - bd, _and_valid(av, bv))
        if op == "int_to_interval_days":
            (ad, av) = vals[0]
            return (ad.to(torch.int64) * dt_ops.NS_PER_DAY, av)
        if op == "coalesce":
            # fold from the last fallback toward the first argument; an
            # always-valid argument resets the chain to all-valid
            out_d, out_v = vals[-1]
            for d, v in reversed(vals[:-1]):
                if v is None:
                    out_d, out_v = d, None
                    continue
                base_valid = torch.ones_like(v) if out_v is None else out_v
                out_d = _where(v, d, out_d)
                out_v = v | base_valid
            return (out_d, out_v)
        raise _Unsupported(f"op {op}")


#: string functions that map a dictionary value by value
_STRING_MAPS = {"upper": str.upper}


def _merged(operands):
    """String operands' codes in one merged dictionary:
    (dictionary, [codes, ...])."""
    return str_ops.merge_dictionaries([(d, c) for c, _, d, _ in operands])


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) \
        and not isinstance(v, (bool, np.bool_))


def _scalar_operand(expr: Expr, slots):
    """The host value of a numeric literal or family parameter (not a
    boolean), or None."""
    if isinstance(expr, Literal):
        return expr.value if _is_number(expr.value) else None
    if isinstance(expr, ParamRef) and PARAMS_SLOT in slots:
        v = np.asarray(slots[PARAMS_SLOT][expr.index])
        return v[()] if v.ndim == 0 and v.dtype.kind in "iuf" else None
    return None


def _promote_pair(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted dtype.  Explicit, because torch lets
    a 0-dim operand (a literal) promote less than a full tensor, where the
    reference promotes by dtype alone."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _where(cond, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _promote_pair(a, b)
    return torch.where(cond, a, b)


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
    """One scan->aggregate pipeline, planned on a concrete input table; it
    keeps only the table's metadata, and `run` takes the table of each
    query."""

    def __init__(self, agg: p.Aggregate, table: Table, filters, group_exprs,
                 agg_exprs, config):
        from ..ops.grouping import RADIX_DOMAIN_LIMIT, resolve_int_bounds

        self.agg = agg
        self.filters = filters
        self.group_exprs = group_exprs
        self.agg_exprs = agg_exprs
        check_no_rle(table)
        check_no_subquery(list(filters) + [
            x for a in agg_exprs
            for x in list(a.args) + [a.filter]])
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
            elif c.encoding is Encoding.DICT:
                # the dictionary codes ARE the radix digits: no min/max
                # pull, no decode, and float and datetime keys group too
                radices.append(len(c.enc_values) + 1)
                offsets.append(0)
            elif c.data.dtype == torch.bool:
                radices.append(3)
                offsets.append(0)
            elif not c.data.is_floating_point() and len(c):
                # PLAIN ints and FOR codes alike: the bounds are over the
                # stored ints; a FOR key decodes at the host group decode
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
        self.gcols = [_ColMeta(c) for c in gcols]
        check_agg_static_support(agg_exprs)
        self.segsum_mode = segsum_ops.choose_segsum_impl(config, self.domain,
                                                         table.device)
        #: compressed-domain accounting (``columnar.encoding.*`` counters)
        self.has_encoded = has_encoded(table)
        self.codespace_preds = count_codespace_predicates(
            list(filters) + [x for a in agg_exprs
                             for x in list(a.args)
                             + ([a.filter] if a.filter is not None else [])],
            table) if self.has_encoded else 0
        #: the evaluator over the table's metadata, kept with the pipeline
        self._ev = _TraceEval(_TableMeta(table))

    def _prelude(self, ev: _TraceEval, table: Table, params: Tuple):
        """Slot table, deferred filter-mask fold and the radix group id.
        Returns ``(slots, sel, gid, nr)``."""
        datas = [table.columns[n].data for n in table.column_names]
        valids = [table.columns[n].validity for n in table.column_names]
        slots: Dict = {i: (datas[i], valids[i]) for i in range(len(datas))}
        slots[PARAMS_SLOT] = tuple(params)
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

    def run(self, table: Table, params: Tuple = ()) -> Table:
        """One query over `table`, with its family's parameter values."""
        ev = self._ev
        slots, sel, gid, nr = self._prelude(ev, table, params)
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


def evict(cache: "OrderedDict", compiled) -> None:
    """Drop a pipeline that declined at run time from its cache, so the
    next query of its family builds (and declines) anew rather than
    counting a family hit, as a pipeline the reference cannot trace is
    never cached."""
    if compiled is None:
        return
    for key in [k for k, v in cache.items() if v is compiled]:
        del cache[key]


#: LRU of scan-chain pipelines, keyed by the table version and the plan
_CACHE_CAP = 32
_cache: "OrderedDict[tuple, CompiledAggregate]" = OrderedDict()


def _scan_chain_pipeline(rel, chain, executor):
    """(pipeline, table, params) for an aggregate over a scan chain, the
    pipeline from the cache or built and cached (a build counts its
    code-space predicates in ``metrics["columnar.encoding.codespace_pred"]``,
    a reuse with parameters ``families.hit``); raises _Unsupported when the
    pipeline declines the chain.  The filters' and the aggregate
    arguments' literals lift into parameters first, so the key, and the
    pipeline, serve the whole family."""
    from .. import families

    scan, filters, group_exprs, agg_exprs = chain
    ctx = executor.context
    table = executor.get_table(scan.schema_name, scan.table_name)
    if scan.projection is not None:
        table = table.select(scan.projection)
    dc = ctx.schema[scan.schema_name].tables[scan.table_name]
    pz = families.pipeline_parameterizer(executor.config)
    filters = [pz.rewrite(f) for f in filters]
    agg_exprs = [pz.rewrite_agg(a) for a in agg_exprs]
    params = pz.params
    key = (
        dc.uid,
        scan.schema_name, scan.table_name,
        tuple(scan.projection or ()),
        tuple(str(f) for f in filters),
        tuple(str(e) for e in group_exprs),
        tuple(str(a) for a in agg_exprs),
        tuple((f.name, f.sql_type) for f in rel.schema),
        table.num_rows,
        str(executor.config.get("sql.compile.segsum", "auto")),
    )

    def build():
        obj = CompiledAggregate(rel, table, filters, group_exprs, agg_exprs,
                                executor.config)
        _cache[key] = obj
        while len(_cache) > _CACHE_CAP:
            _cache.popitem(last=False)
        return obj

    compiled, built_here = singleflight_get_or_build(_cache, key, build)
    if not built_here and params:
        ctx.metrics.inc("families.hit")
    if built_here and compiled.codespace_preds:
        ctx.metrics.inc("columnar.encoding.codespace_pred",
                        compiled.codespace_preds)
    return compiled, table, params


def try_compiled_aggregate(rel: p.Aggregate, executor) -> Optional[Table]:
    """Run an Aggregate over a scan chain as one fused pipeline; None when
    the plan is not a scan chain or the pipeline declines it (a decline of
    a chain is counted in ``metrics["compiled_aggregate.declined"]``), and
    the next rung answers.

    The scan under filters and projections is read in place, its filters
    deferred as a mask and its encoded columns as codes; each run counts
    the rows it decodes on the host in
    ``metrics["columnar.encoding.late_rows"]``."""
    if not executor.config.get("sql.compile", True):
        return None
    chain = _extract_chain(rel)
    if chain is None:
        return None
    metrics = executor.context.metrics
    compiled = None
    try:
        compiled, table, params = _scan_chain_pipeline(rel, chain, executor)
        result = compiled.run(table, params)
    except _Unsupported as e:
        logger.info("compiled aggregate declined the scan chain: %s", e)
        metrics.inc("compiled_aggregate.declined")
        evict(_cache, compiled)
        return None
    if compiled.has_encoded:
        # late materialization: only the group table's rows decode
        metrics.inc("columnar.encoding.late_rows", result.num_rows)
    return result
