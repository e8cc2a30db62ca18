"""Window functions.

Counterpart of `dask_sql_tpu/physical/rel/logical/window.py`.  One stable
sort by (partition keys, order keys) a window spec; segment and peer-group
boundaries from key-change flags; every function is then a vectorised
segmented scan, a difference of table-wide prefix sums, a sparse-table
range query or a gather over the sorted layout, scattered back through the
inverse permutation.  No per-group host loop.

Where the reference leans on JAX:

- ``jax.lax.associative_scan`` (running MIN and MAX within a segment)
  becomes a log-step scan with reset flags (`_segmented_scan`), exact for
  MIN and MAX;
- ``jax.lax.cummin``/``cummax`` become ``torch.cummin``/``cummax``;
- the ``fori_loop`` binary search becomes ceil(log2 n) + 1 vectorised
  steps (`_segmented_searchsorted`).

Frame sums difference a table-wide prefix sum (``P[hi] - P[lo]``).  The
prefix sum adds in another order on CUDA than on the CPU, so a small frame
after a large prefix can differ between devices by about eps * max|P|, not
eps * |frame|.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ....columnar.column import Column, torch_dtype
from ....columnar.dtypes import STRING_TYPES, SqlType, sql_to_np
from ....columnar.table import Table
from ....ops.grouping import key_arrays
from ....ops.sorting import sort_permutation
from ....ops.strings import merge_dictionaries
from ....planner import plan as p
from ....planner.expressions import Literal, WindowExpr
from ....utils import count_d2h, host_ints
from ...executor import Executor
from ..base import BaseRelPlugin, unique_names

#: bytes of the largest sparse table `_range_minmax` built (levels x rows)
SPARSE_TABLE_BYTES: Dict[str, int] = {"max": 0}


@Executor.add_plugin_class
class WindowPlugin(BaseRelPlugin):
    class_name = "Window"

    def convert(self, rel: p.Window, executor) -> Table:
        (inp,) = self.assert_inputs(rel, 1, executor)
        names = unique_names([f.name for f in rel.schema])
        n_in = len(inp.column_names)
        out_cols = dict(zip(names[:n_in],
                            [inp.columns[c] for c in inp.column_names]))
        n = inp.num_rows
        # window expressions of one (partition, order) spec share a sort
        by_spec: Dict[tuple, list] = {}
        for i, w in enumerate(rel.window_exprs):
            key = (w.spec.partition_by, w.spec.order_by)
            by_spec.setdefault(key, []).append((i, w))
        results: List[Column] = [None] * len(rel.window_exprs)
        for (part, order), items in by_spec.items():
            part_cols = [executor.eval_expr(e, inp) for e in part]
            order_cols = [executor.eval_expr(k.expr, inp) for k in order]
            layout = _SortedLayout(part_cols, order_cols,
                                   [k.ascending for k in order],
                                   [k.nulls_first_resolved() for k in order],
                                   n, inp.device)
            for i, w in items:
                args = [executor.eval_expr(a, inp) for a in w.args]
                results[i] = _compute_window(w, args, layout)
        # validity masks that hold no NULL become None, all of the node's
        # in ONE device-to-host transfer (downstream fast paths want None)
        with_masks = [j for j, col in enumerate(results)
                      if col.validity is not None]
        dense = set()
        if with_masks:
            count_d2h()
            flags = torch.stack([results[j].validity.all()
                                 for j in with_masks]).cpu().tolist()
            dense = {j for j, f in zip(with_masks, flags) if f}
        for j, (name, col) in enumerate(zip(names[n_in:], results)):
            if j in dense:
                col = Column(col.data, col.sql_type, None, col.dictionary)
            out_cols[name] = col
        return Table(out_cols, n, inp.device)


def _const_arg(w: WindowExpr, args: List[Column], i: int, default: int) -> int:
    """An integer argument that must be constant (NTILE's buckets, LAG's
    offset, NTH_VALUE's position): from the plan when it is a literal,
    else its first row (one transfer)."""
    if len(args) <= i:
        return default
    if isinstance(w.args[i], Literal) and w.args[i].value is not None:
        return int(w.args[i].value)
    return host_ints(args[i].data[0])[0]


class _SortedLayout:
    """The sorted layout of one (partition, order) spec: the permutation,
    its inverse, and per sorted row the start and end of its segment
    (partition) and peer group (equal order keys)."""

    def __init__(self, part_cols, order_cols, ascendings, nulls_firsts,
                 n: int, device):
        self.n = n
        self.device = device
        if n == 0:
            self.perm = torch.zeros(0, dtype=torch.int64, device=device)
            self.inv = self.perm
            return
        keys_cols = list(part_cols) + list(order_cols)
        asc = [True] * len(part_cols) + list(ascendings)
        nf = [False] * len(part_cols) + list(nulls_firsts)
        idx = torch.arange(n, dtype=torch.int64, device=device)
        self.perm = sort_permutation(keys_cols, asc, nf) if keys_cols else idx
        self.inv = torch.empty_like(self.perm)
        self.inv[self.perm] = idx
        self.new_seg = _change_flags(part_cols, self.perm, n, device)
        self.new_peer = (self.new_seg | _change_flags(order_cols, self.perm,
                                                      n, device)
                         if order_cols else self.new_seg)
        self.seg_start = _running_latest(torch.where(self.new_seg, idx, -1))
        self.peer_start = _running_latest(torch.where(self.new_peer, idx, -1))
        # segment and peer ends (exclusive): the next start after a row
        self.seg_end = _next_start(self.new_seg, n)
        self.peer_end = _next_start(self.new_peer, n)
        # a single numeric or datetime order key: the values RANGE offsets
        # search, made when a RANGE-offset frame asks for them
        self._order_col = order_cols[0] if len(order_cols) == 1 else None
        self._order_asc = ascendings[0] if ascendings else True
        self._order_sorted = None

    def order_values(self):
        """The order key's values, ascending within each segment, or None
        where RANGE offsets are not taken (several keys, strings, bools,
        NULLs or NaNs: the binary search needs a monotone segment)."""
        if self._order_sorted is not None:
            return self._order_sorted
        col = self._order_col
        if col is None or col.dictionary is not None \
                or col.data.dtype == torch.bool or col.validity is not None:
            return None
        v = col.data[self.perm]
        if v.is_floating_point() and host_ints(torch.isnan(v).any())[0]:
            return None
        self._order_sorted = v if self._order_asc else -v
        return self._order_sorted

    def scatter_back(self, sorted_vals, validity=None):
        data = sorted_vals[self.inv]
        return data, None if validity is None else validity[self.inv]


def _change_flags(cols, perm, n: int, device) -> torch.Tensor:
    """True at each sorted row whose keys differ from the row before (and
    at row 0)."""
    flags = torch.zeros(n, dtype=torch.bool, device=device)
    flags[0] = True
    for k in key_arrays(cols):
        ks = k[perm]
        flags[1:] |= ks[1:] != ks[:-1]
    return flags


def _running_latest(marked: torch.Tensor) -> torch.Tensor:
    """Per position, the latest index where marked >= 0 (a running max)."""
    return torch.cummax(marked, 0).values


def _next_start(flags: torch.Tensor, n: int) -> torch.Tensor:
    """Per position, the next flagged index after it (n past the last)."""
    idx = torch.arange(n, dtype=torch.int64, device=flags.device)
    nxt = torch.where(flags, idx, n)
    rev = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    return torch.cat([rev[1:], torch.full((1,), n, dtype=rev.dtype,
                                          device=rev.device)])


def _prefix(vals: torch.Tensor) -> torch.Tensor:
    """P[k] = the sum of the first k entries (length n + 1)."""
    return torch.cat([torch.zeros(1, dtype=vals.dtype, device=vals.device),
                      torch.cumsum(vals, 0)])


def _segmented_searchsorted(vals, lo_bound, hi_bound, targets,
                            side: str) -> torch.Tensor:
    """Per row, a binary search of ``targets[i]`` within
    ``vals[lo_bound[i]:hi_bound[i]]``, which is ascending; a fixed number of
    vectorised halvings, no per-segment slices."""
    n = vals.shape[0]
    lo, hi = lo_bound.to(torch.int64), hi_bound.to(torch.int64)
    rounds = max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)
    for _ in range(rounds):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mv = vals[torch.clamp(mid, 0, n - 1)]
        go_right = mv < targets if side == "left" else mv <= targets
        live = lo < hi
        lo, hi = (torch.where(live & go_right, mid + 1, lo),
                  torch.where(live & ~go_right, mid, hi))
    return lo


def _frame_bounds(w: WindowExpr, lay: _SortedLayout):
    """Per sorted row, the frame [lo, hi)."""
    n = lay.n
    i = torch.arange(n, dtype=torch.int64, device=lay.device)
    spec = w.spec
    if spec.units == "RANGE" or not spec.explicit_frame and spec.order_by:
        # the default ordered frame: segment start .. end of the peer group
        lo, hi = lay.seg_start, lay.peer_end
        if spec.explicit_frame:
            s, e = spec.start, spec.end
            if s.kind == "CURRENT_ROW":
                lo = lay.peer_start
            if e.kind == "UNBOUNDED_FOLLOWING":
                hi = lay.seg_end
            if s.kind == "UNBOUNDED_PRECEDING":
                lo = lay.seg_start
            if e.kind == "CURRENT_ROW":
                hi = lay.peer_end
            if s.kind in ("PRECEDING", "FOLLOWING") and s.offset is not None \
                    or e.kind in ("PRECEDING", "FOLLOWING") \
                    and e.offset is not None:
                # value offsets: a binary search of the order key per row
                v = lay.order_values()
                if v is None:
                    raise NotImplementedError(
                        "RANGE offset frames need a single non-null "
                        "numeric/datetime ORDER BY key")

                def search(off, side):
                    return _segmented_searchsorted(
                        v, lay.seg_start, lay.seg_end, v + off, side)

                if s.kind == "PRECEDING":
                    lo = search(-s.offset, "left")
                elif s.kind == "FOLLOWING":
                    lo = search(s.offset, "left")
                if e.kind == "PRECEDING":
                    hi = search(-e.offset, "right")
                elif e.kind == "FOLLOWING":
                    hi = search(e.offset, "right")
        return lo, hi
    # ROWS frames
    s, e = spec.start, spec.end
    if s.kind == "PRECEDING":
        lo = torch.maximum(lay.seg_start, i - int(s.offset))
    elif s.kind == "CURRENT_ROW":
        lo = i
    elif s.kind == "FOLLOWING":
        lo = torch.minimum(lay.seg_end, i + int(s.offset))
    else:
        lo = lay.seg_start
    if e.kind == "FOLLOWING":
        hi = torch.minimum(lay.seg_end, i + int(e.offset) + 1)
    elif e.kind == "CURRENT_ROW":
        hi = i + 1
    elif e.kind == "PRECEDING":
        hi = torch.maximum(lay.seg_start, i - int(e.offset) + 1)
    else:
        hi = lay.seg_end
    return lo, hi


def _compute_window(w: WindowExpr, args: List[Column],
                    lay: _SortedLayout) -> Column:
    n = lay.n
    if n == 0:
        if w.sql_type in STRING_TYPES:
            return Column(torch.zeros(0, dtype=torch.int32, device=lay.device),
                          w.sql_type, None, np.array([""], dtype=object))
        return Column(torch.zeros(0, dtype=torch_dtype(sql_to_np(w.sql_type)),
                                  device=lay.device), w.sql_type)
    i = torch.arange(n, dtype=torch.int64, device=lay.device)
    func = w.func

    def ranked(vals, sql_type=SqlType.BIGINT):
        data, _ = lay.scatter_back(vals)
        dtype = torch.float64 if sql_type == SqlType.DOUBLE else torch.int64
        return Column(data.to(dtype), sql_type)

    if func == "row_number":
        return ranked(i - lay.seg_start + 1)
    if func == "rank":
        return ranked(lay.peer_start - lay.seg_start + 1)
    if func == "dense_rank":
        c = torch.cumsum(lay.new_peer.to(torch.int64), 0)
        return ranked(c - c[lay.seg_start] + 1)
    if func == "percent_rank":
        seg_len = lay.seg_end - lay.seg_start
        rank = lay.peer_start - lay.seg_start + 1
        # int64 / int64 divides in torch's default float32: divide float64
        vals = torch.where(seg_len > 1, (rank - 1).to(torch.float64)
                           / torch.clamp(seg_len - 1, min=1), 0.0)
        return ranked(vals, SqlType.DOUBLE)
    if func == "cume_dist":
        seg_len = lay.seg_end - lay.seg_start
        return ranked((lay.peer_end - lay.seg_start).to(torch.float64)
                      / torch.clamp(seg_len, min=1), SqlType.DOUBLE)
    if func == "ntile":
        k = _const_arg(w, args, 0, 1)
        seg_len = lay.seg_end - lay.seg_start
        rn = i - lay.seg_start
        return ranked(torch.clamp(torch.div(rn * k, torch.clamp(
            seg_len, min=1), rounding_mode="floor"), max=k - 1) + 1)
    if func in ("lag", "lead"):
        return _lag_lead(w, args, lay, i)

    # frame-based functions
    lo, hi = _frame_bounds(w, lay)
    if func in ("first_value", "last_value", "nth_value"):
        return _frame_value(w, args, lay, lo, hi)
    if func == "count_star":
        data, _ = lay.scatter_back((hi - lo).to(torch.int64))
        return Column(data, SqlType.BIGINT)

    x = args[0] if args else None
    xs = x.data[lay.perm]
    xv = x.valid_mask()[lay.perm]
    pc = _prefix(xv.to(torch.int64))
    cnt = pc[hi] - pc[lo]
    if func == "count":
        data, _ = lay.scatter_back(cnt)
        return Column(data, SqlType.BIGINT)
    if func in ("sum", "avg"):
        acc = xs.to(torch.float64) if func == "avg" or xs.is_floating_point() \
            else xs.to(torch.int64)
        acc = torch.where(xv, acc, torch.zeros_like(acc))
        pre = _prefix(acc)
        s = pre[hi] - pre[lo]
        vals = s / torch.clamp(cnt, min=1) if func == "avg" else s
        data, v = lay.scatter_back(vals, cnt > 0)
        return Column(data.to(torch_dtype(sql_to_np(w.sql_type))),
                      w.sql_type, v)
    if func in ("min", "max"):
        big = _extreme_val(xs.dtype, func == "min")
        masked = torch.where(xv, xs, big)
        # a prefix frame is a running MIN or MAX within the segment; any
        # other frame a sparse-table range query.  Which one is decided
        # from the frame spec, with no look at the data
        if _is_prefix_frame(w.spec):
            run = _segmented_scan(masked, lay.new_seg, func == "min")
            vals = run[torch.clamp(hi - 1, 0, n - 1)]
        else:
            vals = _range_minmax(masked, lo, hi, func == "min")
        data, v = lay.scatter_back(vals, cnt > 0)
        return Column(data, w.sql_type, v, x.dictionary)
    if func in ("stddev_samp", "stddev_pop", "var_samp", "var_pop"):
        acc = torch.where(xv, xs.to(torch.float64),
                          torch.zeros((), dtype=torch.float64,
                                      device=lay.device))
        p1, p2 = _prefix(acc), _prefix(acc * acc)
        s1, s2 = p1[hi] - p1[lo], p2[hi] - p2[lo]
        ddof = 1 if func.endswith("samp") else 0
        mean = s1 / torch.clamp(cnt, min=1)
        var = torch.clamp((s2 - cnt * mean * mean)
                          / torch.clamp(cnt - ddof, min=1), min=0.0)
        vals = torch.sqrt(var) if func.startswith("stddev") else var
        data, v = lay.scatter_back(vals, cnt > ddof)
        return Column(data, SqlType.DOUBLE, v)
    raise NotImplementedError(f"window function {func}")


def _lag_lead(w: WindowExpr, args: List[Column], lay: _SortedLayout,
              i: torch.Tensor) -> Column:
    """LAG and LEAD, with IGNORE NULLS (the k-th earlier or later valid
    value) and a default for rows whose target leaves the segment."""
    n = lay.n
    x = args[0]
    off = _const_arg(w, args, 1, 1)
    default = args[2] if len(args) > 2 else None
    xs = x.data[lay.perm]
    xv = x.valid_mask()[lay.perm]
    if w.ignore_nulls:
        # rows ranked among the valid ones: the target is the valid row
        # `off` ranks before (LAG) or after (LEAD)
        ranks = torch.cumsum(xv.to(torch.int64), 0)  # valids in [0..i]
        valid_pos = torch.nonzero(xv).flatten()
        nvalid = int(valid_pos.shape[0])
        rank = ranks - xv.to(torch.int64) - off if w.func == "lag" \
            else ranks + off - 1
        ok = (rank >= 0) & (rank < nvalid)
        j = valid_pos[torch.clamp(rank, 0, max(nvalid - 1, 0))] if nvalid \
            else torch.zeros(n, dtype=torch.int64, device=lay.device)
        inside = ok & (j >= lay.seg_start) & (j < lay.seg_end)
    else:
        j = i - off if w.func == "lag" else i + off
        inside = (j >= lay.seg_start) & (j < lay.seg_end)
    j_safe = torch.clamp(j, 0, n - 1)
    vals = xs[j_safe]
    valid = xv[j_safe] & inside
    dictionary = x.dictionary
    if default is not None:
        dv = default.cast(x.sql_type)
        if dictionary is not None:
            # both in one merged dictionary (sorted, so code order stays
            # string order)
            dictionary, (vals, dcodes) = merge_dictionaries(
                [(dictionary, vals), (dv.dictionary, dv.data)])
            dv = Column(dcodes, dv.sql_type, dv.validity, dictionary)
        vals = torch.where(inside, vals, dv.data[lay.perm].to(vals.dtype))
        valid = torch.where(inside, valid, dv.valid_mask()[lay.perm])
    data, v = lay.scatter_back(vals, valid)
    return Column(data, w.sql_type, v, dictionary)


def _frame_value(w: WindowExpr, args: List[Column], lay: _SortedLayout,
                 lo: torch.Tensor, hi: torch.Tensor) -> Column:
    """FIRST_VALUE, LAST_VALUE (each with IGNORE NULLS) and NTH_VALUE over
    the frame."""
    n = lay.n
    x = args[0]
    xs = x.data[lay.perm]
    xv = x.valid_mask()[lay.perm]
    func = w.func
    if w.ignore_nulls and func in ("first_value", "last_value"):
        idx = torch.arange(n, dtype=torch.int64, device=lay.device)
        if func == "first_value":
            # the next valid row at or after each position
            marked = torch.where(xv, idx, n)
            nxt = torch.flip(torch.cummin(torch.flip(marked, [0]), 0).values,
                             [0])
            j = nxt[torch.clamp(lo, 0, n - 1)]
        else:
            prev = torch.cummax(torch.where(xv, idx, -1), 0).values
            j = prev[torch.clamp(hi - 1, 0, n - 1)]
    elif func == "first_value":
        j = lo
    elif func == "last_value":
        j = hi - 1
    else:
        if w.ignore_nulls:
            raise NotImplementedError(
                "NTH_VALUE ... IGNORE NULLS is not supported")
        j = lo + (_const_arg(w, args, 1, 1) - 1)
    inside = (j >= lo) & (j < hi) & (hi > lo)
    j_safe = torch.clamp(j, 0, n - 1)
    data, v = lay.scatter_back(xs[j_safe], xv[j_safe] & inside)
    return Column(data, w.sql_type, v, x.dictionary)


def _is_prefix_frame(spec) -> bool:
    """Whether the frame always spans [segment start, current row or peer
    end): the frames `_frame_bounds` gives lo = seg_start and hi = i + 1 or
    peer_end."""
    if not spec.explicit_frame:
        return True
    s, e = spec.start, spec.end
    if s.kind != "UNBOUNDED_PRECEDING":
        return False
    if spec.units == "RANGE" or spec.order_by:
        return e.kind == "CURRENT_ROW" and e.offset is None
    return e.kind == "CURRENT_ROW"


def _extreme_val(dtype: torch.dtype, for_min: bool) -> torch.Tensor:
    """The identity of MIN (the type's largest value) or MAX."""
    if dtype.is_floating_point:
        return torch.tensor(float("inf") if for_min else float("-inf"),
                            dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if for_min else info.min, dtype=dtype)


def _minmax(is_min: bool):
    return torch.minimum if is_min else torch.maximum


def _segmented_scan(vals: torch.Tensor, new_seg: torch.Tensor,
                    is_min: bool) -> torch.Tensor:
    """Running MIN or MAX within segments: a log-step (Hillis-Steele) scan
    of the reference's associative combine ``(af | bf, bf ? bv :
    op(av, bv))``, where a row's flag says whether a segment starts between
    it and the row it reads.  Exact for MIN and MAX."""
    op = _minmax(is_min)
    v, f = vals, new_seg
    n = v.shape[0]
    d = 1
    while d < n:
        v = torch.cat([v[:d], torch.where(f[d:], v[d:], op(v[:-d], v[d:]))])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def _range_minmax(masked: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  is_min: bool) -> torch.Tensor:
    """MIN or MAX over arbitrary frames [lo, hi) by a sparse table: level
    k holds the extreme of the 2^k rows from each row on, and a frame is
    two overlapping power-of-two windows."""
    n = masked.shape[0]
    op = _minmax(is_min)
    big = _extreme_val(masked.dtype, is_min).to(masked.device)
    levels = [masked]
    length = 1
    while length < n:
        prev = levels[-1]
        shifted = torch.cat([prev[length:], big.expand(min(length, n))])
        levels.append(op(prev, shifted))
        length *= 2
    table = torch.stack(levels)  # [levels, n]
    SPARSE_TABLE_BYTES["max"] = max(SPARSE_TABLE_BYTES["max"],
                                    table.numel() * table.element_size())
    width = torch.clamp(hi - lo, min=1)
    k = torch.floor(torch.log2(width.to(torch.float64))).to(torch.int64)
    idx1 = torch.clamp(lo, 0, n - 1)
    idx2 = torch.clamp(hi - torch.bitwise_left_shift(torch.ones_like(k), k),
                       0, n - 1)
    return op(table[k, idx1], table[k, idx2])
