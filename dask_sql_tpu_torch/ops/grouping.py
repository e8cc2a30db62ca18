"""Group ids and segment aggregations (counterpart of
`dask_sql_tpu/ops/grouping.py`).

Keys become dense group ids by a mixed radix of their codes
(`radix_gid`, no sort) or by one lexicographic sort (`factorize`); every
aggregate is then a masked segment reduction.  Float and bool sums and
counts go through `ops.segsum` under the policy of the compiled pipelines
(`choose_segsum_impl`): the hand-written kernel on CUDA where the group
domain fits it, a float64 ``index_add_`` above, the plain version on the
CPU.  Integer sums stay exact in int64 (``index_add_``), min and max are
``scatter_reduce``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..columnar.column import Column
from ..columnar.dtypes import STRING_TYPES
from . import segsum as segsum_ops

#: mixed-radix group-id domain gate shared by every radix planner
RADIX_DOMAIN_LIMIT = 1 << 22


def key_arrays(cols: Sequence[Column]) -> List[torch.Tensor]:
    """Sort/group keys of columns: ints and floats as they are, strings as
    their sorted-dictionary codes (code order is string order), bools as
    int32.  A column with NULLs (or NaNs) adds its validity as a key and
    zeroes its payload there, so every NULL falls in one group."""
    out = []
    for c in cols:
        if c.sql_type in STRING_TYPES:
            data = c.compact_dictionary().data
        elif c.data.dtype == torch.bool:
            data = c.data.to(torch.int32)
        else:
            data = c.data
        valid = c.validity
        if data.is_floating_point():
            nan = torch.isnan(data)
            valid = ~nan if valid is None else (valid & ~nan)
        if valid is not None:
            data = torch.where(valid, data, torch.zeros_like(data))
            out.append(data)
            out.append(valid.to(torch.int32))
        else:
            out.append(data)
    return out


def radix_gid(cols: Sequence[Column], max_domain: int = RADIX_DOMAIN_LIMIT):
    """Sort-free group ids for small-domain keys (dictionary strings, bools,
    integers of a small range): a mixed radix of the codes, one extra code
    per key for NULL.  Returns (gid, domain, decode) or None when a key is
    not eligible or the domain passes `max_domain`; ``decode(gids)`` maps
    ids back to one Column per key.  The integer keys' bounds ride one
    device-to-host transfer."""
    radices: List[Optional[int]] = []
    offsets: List[Optional[int]] = []
    pending = []  # (slot, device min, device max): ONE pull for all keys
    for c in cols:
        if c.sql_type in STRING_TYPES and c.dictionary is not None:
            radices.append(len(c.dictionary) + 1)  # +1 slot for NULL
            offsets.append(0)
        elif c.data.dtype == torch.bool:
            radices.append(3)
            offsets.append(0)
        elif not c.data.is_floating_point() and len(c):
            pending.append((len(radices), c.data.min(), c.data.max()))
            radices.append(None)
            offsets.append(None)
        else:
            return None
    spans = resolve_int_bounds(pending, max_domain)
    if spans is None:
        return None
    for slot, (span, lo) in spans.items():
        radices[slot] = span + 1
        offsets[slot] = lo
    domain = 1
    for r in radices:
        domain *= r
    if domain > max_domain:
        return None
    gid = None
    for c, r, off in zip(cols, radices, offsets):
        codes = c.data.to(torch.int64) - off
        codes = torch.clamp(codes, 0, r - 2)
        if c.validity is not None:
            codes = torch.where(c.validity, codes, r - 1)  # NULL -> last slot
        gid = codes if gid is None else gid * r + codes

    def decode(gids: torch.Tensor) -> List[Column]:
        from ..utils import host_ints

        strides = []
        s = 1
        for r in reversed(radices):
            strides.append(s)
            s *= r
        strides = list(reversed(strides))
        # one transfer decides every key's NULL-group presence
        null_masks = [torch.remainder(torch.div(gids, stride,
                                                rounding_mode="floor"), r)
                      == (r - 1) for r, stride in zip(radices, strides)]
        flags = host_ints(*[m.any() for m in null_masks])
        out = []
        for c, r, off, stride, is_null, flag in zip(
                cols, radices, offsets, strides, null_masks, flags):
            code = torch.remainder(torch.div(gids, stride,
                                             rounding_mode="floor"), r)
            validity = ~is_null if flag else None
            code = torch.clamp(code, max=r - 2)
            if c.sql_type in STRING_TYPES:
                out.append(Column(code.to(torch.int32), c.sql_type, validity,
                                  c.dictionary))
            elif c.data.dtype == torch.bool:
                out.append(Column(code == 1, c.sql_type, validity))
            else:
                out.append(Column((code + off).to(c.data.dtype), c.sql_type,
                                  validity))
        return out

    return (gid.to(torch.int32) if domain < 2 ** 31 else gid), domain, decode


def resolve_int_bounds(pending, max_domain):
    """Batch-resolve queued (slot, device_min, device_max) integer-key
    bounds in ONE device pull.  {slot: (span, lo)}, or None when any span
    blows the domain gate."""
    if not pending:
        return {}
    from ..utils import count_d2h

    bounds = torch.stack([v.to(torch.int64) for _, mn, mx in pending
                          for v in (mn, mx)])
    count_d2h()
    flat = bounds.cpu().tolist()
    out = {}
    for j, (slot, _, _) in enumerate(pending):
        lo, hi = flat[2 * j], flat[2 * j + 1]
        span = hi - lo + 1
        if span <= 0 or span > max_domain:
            return None
        out[slot] = (span, lo)
    return out


def factorize(keys):
    """Dense group ids of multi-column keys: (ids per row, the sorted-order
    permutation, the number of groups).  Ids number the distinct keys in
    ascending lexicographic order (one stable sort per key, least
    significant first)."""
    from ..utils import host_ints

    n = int(keys[0].shape[0])
    device = keys[0].device
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=device)
        return empty, empty.to(torch.int64), 0
    order = _lexsort(keys)
    changed = torch.zeros(n, dtype=torch.bool, device=device)
    changed[0] = True
    for k in keys:
        ks = k[order]
        changed[1:] |= ks[1:] != ks[:-1]
    gid_sorted = torch.cumsum(changed.to(torch.int32), 0, dtype=torch.int32) - 1
    gid = torch.empty(n, dtype=torch.int32, device=device)
    gid[order] = gid_sorted
    (last,) = host_ints(gid_sorted[-1])
    return gid, order, last + 1


def _lexsort(keys) -> torch.Tensor:
    """Permutation sorting rows by `keys`, the first the most significant
    (``jnp.lexsort`` of the reversed keys): one stable sort per key, least
    significant first."""
    order = torch.arange(int(keys[0].shape[0]), device=keys[0].device)
    for k in reversed(list(keys)):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def group_first_indices(gid: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Row index of the first occurrence of each group."""
    n = gid.shape[0]
    first = torch.full((num_groups,), n, dtype=torch.int64, device=gid.device)
    return first.scatter_reduce_(0, gid.to(torch.int64),
                                 torch.arange(n, device=gid.device), "amin",
                                 include_self=True)


# ---------------------------------------------------------------------------
# Segment aggregations.  All take (values, valid, gid, num_groups) and return
# (agg_values, agg_valid); `valid` is a bool mask, and NULL rows are skipped
# (SUM of no rows is NULL).  `mode` is the segment-sum mode of
# `ops.segsum.choose_segsum_impl`; None picks it from the device and the
# domain under the "auto" policy.
# ---------------------------------------------------------------------------
def segsum_mode(num_groups: int, device, config=None) -> str:
    """The segment-sum mode of a reduction over `num_groups` groups: the
    config's ``sql.compile.segsum`` policy, or "auto" without a config."""
    return segsum_ops.choose_segsum_impl(config or {}, num_groups, device)


def _float_sums(gid, columns, num_groups: int, mode: Optional[str]):
    """``[num_groups, k]`` float64 sums of typed ``(data, mask)`` columns
    (float32, float64 or bool data; a bool column sums to a count)."""
    device = gid.device
    if mode is None:
        mode = segsum_mode(num_groups, device)
    if num_groups == 0 or not columns:
        return torch.zeros(num_groups, len(columns), dtype=torch.float64,
                           device=device)
    if mode == "scatter":
        zero = torch.zeros((), dtype=torch.float64, device=device)
        outs = []
        for data, mask in columns:
            x = data.to(torch.float64)
            if mask is not None:
                x = torch.where(mask, x, zero)
            outs.append(torch.zeros(num_groups, dtype=torch.float64,
                                    device=device).index_add_(0, gid, x))
        return torch.stack(outs, dim=1)
    n = gid.shape[0]
    cols = [(d.expand(n).contiguous(),
             None if m is None else m.expand(n).contiguous())
            for d, m in columns]
    return segsum_ops.segsum_typed(gid.to(torch.int32).contiguous(), cols,
                                   num_groups)


def seg_count(valid, gid, num_groups, mode=None) -> torch.Tensor:
    cnt = _float_sums(gid, [(valid, None)], num_groups, mode)[:, 0]
    return cnt.to(torch.int64)


def seg_sum(values, valid, gid, num_groups, mode=None):
    """Sum and count > 0.  Integer (and bool-as-integer) values sum exactly
    in int64; floats through the segment sum in float64."""
    if values.is_floating_point():
        if values.dtype not in (torch.float32, torch.float64):
            values = values.to(torch.float32)  # the kernel's float types
        out = _float_sums(gid, [(values, valid), (valid, None)], num_groups,
                          mode)
        return out[:, 0], out[:, 1] > 0
    acc = torch.where(valid, values.to(torch.int64),
                      torch.zeros((), dtype=torch.int64, device=values.device))
    s = torch.zeros(num_groups, dtype=torch.int64,
                    device=values.device).index_add_(0, gid, acc)
    return s, seg_count(valid, gid, num_groups, mode) > 0


def _reduce(contrib, gid, num_groups, how: str, fill) -> torch.Tensor:
    init = torch.full((num_groups,), fill, dtype=contrib.dtype,
                      device=contrib.device)
    return init.scatter_reduce_(0, gid.to(torch.int64), contrib, how,
                                include_self=True)


def _minmax(values, valid, gid, num_groups, how: str, mode):
    is_bool = values.dtype == torch.bool
    if is_bool:
        values = values.to(torch.int32)
    fill = _extreme(values.dtype, maximum=(how == "amin"))
    contrib = torch.where(valid, values,
                          torch.full((), fill, dtype=values.dtype,
                                     device=values.device))
    m = _reduce(contrib, gid, num_groups, how, fill)
    ok = seg_count(valid, gid, num_groups, mode) > 0
    m = torch.where(ok, m, torch.zeros_like(m))
    return (m.to(torch.bool) if is_bool else m), ok


def seg_min(values, valid, gid, num_groups, mode=None):
    return _minmax(values, valid, gid, num_groups, "amin", mode)


def seg_max(values, valid, gid, num_groups, mode=None):
    return _minmax(values, valid, gid, num_groups, "amax", mode)


def seg_avg(values, valid, gid, num_groups, mode=None):
    out = _float_sums(gid, [(values.to(torch.float64), valid), (valid, None)],
                      num_groups, mode)
    s, cnt = out[:, 0], out[:, 1]
    return s / torch.clamp(cnt, min=1), cnt > 0


def seg_var(values, valid, gid, num_groups, ddof: int, mode=None):
    """Variance by the (count, sum, sum of squares) triple."""
    x = values.to(torch.float64)
    out = _float_sums(gid, [(x, valid), (x * x, valid), (valid, None)],
                      num_groups, mode)
    s, s2, cnt = out[:, 0], out[:, 1], out[:, 2]
    denom = torch.clamp(cnt - ddof, min=1)
    mean = s / torch.clamp(cnt, min=1)
    var = torch.clamp((s2 - cnt * mean * mean) / denom, min=0.0)
    return var, cnt > ddof


def seg_bool_and(values, valid, gid, num_groups, mode=None):
    contrib = torch.where(valid, values.to(torch.int32), 1)
    m = _reduce(contrib, gid, num_groups, "amin", 1)
    return m.to(torch.bool), seg_count(valid, gid, num_groups, mode) > 0


def seg_bool_or(values, valid, gid, num_groups, mode=None):
    contrib = torch.where(valid, values.to(torch.int32), 0)
    m = _reduce(contrib, gid, num_groups, "amax", 0)
    return m.to(torch.bool), seg_count(valid, gid, num_groups, mode) > 0


def seg_bitwise(values, valid, gid, num_groups, op: str, mode=None):
    """bit_and/bit_or/bit_xor per group from per-bit counts: torch has no
    bitwise scatter reduction, so each of the 64 bit planes counts its set
    bits among the valid rows of a group (one int64 ``index_add_`` of an
    ``[n, 64]`` plane matrix).  A bit of the AND is set where the count
    equals the group's valid rows, of the OR where it is positive, of the
    XOR where it is odd."""
    x = values.to(torch.int64)
    shifts = torch.arange(64, dtype=torch.int64, device=x.device)
    bits = (x[:, None] >> shifts[None, :]) & 1
    bits = torch.where(valid[:, None], bits, 0)
    ones = torch.zeros(num_groups, 64, dtype=torch.int64,
                       device=x.device).index_add_(0, gid, bits)
    cnt = seg_count(valid, gid, num_groups, mode)
    if op == "bit_and":
        red = ones == cnt[:, None]
    elif op == "bit_or":
        red = ones > 0
    else:  # bit_xor
        red = (ones & 1) == 1
    out = torch.sum(red.to(torch.int64) << shifts[None, :], dim=1)
    return out, cnt > 0


def seg_first(values, valid, gid, num_groups, mode=None):
    """Value at the smallest row index with a valid value, per group."""
    n = values.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=values.device)
    first = _reduce(torch.where(valid, idx, n), gid, num_groups, "amin", n)
    ok = seg_count(valid, gid, num_groups, mode) > 0
    return values[torch.clamp(first, 0, max(n - 1, 0))], ok


def seg_last(values, valid, gid, num_groups, mode=None):
    n = values.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=values.device)
    last = _reduce(torch.where(valid, idx, -1), gid, num_groups, "amax", -1)
    ok = seg_count(valid, gid, num_groups, mode) > 0
    return values[torch.clamp(last, 0, max(n - 1, 0))], ok


def seg_percentile(values, valid, gid, num_groups, q: float, mode=None):
    """Exact per-group quantile (PERCENTILE_CONT's linear interpolation):
    one lexicographic sort by (group, validity, value), then a pick at each
    group's offset."""
    n = values.shape[0]
    device = values.device
    if n == 0:
        return (torch.zeros(num_groups, dtype=torch.float64, device=device),
                torch.zeros(num_groups, dtype=torch.bool, device=device))
    x = values.to(torch.float64)
    x = torch.where(valid, x, torch.inf)  # invalid (and NaN-masked) last
    order = _lexsort([gid, (~valid).to(torch.int32), x])
    sorted_gid = gid[order]
    sorted_val = x[order]
    idx = torch.arange(n, dtype=torch.int64, device=device)
    starts = _reduce(idx, sorted_gid, num_groups, "amin", n)
    cnt = seg_count(valid, gid, num_groups, mode)
    k = torch.clamp(cnt - 1, min=0).to(torch.float64) * q
    lo = torch.floor(k).to(torch.int64)
    hi = torch.ceil(k).to(torch.int64)
    frac = k - lo

    def at(i):
        return sorted_val[torch.clamp(starts + i, 0, max(n - 1, 0))]

    return at(lo) * (1.0 - frac) + at(hi) * frac, cnt > 0


def _extreme(dtype, maximum: bool):
    if dtype.is_floating_point:
        return float("inf") if maximum else float("-inf")
    if dtype == torch.bool:
        return maximum
    info = torch.iinfo(dtype)
    return info.max if maximum else info.min
