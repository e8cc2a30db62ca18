"""Equijoin kernels: a value-indexed lookup table where the build keys are
unique dense integers, else sort + searchsorted.

Counterpart of `dask_sql_tpu/ops/join.py` on one device (`join_key_gids`,
`dense_unique_lut`, `inner_join_indices`, `left_join_indices`,
`semi_join_mask`, `full_join_indices`, `take_with_nulls`), as plain
functions on tensors on their own device.  Match expansion has a
data-dependent size, so the host learns the match count (one sync) before
the gathers.

NULL semantics: SQL equijoin keys never match NULL; NULL rows get sentinel
ids that no real key takes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.column import Column
from ..columnar.dtypes import DATETIME_TYPES, STRING_TYPES, promote, sql_to_np
from ..utils import host_ints
from .grouping import factorize
from .strings import merge_dictionaries

_INT64_MIN = torch.iinfo(torch.int64).min
_INT64_MAX = torch.iinfo(torch.int64).max


def _merge_string_dicts(lcol: Column, rcol: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both sides' string codes re-coded into one merged sorted dictionary."""
    _, (lk, rk) = merge_dictionaries([(lcol.dictionary, lcol.data),
                                      (rcol.dictionary, rcol.data)])
    return lk, rk


def _key_data(col: Column, target) -> torch.Tensor:
    """A non-string key's values in the promoted key type's dtype
    (datetimes of every kind are int64 nanoseconds)."""
    if col.sql_type == target or (col.sql_type in DATETIME_TYPES
                                  and target in DATETIME_TYPES):
        return col.data
    from ..columnar.column import torch_dtype

    return col.data.to(torch_dtype(sql_to_np(target)))


def join_key_gids(left_keys: Sequence[Column], right_keys: Sequence[Column],
                  null_equals_null: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both sides' key columns as comparable int64 ids (equal ids = equal
    keys); NULL keys get -1 (left) and -2 (right), which match nothing.
    With `null_equals_null` (the set operations' IS NOT DISTINCT FROM) a
    NULL is a value like any other, and the ids are dense: 0 .. distinct
    keys - 1 over both sides."""
    nl = len(left_keys[0]) if left_keys else 0
    nr = len(right_keys[0]) if right_keys else 0
    if len(left_keys) == 1 and not null_equals_null:
        fast = _single_key_fast_path(left_keys[0], right_keys[0])
        if fast is not None:
            return fast
    combined: List[torch.Tensor] = []
    for lc, rc in zip(left_keys, right_keys):
        if lc.sql_type in STRING_TYPES or rc.sql_type in STRING_TYPES:
            lk, rk = _merge_string_dicts(lc, rc)
        else:
            target = promote(lc.sql_type, rc.sql_type)
            lk, rk = _key_data(lc, target), _key_data(rc, target)
            dt = torch.promote_types(lk.dtype, rk.dtype)
            lk, rk = lk.to(dt), rk.to(dt)
        k = torch.cat([lk, rk])
        if null_equals_null and (lc.validity is not None
                                 or rc.validity is not None):
            # the validity joins the key and the payload is zeroed under
            # NULL, so every NULL falls on one id
            v = torch.cat([lc.valid_mask(), rc.valid_mask()])
            combined.append(torch.where(v, k, torch.zeros_like(k)))
            combined.append(v.to(torch.int32))
        else:
            combined.append(k)
    gid, _, _ = factorize(combined)
    lgid, rgid = gid[:nl].to(torch.int64), gid[nl:].to(torch.int64)
    if null_equals_null:
        return lgid, rgid
    lvalid = _all_valid(left_keys, nl)
    rvalid = _all_valid(right_keys, nr)
    if lvalid is not None:
        lgid = torch.where(lvalid, lgid, -1)
    if rvalid is not None:
        rgid = torch.where(rvalid, rgid, -2)
    return lgid, rgid


def _all_valid(keys: Sequence[Column], n: int) -> Optional[torch.Tensor]:
    out = None
    for c in keys:
        if c.validity is not None:
            out = c.validity if out is None else (out & c.validity)
    return out


def _single_key_fast_path(lc: Column, rc: Column):
    """One integer, datetime or string key: the values (or merged codes)
    themselves are the ids, with no joint factorization.  NULL sentinels are
    the int64 extremes, which real keys must not reach."""
    if lc.sql_type in STRING_TYPES or rc.sql_type in STRING_TYPES:
        lk, rk = _merge_string_dicts(lc, rc)
    else:
        target = promote(lc.sql_type, rc.sql_type)
        lk, rk = _key_data(lc, target), _key_data(rc, target)
        if lk.is_floating_point() or rk.is_floating_point() \
                or lk.dtype == torch.bool:
            return None  # float keys take the exact factorize path
    lk, rk = lk.to(torch.int64), rk.to(torch.int64)
    lo = _INT64_MIN
    if lc.validity is not None or rc.validity is not None:
        mins = host_ints(*([lk.min()] if lk.shape[0] else []),
                         *([rk.min()] if rk.shape[0] else []))
        if any(m <= lo + 1 for m in mins):
            return None
        if lc.validity is not None:
            lk = torch.where(lc.validity, lk, lo)
        if rc.validity is not None:
            rk = torch.where(rc.validity, rk, lo + 1)
    return lk, rk


# the lookup table's value range is capped at a small multiple of the build
# side (TPC-H order keys are 4x sparse, hence 8x)
_DENSE_RANGE_SLACK = 8
_DENSE_RANGE_FLOOR = 1 << 16


def _unique_lut(k: torch.Tensor, rmin: int, size: int,
                valid: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """lut[v - rmin] = the row holding key v, -1 where none does; None when
    a key repeats.  Rows under a false `valid` stay out."""
    nr = k.shape[0]
    idx = k - rmin
    rows = torch.arange(nr, dtype=dtype, device=k.device)
    if valid is not None:
        idx, rows = idx[valid], rows[valid]
    counts = torch.zeros(size, dtype=torch.int32, device=k.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    if host_ints(counts.max())[0] > 1:
        return None
    lut = torch.full((size,), -1, dtype=dtype, device=k.device)
    lut[idx] = rows
    return lut


def _dense_match(lgid: torch.Tensor, rgid: torch.Tensor):
    """Unique dense integer build ids: per left row (matched, right row)
    by one scatter and one gather, no sort.  None when ineligible (NULL
    sentinels blow the range gate and take the sort path)."""
    nr = int(rgid.shape[0])
    if nr == 0 or lgid.shape[0] == 0:
        return None
    rmin, rmax = host_ints(rgid.min(), rgid.max())
    size = rmax - rmin + 1
    if size <= 0 or size > max(_DENSE_RANGE_SLACK * nr, _DENSE_RANGE_FLOOR):
        return None
    lut = _unique_lut(rgid, rmin, size, None, torch.int64)
    if lut is None:
        return None
    pidx = lgid - rmin
    inb = (pidx >= 0) & (pidx < size)
    ri_cand = torch.where(inb, lut[torch.clamp(pidx, 0, size - 1)], -1)
    return ri_cand >= 0, ri_cand


def dense_unique_lut(key: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """(rmin, lut) for a unique dense integer key column, or None.

    ``lut[v - rmin]`` is the int32 row holding key v, -1 where no row does;
    NULL rows (valid False) never enter it.  The compiled join pipeline
    builds one per build table and probes it with one gather per row."""
    nr = int(key.shape[0])
    if nr == 0 or key.is_floating_point() or key.dtype == torch.bool:
        return None
    k = key.to(torch.int64)
    if valid is not None:
        # NULLs stay out of the range so they cannot blow the gate
        rmin, rmax = host_ints(torch.where(valid, k, _INT64_MAX).min(),
                               torch.where(valid, k, _INT64_MIN).max())
        if rmin > rmax:
            return None  # all NULL
    else:
        rmin, rmax = host_ints(k.min(), k.max())
    size = rmax - rmin + 1
    if size <= 0 or size > max(_DENSE_RANGE_SLACK * nr, _DENSE_RANGE_FLOOR):
        return None
    # row ids fit int32 (a table holds < 2^31 rows)
    lut = _unique_lut(k, rmin, size, valid, torch.int32)
    if lut is None:
        return None
    return rmin, lut


def inner_join_indices(lgid: torch.Tensor, rgid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left_idx, right_idx) int64 pairs of the matches, left-major."""
    dense = _dense_match(lgid, rgid)
    if dense is not None:
        matched, ri_cand = dense
        li = torch.nonzero(matched).flatten()
        return li, ri_cand[li]
    li, ri, _ = _probe(lgid, rgid)
    return li, ri


def left_join_indices(lgid: torch.Tensor, rgid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left outer pairs, left-major: a left row without a match appears
    once, with right index -1."""
    dense = _dense_match(lgid, rgid)
    if dense is not None:
        # unique build keys: every left row appears exactly once
        matched, ri_cand = dense
        li = torch.arange(lgid.shape[0], dtype=torch.int64, device=lgid.device)
        return li, torch.where(matched, ri_cand, -1)
    r_order, start, counts = _probe_phase(lgid, rgid)
    out_counts = torch.clamp(counts, min=1)
    offsets = torch.cumsum(out_counts, 0) - out_counts
    (total,) = host_ints(out_counts.sum()) if out_counts.shape[0] else (0,)
    li = torch.repeat_interleave(
        torch.arange(lgid.shape[0], dtype=torch.int64, device=lgid.device),
        out_counts, output_size=total)
    pos_in_row = torch.arange(total, dtype=torch.int64,
                              device=lgid.device) - offsets[li]
    matched = counts[li] > 0
    ri_raw = r_order[torch.clamp(start[li] + pos_in_row, 0,
                                 max(int(rgid.shape[0]) - 1, 0))] \
        if rgid.shape[0] else torch.zeros_like(li)
    return li, torch.where(matched, ri_raw, -1)


def semi_join_mask(lgid: torch.Tensor, rgid: torch.Tensor,
                   anti: bool = False) -> torch.Tensor:
    """Per left row: has it a match on the right (its negation when
    `anti`)?  NULL sentinels match nothing."""
    dense = _dense_match(lgid, rgid)
    if dense is not None:
        matched, _ = dense
        return ~matched if anti else matched
    r_sorted = torch.sort(rgid).values
    start = torch.searchsorted(r_sorted, lgid, side="left")
    end = torch.searchsorted(r_sorted, lgid, side="right")
    matched = (end - start) > 0
    return ~matched if anti else matched


def full_join_indices(lgid: torch.Tensor, rgid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full outer pairs: the left outer pairs, then each right row without
    a match once, with left index -1."""
    li, ri = left_join_indices(lgid, rgid)
    extra_r = torch.nonzero(~semi_join_mask(rgid, lgid)).flatten()
    li = torch.cat([li, torch.full((extra_r.shape[0],), -1, dtype=torch.int64,
                                   device=li.device)])
    return li, torch.cat([ri, extra_r])


def _probe_phase(lgid: torch.Tensor, rgid: torch.Tensor):
    """Sort the right ids once (stable); each left row finds its match
    range by two binary searches.  Returns (right order, start, count)."""
    rs = torch.sort(rgid, stable=True)
    start = torch.searchsorted(rs.values, lgid, side="left")
    end = torch.searchsorted(rs.values, lgid, side="right")
    return rs.indices, start, end - start


def _probe(lgid: torch.Tensor, rgid: torch.Tensor):
    """Inner pairs by the sorted probe: the match ranges expand to pairs."""
    r_order, start, counts = _probe_phase(lgid, rgid)
    offsets = torch.cumsum(counts, 0) - counts
    (total,) = host_ints(counts.sum()) if counts.shape[0] else (0,)
    li = torch.repeat_interleave(
        torch.arange(lgid.shape[0], dtype=torch.int64, device=lgid.device),
        counts, output_size=total)
    pos_in_row = torch.arange(total, dtype=torch.int64, device=lgid.device) - offsets[li]
    ri = r_order[start[li] + pos_in_row]
    return li, ri, counts


def take_with_nulls(col: Column, indices: torch.Tensor,
                    may_pad: Optional[bool] = None) -> Column:
    """Gather rows; index -1 gives NULL (an outer join's fill).  `may_pad`
    says whether -1 can occur (False for inner matches), which spares the
    check."""
    n = len(col)
    if n == 0:
        m = int(indices.shape[0])
        return Column(torch.zeros(m, dtype=col.data.dtype, device=col.device),
                      col.sql_type,
                      torch.zeros(m, dtype=torch.bool, device=col.device),
                      col.dictionary)
    neg = indices < 0
    safe = torch.clamp(indices, 0, n - 1)
    data = col.data[safe]
    if may_pad is None:
        may_pad = bool(neg.any())
    if not may_pad and col.validity is None:
        return Column(data, col.sql_type, None, col.dictionary)
    valid = col.valid_mask()[safe] & ~neg
    return Column(data, col.sql_type, valid, col.dictionary)
