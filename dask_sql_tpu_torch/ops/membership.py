"""Set membership of the rex evaluator and the fused pipelines.

Counterpart of `dask_sql_tpu/ops/membership.py`: one sorted lookup
(``torch.searchsorted``) whatever the size of the value set, so an IN list
of thousands of keys (dynamic partition pruning's ``InArray``) costs one
binary search per row.
"""
from __future__ import annotations

import numpy as np
import torch


def sorted_membership(data: torch.Tensor, values) -> torch.Tensor:
    """`data IN values` as a bool tensor on data's device (no NULL handling).

    Integer columns compare exactly: a float value list keeps only its
    integral members (SQL `int_col IN (1.5)` never matches) instead of
    promoting the column to float64, which would merge ids above 2^53."""
    values = np.asarray(values)
    if not len(values):
        return torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    col_dtype = torch.empty(0, dtype=data.dtype).numpy().dtype
    if col_dtype.kind in "iub" and values.dtype.kind == "f":
        integral = values == np.floor(values)
        values = values[integral & (np.abs(values) < 2.0 ** 63)].astype(np.int64)
        if not len(values):
            return torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    cmp_dtype = np.result_type(col_dtype, values.dtype)
    sv = torch.from_numpy(np.unique(values.astype(cmp_dtype, copy=False)))
    sv = sv.to(data.device)
    d = data.to(sv.dtype)
    idx = torch.clamp(torch.searchsorted(sv, d), max=sv.shape[0] - 1)
    return sv[idx] == d


def dictionary_membership(codes: torch.Tensor, dictionary, values) -> torch.Tensor:
    """Membership of dictionary-encoded strings: a host lookup table over
    the dictionary, one gather over the codes on their device."""
    d = dictionary if dictionary is not None else np.array([""], dtype=object)
    lut = np.isin(d.astype(str), np.asarray(values).astype(str))
    if not len(lut):
        lut = np.zeros(1, dtype=bool)
    lut_t = torch.from_numpy(lut).to(codes.device)
    return lut_t[torch.clamp(codes, 0, len(lut) - 1)]
