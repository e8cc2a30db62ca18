"""Stable multi-key sort (counterpart of `sort_permutation` in
`dask_sql_tpu/ops/sorting.py`)."""
from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.column import Column


def sort_permutation(cols: Sequence[Column], ascendings: Sequence[bool],
                     nulls_firsts: Sequence[bool]) -> torch.Tensor:
    """Stable permutation ordering rows by the given keys: one stable sort
    per key, least significant first.  String columns sort by code, which
    is string order because every dictionary is sorted at load."""
    n = len(cols[0]) if cols else 0
    device = cols[0].device if cols else torch.device("cpu")
    perm = torch.arange(n, device=device)
    for col, asc, nf in reversed(list(zip(cols, ascendings, nulls_firsts))):
        data = col.data
        if data.dtype == torch.bool:
            data = data.to(torch.int32)
        if data.is_floating_point():
            # NaN sorts last before the direction is applied
            data = torch.where(torch.isnan(data),
                               torch.full_like(data, float("inf")), data)
        key = data[perm]
        perm = perm[torch.sort(key, stable=True, descending=not asc).indices]
        if col.validity is not None:
            # the NULL indicator outranks the value within this key;
            # NULLs first => invalid rows get 0, which sorts before valid 1
            valid = col.validity[perm].to(torch.int8)
            nullkey = valid if nf else 1 - valid
            perm = perm[torch.sort(nullkey, stable=True).indices]
    return perm
