"""Stable multi-key sort and top-k (counterparts of `sort_permutation` and
`topk_permutation` in `dask_sql_tpu/ops/sorting.py`)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..columnar.column import Column


def sort_permutation(cols: Sequence[Column], ascendings: Sequence[bool],
                     nulls_firsts: Sequence[bool]) -> torch.Tensor:
    """Stable permutation ordering rows by the given keys: one stable sort
    per key, least significant first.  String columns sort by the codes of
    their sorted dictionary (`compact_dictionary`: an Arrow load keeps the
    values in the order they first appear), which is string order."""
    n = len(cols[0]) if cols else 0
    device = cols[0].device if cols else torch.device("cpu")
    perm = torch.arange(n, device=device)
    for col, asc, nf in reversed(list(zip(cols, ascendings, nulls_firsts))):
        if col.dictionary is not None:
            col = col.compact_dictionary()
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


def topk_permutation(col: Column, ascending: bool, k: int,
                     exact_ties: bool = False) -> Optional[torch.Tensor]:
    """Rows of the top k on one key (``torch.topk`` finds the boundary
    value), in input order, ties at the boundary taken in input order as
    the reference's ``lax.top_k`` takes them; None when ineligible (a key
    with NULLs needs the full ordering).

    With ``exact_ties`` (secondary sort keys follow), None unless every row
    tied with the boundary value made the cut: otherwise cutting by the
    first key alone could drop a row the later keys rank into the window.
    String keys compare by the codes of their sorted dictionary, which is
    string order."""
    if col.validity is not None:
        return None
    if col.dictionary is not None:
        col = col.compact_dictionary()
    data = col.data
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    vals = data if data.is_floating_point() else data.to(torch.float64)
    if ascending:
        vals = -vals
    n = int(data.shape[0])
    k = min(k, n)
    if k == 0:
        return torch.zeros(0, dtype=torch.int64, device=data.device)
    boundary = vals[torch.topk(vals, k).indices[-1]]
    # every row above the boundary value, then the first rows tied with
    # it: the rows a stable sort would put in the window
    above = torch.nonzero(vals > boundary).flatten()
    tied = torch.nonzero(vals == boundary).flatten()
    need = k - int(above.shape[0])
    if exact_ties and int(tied.shape[0]) > need:
        return None
    # in input order: the stable sort that follows then breaks full ties by
    # input position, as a full stable sort would
    return torch.sort(torch.cat([above, tied[:need]])).values
