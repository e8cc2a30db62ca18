"""Radix group-id helpers (counterpart of part of `dask_sql_tpu/ops/grouping.py`)."""
from __future__ import annotations

import torch

#: mixed-radix group-id domain gate shared by every radix planner
RADIX_DOMAIN_LIMIT = 1 << 22


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
    order = torch.arange(n, device=device)
    for k in reversed(list(keys)):
        order = order[torch.sort(k[order], stable=True).indices]
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
