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
