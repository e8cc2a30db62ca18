"""Packed host transfer: N device buffers, ONE device-to-host copy.

Counterpart of `dask_sql_tpu/columnar/pack.py`.  Every buffer of a
row-sized result becomes one row of an ``[n_buffers, n_rows]`` int64
matrix on the device, the matrix crosses in one copy, and the host
recovers each buffer's dtype.  Lossless: float64 by bit-cast, float32 and
float16 widened exactly to float64 and then bit-cast, ints and bools
sign-extended.  Narrow buffers (bool masks, int16 codes) widen to 8 bytes
for the crossing: one round trip instead of one per buffer.  Counterpart
of `physical/compiled.py` `pack_flat`, which packs domain-sized aggregate
outputs into float64; each pair stays lossless for its own dtypes.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def packed_host_arrays(bufs: List[torch.Tensor],
                       config=None) -> Optional[List[np.ndarray]]:
    """All buffers as host numpy arrays through one packed transfer
    (counted in ``TRANSFER_STATS``); None when there are fewer than two,
    or they are not 1-D tensors of one length, device and packable dtype
    (the caller then converts each on its own).  With the Context's
    `config`, the ``d2h`` fault site arms before the transfer: a
    `TransientExecutionError`, retryable, never a step down."""
    from ..resilience import faults
    from ..utils import count_d2h

    if len(bufs) < 2:
        return None
    first = bufs[0]
    kinds = []
    for x in bufs:
        if not isinstance(x, torch.Tensor) or x.dim() != 1 \
                or x.shape[0] != first.shape[0] or x.device != first.device:
            return None
        if x.dtype == torch.float64:
            kinds.append("f64")
        elif x.dtype in (torch.float32, torch.float16):
            kinds.append("f")
        elif x.dtype == torch.bool or (not x.is_floating_point()
                                       and not x.is_complex()):
            kinds.append("i")
        else:
            return None
    rows = []
    for x, kind in zip(bufs, kinds):
        if kind == "f64":
            rows.append(x.view(torch.int64))
        elif kind == "f":
            rows.append(x.to(torch.float64).view(torch.int64))
        else:
            rows.append(x.to(torch.int64))
    if config is not None:
        faults.maybe_inject("d2h", config)
    count_d2h()
    packed = torch.stack(rows).cpu().numpy()
    out = []
    for i, (x, kind) in enumerate(zip(bufs, kinds)):
        row = np.ascontiguousarray(packed[i])
        dt = torch.empty(0, dtype=x.dtype).numpy().dtype
        if kind == "f64":
            out.append(row.view(np.float64))
        elif kind == "f":
            out.append(row.view(np.float64).astype(dt))
        else:
            out.append(row.astype(dt))
    return out
