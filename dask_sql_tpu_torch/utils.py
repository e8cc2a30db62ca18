"""Device-to-host transfer accounting (counterparts of the TRANSFER_STATS
counter and `host_ints` in `dask_sql_tpu/utils.py`)."""
from __future__ import annotations

import threading
from typing import Dict

#: device->host transfers made through the port's own seams (the packed
#: aggregate pull, host bounds of integer group keys, column
#: materialization of a table on an accelerator).  The per-query delta is
#: the number the reference pins at 1 for Q1.  Reset with
#: `TRANSFER_STATS["d2h"] = 0`.
TRANSFER_STATS: Dict[str, int] = {"d2h": 0}

#: serving workers count transfers from several threads at once: the
#: read-modify-write below would lose counts without it
_STATS_LOCK = threading.Lock()


def count_d2h(n: int = 1) -> None:
    with _STATS_LOCK:
        TRANSFER_STATS["d2h"] = TRANSFER_STATS.get("d2h", 0) + n


def host_ints(*vals):
    """Pull several device scalars to Python ints in ONE transfer."""
    import torch

    if not vals:
        return ()
    count_d2h()
    return tuple(int(v) for v in torch.stack(
        [torch.as_tensor(v).to(torch.int64) for v in vals]).cpu().tolist())
