"""Device-to-host transfer accounting (counterpart of the TRANSFER_STATS
counter in `dask_sql_tpu/utils.py`)."""
from __future__ import annotations

from typing import Dict

#: device->host transfers made through the port's own seams (the packed
#: aggregate pull, host bounds of integer group keys, column
#: materialization of a table on an accelerator).  The per-query delta is
#: the number the reference pins at 1 for Q1.  Reset with
#: `TRANSFER_STATS["d2h"] = 0`.
TRANSFER_STATS: Dict[str, int] = {"d2h": 0}


def count_d2h(n: int = 1) -> None:
    TRANSFER_STATS["d2h"] = TRANSFER_STATS.get("d2h", 0) + n
