"""Device-to-host transfer accounting and counters (counterparts of the
TRANSFER_STATS counter and `host_ints` in `dask_sql_tpu/utils.py`)."""
from __future__ import annotations

from collections import Counter
from typing import Dict, List

#: device->host transfers made through the port's own seams (the packed
#: aggregate pull, host bounds of integer group keys, column
#: materialization of a table on an accelerator).  The per-query delta is
#: the number the reference pins at 1 for Q1.  Reset with
#: `TRANSFER_STATS["d2h"] = 0`.
TRANSFER_STATS: Dict[str, int] = {"d2h": 0}


def count_d2h(n: int = 1) -> None:
    TRANSFER_STATS["d2h"] = TRANSFER_STATS.get("d2h", 0) + n


def host_ints(*vals):
    """Pull several device scalars to Python ints in ONE transfer."""
    import torch

    if not vals:
        return ()
    count_d2h()
    return tuple(int(v) for v in torch.stack(
        [torch.as_tensor(v).to(torch.int64) for v in vals]).cpu().tolist())


class Metrics(Counter):
    """Named event counters of one Context (``planner.optimize.fallback``,
    ``query.plan_cache.hit``/``miss``, ``compiled_join.run``/``declined``,
    ``resilience.rung.<rung>``, ``columnar.encoding.*``), and the values
    observed under a name (``observed``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.observed: Dict[str, List[float]] = {}

    def inc(self, name: str, n: int = 1) -> None:
        self[name] += n

    def observe(self, name: str, value: float) -> None:
        self.observed.setdefault(name, []).append(value)
