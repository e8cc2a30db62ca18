"""Row partitions of a registered columnar table.

The port's counterpart of `dask_sql_tpu/streaming/partition.py`.  The
streamed rungs (streaming/aggregate.py, streaming/select.py) and the
incremental folds (materialize/incremental.py) run a table as row
ranges, each a positional slice of the stored column buffers (DICT and
FOR codes slice like values, so a partition's bytes are its encoded
bytes).  The reference keeps every chunk one shape for its compiled
executable, sliding the last window back and masking the overlap with
``row_valid``; the port compiles nothing per shape and its tables carry
no row mask, so the last partition is simply shorter.

RLE columns are run-aligned and do not slice positionally; eligibility
checks (streaming/plan.py) decline them before a partition is ever cut.
"""
from __future__ import annotations

from typing import List, Tuple

from ..columnar.table import Table


def partition_layout(total_rows: int, chunk_rows: int
                     ) -> List[Tuple[int, int]]:
    """``[(lo, hi)]`` logical row ranges covering ``[0, total_rows)`` in
    order, every range ``chunk_rows`` long except the last."""
    out: List[Tuple[int, int]] = []
    lo = 0
    while lo < total_rows:
        out.append((lo, min(lo + chunk_rows, total_rows)))
        lo += chunk_rows
    return out


def slice_chunk(table: Table, lo: int, chunk_rows: int) -> Table:
    """Rows ``[lo, min(lo + chunk_rows, rows))`` of ``table``: views of
    its buffers, no copy."""
    return table.slice(lo, min(lo + chunk_rows, table.num_rows))
