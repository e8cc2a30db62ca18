"""Partitioned streaming: serve a working set larger than the budget.

The port's counterpart of `dask_sql_tpu/streaming/`.  Where the admission
gate (serving/admission.py) finds a plan's provable floor over
``serving.admission.max_estimated_bytes``, or the pressure controller is
CRITICAL, a plan whose floor is dominated by ONE registered table's scan
runs as row partitions instead of being shed:

- `plan.stream_decision`: the routing and the partition sizing over the
  estimator's provable floors;
- `partition`: the row ranges (`partition_layout`) and their slices of
  the stored buffers (`slice_chunk`), which `materialize/incremental.py`'s
  folds cut too;
- `runner.drive_partitions`: the launches over row ranges (each a slice
  of the stored buffers, DICT and FOR codes as they lie; the reference
  keeps one chunk shape for its compiled executable and masks the last
  chunk's overlap, and the port, which compiles nothing per shape, runs a
  shorter last partition), with the serving ticket's
  checkpoint between them, per-partition retry, an optional watched
  launch, and mid-stream OOM recovery that halves the partition and
  resumes from the first row no completed partition covered;
- `aggregate` and `select`: the streamed rungs of the ladder.  The
  aggregate's partial states combine on the card in partition order; the
  select's survivors concatenate in global row order.

This package is not `physical/streaming.py`, which streams lazy parquet
files in batches and which `stream_decision` declines.
"""
from .aggregate import StreamedAggregate, try_streamed_aggregate
from .partition import partition_layout, slice_chunk
from .plan import StreamDecision, stream_decision
from .select import try_streamed_select

__all__ = [
    "StreamDecision",
    "StreamedAggregate",
    "partition_layout",
    "slice_chunk",
    "stream_decision",
    "try_streamed_aggregate",
    "try_streamed_select",
]
