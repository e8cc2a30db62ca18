"""Execution tracing: per-plan-node wall time and output rows, surfaced
through ``EXPLAIN ANALYZE`` and `Context.last_trace`.

Counterpart of `dask_sql_tpu/tracing.py`.  On the card a node's host wall
time is only the time its kernels took to be queued, so an enabled tracer
synchronizes the node's device (`torch.cuda.synchronize`) before it reads
the clock at the node's end: the milliseconds then include the device work
of the node and of its children, inclusive as the reference's tree is.
A tracer that is off adds no synchronization anywhere; the untraced path
is the one queries run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class NodeTrace:
    node_type: str
    label: str
    wall_ms: float
    rows: int
    children: List["NodeTrace"] = field(default_factory=list)
    #: start timestamp (time.perf_counter seconds): the node's position on
    #: the timeline, so the lifecycle trace can export the tree as spans
    t0: float = 0.0

    def format(self, indent: int = 0) -> str:
        pad = "  " * indent
        if self.node_type == "Resilience":
            # a zero-duration marker (a ladder step down): its label is the
            # information
            lines = [f"{pad}!! {self.label}"]
        else:
            # rows < 0 means "not observed", not a row count
            rows = "? rows" if self.rows < 0 else f"{self.rows} rows"
            lines = [f"{pad}{self.label}  [{self.wall_ms:.2f} ms, {rows}]"]
        for child in self.children:
            lines.append(child.format(indent + 1))
        return "\n".join(lines)


class Tracer:
    """The node tree of one execution.  `device` is the executing
    Context's: on a CUDA device each node's end waits for its work."""

    def __init__(self, device: Optional[torch.device] = None):
        self.enabled = False
        self.device = device
        self._stack: List[List[NodeTrace]] = [[]]
        self.root: Optional[NodeTrace] = None

    def start(self):
        self.enabled = True
        self._stack = [[]]
        self.root = None

    def publish(self, registry) -> None:
        """Fold the finished tree into a `MetricsRegistry`: per-node-type
        wall-time histograms and row counters (``executor.node.*``)."""
        if registry is not None and self.root is not None:
            registry.observe_trace(self.root)

    def event(self, label: str) -> None:
        """A zero-duration marker (a ladder step down) at the current tree
        position, so EXPLAIN ANALYZE shows where the engine stepped down."""
        if self.enabled:
            self._stack[-1].append(
                NodeTrace("Resilience", label, 0.0, -1,
                          t0=time.perf_counter()))

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def node(self, rel):
        tracer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                tracer._stack.append([])
                return self

            def __exit__(self, exc_type, exc, tb):
                if exc_type is None:  # a failed node's error stays its own
                    tracer._sync()
                elapsed = (time.perf_counter() - self.t0) * 1000.0
                children = tracer._stack.pop()
                trace = NodeTrace(rel.node_type, rel._label(), elapsed,
                                  getattr(self, "rows", -1), children,
                                  t0=self.t0)
                tracer._stack[-1].append(trace)
                tracer.root = trace
                return False

        return _Ctx()
