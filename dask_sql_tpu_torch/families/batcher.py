"""Inter-query family batcher: one stacked kernel launch for concurrently
admitted same-family queries.  (A copy of
`dask_sql_tpu/families/batcher.py`.)

When several serving workers run queries of the same plan family (one
compiled pipeline, different literal vectors) at the same time, running
them one after another scans the same table N times.  The batcher
rendezvouses them instead: the first arrival becomes the *leader*, waits a
short window (``serving.batch.window_ms``) for followers of the same
(family, table version) key, and makes ONE stacked run that reads the scan
once and reduces every member's literals against it
(physical/compiled.py `CompiledAggregate.run_batched`: one segment-sum
call over all members' columns).  Followers block on the group and
receive their slice of the result.

Latency discipline: the leader waits out the window only when the
serving runtime reports other queries in flight (`busy` probe) or the
packer co-scheduled same-family mates; an idle server pays at most a
short grace.  The reference pads a batch to the next power of two so that
a family compiles at most log2(max) stacked programs; nothing compiles
per batch size on the card, so the port launches the members alone.
Failures propagate to every member and feed the degradation ladder in
each member's own thread.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional

from ..runtime import locks

logger = logging.getLogger(__name__)

#: upper bound on how long a follower waits for its leader's launch; the
#: leader always sets the group's done event in a finally, so this only
#: guards against pathological scheduler stalls
_FOLLOWER_WAIT_S = 600.0


class _Group:
    __slots__ = ("members", "outputs", "error", "done", "full", "closed",
                 "gid", "leader_qid", "qids")

    def __init__(self):
        import uuid

        self.members: List[Any] = []  # one params tuple per member
        self.outputs: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.full = threading.Event()
        self.closed = False
        #: flow-link namespace of this rendezvous: member i's causality
        #: arrow into the leader's stacked launch is id "<gid>:<i>"
        self.gid = uuid.uuid4().hex[:12]
        self.leader_qid: Optional[str] = None
        #: member trace qids (index-aligned with `members`, None where a
        #: member ran untraced) — the leader links them after the launch
        self.qids: List[Optional[str]] = []


class FamilyBatcher:
    """Rendezvous point keyed by (family, table version).

    `run` is called from the executing worker thread with this query's
    parameter vector and two callables: ``solo()`` runs the member alone,
    ``batched(members)`` runs one stacked launch and returns one result
    per member, in order."""

    def __init__(self, max_queries: int = 8, window_ms: float = 2.0,
                 metrics=None, busy: Optional[Callable[[], bool]] = None,
                 mates: Optional[Callable[[], int]] = None):
        self.max_queries = max(1, int(max_queries))
        self.window_s = max(0.0, float(window_ms)) / 1000.0
        self.metrics = metrics
        #: "is any OTHER query in flight right now?" — gates the leader's
        #: window wait so idle traffic pays no batching latency
        self._busy = busy
        #: packer knowledge (serving/scheduler.py): how many OTHER admitted
        #: queries share the calling thread's plan family.  A positive
        #: count means the scheduler co-packed batch-mates — the leader
        #: waits the window with certainty instead of guessing from the
        #: in-flight heuristic (0 / None when no scheduler or no family)
        self._mates = mates
        # rank 50: only group-dict bookkeeping runs under this lock —
        # leaders execute and members wait on per-group Events OUTSIDE it
        self._lock = locks.named_lock("families.batcher")
        self._groups: Dict[Any, _Group] = {}

    # ----------------------------------------------------------------- run
    def run(self, key: Any, params: Any,
            solo: Callable[[], Any],
            batched: Callable[[List[Any]], List[Any]]) -> Any:
        if self.max_queries <= 1:
            return solo()
        from ..observability import current_trace

        tr = current_trace()
        with self._lock:
            group = self._groups.get(key)
            if group is None or group.closed \
                    or len(group.members) >= self.max_queries:
                # dsql: allow-unpaired-effect — leader-only path: _lead()
                group = _Group()  # settles group.done in its finally
                self._groups[key] = group
                leader = True
            else:
                leader = False
            index = len(group.members)
            group.members.append(params)
            group.qids.append(tr.qid if tr is not None else None)
            if not leader and len(group.members) >= self.max_queries:
                group.full.set()
        if leader:
            return self._lead(key, group, solo, batched)
        if tr is not None:
            # causality flow OUT of this member, terminating at the
            # leader's stacked launch (the leader emits the matching
            # flow_in after it runs) — Perfetto draws the arrow when the
            # linked traces are merged into one export
            tr.event("batch_join", flow_out=f"{group.gid}:{index}")
        group.done.wait(_FOLLOWER_WAIT_S)
        if group.error is not None:
            raise group.error
        if group.outputs is None:  # leader never finished (stalled/killed)
            logger.warning("family batch leader stalled; running solo")
            return solo()
        if len(group.members) > 1:
            from ..observability import flight, live

            live.update(batch_role="member", batch_size=len(group.members))
            flight.record("batch.member",
                          qid=tr.qid if tr is not None else None,
                          leader=group.leader_qid, size=len(group.members))
            if tr is not None:
                tr.link(group.leader_qid)
        self._mark_member(len(group.members))
        return group.outputs[index]

    #: unconditional rendezvous grace: the first query of a burst can reach
    #: the batcher before its batch-mates are even admitted (the submit
    #: loop races the worker pool), so a single busy-probe sample at entry
    #: would skip the window exactly when it matters.  The grace bounds the
    #: idle-traffic latency cost; the probe then decides whether the FULL
    #: window is worth waiting out.
    _GRACE_S = 0.010

    def _lead(self, key: Any, group: _Group,
              solo: Callable[[], Any],
              batched: Callable[[List[Any]], List[Any]]) -> Any:
        from ..observability import current_trace

        tr = current_trace()
        group.leader_qid = tr.qid if tr is not None else None
        try:
            if self.window_s:
                grace = min(self.window_s, self._GRACE_S)
                group.full.wait(grace)
                if not group.full.is_set() and self.window_s > grace:
                    with self._lock:
                        joined = len(group.members) > 1
                    if joined or self._copacked() \
                            or self._busy is None or self._busy():
                        group.full.wait(self.window_s - grace)
            with self._lock:
                group.closed = True
                if self._groups.get(key) is group:
                    del self._groups[key]
                members = list(group.members)
            if len(members) == 1:
                if self.metrics is not None:
                    self.metrics.inc("serving.batch.solo")
                group.outputs = [solo()]
            else:
                group.outputs = batched(members)
                if self.metrics is not None:
                    self.metrics.inc("serving.batch.launches")
                    self.metrics.inc("serving.batch.queries", len(members))
                    self.metrics.observe("serving.batch.size", len(members))
                from ..observability import flight, live

                live.update(batch_role="leader", batch_size=len(members))
                flight.record("batch.lead",
                              qid=group.leader_qid, size=len(members))
                if tr is not None:
                    # terminate each member's causality arrow at THIS
                    # stacked launch, and link the member traces so the
                    # merged /v1/trace export carries both endpoints
                    with self._lock:
                        qids = list(group.qids)
                    for i, member_qid in enumerate(qids):
                        if i == 0:
                            continue  # the leader itself
                        tr.event("batch_launch",
                                 flow_in=f"{group.gid}:{i}",
                                 member=member_qid)
                        tr.link(member_qid)
        except BaseException as exc:
            group.error = exc
            raise
        finally:
            # ALWAYS close and deregister — an exception before the mid-try
            # close (window wait / busy probe raising) must not leave an
            # open zombie group that later same-family queries join only to
            # re-raise this leader's stale error (review finding)
            with self._lock:
                group.closed = True
                if self._groups.get(key) is group:
                    del self._groups[key]
            group.done.set()
        self._mark_member(len(group.members))
        return group.outputs[0]

    def _copacked(self) -> bool:
        """True when the packer reports same-family batch-mates admitted
        alongside the calling thread's query (probe failures read as no)."""
        if self._mates is None:
            return False
        try:
            return self._mates() > 0
        except Exception:  # dsql: allow-broad-except — advisory probe: a
            # scheduler teardown race must not fail the leader's query
            logger.debug("family-mates probe failed", exc_info=True)
            return False

    def _mark_member(self, size: int) -> None:
        if size > 1:
            from ..observability import trace_event

            trace_event("family_batched", size=size)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "maxQueries": self.max_queries,
                "windowMs": self.window_s * 1000.0,
                "openGroups": len(self._groups),
            }
