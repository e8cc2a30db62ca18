"""MaterializationManager: the decide-and-act half of semantic reuse.

Copied from `dask_sql_tpu/materialize/manager.py`.  In the port a pinned
stem is a Table on the Context's device (the card unless the caller asked
for the CPU): the pin pass runs the full-width stem there once, an append
runs it over the delta slice alone and concatenates on the device, and a
rewritten plan scans the pinned table on the interpreted walk.  A card
Context re-filters only cached rows that lie on the card
(`subsume.servable_on`).  Port tables are never padded; the reference's
``row_valid`` decline of a stem over padded, sharded storage is a decline
of a sharded table here.

Three answering tiers sit above the exact-match result cache, all owned by
this manager (one per Context, ``context.materialize``):

1. **Sub-plan materialization** — the observe→decide→act loop over plan
   *prefixes*: every executed query's scan->filter stem is fingerprinted
   (`families.compute_stem`); a stem observed ``serving.materialize
   .min_hits`` times whose estimator byte floor fits the
   ``serving.materialize.max_bytes`` budget is pinned as a device-resident
   table (one interpreted pass, zero compiles).  Incoming plans whose stem
   matches are rewritten to scan the pinned table instead — the stem's
   filters never re-execute, the base table is never re-scanned, and every
   node of the rewritten copy carries ``_dsql_skip_rungs`` for ALL
   compiled rungs (the compiled pipelines resolve tables through the
   catalog and would silently compute over the UNFILTERED base table).
   Pinned bytes are charged to the HBM ledger's ``materialized`` component.
2. **Subsumption answering** — cached results register as candidates per
   family; a new query whose parameter intervals are provably contained in
   a candidate's (materialize/subsume.py over the estimator's interval
   algebra) is served by re-filtering the cached result.  The candidate's
   cache key must match the incoming key in every part except the
   parameter values — catalog epochs, table uids and config all live in
   the key, so a stale candidate can never serve.
3. **Incremental maintenance** — materialize/incremental.py: streamed
   combine states folded forward on `Context.append_rows`.

Everything here is advisory: any internal failure falls back to normal
execution (`try_*` returns None), never a wrong answer or a failed query.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..columnar.table import Table
from ..observability import flight
from ..planner import plan as p
from . import subsume
from .incremental import IncrementalStates

logger = logging.getLogger(__name__)

#: every ladder rung that resolves tables through the catalog (or keys a
#: compiled executable on catalog state) instead of the executor's
#: `table_overrides`.  A stem-rewritten plan MUST skip all of them: its
#: TableScan carries stripped filters whose effect lives only in the
#: override table, so a catalog-resolving rung would compute over the
#: unfiltered base rows.  The interpreted walk honors overrides.
CATALOG_RESOLVING_RUNGS = frozenset({
    "compiled_predict", "streamed_select", "spmd_select", "compiled_select",
    "streamed_aggregate", "spmd_join_aggregate", "spmd_aggregate",
    "compiled_join_aggregate", "compiled_aggregate", "dist_aggregate",
    "dist_sort",
})

#: subsumption candidates retained per family (newest win: dashboards
#: re-issue the widest filters periodically, so recency tracks utility)
_CANDIDATES_PER_FAMILY = 8

#: stem hit counters retained (observation state, not pinned bytes)
_MAX_STEM_COUNTERS = 256


@dataclasses.dataclass
class _PinnedStem:
    """One device-resident materialized stem."""

    table: Table
    nbytes: int
    schema_name: str
    table_name: str
    uid: int                     # base DataContainer identity
    epoch: int                   # base table delta epoch at (re)build
    stem_plan: p.LogicalPlan     # literal-baked stem subtree (for refresh)
    fingerprint: str
    hits: int = 0


@dataclasses.dataclass
class _Candidate:
    """One cached result registered for subsumption answering."""

    key: Tuple                   # its exact result-cache key
    values: Tuple                # its parameter vector
    spec: subsume.SubsumeSpec
    deps: frozenset              # (schema, table) provenance


class MaterializationManager:
    """Per-Context semantic reuse: stems, subsumption, incremental."""

    def __init__(self, context):
        self.context = context
        self._lock = threading.RLock()
        #: (stem fingerprint, key_values) -> hit count (pre-pin observation)
        self._stem_hits: "OrderedDict[Tuple, int]" = OrderedDict()
        #: (stem fingerprint, key_values) -> pinned stem, LRU by last hit
        self._pinned: "OrderedDict[Tuple, _PinnedStem]" = OrderedDict()
        #: stems that failed the byte policy — never re-executed per query
        self._rejected: set = set()
        #: family fingerprint -> key_values -> candidate (LRU per family)
        self._subsume: Dict[str, "OrderedDict[Tuple, _Candidate]"] = {}
        self.incremental = IncrementalStates(context)

    # ------------------------------------------------------------- config
    def _cfg(self, key: str, default):
        return self.context.config.get(key, default)

    def enabled(self) -> bool:
        return bool(self._cfg("serving.materialize.enabled", True))

    def subsumption_enabled(self) -> bool:
        return bool(self._cfg("serving.reuse.subsumption", True))

    # -------------------------------------------------------- ledger input
    def pinned_bytes(self) -> int:
        """Device bytes of every pinned stem — the ledger's
        ``materialized`` component (observability/ledger.py)."""
        with self._lock:
            return sum(e.nbytes for e in self._pinned.values())

    def reclaim_bytes(self, bytes_needed: Optional[int] = None) -> int:
        """Pressure reclaim (resilience/pressure.py tier 2): evict
        LRU-coldest pinned stems until at least ``bytes_needed`` are freed
        (``None`` = drop every pin); returns bytes actually freed.  A
        dropped stem just re-pins once traffic re-earns its hit count."""
        freed = 0
        with self._lock:
            while self._pinned and (bytes_needed is None
                                    or freed < bytes_needed):
                key = next(iter(self._pinned))
                freed += self._pinned[key].nbytes
                self._evict_locked(key, "pressure")
        return freed

    # ===================================================== answering tiers
    def try_reuse(self, plan: p.LogicalPlan, family,
                  key: Optional[Tuple]) -> Optional[Tuple[Table, str]]:
        """The semantic answering tiers, tried after an exact-cache miss:
        (table, tier) or None.  `key` is the query's exact cache key."""
        if family is None or key is None:
            return None
        out = self._try_incremental(plan, family)
        if out is not None:
            return out, "incremental"
        out = self._try_subsumption(plan, family, key)
        if out is not None:
            return out, "subsumption"
        return None

    def _try_incremental(self, plan, family) -> Optional[Table]:
        try:
            out = self.incremental.answer(plan, family)
        except Exception:  # dsql: allow-broad-except — advisory reuse tier
            logger.debug("incremental answer failed", exc_info=True)
            return None
        if out is not None:
            self.context.metrics.inc("serving.reuse.incremental.hits")
            flight.record("materialize.hit", tier="incremental",
                          fingerprint=family.fingerprint)
        return out

    def _try_subsumption(self, plan, family, key) -> Optional[Table]:
        if not self.subsumption_enabled():
            return None
        metrics = self.context.metrics
        with self._lock:
            slot = self._subsume.get(family.fingerprint)
            candidates = list(reversed(slot.items())) if slot else []
        tried = False
        for values, cand in candidates:
            if values == family.key_values:
                continue  # identical query: the exact cache already missed
            # every key part except the parameter vector (slot 2) must
            # match — epochs, uids and config ride the key, so staleness
            # and config drift fail closed here
            if cand.key[:2] != key[:2] or cand.key[3:] != key[3:]:
                continue
            tried = True
            if not subsume.contains(cand.spec, values, family.key_values):
                continue
            cached = self.context._result_cache.get(cand.key)
            if cached is None:
                with self._lock:
                    slot = self._subsume.get(family.fingerprint)
                    if slot is not None:
                        slot.pop(values, None)
                continue
            if not subsume.servable_on(self.context.device, cached):
                continue  # rows on the host: a card Context runs afresh
            try:
                served = subsume.serve(cached, cand.spec, family.key_values)
            except Exception:  # dsql: allow-broad-except — advisory tier
                logger.debug("subsumption serve failed", exc_info=True)
                served = None
            if served is None:
                continue
            metrics.inc("serving.reuse.subsumption.hits")
            flight.record("materialize.hit", tier="subsumption",
                          fingerprint=family.fingerprint)
            return served
        if tried:
            metrics.inc("serving.reuse.subsumption.declined")
        return None

    # ======================================================== stem rewrite
    def try_stem_rewrite(self, plan: p.LogicalPlan
                         ) -> Optional[Tuple[p.LogicalPlan, Dict]]:
        """(rewritten plan copy, executor table overrides) scanning a
        pinned stem instead of the base table, or None.  The copy's nodes
        all carry `_dsql_skip_rungs` = `CATALOG_RESOLVING_RUNGS` — the
        interpreted walk is the only path that honors the override."""
        if not self.enabled():
            return None
        from .. import families

        try:
            si = families.compute_stem(plan)
        except Exception:  # dsql: allow-broad-except — advisory analysis
            logger.debug("stem fingerprint failed", exc_info=True)
            return None
        if si is None:
            return None
        stem, scan, info = si.stem, si.scan, si.info
        key = (info.fingerprint, info.key_values)
        ctx = self.context
        with self._lock:
            entry = self._pinned.get(key)
            if entry is None:
                return None
            container = ctx.schema.get(entry.schema_name)
            dc = container.tables.get(entry.table_name) if container else None
            if dc is None or dc.uid != entry.uid or entry.epoch != \
                    ctx.table_epoch(entry.schema_name, entry.table_name):
                self._evict_locked(key, "stale")
                return None
            entry.hits += 1
            self._pinned.move_to_end(key)
            pinned_table = entry.table
        try:
            copy = _copy_replacing(plan, stem,
                                   dataclasses.replace(scan, filters=[]))
        except Exception:  # dsql: allow-broad-except — an uncopyable node
            # shape simply keeps the normal execution path
            logger.debug("stem plan rewrite failed", exc_info=True)
            return None
        self.context.metrics.inc("serving.materialize.hits")
        flight.record("materialize.hit", tier="stem",
                      fingerprint=info.fingerprint)
        return copy, {(scan.schema_name, scan.table_name): pinned_table}

    # ========================================================= observation
    def observe(self, plan: p.LogicalPlan, family, key: Optional[Tuple],
                deps, result: Table) -> None:
        """Post-execution hook (cache-miss path): count the stem, register
        the result as a subsumption candidate, register the aggregate for
        incremental capture.  Advisory — failures are swallowed."""
        if key is None:
            return  # volatile / uncacheable queries must never seed reuse
        try:
            if self.enabled():
                self._observe_stem(plan)
            if self.subsumption_enabled() and family is not None:
                spec = subsume.analyze(plan, family)
                if spec is not None:
                    with self._lock:
                        slot = self._subsume.setdefault(
                            family.fingerprint, OrderedDict())
                        slot.pop(family.key_values, None)
                        slot[family.key_values] = _Candidate(
                            key, family.key_values, spec,
                            frozenset(deps or ()))
                        while len(slot) > _CANDIDATES_PER_FAMILY:
                            slot.popitem(last=False)
            self.incremental.register(plan, family)
        except Exception:  # dsql: allow-broad-except — observation must
            # never fail the query that just succeeded
            logger.debug("materialize observation failed", exc_info=True)

    def _observe_stem(self, plan: p.LogicalPlan) -> None:
        from .. import families

        si = families.compute_stem(plan)
        if si is None:
            return
        key = (si.info.fingerprint, si.info.key_values)
        with self._lock:
            if key in self._pinned or key in self._rejected:
                return
            hits = self._stem_hits.get(key, 0) + 1
            self._stem_hits[key] = hits
            self._stem_hits.move_to_end(key)
            while len(self._stem_hits) > _MAX_STEM_COUNTERS:
                self._stem_hits.popitem(last=False)
            if hits < int(self._cfg("serving.materialize.min_hits", 2)):
                return
        pressure = getattr(self.context, "pressure", None)
        if pressure is not None and pressure.suspend_speculative():
            # YELLOW band (resilience/pressure.py): a new pin is
            # speculative HBM growth — skip it.  The earned hit count
            # stays, so the next observation under GREEN pins immediately.
            self.context.metrics.inc("resilience.pressure.suspended")
            return
        # the pin's ledger charge is custodied by the manager: pressure
        # reclaim and staleness eviction release it via _evict_locked
        # dsql: allow-unpaired-effect — policy-driven eviction custody
        self._pin(si, key)

    def _pin(self, si, key) -> None:
        """Decide-and-act: estimator floor gate, one interpreted execution
        of the FULL-WIDTH stem (every table column, so any sibling's
        projection serves from the pinned rows), byte policy, LRU
        admission."""
        from .. import families

        ctx = self.context
        metrics = ctx.metrics
        scan, info = si.scan, si.info
        max_bytes = int(self._cfg("serving.materialize.max_bytes",
                                  128 << 20))
        min_bytes = int(self._cfg("serving.materialize.min_bytes", 1024))
        container = ctx.schema.get(scan.schema_name)
        dc = container.tables.get(scan.table_name) if container else None
        if dc is None:
            return
        from ..datacontainer import LazyParquetContainer

        if isinstance(dc, LazyParquetContainer):
            return  # file-backed rows can change without a catalog bump
        from ..parallel.dist_plan import table_is_sharded

        if table_is_sharded(dc.table):
            return  # sharded storage belongs to the sharded rungs
        exec_stem = families.full_width_stem(si, dc.table)
        if exec_stem is None:
            metrics.inc("serving.materialize.declined")
            with self._lock:
                self._rejected.add(key)
            return
        # estimator floor: a stem whose PROVABLE result bytes already
        # exceed the budget must not even execute the pin pass
        try:
            from ..analysis.estimator import estimate_plan

            est = estimate_plan(exec_stem, context=ctx)
            if est.result_bytes.lo > max_bytes:
                metrics.inc("serving.materialize.declined")
                with self._lock:
                    self._rejected.add(key)
                return
        except Exception:  # dsql: allow-broad-except — the estimate is a
            # pre-gate; the post-execution byte check below still enforces
            logger.debug("stem estimate failed", exc_info=True)
        try:
            from ..physical.executor import Executor

            table = Executor(ctx).execute(exec_stem)
        except Exception:  # dsql: allow-broad-except — a failed pin pass
            # must never surface into the query that triggered it
            logger.debug("stem pin execution failed", exc_info=True)
            metrics.inc("serving.materialize.declined")
            return
        from ..serving.cache import table_nbytes

        nbytes = table_nbytes(table)
        if nbytes < min_bytes or nbytes > max_bytes:
            metrics.inc("serving.materialize.declined")
            with self._lock:
                self._rejected.add(key)
            return
        epoch = ctx.table_epoch(scan.schema_name, scan.table_name)
        with self._lock:
            self._stem_hits.pop(key, None)
            self._pinned[key] = _PinnedStem(
                table=table, nbytes=nbytes, schema_name=scan.schema_name,
                table_name=scan.table_name, uid=dc.uid, epoch=epoch,
                stem_plan=exec_stem, fingerprint=info.fingerprint)
            while sum(e.nbytes for e in self._pinned.values()) > max_bytes \
                    and len(self._pinned) > 1:
                old_key = next(iter(self._pinned))
                self._evict_locked(old_key, "pressure")
        metrics.inc("serving.materialize.stored")
        flight.record("materialize.store", fingerprint=info.fingerprint,
                      table=f"{scan.schema_name}.{scan.table_name}",
                      bytes=nbytes)

    def _evict_locked(self, key, reason: str) -> None:
        # caller holds the lock (self-lint DSQL201 *_locked convention)
        entry = self._pinned.pop(key, None)
        if entry is None:
            return
        self.context.metrics.inc("serving.materialize.evicted")
        flight.record("materialize.evict", fingerprint=entry.fingerprint,
                      reason=reason, bytes=entry.nbytes)

    # ======================================================== maintenance
    def on_append(self, schema_name: str, table_name: str, dc,
                  old_rows: int, epoch: int) -> None:
        """Append notification (Context.append_rows): refresh dependent
        pinned stems over ONLY the delta slice, fold incremental states."""
        tkey = (schema_name, table_name)
        new_rows = int(dc.table.num_rows)
        delta_rows = new_rows - old_rows
        with self._lock:
            targets = [(k, e) for k, e in self._pinned.items()
                       if (e.schema_name, e.table_name) == tkey]
            for key, entry in targets:
                if entry.uid != dc.uid or delta_rows < 0:
                    self._evict_locked(key, "append")
                    continue
                try:
                    if delta_rows > 0:
                        from ..physical.executor import Executor

                        ex = Executor(self.context)
                        ex.table_overrides[tkey] = \
                            dc.table.slice(old_rows, new_rows)
                        part = ex.execute(entry.stem_plan)
                        entry.table = Table.concat([entry.table, part])
                        from ..serving.cache import table_nbytes

                        entry.nbytes = table_nbytes(entry.table)
                    entry.epoch = epoch
                    self.context.metrics.inc("serving.materialize.refreshed")
                    flight.record("materialize.refresh",
                                  fingerprint=entry.fingerprint,
                                  table=f"{schema_name}.{table_name}",
                                  delta_rows=delta_rows)
                except Exception:  # dsql: allow-broad-except — a failed
                    # refresh evicts (the next query re-pins); it must not
                    # fail the append
                    logger.debug("stem refresh failed; evicting",
                                 exc_info=True)
                    self._evict_locked(key, "refresh_failed")
        self.incremental.on_append(schema_name, table_name, dc, old_rows,
                                   epoch)

    def invalidate_tables(self, tables) -> int:
        """Targeted invalidation (replace / drop / non-append DDL): evict
        exactly the state depending on these (schema, table) names."""
        targets = set(tables)
        n = 0
        with self._lock:
            for key in [k for k, e in self._pinned.items()
                        if (e.schema_name, e.table_name) in targets]:
                self._evict_locked(key, "invalidated")
                n += 1
            for fam, slot in list(self._subsume.items()):
                for values in [v for v, c in slot.items()
                               if c.deps & targets or not c.deps]:
                    del slot[values]
                    n += 1
                if not slot:
                    del self._subsume[fam]
        n += self.incremental.invalidate_tables(targets)
        return n

    def invalidate_all(self) -> int:
        with self._lock:
            n = len(self._pinned)
            for key in list(self._pinned):
                self._evict_locked(key, "invalidated")
            n += sum(len(s) for s in self._subsume.values())
            self._subsume.clear()
            self._stem_hits.clear()
            self._rejected.clear()
        n += self.incremental.invalidate_all()
        return n

    # ------------------------------------------------------------- surface
    def rows(self) -> List[Tuple[str, str, str, int, int, int, int]]:
        """``SHOW MATERIALIZED`` rows: (kind, fingerprint, table, rows,
        bytes, hits, epoch) — pinned stems then incremental states."""
        out: List[Tuple[str, str, str, int, int, int, int]] = []
        with self._lock:
            for entry in self._pinned.values():
                out.append(("stem", entry.fingerprint,
                            f"{entry.schema_name}.{entry.table_name}",
                            int(entry.table.num_rows), entry.nbytes,
                            entry.hits, entry.epoch))
        for fp, sname, tname, rows, epoch, hits in self.incremental.rows():
            out.append(("incremental", fp, f"{sname}.{tname}", rows, 0,
                        hits, epoch))
        return out


def _copy_replacing(node: p.LogicalPlan, target: p.LogicalPlan,
                    replacement: p.LogicalPlan) -> p.LogicalPlan:
    """Deep structural copy of ``node`` with the ``target`` subtree (by
    identity) swapped for ``replacement``, and EVERY copied node tagged to
    skip the catalog-resolving rungs.  Plans in the plan cache are shared
    across concurrent executions — the rewrite must never mutate or tag
    the original nodes."""
    if node is target:
        out = replacement
    else:
        kids = node.inputs()
        if kids:
            out = node.with_inputs([_copy_replacing(c, target, replacement)
                                    for c in kids])
        else:
            out = dataclasses.replace(node)
    if out is node:
        raise ValueError("plan node copy returned the shared original")
    out._dsql_skip_rungs = frozenset(
        getattr(node, "_dsql_skip_rungs", frozenset())
    ) | CATALOG_RESOLVING_RUNGS
    return out
