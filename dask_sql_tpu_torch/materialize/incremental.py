"""Incremental maintenance: streamed combine states as view states.

Copied from `dask_sql_tpu/materialize/incremental.py`.  In the port the
bootstrap and each fold are one `StreamedAggregate.run_partition` call,
that is one `ops/segsum.py` `segsum_typed` launch (the hand-written kernel
on the card up to its domain cutoff), and the float64 partial states stay
on the card between folds; an answer is the finalize alone (one packed
transfer, no launch).  The delta's group-key bounds are checked with one
min/max reduction on the device and one scalar pull per group column,
never a copy of the delta.  Float sums are grouped by fold, so an answer
is held to the float64 oracle; integer sums, counts, MIN and MAX are
exact.

The streamed aggregate rung (streaming/aggregate.py) already produces
checkpointable partial-combine states whose time-axis algebra is exactly
incremental view maintenance: an appended chunk of rows is one more
partition to fold.  This module stores those states per (aggregate family,
parameter values) and keeps them current across `Context.append_rows` /
``INSERT INTO``:

- **register** (query time, free): when an eligible aggregate query
  executes, remember its plan + family.  No state is computed here — a
  state build costs a full-table pass, and tables that never see appends
  never need one.
- **capture + fold** (append time): on the FIRST append to a table with
  registered aggregates, build the `StreamedAggregate` state over the
  pre-append rows (the one unavoidable bootstrap scan), then fold the
  appended chunk through it as one `run_partition` over the delta slice.
  Every later append folds ONLY its delta — history is never rescanned.
- **answer** (query time): a re-query of the family with the same
  parameter values finalizes the stored state — one host pull, zero scans,
  zero compiles — provided the state is current (same table uid, same
  delta epoch, rows covered == table rows).

Eligibility is conservative and validated at every fold; a violated
invariant drops the state (``serving.reuse.incremental.declined``), never
serves a wrong answer:

- plan root is the Aggregate (optionally under a bare-ColumnRef Projection
  / SubqueryAlias) whose scan->filter*->aggregate chain covers the whole
  plan;
- every projected input column is PLAIN-encoded, non-string, and keeps its
  dtype across the append (`concat_columns` promotes dtypes and remaps
  string dictionaries — either would silently shift the frozen trace's
  comparison/code domain);
- integer group-key values in the delta stay inside the construction-time
  radix bounds ``[offset, offset + radix - 2]`` — outside values would be
  silently clamped into the wrong group by the kernel's code clip.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from ..columnar.encodings import Encoding
from ..columnar.table import Table
from ..planner import plan as p
from ..planner.expressions import ColumnRef

logger = logging.getLogger(__name__)

#: registered families per (schema, table) — a bounded working set; LRU
#: beyond this would evict dashboards' own aggregates, so keep it small
#: and per-table
_MAX_PER_TABLE = 16


@dataclasses.dataclass
class _Registration:
    """One observed aggregate family over one table (no state yet)."""

    plan: p.LogicalPlan          # the literal-baked cached plan object
    family_fp: str
    key_values: Tuple
    schema_name: str
    table_name: str


@dataclasses.dataclass
class _State:
    """One live incremental view state."""

    reg: _Registration
    compiled: object             # StreamedAggregate (frozen radix plan)
    params: Tuple
    acc: List                    # running combined states (device arrays)
    proj_names: Tuple[str, ...]  # projected input column order
    col_dtypes: Tuple[str, ...]  # construction dtypes, append-validated
    group_names: Tuple[str, ...]
    uid: int                     # DataContainer identity the state tracks
    rows_covered: int
    epoch: int
    hits: int = 0


def _chain_of(plan: p.LogicalPlan):
    """(aggregate node, projection-or-None) when the plan is a whole-plan
    scan->filter*->aggregate chain, else None."""
    node = plan
    while isinstance(node, p.SubqueryAlias):
        node = node.input
    proj = None
    if isinstance(node, p.Projection):
        if not all(type(e) is ColumnRef for e in node.exprs):
            return None
        names = [f.name for f in node.schema]
        if len(set(names)) != len(names):
            return None  # duplicate output names: manual apply is ambiguous
        proj = node
        node = node.input
    if not isinstance(node, p.Aggregate):
        return None
    return node, proj


class IncrementalStates:
    """The per-Context incremental view-state store."""

    def __init__(self, context):
        self.context = context
        self._lock = threading.RLock()
        #: (schema, table) -> key -> _Registration | _State, insertion-LRU
        self._tables: Dict[Tuple[str, str],
                           "OrderedDict[Tuple, object]"] = {}

    def enabled(self) -> bool:
        return bool(self.context.config.get("serving.reuse.incremental",
                                            True))

    # ------------------------------------------------------------ register
    def register(self, plan: p.LogicalPlan, family) -> bool:
        """Query-time observation: remember this aggregate family so the
        next append can capture its state.  Cheap — shape checks only."""
        if not self.enabled() or family is None:
            return False
        got = _chain_of(plan)
        if got is None:
            return False
        agg, _ = got
        from ..physical.compiled import _extract_chain

        chain = _extract_chain(agg)
        if chain is None:
            return False
        scan = chain[0]
        ctx = self.context
        container = ctx.schema.get(scan.schema_name)
        dc = container.tables.get(scan.table_name) if container else None
        if dc is None:
            return False
        from ..datacontainer import LazyParquetContainer

        if isinstance(dc, LazyParquetContainer):
            return False
        key = (family.fingerprint, family.key_values)
        tkey = (scan.schema_name, scan.table_name)
        with self._lock:
            slot = self._tables.setdefault(tkey, OrderedDict())
            if key in slot:
                slot.move_to_end(key)
                return True
            slot[key] = _Registration(plan, family.fingerprint,
                                      family.key_values, *tkey)
            while len(slot) > _MAX_PER_TABLE:
                slot.popitem(last=False)
        return True

    # ------------------------------------------------------------- capture
    def _capture(self, reg: _Registration, dc, rows: int,
                 epoch: int) -> Optional[_State]:
        """Build the bootstrap state over the CURRENT first ``rows`` rows —
        the one full pass that turns a registration into a live view state.
        Called at append time with the pre-append row count."""
        from .. import families
        from ..physical.compiled import _Unsupported, _extract_chain
        from ..streaming.aggregate import StreamedAggregate
        from ..streaming.partition import slice_chunk

        got = _chain_of(reg.plan)
        if got is None:
            return None
        agg, _ = got
        chain = _extract_chain(agg)
        if chain is None:
            return None
        scan, filters, group_exprs, agg_exprs = chain
        table = dc.table
        if scan.projection is not None:
            table = table.select([c for c in scan.projection
                                  if c in table.columns])
        names = tuple(table.column_names)
        for n in names:
            col = table.columns[n]
            if col.encoding is not Encoding.PLAIN \
                    or col.dictionary is not None:
                # encoded codes / string dictionaries are frozen into the
                # trace; an append remaps both (concat.py) — not foldable
                return None
        if not all(isinstance(e, ColumnRef) and type(e) is ColumnRef
                   for e in group_exprs):
            return None
        group_names = tuple(names[e.index] for e in group_exprs)
        pz = families.pipeline_parameterizer(self.context.config)
        filters = [pz.rewrite(f) for f in filters]
        agg_exprs = [pz.rewrite_agg(a) for a in agg_exprs]
        try:
            # the pipeline keeps only the table's metadata, never its
            # buffers
            compiled = StreamedAggregate(agg, table, filters, group_exprs,
                                         agg_exprs)
        except (_Unsupported, ValueError, TypeError, NotImplementedError):
            return None
        if rows <= 0:
            acc = None
        else:
            chunk = slice_chunk(table, 0, rows)
            acc = compiled.combine(None,
                                   compiled.run_partition(chunk, pz.params))
        return _State(
            reg=reg, compiled=compiled, params=pz.params, acc=acc or [],
            proj_names=names,
            col_dtypes=tuple(str(table.columns[n].data.dtype)
                             for n in names),
            group_names=group_names, uid=dc.uid, rows_covered=rows,
            epoch=epoch)

    def _delta_in_bounds(self, state: _State, delta: Table) -> bool:
        """Validate the delta's group-key values against the frozen radix
        plan: a value outside ``[offset, offset + radix - 2]`` would be
        silently clamped into a neighboring group by the group id's code
        clip — the one corruption the static checks cannot rule out.  Per
        group column one min/max reduction on the delta's device (NULL
        rows left out) and one pull of the two scalars."""
        compiled = state.compiled
        for name, radix, offset, meta in zip(
                state.group_names, compiled.radices, compiled.offsets,
                compiled.gcols):
            col = delta.columns.get(name)
            if col is None:
                return False
            if meta.data.dtype == torch.bool:
                continue  # bool radix 3 covers {0, 1} by construction
            if not len(col):
                continue
            vals = col.data.to(torch.int64)
            if col.validity is None:
                lo, hi = torch.aminmax(vals)
            else:
                big = torch.iinfo(torch.int64)
                lo = torch.where(col.validity, vals, big.max).min()
                hi = torch.where(col.validity, vals, big.min).max()
            lo, hi = torch.stack([lo, hi]).tolist()
            if lo > hi:
                continue  # every delta key is NULL
            if lo < int(offset) or hi > int(offset) + int(radix) - 2:
                return False
        return True

    # ---------------------------------------------------------------- fold
    def on_append(self, schema_name: str, table_name: str, dc,
                  old_rows: int, epoch: int) -> Tuple[int, int]:
        """Append notification: capture missing states (bootstrap over the
        pre-append rows) and fold the delta partition through every state
        for this table.  Returns (folded, dropped) counts."""
        from ..streaming.partition import slice_chunk

        tkey = (schema_name, table_name)
        metrics = self.context.metrics
        folded = dropped = 0
        with self._lock:
            slot = self._tables.get(tkey)
            if not slot or not self.enabled():
                return 0, 0
            new_table = dc.table
            new_rows = int(new_table.num_rows)
            delta_rows = new_rows - old_rows
            for key in list(slot):
                entry = slot[key]
                if isinstance(entry, _Registration):
                    state = self._capture(entry, dc, old_rows, epoch - 1)
                    if state is None:
                        del slot[key]
                        dropped += 1
                        metrics.inc("serving.reuse.incremental.declined")
                        continue
                    slot[key] = entry = state
                state = entry
                ok = (state.uid == dc.uid
                      and state.rows_covered == old_rows
                      and delta_rows > 0)
                if ok:
                    proj = new_table
                    if set(state.proj_names) <= set(new_table.column_names):
                        proj = new_table.select(list(state.proj_names))
                    else:
                        ok = False
                if ok:
                    ok = tuple(str(proj.columns[n].data.dtype)
                               for n in state.proj_names) \
                        == state.col_dtypes \
                        and all(proj.columns[n].encoding is Encoding.PLAIN
                                and proj.columns[n].dictionary is None
                                for n in state.proj_names)
                if ok:
                    delta = slice_chunk(proj, old_rows, delta_rows)
                    ok = self._delta_in_bounds(state, delta)
                if not ok:
                    del slot[key]
                    dropped += 1
                    metrics.inc("serving.reuse.incremental.declined")
                    continue
                try:
                    states = state.compiled.run_partition(delta,
                                                          state.params)
                    state.acc = state.compiled.combine(
                        state.acc or None, states)
                except Exception:  # dsql: allow-broad-except — advisory
                    # reuse state: a fold failure falls back to full
                    # recomputation at the next query, never a wrong answer
                    logger.debug("incremental fold failed; dropping state",
                                 exc_info=True)
                    del slot[key]
                    dropped += 1
                    metrics.inc("serving.reuse.incremental.declined")
                    continue
                state.rows_covered = new_rows
                state.epoch = epoch
                folded += 1
                metrics.inc("serving.reuse.incremental.folds")
        return folded, dropped

    # -------------------------------------------------------------- answer
    def answer(self, plan: p.LogicalPlan, family) -> Optional[Table]:
        """Serve a query from its stored state: finalize (one host pull),
        then apply the plan's bare-ColumnRef root projection manually.
        None unless a CURRENT state exists for the exact family + values."""
        if not self.enabled() or family is None:
            return None
        got = _chain_of(plan)
        if got is None:
            return None
        agg, proj = got
        key = (family.fingerprint, family.key_values)
        ctx = self.context
        with self._lock:
            state = None
            for slot in self._tables.values():
                entry = slot.get(key)
                if isinstance(entry, _State):
                    state = entry
                    break
            if state is None:
                return None
            sname, tname = state.reg.schema_name, state.reg.table_name
            container = ctx.schema.get(sname)
            dc = container.tables.get(tname) if container else None
            if dc is None or dc.uid != state.uid \
                    or state.epoch != ctx.table_epoch(sname, tname) \
                    or state.rows_covered != int(dc.table.num_rows) \
                    or not state.acc:
                return None
            try:
                out = state.compiled.finalize(list(state.acc))
            except Exception:  # dsql: allow-broad-except — advisory reuse:
                # a finalize failure must fall back to normal execution
                logger.debug("incremental finalize failed", exc_info=True)
                return None
            state.hits += 1
        if proj is not None:
            cols = list(out.columns.values())
            if any(e.index >= len(cols) for e in proj.exprs):
                return None
            out = Table({f.name: cols[e.index]
                         for e, f in zip(proj.exprs, proj.schema)},
                        out.num_rows)
        return out

    # --------------------------------------------------------- invalidation
    def invalidate_tables(self, tables) -> int:
        n = 0
        with self._lock:
            for tkey in set(tables):
                slot = self._tables.pop(tkey, None)
                n += len(slot) if slot else 0
        return n

    def invalidate_all(self) -> int:
        with self._lock:
            n = sum(len(s) for s in self._tables.values())
            self._tables.clear()
        return n

    def rows(self) -> List[Tuple]:
        """(fingerprint, schema, table, rows_covered, epoch, hits) for the
        live states — the SHOW MATERIALIZED incremental section."""
        out = []
        with self._lock:
            for slot in self._tables.values():
                for entry in slot.values():
                    if isinstance(entry, _State):
                        out.append((entry.reg.family_fp,
                                    entry.reg.schema_name,
                                    entry.reg.table_name,
                                    entry.rows_covered, entry.epoch,
                                    entry.hits))
        return out
