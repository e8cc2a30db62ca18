"""Compiled join->aggregate pipeline: the whole probe side in one pass.

Counterpart of `dask_sql_tpu/physical/compiled_join.py`.  For left-deep
chains of INNER equijoins whose build sides have unique dense integer keys
(every PK/FK star join of TPC-H), each probe row matches at most one build
row, so scan filters, the joins, projection arithmetic and the segment
aggregation run over the probe table's rows without materializing a join:

    build sides  : executed eagerly (small after their filters); one
                   value-indexed lookup table per build key, built once per
                   table version and kept in the pipeline cache
    probe side   : filters become masks (nothing compacts), joins become
                   ``lut[key - rmin]`` gathers carrying a matched mask, and
                   build columns are gathered through that row pointer
    aggregation  : group keys that the build row of one join determines make
                   that pointer the segment id; other keys take a radix id

The segment reduction is the shared `SegmentReducer` (the hand-written
segment-sum kernel where the group domain fits it), and the group table
reaches the host in one transfer of one packed float64 matrix, the group
key values of a pointer id riding along.  The probe table's encoded
columns are read as codes (code-space filters, DICT and FOR group keys as
radix digits, decode where an expression reads values); an RLE probe
column makes the pipeline decline.  A sharded probe runs here on its
global columns when the sharded rung (`spmd/join.py`, which runs
`_register_run` a shard) steps down.  Left out of the reference's version:
the lazy parquet scan and observability.  The probe
side's literals lift into the family's parameters (`families/`), so one
pipeline serves every literal of a family.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass, replace as _rp
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.dtypes import STRING_TYPES, SqlType, sql_to_np
from ..columnar.encodings import Encoding
from ..columnar.table import Table
from ..datacontainer import LazyParquetContainer
from ..ops import segsum as segsum_ops
from ..ops.join import dense_unique_lut
from ..planner import plan as p
from ..planner.expressions import (
    ColumnRef,
    Expr,
    shift_columns,
    transform,
    walk,
)
from ..resilience import faults
from .. import families
from .compiled import (
    PARAMS_SLOT,
    SegmentReducer,
    _ColMeta,
    _TableMeta,
    _TraceEval,
    _Unsupported,
    check_agg_static_support,
    check_no_rle,
    check_no_subquery,
    count_codespace_predicates,
    evict,
    has_encoded,
    decode_agg_columns,
    decode_radix_keys,
    fetch_packed,
    global_row_of_nothing,
    group_table,
    assemble_agg_outputs,
    pack_flat,
    register_agg_outputs,
    singleflight_get_or_build,
    unpack_row,
)

logger = logging.getLogger(__name__)

_MAX_JOINS = 6


@dataclass(frozen=True)
class _BuildRef(Expr):
    """Placeholder ref to column `col` of build table `k` during extraction;
    rewritten to an extended-slot ColumnRef before the pipeline runs."""

    k: int
    col: int
    sql_type: SqlType
    nullable: bool = True

    def children(self):
        return []


class _Extraction:
    def __init__(self):
        self.scan: Optional[p.TableScan] = None
        self.conjuncts: List[Expr] = []  # over global space (probe + _BuildRef)
        self.joins: List[dict] = []  # {"plan": right subplan, "lkey", "rkey"}


def _rewrite(expr: Expr, slots: List[Expr]) -> Expr:
    """Bind `expr`'s ColumnRefs (input-schema positions) to slot exprs."""

    def fn(x):
        if isinstance(x, ColumnRef) and type(x) is ColumnRef:
            return slots[x.index]
        return x

    return transform(expr, fn)


def _walk_left_spine(node, ext: _Extraction) -> Optional[List[Expr]]:
    """The node's output as a list of slot exprs, or None to decline.

    Probe-side columns and computations stay exprs over the scan schema;
    build-side columns become _BuildRef markers.  Filters anywhere on the
    spine become conjuncts: an INNER-join chain is a pure AND pipeline, so
    where a predicate sits does not change the final row mask."""
    if isinstance(node, p.SubqueryAlias):
        return _walk_left_spine(node.inputs()[0], ext)
    if isinstance(node, p.Projection):
        inner = _walk_left_spine(node.input, ext)
        if inner is None:
            return None
        return [_rewrite(e, inner) for e in node.exprs]
    if isinstance(node, p.Filter):
        inner = _walk_left_spine(node.input, ext)
        if inner is None:
            return None
        ext.conjuncts.append(_rewrite(node.predicate, inner))
        return inner
    if isinstance(node, p.Join):
        if node.join_type != "INNER" or node.filter is not None:
            return None
        if len(node.on) != 1 or len(ext.joins) >= _MAX_JOINS:
            return None
        left = _walk_left_spine(node.left, ext)
        if left is None:
            return None
        k = len(ext.joins)
        lkey_raw, rkey_raw = node.on[0]
        lkey = _rewrite(lkey_raw, left)
        rkey = shift_columns(rkey_raw, -len(node.left.schema))
        ext.joins.append({"plan": node.right, "lkey": lkey, "rkey": rkey})
        rslots = [_BuildRef(k, j, f.sql_type, f.nullable)
                  for j, f in enumerate(node.right.schema)]
        return left + rslots
    if isinstance(node, p.TableScan):
        if ext.scan is not None:
            return None  # a second scan can only mean a non-left-deep shape
        ext.scan = node
        ext.conjuncts.extend(node.filters)
        return [ColumnRef(j, f.name, f.sql_type, f.nullable)
                for j, f in enumerate(node.schema)]
    return None


def _extract(agg: p.Aggregate):
    ext = _Extraction()
    slots = _walk_left_spine(agg.input, ext)
    if slots is None or ext.scan is None or not ext.joins:
        return None
    group_exprs = [_rewrite(e, slots) for e in agg.group_exprs]
    agg_exprs = []
    for a in agg.agg_exprs:
        new_args = tuple(_rewrite(x, slots) for x in a.args)
        new_filter = _rewrite(a.filter, slots) if a.filter is not None else None
        agg_exprs.append(_rp(a, args=new_args, filter=new_filter))
    return ext, group_exprs, agg_exprs


def _choose_gid_join(ext, group_exprs) -> Optional[Tuple[int, List[int]]]:
    """A join k whose build-row pointer can serve as the segment id.

    Sound only when the group keys determine the build row: they must
    include join k's key (the probe-side expr or the build key column), and
    every other key must be a column of build k.  Grouping by a non-key
    build column (a category shared by many rows) must not use the pointer,
    which would split a group per build row; that case takes the radix id.
    Returns (k, build column per group expr); k = -1 for a global
    aggregate."""
    if not group_exprs:
        return (-1, [])
    for k in range(len(ext.joins) - 1, -1, -1):
        rkey = ext.joins[k]["rkey"]
        if not (isinstance(rkey, ColumnRef) and type(rkey) is ColumnRef):
            continue
        cols = []
        has_key = False
        ok = True
        for g in group_exprs:
            if g == ext.joins[k]["lkey"] or (
                    isinstance(g, _BuildRef) and g.k == k
                    and g.col == rkey.index):
                cols.append(rkey.index)
                has_key = True
            elif isinstance(g, _BuildRef) and g.k == k:
                cols.append(g.col)
            else:
                ok = False
                break
        if ok and has_key:
            return (k, cols)
    return None


class CompiledJoinAggregate:
    """One scan->joins->aggregate pipeline, planned on concrete tables.  It
    keeps the build keys' lookup tables; `run` takes the tables of each
    query."""

    def __init__(self, rel: p.Aggregate, ext: _Extraction, group_exprs,
                 agg_exprs, probe_table: Table, build_tables: List[Table],
                 executor):
        self.rel = rel
        self.n_joins = len(ext.joins)
        check_agg_static_support(agg_exprs)
        check_no_rle(probe_table)
        check_no_subquery(list(ext.conjuncts) + [
            x for a in agg_exprs for x in list(a.args) + [a.filter]])
        #: compressed-domain accounting: the probe scan reads encoded bytes
        self.has_encoded = has_encoded(probe_table)

        choice = _choose_gid_join(ext, group_exprs)
        if choice is not None:
            self.gid_join, self.group_cols = choice
            self.radix_spec = None
        else:
            self.gid_join, self.group_cols = None, []
            self.radix_spec = self._plan_radix(group_exprs, probe_table,
                                               build_tables)

        # per build table: its key's lookup table, kept across runs of the
        # same table versions by the pipeline cache
        self.luts: List[Tuple[int, torch.Tensor]] = []
        for j, bt in zip(ext.joins, build_tables):
            kc = executor.eval_expr(j["rkey"], bt)
            if kc.sql_type in STRING_TYPES:
                raise _Unsupported("string join key")
            prep = dense_unique_lut(kc.data, kc.validity)
            if prep is None:
                raise _Unsupported("build keys not unique-dense ints")
            self.luts.append(prep)

        # global slot space: probe scan columns, then every _BuildRef used
        n_probe = len(probe_table.column_names)
        used: Dict[Tuple[int, int], int] = {}
        all_exprs = (ext.conjuncts + [j["lkey"] for j in ext.joins]
                     + [x for a in agg_exprs for x in a.args]
                     + [a.filter for a in agg_exprs if a.filter is not None])
        if self.radix_spec is not None:
            all_exprs = all_exprs + list(group_exprs)
        for e in all_exprs:
            for sub in walk(e):
                if isinstance(sub, _BuildRef):
                    used.setdefault((sub.k, sub.col), n_probe + len(used))
        self.used_build_slots = used

        def finalize(expr):
            def fn(x):
                if isinstance(x, _BuildRef):
                    return ColumnRef(used[(x.k, x.col)], f"__b{x.k}_{x.col}",
                                     x.sql_type, x.nullable)
                return x

            return transform(expr, fn)

        self.conjuncts = [finalize(e) for e in ext.conjuncts]
        self.lkeys = [finalize(j["lkey"]) for j in ext.joins]
        for lk in self.lkeys:
            if lk.sql_type in STRING_TYPES or np.dtype(
                    sql_to_np(lk.sql_type)).kind not in "iuM":
                raise _Unsupported("probe join key not an integer")
        if self.radix_spec is not None:
            self.radix_spec = [dict(s, ref=finalize(s["ref"]),
                                    col=_ColMeta(s["col"]))
                               for s in self.radix_spec]
        self.agg_exprs = [
            _rp(a, args=tuple(finalize(x) for x in a.args),
                filter=finalize(a.filter) if a.filter is not None else None)
            for a in agg_exprs]

        meta_cols = [_ColMeta(probe_table.columns[n])
                     for n in probe_table.column_names]
        meta_names = list(probe_table.column_names)
        for (k, col), _slot in sorted(used.items(), key=lambda kv: kv[1]):
            bt = build_tables[k]
            meta_cols.append(_ColMeta(bt.columns[bt.column_names[col]]))
            meta_names.append(f"__b{k}_{col}")
        self._ev = _TraceEval(_TableMeta(columns=meta_cols, names=meta_names,
                                         device=probe_table.device))
        self.codespace_preds = count_codespace_predicates(
            list(self.conjuncts)
            + [x for a in self.agg_exprs for x in list(a.args)
               + ([a.filter] if a.filter is not None else [])],
            self._ev.table) if self.has_encoded else 0
        if self.gid_join is not None and self.gid_join >= 0:
            bt = build_tables[self.gid_join]
            self.group_meta = [_ColMeta(bt.columns[bt.column_names[c]])
                               for c in self.group_cols]
        else:
            self.group_meta = []
        # one segment-sum mode per pipeline, from the group domain: the
        # radix product, or the gid build table's row count for a pointer
        if self.radix_spec is not None:
            domain = 1
            for s in self.radix_spec:
                domain *= s["r"]
        elif self.gid_join is not None and self.gid_join >= 0:
            domain = build_tables[self.gid_join].num_rows
        else:
            domain = 1
        self.domain = domain
        self.segsum_mode = segsum_ops.choose_segsum_impl(
            executor.config, domain, probe_table.device)

    @staticmethod
    def _plan_radix(group_exprs, probe_table, build_tables):
        """Mixed-radix gid plan over the group-key columns (the scheme of
        CompiledAggregate: dictionary strings, bools and small integer
        ranges, one extra code per key for NULL)."""
        from ..ops.grouping import RADIX_DOMAIN_LIMIT, resolve_int_bounds

        spec = []
        pending = []  # (slot, device min, device max): ONE pull for all keys
        for g in group_exprs:
            if isinstance(g, _BuildRef):
                bt = build_tables[g.k]
                col = bt.columns[bt.column_names[g.col]]
            elif isinstance(g, ColumnRef) and type(g) is ColumnRef:
                col = probe_table.columns[probe_table.column_names[g.index]]
            else:
                raise _Unsupported("non-column group key")
            if col.sql_type in STRING_TYPES and col.dictionary is not None:
                spec.append({"ref": g, "kind": "str",
                             "r": len(col.dictionary) + 1, "off": 0,
                             "col": col})
            elif col.encoding is Encoding.DICT:
                # numeric dictionary codes are the radix digits directly
                spec.append({"ref": g, "kind": "dict", "raw": True,
                             "r": len(col.enc_values) + 1, "off": 0,
                             "col": col})
            elif col.data.dtype == torch.bool:
                spec.append({"ref": g, "kind": "bool", "r": 3, "off": 0,
                             "col": col})
            elif not col.data.is_floating_point() and len(col):
                # PLAIN values and FOR codes alike: the bounds are over the
                # stored ints; the run reads a FOR key's codes and the host
                # decode maps them back through the affine
                pending.append((len(spec), col.data.min(), col.data.max()))
                spec.append({"ref": g, "kind": "int", "r": None, "off": None,
                             "col": col,
                             "raw": col.encoding is Encoding.FOR})
            else:
                raise _Unsupported("group key not radix-encodable")
        spans = resolve_int_bounds(pending, RADIX_DOMAIN_LIMIT)
        if spans is None:
            raise _Unsupported("integer key range too large")
        for slot, (span, lo) in spans.items():
            spec[slot]["r"] = span + 1
            spec[slot]["off"] = lo
        domain = 1
        for entry in spec:
            domain *= entry["r"]
            if domain > RADIX_DOMAIN_LIMIT:
                raise _Unsupported("group domain too large")
        return spec

    def _probe(self, kd: torch.Tensor, rmin: int, lut: torch.Tensor):
        """Build row of each probe key (-1: none), by one gather."""
        size = lut.shape[0]
        # widen sub-int32 keys before subtracting (narrow dtypes overflow
        # under `key - rmin`); when rmin does not fit the key dtype, work
        # in int64.  A key far outside the build range must not wrap back
        # into [0, size): bound the key itself first
        if kd.dtype == torch.bool or kd.element_size() < 4:
            kd = kd.to(torch.int32)
        if rmin:
            info = torch.iinfo(kd.dtype)
            if info.min <= rmin <= info.max:
                hi = min(rmin + size - 1, info.max)
                inb = (kd >= rmin) & (kd <= hi)
                idx = torch.where(inb, kd - rmin, 0)
            else:
                idx = kd.to(torch.int64) - rmin
                inb = (idx >= 0) & (idx < size)
        else:
            idx = kd
            inb = (idx >= 0) & (idx < size)
        return torch.where(inb, lut[torch.clamp(idx, 0, size - 1)], -1)

    def run(self, probe_table: Table, build_tables: List[Table],
            params: Tuple = ()) -> Table:
        """One query over the probe and build tables, with its family's
        parameter values."""
        reducer, hit_h, plans = self._register_run(
            self._ev, probe_table, build_tables, params, SegmentReducer)
        reducer.finish()
        return self._finish_run(reducer, hit_h, plans, build_tables)

    def _register_run(self, ev, probe_table: Table, build_tables: List[Table],
                      params: Tuple, reducer_cls):
        """The probe, the joins and the filters over the probe table's rows,
        and every reduction registered on a new ``reducer_cls`` reducer,
        not yet finished: (reducer, hit handle, plans).  The sharded rung
        (`spmd/join.py`) runs it a shard, over the shard's probe block."""
        n_rows = probe_table.num_rows
        device = probe_table.device
        slots: Dict = {
            i: (c.data, c.validity)
            for i, c in enumerate(probe_table.columns.values())}
        slots[PARAMS_SLOT] = tuple(params)
        mask = torch.ones(n_rows, dtype=torch.bool, device=device)
        ri_safe: List[torch.Tensor] = []
        for k in range(self.n_joins):
            kd, kv = ev.eval(self.lkeys[k], slots)
            rmin, lut = self.luts[k]
            ri = self._probe(kd, rmin, lut.to(device))
            if kv is not None:
                ri = torch.where(kv, ri, -1)
            matched = ri >= 0
            mask = mask & matched
            safe = torch.clamp(ri, min=0)
            ri_safe.append(safe)
            # this build table's used columns, gathered into the slot space
            # so later keys, filters and aggregates can reference them
            bt = build_tables[k]
            for (bk, col), slot in self.used_build_slots.items():
                if bk != k:
                    continue
                c = bt.columns[bt.column_names[col]]
                v = matched if c.validity is None else (matched & c.validity[safe])
                slots[slot] = (c.data[safe], v)
        for f in self.conjuncts:
            d, v = ev.eval(f, slots)
            mask = mask & (d if v is None else (d & v))
        if self.radix_spec is not None:
            gid = torch.zeros(n_rows, dtype=torch.int32, device=device)
            for s in self.radix_spec:
                if s.get("raw"):
                    # an encoded key: its CODES are the radix digits
                    d, v = slots[s["ref"].index]
                else:
                    d, v = ev.eval(s["ref"], slots)
                r = s["r"]
                if s["kind"] == "bool":
                    code = d.to(torch.int32)
                else:
                    # widen narrow ints, subtract the offset in the source
                    # dtype, then narrow: the span always fits int32
                    if d.element_size() < 4:
                        d = d.to(torch.int32)
                    if s["off"]:
                        d = d - s["off"]
                    code = d.to(torch.int32)
                code = torch.clamp(code, 0, r - 2)
                if v is not None:
                    code = torch.where(v, code, r - 1)
                gid = gid * r + code
        elif self.gid_join is None or self.gid_join < 0:
            gid = torch.zeros(n_rows, dtype=torch.int32, device=device)
        else:
            gid = ri_safe[self.gid_join].to(torch.int32)

        reducer = reducer_cls(gid, self.domain, self.segsum_mode, n_rows)
        hit_h = reducer.count(mask)
        plans = register_agg_outputs(ev, slots, self.agg_exprs, mask,
                                     reducer)
        return reducer, hit_h, plans

    def _finish_run(self, reducer, hit_h, plans,
                    build_tables: List[Table]) -> Table:
        """The outputs of a finished run packed, pulled in one transfer
        and decoded."""
        outs = assemble_agg_outputs(plans, reducer)
        hit = reducer.get(hit_h) > 0
        flat = [hit]
        for d, v in outs:
            flat.append(d)
            flat.append(v if v is not None else torch.ones_like(hit))
        if self.group_meta:
            # a pointer gid's group keys are the build row's columns: they
            # ride the same transfer, one row per build row
            bt = build_tables[self.gid_join].to(hit.device)
            for col_idx in self.group_cols:
                c = bt.columns[bt.column_names[col_idx]]
                flat.append(c.data)
                flat.append(c.validity if c.validity is not None
                            else torch.ones_like(hit))
        tags: List[Tuple[str, np.dtype]] = []
        packed = pack_flat(flat, tags)
        host, present = fetch_packed(packed, self.domain)
        return self._decode_result(host, present, tags)

    def _decode_result(self, host: np.ndarray, present: np.ndarray,
                       tags) -> Table:
        if self.radix_spec is not None:
            keys = decode_radix_keys(present, [(s["col"], s["r"], s["off"])
                                               for s in self.radix_spec])
        else:
            if not self.group_meta and present.shape[0] == 0:
                host, present = global_row_of_nothing(host, self.rel.agg_exprs)
            # a pointer gid's key values rode the pack, after the aggregates
            base = 1 + 2 * len(self.rel.agg_exprs)
            keys = []
            for j, meta in enumerate(self.group_meta):
                d = unpack_row(host, base + 2 * j, tags)
                v = unpack_row(host, base + 2 * j + 1, tags) != 0.0
                keys.append(Column.from_parts(d, None if bool(v.all()) else v,
                                              meta.dictionary, meta.sql_type))
        cols = keys + decode_agg_columns(host, tags, self.rel.agg_exprs)
        return group_table(self.rel, cols, present)


def _plan_nodes(node):
    yield node
    for k in node.inputs():
        yield from _plan_nodes(k)


#: LRU of pipelines; an entry keeps its lookup tables on the device across
#: runs of the same table versions, capped so stale versions cannot pin
#: device memory for ever, and evicted with its Context
#: (`compiled.pipeline_owner`)
_CACHE_CAP = 16
_cache: "OrderedDict[tuple, CompiledJoinAggregate]" = OrderedDict()
#: plan shapes known ineligible, checked before any build side runs; keys
#: carry table uids, so the set is reset wholesale at a small cap
_DECLINED_CAP = 256
_declined: set = set()


def try_compiled_join_aggregate(rel: p.Aggregate, executor) -> Optional[Table]:
    """Run an Aggregate over a join chain as one pipeline (each run counted
    in ``metrics.counter("compiled_join.run")``); None when the plan is not such a
    chain or the pipeline declines it (counted in
    ``metrics.counter("compiled_join.declined")`` and logged)."""
    if not executor.config.get("sql.compile", True):
        return None
    if not executor.config.get("sql.compile.join_pipeline", True):
        return None
    extraction = _extract(rel)
    if extraction is None:
        return None
    ext, group_exprs, agg_exprs = extraction
    ctx = executor.context
    decline_key = None
    compiled = None
    try:
        dc = ctx.schema[ext.scan.schema_name].tables.get(ext.scan.table_name)
        if dc is None or isinstance(dc, LazyParquetContainer):
            # a lazy parquet probe keeps the eager scan, where its filters
            # (dynamic partition pruning's too) reach pyarrow
            return None
        # every base table version (uid and delta epoch) keys the cache: the
        # lookup tables are baked per build-table contents
        uids = [(dc.uid, ctx.table_epoch(ext.scan.schema_name,
                                         ext.scan.table_name))]
        for j in ext.joins:
            for node in _plan_nodes(j["plan"]):
                if isinstance(node, p.TableScan):
                    bdc = ctx.schema[node.schema_name].tables.get(node.table_name)
                    if bdc is None:
                        return None
                    uids.append((bdc.uid, ctx.table_epoch(node.schema_name,
                                                          node.table_name)))
        decline_key = (tuple(uids), str(rel))
        if decline_key in _declined:
            ctx.metrics.inc("compiled_join.declined")
            return None
        # plan-only checks before any build side runs
        check_agg_static_support(agg_exprs)
        # the probe side's conjuncts and the aggregate arguments take their
        # literals as the family's parameters; build-side literals stay
        # baked (they shape the build tables and their lookup tables) and
        # key the cache through the build plans' reprs
        pz = families.pipeline_parameterizer(executor.config)
        ext.conjuncts = [pz.rewrite(e) for e in ext.conjuncts]
        agg_exprs = [pz.rewrite_agg(a) for a in agg_exprs]
        params = pz.params
        probe_table = executor.get_table(ext.scan.schema_name,
                                         ext.scan.table_name)
        if ext.scan.projection is not None:
            probe_table = probe_table.select(ext.scan.projection)
        if not probe_table.column_names:
            return None
        # build sides run through the eager converters (filtered scans,
        # nested joins, anything), compacted
        # an aggregate's group table lives on the host: it moves to the
        # probe's device
        build_tables = [executor.execute(j["plan"]).to(probe_table.device)
                        for j in ext.joins]
        key = (
            tuple(uids),
            ext.scan.schema_name, ext.scan.table_name,
            tuple(ext.scan.projection or ()),
            tuple(repr(j["plan"]) for j in ext.joins),
            tuple(str(j["lkey"]) + "=" + str(j["rkey"]) for j in ext.joins),
            tuple(str(e) for e in ext.conjuncts),
            tuple(str(e) for e in group_exprs),
            tuple(str(a) for a in agg_exprs),
            tuple((f.name, f.sql_type) for f in rel.schema),
            probe_table.num_rows,
            tuple(bt.num_rows for bt in build_tables),
            str(executor.config.get("sql.compile.segsum", "auto")),
        )

        def build():
            return CompiledJoinAggregate(rel, ext, group_exprs, agg_exprs,
                                         probe_table, build_tables, executor)

        compiled, built_here = singleflight_get_or_build(
            _cache, key, build, "compiled_join_aggregate", ctx, _CACHE_CAP)
        if not built_here and params:
            ctx.metrics.inc("families.hit")
        if built_here and compiled.codespace_preds:
            ctx.metrics.inc("columnar.encoding.codespace_pred",
                            compiled.codespace_preds)
        faults.maybe_inject("oom", executor.config)
        from ..parallel import dist_plan

        if dist_plan.table_is_sharded(probe_table):
            # a sharded probe below its SPMD rung: the pipeline reads the
            # global columns on the first shard's device (the reference's
            # GSPMD run of the same pipeline); joined rows never
            # materialize anywhere
            dist_plan._stat("sharded_join_agg")
        result = compiled.run(probe_table, build_tables, params)
        ctx.metrics.inc("compiled_join.run")
        if compiled.has_encoded:
            ctx.metrics.inc("columnar.encoding.late_rows", result.num_rows)
        return result
    except _Unsupported as e:
        logger.info("compiled join pipeline declined the plan: %s", e)
        ctx.metrics.inc("compiled_join.declined")
        evict(_cache, compiled)
        if decline_key is not None:
            if len(_declined) >= _DECLINED_CAP:
                _declined.clear()
            _declined.add(decline_key)
        return None
