"""Compiled root SELECT: two device programs and two transfers for a
root-level ``scan -> filter* -> project [-> sort -> limit]`` query.

Counterpart of `dask_sql_tpu/physical/compiled_select.py`.  The result of
a plan ROOT goes to the host anyway, so the chain runs as:

1. the mask program: every filter folds into one row mask (a LIMIT parked
   above the scan becomes a window over the survivor ordinal), and the
   running survivor count is kept; the count crosses to the host, the
   first transfer;
2. the gather program, sized to the power-of-two bucket above the count:
   the survivors' rows gather by a sized nonzero (a scatter of row ids to
   their ordinals, with no host sync), the projections evaluate over the
   bucket only, so an encoded column decodes only for the survivors, and
   every output and its validity pack into one float64 matrix, which
   crosses in the second transfer;
3. ORDER BY and LIMIT run on the host over the survivors (a stable sort:
   ties keep their input order).

PyTorch runs eagerly: the two programs are torch ops, and a pipeline is
checked at construction by running both over one row, so an expression the
evaluator does not take declines before the pipeline is cached.  Left out
of the reference's version: literal parameterization (`families/`), the
family batcher, the lazy parquet and sharded scans, and the fused PREDICT
seam.
"""
from __future__ import annotations

import logging
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.dtypes import STRING_TYPES, SqlType, sql_to_np
from ..columnar.table import Table
from ..planner import plan as p
from ..planner.expressions import ColumnRef
from ..utils import count_d2h
from .compiled import (
    _TableMeta,
    _TraceEval,
    _Unsupported,
    check_no_rle,
    count_codespace_predicates,
    has_encoded,
    pack_flat,
    singleflight_get_or_build,
    unpack_row,
)

logger = logging.getLogger(__name__)


def _extract(root):
    """Match [Limit]? [Sort]? Projection Filter* Limit* TableScan; None
    otherwise."""
    node = root
    limit = None
    if isinstance(node, p.Limit):
        limit = (node.skip, node.fetch)
        node = node.input
    sort_keys = None
    sort_fetch = None
    if isinstance(node, p.Sort):
        sort_keys = list(node.keys)
        sort_fetch = node.fetch  # caps the window INSIDE any outer Limit
        node = node.input
    if not isinstance(node, p.Projection):
        return None
    proj = node
    node = proj.input
    filters = []
    while isinstance(node, p.Filter):
        filters.append(node.predicate)
        node = node.input
    inner_limit = None
    while isinstance(node, p.Limit):
        # Limits parked right above the scan compose into one row window
        if inner_limit is None:
            inner_limit = (node.skip, node.fetch)
        else:
            oskip, ofetch = inner_limit  # applied AFTER this inner node
            iskip, ifetch = node.skip, node.fetch
            fetches = [f for f in (
                None if ifetch is None else max(ifetch - oskip, 0),
                ofetch) if f is not None]
            inner_limit = (iskip + oskip, min(fetches) if fetches else None)
        node = node.input
    if not isinstance(node, p.TableScan):
        return None
    # upper Filter predicates stay apart from the scan's: a Limit parked
    # between them windows only the scan-filtered rows
    return (node, list(filters), proj, sort_keys, sort_fetch, limit,
            inner_limit)


def sized_nonzero(mask: torch.Tensor, ordinal: torch.Tensor,
                  size: int) -> torch.Tensor:
    """The first `size` row ids where `mask` holds, ascending, padded with
    0 (``jnp.nonzero(mask, size=size, fill_value=0)``), without a host
    sync: each surviving row writes its id at its ordinal - 1 (`ordinal`
    is the running survivor count), and every other row writes into one
    dump slot past the end."""
    n = mask.shape[0]
    pos = torch.where(mask & (ordinal <= size), ordinal - 1,
                      torch.full((), size, dtype=ordinal.dtype,
                                 device=mask.device))
    out = torch.zeros(size + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, pos, torch.arange(n, dtype=torch.int64, device=mask.device))
    return out[:size]


class CompiledSelect:
    """One root select pipeline, planned on a concrete table; it keeps only
    the table's metadata, and `run` takes the table of each query."""

    def __init__(self, table: Table, upper_filters, scan_filters, proj,
                 proj_exprs, sort_keys, sort_fetch, limit, inner_limit):
        self.sort_keys = sort_keys
        self.sort_fetch = sort_fetch
        self.limit = limit
        self.inner_limit = inner_limit
        #: the scan's (projected) columns, the table `run` takes
        self.scan_names = list(table.column_names)
        self.upper_filters = list(upper_filters)
        self.scan_filters = list(scan_filters)
        self.exprs = list(proj_exprs)

        # every output expression must evaluate; string outputs only as
        # plain column refs (codes and dictionary pass through); sort keys
        # must be output columns, strings only over sorted dictionaries
        check_no_rle(table)
        #: compressed-domain accounting: the mask reads codes and the
        #: gather decodes the survivors only
        self.has_encoded = has_encoded(table)
        self.codespace_preds = count_codespace_predicates(
            self.upper_filters + self.scan_filters + self.exprs,
            table) if self.has_encoded else 0
        self.out_meta: List[Tuple[str, SqlType, Optional[np.ndarray]]] = []
        for e, f in zip(self.exprs, proj.schema):
            if f.sql_type in STRING_TYPES:
                if not (isinstance(e, ColumnRef) and type(e) is ColumnRef):
                    raise _Unsupported("computed string output")
                dictionary = table.columns[table.column_names[e.index]].dictionary
            else:
                dictionary = None
            self.out_meta.append((f.name, f.sql_type, dictionary))
        if sort_keys is not None:
            for k in sort_keys:
                e = k.expr
                if not (isinstance(e, ColumnRef) and type(e) is ColumnRef):
                    raise _Unsupported("sort key is not an output column")
                if proj.schema[e.index].sql_type in STRING_TYPES:
                    dic = self.out_meta[e.index][2]
                    if dic is None or not _dictionary_sorted(dic):
                        raise _Unsupported("string sort key w/o sorted dict")
        self._ev = _TraceEval(_TableMeta(table))
        self._tags: List[Tuple[str, np.dtype]] = []
        # both programs over one row: what the evaluator does not take
        # declines now, before the pipeline is cached
        datas, valids = _buffers(table.slice(0, 1))
        mask, ordinal = self._mask(datas, valids)
        self._gather(datas, valids, mask, ordinal, 1)

    # -- the two device programs -------------------------------------------
    def _mask(self, datas, valids):
        """(row mask, running survivor count) over every row."""
        ev = self._ev
        slots = {i: (datas[i], valids[i]) for i in range(len(datas))}
        nr = datas[0].shape[0] if datas else 0
        device = ev.device

        def fold(mask, f):
            d, v = ev.eval(f, slots)
            m = d if v is None else (d & v)
            return m if mask is None else (mask & m)

        def as_rows(mask):
            if mask is None:
                return torch.ones(nr, dtype=torch.bool, device=device)
            if mask.dim() == 0:  # a constant predicate (WHERE 1 = 1)
                return mask.expand(nr)
            return mask

        mask = None
        for f in self.scan_filters:
            mask = fold(mask, f)
        if self.inner_limit is not None:
            # a Limit parked above the scan windows the rows the scan's own
            # filters keep; the upper filters apply after the window
            mask = as_rows(mask)
            skip_i, fetch_i = self.inner_limit
            ordinal = torch.cumsum(mask, 0)
            w = ordinal > skip_i
            if fetch_i is not None:
                w &= ordinal <= skip_i + fetch_i
            mask = mask & w
        for f in self.upper_filters:
            mask = fold(mask, f)
        mask = as_rows(mask)
        return mask, torch.cumsum(mask, 0)

    def _gather(self, datas, valids, mask, ordinal, bucket: int):
        """The packed [2 x outputs, bucket] float64 matrix of the first
        `bucket` survivors: each output's values, then its validity."""
        ev = self._ev
        idx = sized_nonzero(mask, ordinal, bucket)
        slots: Dict = {}
        for i in range(len(datas)):
            v = valids[i]
            slots[i] = (datas[i][idx], None if v is None else v[idx])
        ones = torch.ones(bucket, dtype=torch.bool, device=ev.device)
        flat = []
        for e in self.exprs:
            d, v = ev.eval(e, slots)
            if d.dim() == 0:  # a literal output
                d = d.expand(bucket).contiguous()
            if v is not None and v.dim() == 0:
                v = v.expand(bucket)
            flat.append(d)
            flat.append(ones if v is None else v)
        return pack_flat(flat, self._tags)

    # -- one query ----------------------------------------------------------
    def run(self, table: Table, times: Optional[Dict[str, float]] = None
            ) -> Table:
        """One query over `table`.  With `times`, the device is synchronized
        after each phase and its milliseconds recorded under ``mask``,
        ``count_d2h``, ``gather``, ``d2h``, ``decode`` (the packed rows to
        host columns) and ``host_sort`` (ORDER BY and the window)."""
        clock = _PhaseClock(times, table.device)
        datas, valids = _buffers(table)
        mask, ordinal = self._mask(datas, valids)
        clock.lap("mask")
        count_d2h()
        count = int(ordinal[-1])  # one scalar pull
        clock.lap("count_d2h")
        # without an ORDER BY, a LIMIT caps the pull: the gathered ids
        # ascend, so the first rows ARE the eager path's first rows
        count = self._limit_trim(count)
        host = None
        if count:
            bucket = 1 << (count - 1).bit_length()
            packed = self._gather(datas, valids, mask, ordinal, bucket)
            clock.lap("gather")
            count_d2h()
            host = packed.cpu().numpy()
            clock.lap("d2h")
        cols, valid_arrs = self._decode_packed(host, count)
        clock.lap("decode")
        out = self._assemble(cols, valid_arrs, count)
        clock.lap("host_sort")
        return out

    def _limit_trim(self, count: int) -> int:
        if self.sort_keys is None and self.limit is not None \
                and self.limit[1] is not None:
            return min(count, self.limit[0] + self.limit[1])
        return count

    def _decode_packed(self, host: Optional[np.ndarray], count: int):
        """The packed host matrix -> per-output (data, validity) numpy
        arrays; `host` is None when no row survives."""
        cols: List[np.ndarray] = []
        valid_arrs: List[Optional[np.ndarray]] = []
        if count == 0 or host is None:
            for _, sql_type, _ in self.out_meta:
                cols.append(np.zeros(0, dtype=sql_to_np(sql_type)))
                valid_arrs.append(None)
            return cols, valid_arrs
        for i, (_, sql_type, _) in enumerate(self.out_meta):
            d = unpack_row(host, 2 * i, self._tags)[:count]
            v = unpack_row(host, 1 + 2 * i, self._tags).astype(bool)[:count]
            target = sql_to_np(sql_type)
            if d.dtype != target:
                d = d.astype(target)
            cols.append(d)
            valid_arrs.append(None if bool(v.all()) else v)
        return cols, valid_arrs

    def _assemble(self, cols: List[np.ndarray],
                  valid_arrs: List[Optional[np.ndarray]], count: int) -> Table:
        """ORDER BY, the LIMIT window and the output names, on the host."""
        from ..ops.sorting import sort_permutation
        from .rel.base import unique_names

        host_cols = [Column.from_parts(d, v, dictionary, sql_type)
                     for d, v, (_, sql_type, dictionary)
                     in zip(cols, valid_arrs, self.out_meta)]
        if self.sort_keys:
            order = sort_permutation(
                [host_cols[k.expr.index] for k in self.sort_keys],
                [k.ascending for k in self.sort_keys],
                [k.nulls_first_resolved() for k in self.sort_keys])
        n_out = count
        if self.sort_fetch is not None:
            n_out = min(n_out, self.sort_fetch)
        lo, hi = 0, n_out
        if self.limit is not None:
            skip, fetch = self.limit
            lo = min(skip, n_out)
            hi = n_out if fetch is None else min(skip + fetch, n_out)
        if self.sort_keys:
            host_cols = [c.take(order[lo:hi]) for c in host_cols]
        else:
            host_cols = [c.slice(lo, hi) for c in host_cols]
        names = unique_names([m[0] for m in self.out_meta])
        return Table(dict(zip(names, host_cols)), hi - lo, "cpu")


class _PhaseClock:
    """Milliseconds per phase into `times` (nothing when it is None), the
    device synchronized at each lap so its work lands in its own phase."""

    def __init__(self, times: Optional[Dict[str, float]], device):
        self.times = times
        self.device = device
        if times is not None:
            self._sync()
            self.t0 = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lap(self, name: str) -> None:
        if self.times is None:
            return
        self._sync()
        now = time.perf_counter()
        self.times[name] = (now - self.t0) * 1e3
        self.t0 = now


def _buffers(table: Table):
    return ([table.columns[n].data for n in table.column_names],
            [table.columns[n].validity for n in table.column_names])


def _dictionary_sorted(dic) -> bool:
    a = np.asarray(dic, dtype=object)
    return bool(all(str(a[i]) <= str(a[i + 1]) for i in range(len(a) - 1)))


_CACHE_CAP = 32
_cache: "OrderedDict[Tuple, CompiledSelect]" = OrderedDict()


def resolve_pipeline_inputs(scan, executor):
    """``(container, table)`` of a root chain's scan, projected, or None to
    decline (a scan of no registered table, of no columns or of no rows,
    which the reference's pipeline declines too)."""
    dc = executor.context.schema[scan.schema_name].tables.get(scan.table_name)
    if dc is None:
        return None
    table = executor.get_table(scan.schema_name, scan.table_name)
    if scan.projection is not None:
        table = table.select(scan.projection)
    if not table.column_names or not table.num_rows:
        return None
    return dc, table


def try_compiled_select(root, executor) -> Optional[Table]:
    """Run a ROOT select chain as the two programs and two transfers; None
    when the plan is not such a chain or the pipeline declines it.  A build
    counts its code-space predicates in
    ``metrics["columnar.encoding.codespace_pred"]``; a run over encoded
    columns counts its result rows in ``columnar.encoding.late_rows``."""
    if not executor.config.get("sql.compile", True):
        return None
    got = _extract(root)
    if got is None:
        return None
    scan, upper_filters, proj, sort_keys, sort_fetch, limit, inner_limit = got
    try:
        resolved = resolve_pipeline_inputs(scan, executor)
        if resolved is None:
            return None
        dc, table = resolved
        key = (
            dc.uid,
            tuple(scan.projection or ()),
            tuple(str(f) for f in upper_filters),
            tuple(str(f) for f in scan.filters),
            tuple(str(e) for e in proj.exprs),
            tuple((f.name, f.sql_type) for f in proj.schema),
            tuple(str(k.expr) + str(k.ascending) + str(k.nulls_first)
                  for k in sort_keys) if sort_keys else None,
            sort_fetch,
            limit,
            inner_limit,
            table.num_rows,
        )
        ctx = executor.context

        def build():
            obj = CompiledSelect(table, upper_filters, scan.filters, proj,
                                 proj.exprs, sort_keys, sort_fetch, limit,
                                 inner_limit)
            _cache[key] = obj
            while len(_cache) > _CACHE_CAP:
                _cache.popitem(last=False)
            return obj

        compiled, built_here = singleflight_get_or_build(_cache, key, build)
        if built_here and compiled.codespace_preds:
            ctx.metrics.inc("columnar.encoding.codespace_pred",
                            compiled.codespace_preds)
        result = compiled.run(table)
        if compiled.has_encoded:
            # late materialization: only the survivors decoded, at the root
            ctx.metrics.inc("columnar.encoding.late_rows", result.num_rows)
        return result
    except (_Unsupported, ValueError, TypeError, NotImplementedError) as e:
        # an expression the evaluator does not take must never sink the
        # query: the eager walk answers it
        logger.info("compiled select declined the plan: %s", e)
        return None
