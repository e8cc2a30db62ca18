"""Collectives-routed distributed execution of Aggregate, Join and Sort.

Counterpart of `dask_sql_tpu/parallel/dist_plan.py`.  When a plan node's
input is a sharded table (`Table.sharding`), the aggregate, the join and
the full sort run as per-shard torch programs that meet only through the
explicit exchanges of `collectives.py`:

- Aggregate: a local pre-aggregation a shard, a key-routed all-to-all of
  the partial group tables (owner ``hash(key) % width``), an owner-side
  combine, then the finalize of the small group table on the host (the
  reference's ``try_dist_aggregate``);
- Join: a hash shuffle of (gid, row id) pairs of both sides and a sorted
  probe a shard (``dist_inner_pairs``), or a broadcast of the small side
  probed in place (``broadcast_inner_pairs``);
- Sort: splitters from a sample, a range partition to owners, a local sort
  a shard, then a rebalance to even blocks (``dist_sort_table``); the
  output stays sharded in sort order.

The reference gives each exchange a static capacity from a ladder and
retries on overflow.  Here every exchange is sized exactly after one count
sync, as the port's eager join already syncs for its key bounds, so no
overflow retry exists; the ladders bound an exchange, and one past their
top raises `ResourceExhaustedError` (a degradable failure: the rung below
answers).  The sort's payload columns ride as row ids: each range owner
gathers its rows at the end.

Aggregation state layout a value column (the reference's chunk/agg/
finalize triples): int64 (isum, imin, imax), exact for BIGINT, timestamps
and dictionary codes; float64 (cnt, fsum, fsumsq) for averages, variances
and float sums.  Floats ride imin/imax through an order-preserving int64
bit map, so min and max stay exact for every type.
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.dtypes import STRING_TYPES, SqlType, sql_to_np
from ..columnar.table import Table
from ..resilience.errors import ResourceExhaustedError
from ..utils import host_ints
from . import collectives as cx
from .mesh import Mesh, RowBlocks, block_offsets, default_mesh

logger = logging.getLogger(__name__)

I64 = torch.int64
I64_MIN = int(np.iinfo(np.int64).min)
I64_MAX = int(np.iinfo(np.int64).max)

#: capacity ladders of the reference (powers of 4): here the bounds of an
#: exactly sized exchange, and the sizes the estimator budgets
GROUP_CAPACITY_LADDER = (1024, 16384, 262144, 1 << 22)
PEER_CAPACITY_LADDER = (2048, 16384, 131072, 1 << 20, 1 << 23)

#: kernel runs in this process, by kind (the reference's keys).  Steps down
#: are counted in the Context's metrics as ``resilience.fallback.*``; the
#: ``agg_fallback`` key stays at 0 as in the reference
STATS = {"agg_kernel": 0, "join_kernel": 0, "agg_fallback": 0,
         "broadcast_join": 0, "broadcast_join_sorted": 0,
         "sharded_join_agg": 0, "sort_kernel": 0}
_STATS_LOCK = threading.Lock()


def _stat(key: str) -> None:
    with _STATS_LOCK:
        STATS[key] += 1


# ---------------------------------------------------------------------------
# sharding predicates
# ---------------------------------------------------------------------------
def array_is_sharded(arr) -> bool:
    """A `mesh.ShardedArray` of row blocks over two or more shards (a
    torch tensor is one device's)."""
    from .mesh import ShardedArray

    return (isinstance(arr, ShardedArray) and not arr.is_replicated
            and arr.mesh.size > 1)


def table_is_sharded(table) -> bool:
    return mesh_for_table(table) is not None


def mesh_for_table(table) -> Optional[Mesh]:
    """The mesh of a table's row blocks when it has two or more shards."""
    sh = getattr(table, "sharding", None)
    if sh is None or sh.mesh.size < 2:
        return None
    return sh.mesh


def _mode(executor, key: str) -> str:
    return str(executor.config.get(key, "auto")).lower()


def plan_has_sharded_scan(plan, context) -> bool:
    """Does this subtree scan a sharded table?  (Never loads a lazy parquet
    table.)"""
    from ..datacontainer import LazyParquetContainer
    from ..planner import plan as p

    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, p.TableScan):
            schema = context.schema.get(node.schema_name)
            dc = schema.tables.get(node.table_name) if schema else None
            if dc is not None and not isinstance(dc, LazyParquetContainer):
                if table_is_sharded(dc.table):
                    return True
        stack.extend(node.inputs())
    return False


def should_distribute(executor, key: str, *tables) -> Optional[Mesh]:
    """The mesh to run on, or None to keep the one-device path."""
    mode = _mode(executor, key)
    if mode in ("off", "false", "0"):
        return None
    for t in tables:
        m = mesh_for_table(t)
        if m is not None:
            return m
    if mode in ("on", "force", "true", "1"):
        kind = tables[0].device.type if tables else "cuda"
        m = default_mesh(kind)
        return m if m.size > 1 else None
    return None


def _blocks_of(mesh: Mesh, table: Optional[Table], n: int) -> Tuple[int, ...]:
    """The block boundaries a table's rows take on ``mesh``: its own when
    it is sharded there, else even blocks."""
    sh = getattr(table, "sharding", None)
    if sh is not None and sh.mesh == mesh and sh.offsets[-1] == n:
        return sh.offsets
    return block_offsets(n, mesh.size)


# ---------------------------------------------------------------------------
# encodings: Column -> int64 key and value arrays
# ---------------------------------------------------------------------------
def _float_to_ordered_i64(x: torch.Tensor) -> torch.Tensor:
    """Monotone float64 -> int64 (the IEEE bit map); NaNs masked first."""
    b = x.to(torch.float64).contiguous().view(I64)
    return torch.where(b >= 0, b, I64_MAX - b)


def _ordered_i64_to_float(o: np.ndarray) -> np.ndarray:
    b = np.where(o >= 0, o, I64_MAX - o).astype(np.int64)
    return b.view(np.float64)


def encode_key_column(col: Column) -> Tuple[List[torch.Tensor], dict]:
    """A group-key column as int64 key arrays plus its decode info.  NULL
    keys form their own group (pandas ``dropna=False``): a nullable column
    adds a leading null-flag array."""
    info = {"sql_type": col.sql_type, "dictionary": col.dictionary,
            "float": False, "nullable": col.validity is not None}
    data = col.data
    if data.dtype == torch.bool:
        enc = data.to(I64)
    elif data.is_floating_point():
        clean = torch.where(torch.isnan(data), 0.0, data.to(torch.float64))
        clean = torch.where(clean == 0.0, 0.0, clean)  # -0.0 groups with 0.0
        enc = _float_to_ordered_i64(clean)
        info["float"] = True
    else:
        enc = data.to(I64)
    arrays = []
    if col.validity is not None:
        null = ~col.valid_mask()
        enc = torch.where(null, 0, enc)
        arrays.append(null.to(I64))
    arrays.append(enc)
    return arrays, info


def decode_key_outputs(key_arrays: List[np.ndarray],
                       infos: List[dict]) -> List[Column]:
    """Group-key Columns (on the host) from the int64 key outputs."""
    cols = []
    i = 0
    for info in infos:
        if info["nullable"]:
            null = key_arrays[i].astype(bool)
            i += 1
        else:
            null = None
        raw = key_arrays[i]
        i += 1
        st = info["sql_type"]
        if info["float"]:
            data = _ordered_i64_to_float(raw)
        elif st in STRING_TYPES:
            data = raw.astype(np.int32)
        elif st == SqlType.BOOLEAN:
            data = raw.astype(bool)
        else:
            data = raw.astype(sql_to_np(st))
        validity = None if null is None or not null.any() else ~null
        cols.append(Column.from_parts(data, validity, info["dictionary"], st))
    return cols


def encode_value_column(col: Column
                        ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """An aggregate's argument -> (int64 values, float64 values, info)."""
    if col is None:
        raise ValueError("encode_value_column requires a column")
    info = {"sql_type": col.sql_type, "dictionary": col.dictionary,
            "float": False}
    data = col.data
    if data.dtype == torch.bool:
        iv = data.to(I64)
        fv = data.to(torch.float64)
    elif data.is_floating_point():
        clean = torch.where(torch.isnan(data), 0.0, data.to(torch.float64))
        iv = _float_to_ordered_i64(clean)
        fv = clean
        info["float"] = True
    else:
        iv = data.to(I64)
        fv = data.to(torch.float64)
    return iv, fv, info


def _mix(h: torch.Tensor) -> torch.Tensor:
    """splitmix64-style finalizer on int64 (wrapping arithmetic, the
    reference's constants, so a key routes to the same shard there)."""
    h = h * -7046029254386353131  # 0x9E3779B97F4A7C15 as signed
    h = h ^ (h >> 33)
    h = h * -4417276706812531889  # 0xC2B2AE3D27D4EB4F
    h = h ^ (h >> 29)
    return h


def _hash_keys(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    h = torch.zeros_like(keys[0])
    for k in keys:
        h = _mix(h + k)
    return h


# ---------------------------------------------------------------------------
# per-shard building blocks (exact sizes)
# ---------------------------------------------------------------------------
def _lex_groups(keys: Sequence[torch.Tensor]):
    """The distinct key tuples in lexicographic order: (group of each row,
    unique key arrays, group count)."""
    if len(keys) == 1:
        uniq, inv = torch.unique(keys[0], sorted=True, return_inverse=True)
        return inv, [uniq], int(uniq.shape[0])
    mat = torch.stack(list(keys), dim=1)
    uniq, inv = torch.unique(mat, dim=0, sorted=True, return_inverse=True)
    return inv, [uniq[:, i] for i in range(uniq.shape[1])], int(uniq.shape[0])


def _check_capacity(ladder, n: int) -> None:
    """An exactly sized exchange still stays within its ladder's top."""
    if n > ladder[-1]:
        _ladder_next(ladder, ladder[-1])


def _seg_states(inv: torch.Tensor, g: int, weights: torch.Tensor,
                ivals: torch.Tensor, fvals: torch.Tensor):
    """Per value column, the six states of each of ``g`` groups: int64
    (isum, imin, imax) [nv, g, 3] and float64 (cnt, fsum, fsq) [nv, g, 3].
    ``weights`` [nv, n] says which rows count for each column."""
    from ..ops.segsum import SortedSegments

    device = inv.device
    segs = SortedSegments(inv.to(torch.int32), g)
    ist, fst = [], []
    idx = inv.to(I64)
    for j in range(ivals.shape[0]):
        w = weights[j]
        iv = ivals[j]
        fv = fvals[j]
        isum = torch.zeros(g, dtype=I64, device=device).index_add_(
            0, idx, torch.where(w, iv, 0))
        imin = torch.full((g,), I64_MAX, dtype=I64, device=device)
        imin = imin.scatter_reduce(0, idx, torch.where(w, iv, I64_MAX),
                                   "amin")
        imax = torch.full((g,), I64_MIN, dtype=I64, device=device)
        imax = imax.scatter_reduce(0, idx, torch.where(w, iv, I64_MIN),
                                   "amax")
        zero = torch.zeros((), dtype=torch.float64, device=device)
        cnt = segs.sum(w.to(torch.float64))
        fsum = segs.sum(torch.where(w, fv, zero))
        fsq = segs.sum(torch.where(w, fv * fv, zero))
        ist.append(torch.stack([isum, imin, imax], dim=-1))
        fst.append(torch.stack([cnt, fsum, fsq], dim=-1))
    return torch.stack(ist), torch.stack(fst)


def _combine_received(inv: torch.Tensor, g: int, ist: torch.Tensor,
                      fst: torch.Tensor):
    """Merge received partial states by group (the `agg` stage): sums add
    (float64 in a fixed order), minima and maxima reduce."""
    from ..ops.segsum import SortedSegments

    device = inv.device
    segs = SortedSegments(inv.to(torch.int32), g)
    idx = inv.to(I64)
    iout, fout = [], []
    for j in range(ist.shape[0]):
        isum = torch.zeros(g, dtype=I64, device=device).index_add_(
            0, idx, ist[j, :, 0])
        imin = torch.full((g,), I64_MAX, dtype=I64, device=device) \
            .scatter_reduce(0, idx, ist[j, :, 1], "amin")
        imax = torch.full((g,), I64_MIN, dtype=I64, device=device) \
            .scatter_reduce(0, idx, ist[j, :, 2], "amax")
        iout.append(torch.stack([isum, imin, imax], dim=-1))
        fout.append(torch.stack([segs.sum(fst[j, :, k]) for k in range(3)],
                                dim=-1))
    return torch.stack(iout), torch.stack(fout)


N_ISTATE = 3  # isum, imin, imax
N_FSTATE = 3  # cnt, fsum, fsumsq


def run_dist_groupby(mesh: Mesh, key_blocks: List[List[torch.Tensor]],
                     ival_blocks: List[torch.Tensor],
                     fval_blocks: List[torch.Tensor],
                     weight_blocks: List[torch.Tensor]):
    """The distributed groupby kernel over per-shard blocks (each shard's
    nk key arrays, its [nv, n] int64 and float64 values and [nv, n] row
    weights): local pre-aggregation, the key-routed all-to-all of the
    partial group tables, the owner combine.  Returns, per owner shard,
    (key arrays, istates [nv, g, 3], fstates [nv, g, 3]) on its device;
    owners hold disjoint keys."""
    ndev = mesh.size
    send = []
    for keys, iv, fv, w in zip(key_blocks, ival_blocks, fval_blocks,
                               weight_blocks):
        nk = len(keys)
        nv = iv.shape[0]
        if keys[0].shape[0] == 0:
            empty_i = torch.zeros((0, nk + nv * N_ISTATE), dtype=I64,
                                  device=keys[0].device)
            empty_f = torch.zeros((0, nv * N_FSTATE), dtype=torch.float64,
                                  device=keys[0].device)
            send.append([(empty_i, empty_f)] * ndev)
            continue
        inv, uk, g = _lex_groups(keys)
        _check_capacity(GROUP_CAPACITY_LADDER, g)
        ist, fst = _seg_states(inv, g, w, iv, fv)
        dest = torch.remainder(_hash_keys(uk), ndev)
        iblock = torch.cat([torch.stack(uk, dim=-1)]
                           + [ist[j] for j in range(nv)], dim=-1)
        fblock = torch.cat([fst[j] for j in range(nv)], dim=-1)
        buckets = []
        for d in range(ndev):
            rows = torch.nonzero(dest == d).flatten()
            buckets.append((iblock[rows], fblock[rows]))
        send.append(buckets)
    nk = len(key_blocks[0])
    nv = ival_blocks[0].shape[0]
    ri = cx.all_to_all([[b[d][0] for d in range(ndev)] for b in send], mesh)
    rf = cx.all_to_all([[b[d][1] for d in range(ndev)] for b in send], mesh)
    out = []
    for me in range(ndev):
        _check_capacity(PEER_CAPACITY_LADDER, ri[me].shape[0])
        if ri[me].shape[0] == 0:
            out.append(([ri[me][:, i] for i in range(nk)],
                        torch.zeros((nv, 0, N_ISTATE), dtype=I64,
                                    device=ri[me].device),
                        torch.zeros((nv, 0, N_FSTATE), dtype=torch.float64,
                                    device=ri[me].device)))
            continue
        rkeys = [ri[me][:, i] for i in range(nk)]
        rist = torch.stack([ri[me][:, nk + j * N_ISTATE:
                                    nk + (j + 1) * N_ISTATE]
                            for j in range(nv)])
        rfst = torch.stack([rf[me][:, j * N_FSTATE:(j + 1) * N_FSTATE]
                            for j in range(nv)])
        inv, fk, g = _lex_groups(rkeys)
        iout, fout = _combine_received(inv, g, rist, rfst)
        out.append((fk, iout, fout))
    return out


# ---------------------------------------------------------------------------
# capacity ladders
# ---------------------------------------------------------------------------
def _ladder_at_least(ladder, n):
    for v in ladder:
        if v >= n:
            return v
    return ladder[-1]


def _ladder_next(ladder, cur):
    for v in ladder:
        if v > cur:
            return v
    # degradable: the resilience ladder steps the query down
    raise ResourceExhaustedError(
        f"capacity ladder exhausted at {cur} (top {ladder[-1]})")


def _ladder_next_or_none(ladder, v):
    """Next rung, or None at the top (the caller falls back)."""
    try:
        return _ladder_next(ladder, v)
    except ResourceExhaustedError as e:
        logger.debug("capacity ladder topped out at %d: %s", v, e)
        return None


# ---------------------------------------------------------------------------
# distributed range-partition sort
# ---------------------------------------------------------------------------
def _encode_sort_key(col: Column, ascending: bool, nulls_first: bool):
    """Column -> ascending-order int64 arrays (a leading null key when
    nullable).  Kept in step with `ops.sorting.sort_permutation`: NaN
    sorts as +inf, the null indicator leads, descending is a monotone
    reversal; tests compare the two paths row for row."""
    if col.sql_type in STRING_TYPES:
        col = col.compact_dictionary()
    data = col.data
    if data.dtype == torch.bool:
        enc = data.to(I64)
    elif data.is_floating_point():
        clean = torch.where(torch.isnan(data),
                            torch.full_like(data, float("inf")), data)
        enc = _float_to_ordered_i64(clean)
    else:
        enc = data.to(I64)
    if not ascending:
        enc = -1 - enc  # monotone reversal, no overflow
    arrays = []
    if col.validity is not None:
        valid = col.valid_mask()
        nullkey = torch.where(valid, 1, 0) if nulls_first else \
            torch.where(valid, 0, 1)
        arrays.append(nullkey.to(I64))
        enc = torch.where(valid, enc, 0)
    arrays.append(enc)
    return arrays


def _lex_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order of rows (first key most significant)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(list(keys)):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _rank_among(keys: Sequence[torch.Tensor], splitters: np.ndarray
                ) -> torch.Tensor:
    """Each row's range owner: how many splitters it is >= to
    (lexicographically; ties go right, as in the reference)."""
    n = keys[0].shape[0]
    dest = torch.zeros(n, dtype=I64, device=keys[0].device)
    for s in range(splitters.shape[1]):
        gt = torch.zeros(n, dtype=torch.bool, device=keys[0].device)
        eq = torch.ones(n, dtype=torch.bool, device=keys[0].device)
        for i, k in enumerate(keys):
            si = int(splitters[i, s])
            gt = gt | (eq & (k > si))
            eq = eq & (k == si)
        dest = dest + (gt | eq).to(I64)
    return dest


def dist_sort_table(mesh: Mesh, table: Table, sort_cols: List[Column],
                    ascendings: List[bool], nulls_firsts: List[bool],
                    metrics=None) -> Optional[Table]:
    """Sort a sharded Table globally; the output is sharded in even blocks
    in sort order (shard order IS the sort order).  Splitters come from an
    evenly spaced sample; each shard sends its rows to their range owner
    (all-to-all), the owners sort locally, and a second all-to-all
    rebalances the sorted rows to even blocks.  None when ineligible or
    when an exchange passes its ladder's top (a ``resilience.fallback``)."""

    def _fallback(why: str):
        logger.debug("dist sort falling back to one device: %s", why)
        if metrics is not None:
            metrics.inc("resilience.fallback")
            metrics.inc("resilience.fallback.dist_sort")
        return None

    n = table.num_rows
    ndev = mesh.size
    if n == 0 or ndev <= 1:
        return None
    key_arrays: List[torch.Tensor] = []
    for col, asc, nf in zip(sort_cols, ascendings, nulls_firsts):
        key_arrays.extend(_encode_sort_key(col, asc, nf))
    nk = len(key_arrays)
    offsets = _blocks_of(mesh, table, n)
    home = table.device

    # splitters from an evenly spaced sample (a few hundred host values)
    ns = min(n, max(ndev * 64, 512))
    sample_idx = torch.from_numpy(
        np.linspace(0, n - 1, ns).astype(np.int64)).to(home)
    from ..utils import count_d2h

    if home.type != "cpu":
        count_d2h()
    # dsql: allow-host-sync — the sample the splitters come from
    sample = torch.stack([k[sample_idx] for k in key_arrays]).cpu().numpy()
    order = np.lexsort(sample[::-1])
    qs = sample[:, order][:, np.linspace(0, ns - 1, ndev + 1)
                          .astype(int)[1:-1]]

    # 1. each shard routes its rows (keys + global row id) to range owners
    rows_all = torch.arange(n, dtype=I64, device=home)
    send = []
    for i in range(ndev):
        lo, hi = offsets[i], offsets[i + 1]
        device = mesh.devices[i]
        kb = [k[lo:hi].to(device) for k in key_arrays]
        block = torch.stack(kb + [rows_all[lo:hi].to(device)], dim=-1)
        dest = _rank_among(kb, qs)
        send.append([block[torch.nonzero(dest == d).flatten()]
                     for d in range(ndev)])
    recv = cx.all_to_all(send, mesh)
    # 2. each owner sorts what it received (ties keep global row order:
    #    the sources arrive in shard order, their rows ascending)
    counts = []
    owned = []
    for me in range(ndev):
        got = recv[me]
        if got.shape[0] > PEER_CAPACITY_LADDER[-1]:
            return _fallback("range partition past the exchange ladder")
        perm = _lex_order([got[:, i] for i in range(nk)]) if got.shape[0] \
            else torch.zeros(0, dtype=I64, device=got.device)
        owned.append(got[perm, nk])
        counts.append(torch.tensor([got.shape[0]], dtype=I64,
                                   device=got.device))
    # 3. global positions: the owners' counts, all-gathered, prefix-summed
    sizes = host_ints(*cx.all_gather(counts, home).unbind(0))
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    out_off = block_offsets(n, ndev)
    bounds = torch.tensor(out_off[1:-1], dtype=I64)
    send2 = []
    for me in range(ndev):
        device = mesh.devices[me]
        pos = int(starts[me]) + torch.arange(sizes[me], dtype=I64,
                                             device=device)
        dest2 = torch.searchsorted(bounds.to(device), pos, right=True)
        block = torch.stack([pos, owned[me]], dim=-1)
        send2.append([block[torch.nonzero(dest2 == d).flatten()]
                      for d in range(ndev)])
    recv2 = cx.all_to_all(send2, mesh)
    _stat("sort_kernel")
    if metrics is not None:
        metrics.inc("parallel.dist.sort_kernel")
    # 4. each shard orders its block by global position; the payload
    #    columns gather by row id
    perm = []
    for me in range(ndev):
        got = recv2[me]
        perm.append(got[torch.sort(got[:, 0]).indices, 1])
    row_ids = cx.all_gather(perm, home)
    out = table.unsharded().take(row_ids)
    out.sharding = RowBlocks(mesh, out_off)
    return out


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------
def _sorted_probe(big_gid, big_valid, small_gid, small_valid):
    """Replicated-build probe for any keys: NULL build rows sort to the end
    (valid first, then key; no sentinel can collide with a real key) and
    the match range is clamped to the valid prefix.  Returns
    (stack([start, count]) over big rows, build order)."""
    sg = small_gid.to(I64)
    order = _lex_order([(~small_valid).to(I64), sg])
    n_valid = small_valid.to(I64).sum()
    iota = torch.arange(sg.shape[0], dtype=I64, device=sg.device)
    sg_sorted = torch.where(iota < n_valid, sg[order], I64_MAX)
    bg = big_gid.to(I64)
    start = torch.minimum(torch.searchsorted(sg_sorted, bg, side="left"),
                          n_valid)
    end = torch.minimum(torch.searchsorted(sg_sorted, bg, side="right"),
                        n_valid)
    counts = torch.where(big_valid, torch.clamp(end - start, min=0), 0)
    return torch.stack([start, counts]), order


def _blocks_after(keep_counts: torch.Tensor, offsets) -> Tuple[int, ...]:
    """Output block boundaries of pairs listed in big-row order: the
    cumulative pair count at each big block boundary."""
    csum = torch.cat([torch.zeros(1, dtype=I64, device=keep_counts.device),
                      torch.cumsum(keep_counts.to(I64), 0)])
    bounds = torch.tensor(offsets, dtype=I64, device=keep_counts.device)
    return host_ints(*csum[bounds].unbind(0))


def broadcast_inner_pairs(big_gid, big_valid, small_gid, small_valid,
                          big_offsets=None):
    """Broadcast-join matching: the small side replicates and the big side
    never moves (the reference's ``sql.join.broadcast``, which broadcasts
    any small table).  Unique dense integer small keys probe a value-
    indexed lookup table; any other keys a sorted probe.  Returns (big row
    ids, small row ids, big matched flags, output block boundaries in big
    row order when ``big_offsets`` is given) on the big side's device."""
    from ..ops.join import dense_unique_lut

    sv = None if bool(small_valid.all()) else small_valid
    prep = dense_unique_lut(small_gid, sv)
    if prep is None:
        return _broadcast_sorted_pairs(big_gid, big_valid, small_gid,
                                       small_valid, big_offsets)
    rmin, lut = prep
    size = lut.shape[0]
    idx = big_gid.to(I64) - rmin
    inb = (idx >= 0) & (idx < size) & big_valid
    safe = torch.clamp(idx, 0, size - 1)
    cand = torch.where(inb, lut[safe].to(I64), -1)
    _stat("broadcast_join")
    matched = cand >= 0
    bi = torch.nonzero(matched).flatten()
    si = cand[bi]
    blocks = None if big_offsets is None else \
        _blocks_after(matched, big_offsets)
    return bi, si, matched, blocks


def _broadcast_sorted_pairs(big_gid, big_valid, small_gid, small_valid,
                            big_offsets=None):
    ns = int(small_gid.shape[0])
    nb = int(big_gid.shape[0])
    device = big_gid.device
    _stat("broadcast_join")
    _stat("broadcast_join_sorted")
    if ns == 0 or nb == 0:
        empty = torch.zeros(0, dtype=I64, device=device)
        matched = torch.zeros(nb, dtype=torch.bool, device=device)
        blocks = None if big_offsets is None else \
            _blocks_after(matched, big_offsets)
        return empty, empty, matched, blocks
    packed, order = _sorted_probe(big_gid, big_valid, small_gid, small_valid)
    start, counts = packed[0], packed[1]
    matched = counts > 0
    bi = torch.repeat_interleave(torch.arange(nb, dtype=I64, device=device),
                                 counts)
    first = torch.cumsum(counts, 0) - counts
    within = torch.arange(bi.shape[0], dtype=I64, device=device) - first[bi]
    si = order[start[bi] + within]
    blocks = None if big_offsets is None else \
        _blocks_after(counts, big_offsets)
    return bi, si, matched, blocks


def dist_inner_pairs(mesh: Mesh, lgid: torch.Tensor, lvalid: torch.Tensor,
                     rgid: torch.Tensor, rvalid: torch.Tensor,
                     l_offsets=None, r_offsets=None):
    """Distributed equijoin matching: both sides' (gid, row id) pairs hash-
    shuffle to owner ``hash(gid) % width`` (all-to-all), each owner sorts
    its right rows and probes with its left rows.  Returns (left row ids,
    right row ids, left matched flags, output block boundaries): the pairs
    are listed owner by owner, left-major within an owner, and the blocks
    are the owners'."""
    nl, nr = int(lgid.shape[0]), int(rgid.shape[0])
    ndev = mesh.size
    home = lgid.device
    l_offsets = l_offsets or block_offsets(nl, ndev)
    r_offsets = r_offsets or block_offsets(nr, ndev)

    def shuffle(gid, valid, offsets):
        rows = torch.arange(gid.shape[0], dtype=I64, device=gid.device)
        send = []
        for i, device in enumerate(mesh.devices):
            lo, hi = offsets[i], offsets[i + 1]
            g = gid[lo:hi].to(I64).to(device)
            ok = valid[lo:hi].to(device)
            dest = torch.remainder(_mix(g), ndev)
            block = torch.stack([g, rows[lo:hi].to(device)], dim=-1)
            send.append([block[torch.nonzero(ok & (dest == d)).flatten()]
                         for d in range(ndev)])
        got = cx.all_to_all(send, mesh)
        for g in got:
            _check_capacity(PEER_CAPACITY_LADDER, g.shape[0])
        return got

    lrecv = shuffle(lgid, lvalid, l_offsets)
    rrecv = shuffle(rgid, rvalid, r_offsets)
    lis, ris, counts = [], [], []
    lmatch = torch.zeros(nl, dtype=torch.bool, device=home)
    for me, device in enumerate(mesh.devices):
        lk, lrow = lrecv[me][:, 0].contiguous(), lrecv[me][:, 1]
        rk, rrow = rrecv[me][:, 0].contiguous(), rrecv[me][:, 1]
        r_sorted, r_order = torch.sort(rk, stable=True)
        start = torch.searchsorted(r_sorted, lk, side="left")
        end = torch.searchsorted(r_sorted, lk, side="right")
        cnt = end - start
        li = torch.repeat_interleave(lrow, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        pos = torch.repeat_interleave(start - first, cnt) + torch.arange(
            li.shape[0], dtype=I64, device=device)
        ri = rrow[r_order[pos]]
        lis.append(li)
        ris.append(ri)
        counts.append(int(li.shape[0]))
        lmatch[lrow[cnt > 0].to(home)] = True
    _stat("join_kernel")
    li = cx.all_gather(lis, home)
    ri = cx.all_gather(ris, home)
    blocks = tuple(int(x) for x in np.concatenate(([0], np.cumsum(counts))))
    return li, ri, lmatch, blocks


# ---------------------------------------------------------------------------
# SQL integration: Aggregate
# ---------------------------------------------------------------------------
#: aggregates decomposable into the six-state layout
_DECOMPOSABLE = {
    "count", "count_star", "sum", "min", "max", "avg",
    "var_samp", "var_pop", "stddev_samp", "stddev_pop",
    "every", "bool_or", "single_value", "first_value",
    "regr_count", "regr_syy", "regr_sxx",
}


def try_dist_aggregate(rel, executor, inp: Table) -> Optional[Table]:
    """A GROUP BY over a sharded input through the collectives kernel;
    None keeps the one-device path.  The group table comes back on the
    host, as the compiled aggregate's does."""
    mesh = should_distribute(executor, "sql.distributed.aggregate", inp)
    if mesh is None:
        return None
    if not rel.group_exprs or inp.num_rows == 0:
        return None  # a global aggregate reduces on one device
    for agg in rel.agg_exprs:
        if agg.func not in _DECOMPOSABLE or agg.distinct:
            logger.debug("dist aggregate declining %s%s", agg.func,
                         " DISTINCT" if agg.distinct else "")
            executor.context.metrics.inc("resilience.fallback")
            executor.context.metrics.inc("resilience.fallback.dist_aggregate")
            return None

    group_cols = [executor.eval_expr(e, inp) for e in rel.group_exprs]
    key_arrays: List[torch.Tensor] = []
    key_infos: List[dict] = []
    for col in group_cols:
        if col.sql_type in STRING_TYPES and col.dictionary is None:
            return None
        col = col.decode()
        arrs, info = encode_key_column(col)
        key_arrays.extend(arrs)
        key_infos.append(info)

    n = inp.num_rows
    device = inp.device
    ivals, fvals, weights, val_infos = [], [], [], []
    ones = torch.ones(n, dtype=torch.bool, device=device)
    for agg in rel.agg_exprs:
        fmask = None
        if agg.filter is not None:
            fc = executor.eval_expr(agg.filter, inp)
            fmask = fc.data & fc.valid_mask()
        if agg.func == "count_star":
            iv = torch.ones(n, dtype=I64, device=device)
            fv = torch.ones(n, dtype=torch.float64, device=device)
            valid = ones
            info = {"sql_type": SqlType.BIGINT, "dictionary": None,
                    "float": False}
        else:
            args = [executor.eval_expr(a, inp).decode() for a in agg.args]
            col = args[0]
            if col.sql_type in STRING_TYPES:
                if col.dictionary is None:
                    return None
                col = col.compact_dictionary()
            valid = col.valid_mask()
            if col.data.is_floating_point():
                valid = valid & ~torch.isnan(col.data)
            if agg.func in ("regr_count", "regr_syy", "regr_sxx"):
                if len(args) < 2:
                    return None
                y, x = args[0], args[1]
                valid = y.valid_mask() & x.valid_mask()
                col = {"regr_count": y, "regr_syy": y,
                       "regr_sxx": x}[agg.func]
                if col.sql_type in STRING_TYPES:
                    return None
            iv, fv, info = encode_value_column(col)
        if fmask is not None:
            valid = valid & fmask
        ivals.append(iv)
        fvals.append(fv)
        weights.append(valid)
        val_infos.append(info)
    if not rel.agg_exprs:
        # pure GROUP BY (distinct keys): one count_star slot
        ivals = [torch.ones(n, dtype=I64, device=device)]
        fvals = [torch.ones(n, dtype=torch.float64, device=device)]
        weights = [ones]
        val_infos = [{"sql_type": SqlType.BIGINT, "dictionary": None,
                      "float": False}]

    offsets = _blocks_of(mesh, inp, n)
    iv_mat = torch.stack(ivals)
    fv_mat = torch.stack(fvals)
    w_mat = torch.stack(weights)
    key_blocks = [[k[offsets[i]:offsets[i + 1]].to(d) for k in key_arrays]
                  for i, d in enumerate(mesh.devices)]

    def cols_of(mat):
        return [mat[:, offsets[i]:offsets[i + 1]].to(d)
                for i, d in enumerate(mesh.devices)]

    owners = run_dist_groupby(mesh, key_blocks, cols_of(iv_mat),
                              cols_of(fv_mat), cols_of(w_mat))
    _stat("agg_kernel")
    executor.context.metrics.inc("parallel.dist.agg_kernel")

    # the owners' group tables (disjoint keys) in shard order, one transfer
    nk = len(key_arrays)
    home = mesh.devices[0]
    keys_all = cx.all_gather([torch.stack(o[0], dim=-1) for o in owners],
                             home)
    ist_all = cx.all_gather([o[1].transpose(0, 1) for o in owners], home)
    fst_all = cx.all_gather([o[2].transpose(0, 1) for o in owners], home)
    from ..utils import count_d2h

    if home.type != "cpu":
        count_d2h()
    # dsql: allow-host-sync — the group table, the run's one pull
    host = torch.cat([keys_all.view(torch.float64)
                      if keys_all.numel() else keys_all.to(torch.float64),
                      ist_all.reshape(ist_all.shape[0], -1)
                      .view(torch.float64),
                      fst_all.reshape(fst_all.shape[0], -1)], dim=1
                     ).cpu().numpy()
    ng = host.shape[0]
    keys_h = host[:, :nk].copy().view(np.int64)
    nv = len(val_infos)
    ist_h = host[:, nk:nk + nv * N_ISTATE].copy().view(np.int64) \
        .reshape(ng, nv, N_ISTATE)
    fst_h = host[:, nk + nv * N_ISTATE:].reshape(ng, nv, N_FSTATE)
    key_cols = decode_key_outputs([keys_h[:, i] for i in range(nk)],
                                  key_infos)

    from ..physical.rel.base import unique_names

    names = unique_names([f.name for f in rel.schema])
    out: Dict[str, Column] = dict(zip(names, key_cols))
    for j, (name, agg) in enumerate(zip(names[len(group_cols):],
                                        rel.agg_exprs)):
        out[name] = _finalize_agg(agg, val_infos[j], ist_h[:, j, :],
                                  fst_h[:, j, :])
    return Table(out, ng, "cpu")


def _finalize_agg(agg, info: dict, ist: np.ndarray,
                  fst: np.ndarray) -> Column:
    """States -> the aggregate's Column (the `finalize` stage), on the
    host."""
    isum, imin, imax = ist[:, 0], ist[:, 1], ist[:, 2]
    cnt, fsum, fsq = fst[:, 0], fst[:, 1], fst[:, 2]
    func = agg.func
    nonempty = cnt > 0
    st = agg.sql_type

    def mk(vals, ok=None, dictionary=None, np_dtype=None):
        dtype = np_dtype or sql_to_np(st)
        arr = np.asarray(vals).astype(dtype)
        validity = None if ok is None or ok.all() else ok
        return Column.from_parts(arr, validity, dictionary, st)

    if func in ("count", "count_star", "regr_count"):
        return mk(cnt.astype(np.int64))
    if func == "sum":
        if info["float"]:
            return mk(fsum, nonempty)
        return mk(isum, nonempty)
    if func in ("min", "max", "single_value", "first_value"):
        raw = imax if func == "max" else imin
        if info["float"]:
            return mk(_ordered_i64_to_float(raw), nonempty)
        if info["sql_type"] in STRING_TYPES:
            return mk(raw.astype(np.int32), nonempty,
                      dictionary=info["dictionary"], np_dtype=np.int32)
        return mk(raw, nonempty)
    if func == "avg":
        return mk(fsum / np.maximum(cnt, 1), nonempty, np_dtype=np.float64)
    if func in ("var_samp", "var_pop", "stddev_samp", "stddev_pop"):
        mean = fsum / np.maximum(cnt, 1)
        m2 = np.maximum(fsq - cnt * mean * mean, 0.0)
        ddof = 1 if func.endswith("samp") else 0
        v = m2 / np.maximum(cnt - ddof, 1)
        if func.startswith("stddev"):
            v = np.sqrt(v)
        return mk(v, cnt > ddof, np_dtype=np.float64)
    if func == "every":
        return mk(np.where(nonempty, imin, 0).astype(bool), nonempty,
                  np_dtype=np.bool_)
    if func == "bool_or":
        return mk(np.where(nonempty, imax, 0).astype(bool), nonempty,
                  np_dtype=np.bool_)
    if func in ("regr_syy", "regr_sxx"):
        mean = fsum / np.maximum(cnt, 1)
        m2 = np.maximum(fsq - cnt * mean * mean, 0.0)
        return mk(m2, nonempty, np_dtype=np.float64)
    raise NotImplementedError(f"distributed finalize for {func}")
