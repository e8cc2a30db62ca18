"""The exchanges between shards, and the capacity-bounded collective kernels.

Counterpart of `dask_sql_tpu/parallel/collectives.py`.  The reference's
programs are `shard_map`ped over a device mesh and talk through XLA
collectives.  Here each program is torch ops over per-shard tensors, and
each collective is an explicit exchange:

- `psum` / `pmin` / `pmax`: the shards' states combined in shard order on
  the first shard's device;
- `all_gather`: concatenation in shard order, on a device;
- `all_to_all`: per-peer buckets, each moved to its peer's device with
  ``.to(device)``.

No NCCL call is made: on a mesh whose shards share one card every move is
a no-op, and a mesh over several cards waits for a machine that has them.
`EXCHANGES` counts the exchanges by kind; it takes the place of the
reference's checks that a compiled program holds an ``all-to-all``.

The kernels below keep the reference's capacity-bounded shapes: each shard
reduces into a partial table of ``capacity`` slots (keys, states, valid)
and raises an overflow flag when it sees more distinct keys, so a caller
retries with a larger capacity (`CAPACITY_LADDER`).  The SQL engine's own
paths (`dist_plan.py`) size their exchanges exactly instead.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, default_mesh, row_sharding

#: capacity ladder keeps the partial tables bounded (capacity doubling)
CAPACITY_LADDER = (256, 4096, 65536, 1 << 20)

#: exchanges made, by kind (``all_to_all``, ``all_gather``, ``psum``,
#: ``pmin``, ``pmax``); a kernel's test reads what one call adds
EXCHANGES: Dict[str, int] = {"all_to_all": 0, "all_gather": 0, "psum": 0,
                             "pmin": 0, "pmax": 0}
_EXCHANGE_LOCK = threading.Lock()


def _count(kind: str) -> None:
    with _EXCHANGE_LOCK:
        EXCHANGES[kind] += 1


# ---------------------------------------------------------------------------
# the exchanges
# ---------------------------------------------------------------------------
def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of the shards' tensors, added in shard order on the first
    shard's device (the same bits on every run)."""
    _count("psum")
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc


def pmin(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    _count("pmin")
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.minimum(acc, p.to(acc.device))
    return acc


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    _count("pmax")
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(acc.device))
    return acc


def all_gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' tensors concatenated in shard order on ``device``."""
    _count("all_gather")
    return torch.cat([p.to(device) for p in parts])


def all_to_all(buckets: Sequence[Sequence[torch.Tensor]], mesh: Mesh
               ) -> List[torch.Tensor]:
    """``buckets[src][dst]`` (rows shard src sends to shard dst) -> for
    each shard dst the rows it receives, concatenated in source order on
    its device."""
    _count("all_to_all")
    out = []
    for dst, device in enumerate(mesh.devices):
        out.append(torch.cat([buckets[src][dst].to(device)
                              for src in range(len(buckets))]))
    return out


def split_even(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """A global row-aligned tensor as even blocks, one a shard, each on its
    shard's device (the reference's row-block placement, without the
    padding)."""
    return row_sharding(mesh, t.shape[0]).split(t)


# ---------------------------------------------------------------------------
# per-shard building blocks: static capacity, overflow flagged
# ---------------------------------------------------------------------------
def _local_sorted_groups(keys: torch.Tensor, valid: torch.Tensor,
                         capacity: int):
    """The distinct valid keys in ascending order, bounded by `capacity`.

    Returns (seg of each row [n] (-1 for invalid rows or a group past the
    capacity), uniq_keys[capacity], uniq_valid[capacity], overflow)."""
    device = keys.device
    uniq, inv = torch.unique(keys[valid], sorted=True, return_inverse=True)
    n_groups = int(uniq.shape[0])
    overflow = n_groups > capacity
    seg = torch.full(keys.shape, -1, dtype=torch.int64, device=device)
    seg[valid] = torch.where(inv < capacity, inv, -1)
    kept = min(n_groups, capacity)
    uk = torch.zeros(capacity, dtype=keys.dtype, device=device)
    uk[:kept] = uniq[:kept]
    uv = torch.zeros(capacity, dtype=torch.bool, device=device)
    uv[:kept] = True
    return seg, uk, uv, overflow


#: aggregation state layout: (count, sum, min, max, sumsq) a value column
N_STATE = 5


def _segment_states(values: torch.Tensor, valid: torch.Tensor,
                    seg: torch.Tensor, capacity: int) -> torch.Tensor:
    """[capacity, N_STATE] float64 states of the rows with a segment."""
    from ..ops.segsum import SortedSegments

    keep = valid & (seg >= 0)
    v = values.to(torch.float64)
    s = torch.where(keep, seg, capacity).to(torch.int32)
    segs = SortedSegments(s, capacity)  # rows without a segment add nothing
    zero = torch.zeros((), dtype=torch.float64, device=v.device)
    cnt = segs.sum(keep.to(torch.float64))
    tot = segs.sum(torch.where(keep, v, zero))
    sq = segs.sum(torch.where(keep, v * v, zero))
    idx = torch.where(keep, seg, 0)
    inf = torch.full((capacity,), float("inf"), dtype=torch.float64,
                     device=v.device)
    mn = inf.scatter_reduce(0, idx, torch.where(keep, v, inf[0]), "amin")
    mx = (-inf).scatter_reduce(0, idx, torch.where(keep, v, -inf[0]), "amax")
    return torch.stack([cnt, tot, mn, mx, sq], dim=-1)


def _identity_states(capacity: int, device) -> torch.Tensor:
    z = torch.zeros(capacity, dtype=torch.float64, device=device)
    inf = torch.full((capacity,), float("inf"), dtype=torch.float64,
                     device=device)
    return torch.stack([z, z, inf, -inf, z], dim=-1)


def _combine_partials(keys, valid, states, capacity: int):
    """Merge duplicate keys of concatenated partial tables (the `agg`
    stage): counts, sums and sums of squares add, min and max reduce."""
    seg, uk, uv, overflow = _local_sorted_groups(keys, valid, capacity)
    device = keys.device
    keep = seg >= 0
    s = torch.where(keep, seg, capacity).to(torch.int32)
    from ..ops.segsum import SortedSegments

    segs = SortedSegments(s, capacity)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    out = []
    for j, how in enumerate(("sum", "sum", "amin", "amax", "sum")):
        col = states[:, j]
        if how == "sum":
            out.append(segs.sum(torch.where(keep, col, zero)))
        else:
            fill = float("inf") if how == "amin" else float("-inf")
            init = torch.full((capacity,), fill, dtype=torch.float64,
                              device=device)
            out.append(init.scatter_reduce(
                0, torch.where(keep, seg, 0),
                torch.where(keep, col, init[0]), how))
    return uk, uv, torch.stack(out, dim=-1), overflow


# ---------------------------------------------------------------------------
# distributed groupby-aggregate (partial -> gather by owner -> final)
# ---------------------------------------------------------------------------
def make_dist_groupby(mesh: Optional[Mesh] = None, capacity: int = 4096):
    """The distributed groupby-sum/min/max/count/avg kernel.

    Takes global ``keys`` (int64), ``values`` and ``valid`` rows, placed as
    even blocks over the mesh.  Each shard reduces its rows into a partial
    table of `capacity` groups; the partial tables are all-gathered and
    each shard keeps the keys it owns (``key % width == shard``) and
    combines them.  Returns ``(keys [S, cap], valid [S, cap], states
    [S, cap, N_STATE], overflow [S])`` on the first shard's device."""
    mesh = mesh or default_mesh()
    ndev = mesh.size

    def run(keys, values, valid):
        kb = split_even(keys.to(torch.int64), mesh)
        vb = split_even(values, mesh)
        okb = split_even(valid, mesh)
        uks, uvs, sts, ofs = [], [], [], []
        for k, v, ok in zip(kb, vb, okb):
            seg, uk, uv, of = _local_sorted_groups(k, ok, capacity)
            st = _segment_states(v, ok, seg, capacity)
            st = torch.where(uv[:, None], st, _identity_states(capacity,
                                                               k.device))
            uks.append(uk)
            uvs.append(uv)
            sts.append(st)
            ofs.append(of)
        out_k, out_v, out_s, out_of = [], [], [], []
        for me, device in enumerate(mesh.devices):
            all_k = all_gather(uks, device)
            all_v = all_gather(uvs, device)
            all_s = all_gather(sts, device)
            mine = all_v & (torch.remainder(all_k, ndev) == me)
            fk, fv, fs, of2 = _combine_partials(all_k, mine, all_s, capacity)
            first = mesh.devices[0]
            out_k.append(fk.to(first))
            out_v.append(fv.to(first))
            out_s.append(fs.to(first))
            out_of.append(ofs[me] or of2)
        return (torch.stack(out_k), torch.stack(out_v), torch.stack(out_s),
                torch.tensor(out_of, dtype=torch.bool,
                             device=mesh.devices[0]))

    return run


def finalize_states(keys, valid, states):
    """Host-side: sharded partial tables -> dense (keys, count, sum, min,
    max, mean, var) arrays, ascending by key."""
    k = _host(keys).reshape(-1)
    v = _host(valid).reshape(-1)
    st = _host(states).reshape(-1, N_STATE)
    k, st = k[v], st[v]
    order = np.argsort(k, kind="stable")
    k, st = k[order], st[order]
    cnt, s, mn, mx, s2 = st.T
    mean = s / np.maximum(cnt, 1)
    var = np.maximum(s2 - cnt * mean * mean, 0) / np.maximum(cnt - 1, 1)
    return k, cnt, s, mn, mx, mean, var


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        # dsql: allow-host-sync — the finalize reads the tiny group tables
        return x.cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# hash shuffle (DISTRIBUTE BY / join partitioning)
# ---------------------------------------------------------------------------
def _bucket(dest: torch.Tensor, valid: torch.Tensor, ndev: int, C: int):
    """Per destination: the rows (ascending) that land in its first C
    slots, and whether any valid row did not fit."""
    overflow = False
    picks = []
    for d in range(ndev):
        rows = torch.nonzero(valid & (dest == d)).flatten()
        if rows.shape[0] > C:
            overflow = True
            rows = rows[:C]
        picks.append(rows)
    return picks, overflow


def make_hash_shuffle(mesh: Optional[Mesh] = None,
                      capacity_per_peer: int = 4096, n_payloads: int = 1):
    """The all-to-all hash shuffle.

    Each shard routes its rows to shard ``key % width``; each (source,
    destination) pair carries at most ``capacity_per_peer`` rows (an
    overflow is flagged).  Payload columns ride along as an ``[n,
    n_payloads]`` float64 block.  Returns ``(keys [S, S*C], valid [S, S*C],
    payload [S, S*C, P], overflow [S])``: shard d's row holds, in source
    order, C slots from each source."""
    mesh = mesh or default_mesh()
    ndev = mesh.size
    C = capacity_per_peer

    def run(keys, payload, valid):
        kb = split_even(keys.to(torch.int64), mesh)
        pb = split_even(payload, mesh)
        vb = split_even(valid, mesh)
        bk, bv, bp, ofs = [], [], [], []
        for k, pl, ok in zip(kb, pb, vb):
            dest = torch.remainder(k, ndev)
            picks, of = _bucket(dest, ok, ndev, C)
            row_k, row_v, row_p = [], [], []
            for rows in picks:
                m = rows.shape[0]
                slot_k = torch.zeros(C, dtype=torch.int64, device=k.device)
                slot_v = torch.zeros(C, dtype=torch.bool, device=k.device)
                slot_p = torch.zeros((C, pl.shape[1]), dtype=pl.dtype,
                                     device=k.device)
                slot_k[:m] = k[rows]
                slot_v[:m] = True
                slot_p[:m] = pl[rows]
                row_k.append(slot_k)
                row_v.append(slot_v)
                row_p.append(slot_p)
            bk.append(row_k)
            bv.append(row_v)
            bp.append(row_p)
            ofs.append(of)
        rk = all_to_all(bk, mesh)
        rv = all_to_all(bv, mesh)
        rp = all_to_all(bp, mesh)
        first = mesh.devices[0]
        return (torch.stack([r.to(first) for r in rk]),
                torch.stack([r.to(first) for r in rv]),
                torch.stack([r.to(first) for r in rp]),
                torch.tensor(ofs, dtype=torch.bool, device=first))

    return run


# ---------------------------------------------------------------------------
# broadcast join: the build side replicated, the probe side stays put
# ---------------------------------------------------------------------------
def _match_counts(probe_keys, probe_valid, build_keys, build_valid):
    big = torch.iinfo(torch.int64).max
    b_sorted = torch.sort(torch.where(build_valid, build_keys.to(torch.int64),
                                      big)).values
    pk = probe_keys.to(torch.int64)
    start = torch.searchsorted(b_sorted, pk, side="left")
    end = torch.searchsorted(b_sorted, pk, side="right")
    return torch.where(probe_valid, end - start, 0)


def make_broadcast_join_count(mesh: Optional[Mesh] = None):
    """Broadcast equijoin match counts: the build side is all-gathered to
    every shard, each shard probes its own block.  Returns the per-probe-
    row match counts in global row order."""
    mesh = mesh or default_mesh()

    def run(probe_keys, probe_valid, build_keys, build_valid):
        pk = split_even(probe_keys, mesh)
        pv = split_even(probe_valid, mesh)
        bk = split_even(build_keys, mesh)
        bv = split_even(build_valid, mesh)
        counts = []
        for me, device in enumerate(mesh.devices):
            all_bk = all_gather(bk, device)
            all_bv = all_gather(bv, device)
            counts.append(_match_counts(pk[me], pv[me], all_bk, all_bv))
        return torch.cat([c.to(mesh.devices[0]) for c in counts])

    return run


# ---------------------------------------------------------------------------
# distributed hash join: shuffle both sides, probe locally
# ---------------------------------------------------------------------------
def make_dist_join_count(mesh: Optional[Mesh] = None,
                         capacity_per_peer: int = 4096):
    """Distributed equijoin match counts (the shuffle and probe core): both
    sides shuffle by key, each shard probes what it received.  Returns
    ``(counts [S, S*C], totals [S], overflow)``."""
    mesh = mesh or default_mesh()
    shuffle = make_hash_shuffle(mesh, capacity_per_peer)

    def run(lkeys, lvalid, rkeys, rvalid):
        first = mesh.devices[0]
        one = torch.zeros((lkeys.shape[0], 1), dtype=torch.float64,
                          device=lkeys.device)
        slk, slv, _, of1 = shuffle(lkeys, one, lvalid)
        oner = torch.zeros((rkeys.shape[0], 1), dtype=torch.float64,
                           device=rkeys.device)
        srk, srv, _, of2 = shuffle(rkeys, oner, rvalid)
        counts, totals = [], []
        for me, device in enumerate(mesh.devices):
            c = _match_counts(slk[me].to(device), slv[me].to(device),
                              srk[me].to(device), srv[me].to(device))
            counts.append(c.to(first))
            totals.append(c.sum().to(first))
        return torch.stack(counts), torch.stack(totals), bool((of1 | of2)
                                                              .any())

    return run
