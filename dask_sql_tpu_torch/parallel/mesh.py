"""The shard mesh of the PyTorch port.

Counterpart of `dask_sql_tpu/parallel/mesh.py`.  There a mesh is a
`jax.sharding.Mesh` of distinct devices.  Here a `Mesh` is a list of
shards, each naming a device, and several shards may name the same device:
its width is its number of shards.  A mesh of four shards on one card runs
every sharded path a four-card mesh runs, except the copies between cards;
on the CPU an eight-shard mesh stands where the reference's eight virtual
devices stand.

A sharded table keeps contiguous row blocks, one per shard (`RowBlocks`):
no padding, so the blocks may differ by a row.  A block on the device of
the table's columns is a view of them; a block on another device is a
copy made once, when the table is sharded.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..columnar.table import Table, normalize_device

#: the mesh axis name of the reference, kept for the key of a mesh
AXIS = "shards"

#: the default mesh of each device kind ("cuda", "cpu"), set by
#: `set_default_mesh` or made on first use
_default_meshes: Dict[str, "Mesh"] = {}


class Mesh:
    """Shards in order, each naming the device its rows live on."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices: Tuple[torch.device, ...] = tuple(
            normalize_device(d) for d in devices)

    @property
    def size(self) -> int:
        """The mesh's width: its number of shards."""
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other.devices == self.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        names = [str(d) for d in self.devices]
        shards = f"{len(names)} shard" + ("s" if len(names) > 1 else "")
        if len(set(names)) == 1:
            return f"Mesh[{shards} on {names[0]}]"
        return f"Mesh[{shards}: {', '.join(names)}]"


def make_mesh(n_shards: Optional[int] = None, devices=None,
              kind: str = "cuda") -> Mesh:
    """A mesh of ``n_shards`` shards over ``devices`` in turn (every
    device of ``kind`` by default; one shard a device when ``n_shards`` is
    None).  ``make_mesh(4, devices=["cuda:0"])`` puts four shards on one
    card."""
    if devices is None:  # every card, or the host
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] \
            if kind == "cuda" else [torch.device(kind)]
    devices = [normalize_device(d) for d in devices]
    if not devices:
        raise ValueError(f"no device of kind {kind!r} for a mesh")
    if n_shards is None:
        n_shards = len(devices)
    return Mesh([devices[i % len(devices)] for i in range(n_shards)])


def default_mesh(kind: str = "cuda") -> Mesh:
    """The default mesh of a device kind: one shard a device of that kind
    (on the card machine, ``torch.cuda.device_count()`` shards)."""
    mesh = _default_meshes.get(kind)
    if mesh is None:
        mesh = _default_meshes[kind] = make_mesh(kind=kind)
    return mesh


def set_default_mesh(mesh: Mesh) -> None:
    """Make ``mesh`` the default of its first shard's device kind."""
    _default_meshes[mesh.devices[0].type] = mesh


def reset_default_mesh(kind: str) -> None:
    """Forget the default mesh of a kind (the next use makes it anew)."""
    _default_meshes.pop(kind, None)


def mesh_key(mesh: Mesh) -> Tuple[Tuple[str, int], ...]:
    """A cache-key component naming each shard by (device, index): a
    pipeline built for one mesh is never reused on another."""
    return tuple((str(d), i) for i, d in enumerate(mesh.devices))


def block_offsets(n_rows: int, n_shards: int) -> Tuple[int, ...]:
    """Even contiguous blocks: the first ``n_rows % n_shards`` shards take
    one row more.  Returns the ``n_shards + 1`` block boundaries."""
    base, extra = divmod(n_rows, n_shards)
    out = [0]
    for i in range(n_shards):
        out.append(out[-1] + base + (1 if i < extra else 0))
    return tuple(out)


class RowBlocks:
    """The row layout of a sharded Table: shard i holds the rows
    ``[offsets[i], offsets[i + 1])``.  ``resident`` holds, per column
    object, the blocks placed on shards whose device is not the table's
    (copies made once, at sharding time)."""

    __slots__ = ("mesh", "offsets", "resident")

    def __init__(self, mesh: Mesh, offsets: Sequence[int],
                 resident: Optional[Dict[int, Tuple]] = None):
        if len(offsets) != mesh.size + 1:
            raise ValueError(f"{mesh.size} shards need {mesh.size + 1} "
                             f"block boundaries, got {len(offsets)}")
        self.mesh = mesh
        self.offsets = tuple(int(o) for o in offsets)
        self.resident = resident or {}

    @property
    def sizes(self) -> List[int]:
        o = self.offsets
        return [o[i + 1] - o[i] for i in range(len(o) - 1)]

    def blocks(self, table: Table) -> List[Table]:
        """The table's rows as one Table a shard, on the shard's device."""
        out = []
        for i, device in enumerate(self.mesh.devices):
            lo, hi = self.offsets[i], self.offsets[i + 1]
            if device == table.device:
                out.append(table.slice(lo, hi))
                continue
            cols = {}
            for name, col in table.columns.items():
                placed = self.resident.get(id(col))
                cols[name] = placed[1][i] if placed is not None \
                    else col.slice(lo, hi).to(device)
            out.append(Table(cols, hi - lo, device))
        return out

    def split(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """A row-aligned tensor's blocks, each on its shard's device."""
        return [tensor[self.offsets[i]:self.offsets[i + 1]].to(d)
                for i, d in enumerate(self.mesh.devices)]

    def after_mask(self, mask: torch.Tensor) -> "RowBlocks":
        """The blocks of the rows a mask keeps: each block keeps its own
        survivors (one transfer of the blocks' survivor counts)."""
        from ..utils import host_ints

        csum = torch.cat([torch.zeros(1, dtype=torch.int64,
                                      device=mask.device),
                          torch.cumsum(mask.to(torch.int64), 0)])
        bounds = torch.tensor(self.offsets, dtype=torch.int64,
                              device=mask.device)
        return RowBlocks(self.mesh, host_ints(*csum[bounds].unbind(0)))


def row_sharding(mesh: Mesh, n_rows: int) -> RowBlocks:
    """Even row blocks of ``n_rows`` rows over the mesh."""
    return RowBlocks(mesh, block_offsets(n_rows, mesh.size))


class ShardedArray:
    """A row-aligned tensor as its blocks, one a shard (`shard_rows`), or
    one full copy a shard (`replicated`)."""

    __slots__ = ("mesh", "parts", "is_replicated")

    def __init__(self, mesh: Mesh, parts: List[torch.Tensor],
                 is_replicated: bool = False):
        self.mesh = mesh
        self.parts = parts
        self.is_replicated = is_replicated

    def gather(self) -> torch.Tensor:
        """The global tensor on the first shard's device: the blocks
        concatenated in shard order (a replicated array's first copy)."""
        if self.is_replicated:
            return self.parts[0]
        first = self.mesh.devices[0]
        return torch.cat([p.to(first) for p in self.parts])


def replicated(mesh: Mesh, tensor: torch.Tensor) -> ShardedArray:
    """One copy of ``tensor`` a shard (shared by shards of one device)."""
    copies: Dict[torch.device, torch.Tensor] = {}
    parts = []
    for d in mesh.devices:
        if d not in copies:
            copies[d] = tensor.to(d)
        parts.append(copies[d])
    return ShardedArray(mesh, parts, is_replicated=True)


def pad_to_multiple(arr: torch.Tensor, multiple: int, fill=0):
    """Pad a 1-D tensor so its length divides ``multiple``; returns
    (padded, valid_mask).  Sharded tables are never padded (their blocks
    may differ by a row); this serves callers that want equal blocks."""
    n = arr.shape[0]
    target = -(-n // multiple) * multiple
    valid = torch.ones(target, dtype=torch.bool, device=arr.device)
    if target == n:
        return arr, valid
    pad = torch.full((target - n,), fill, dtype=arr.dtype, device=arr.device)
    valid[n:] = False
    return torch.cat([arr, pad]), valid


def shard_rows(arr: torch.Tensor, mesh: Optional[Mesh] = None
               ) -> ShardedArray:
    """Place a row-aligned tensor as even blocks over the mesh (views
    where a shard names the tensor's device)."""
    mesh = mesh or default_mesh(arr.device.type)
    return ShardedArray(mesh, row_sharding(mesh, arr.shape[0]).split(arr))
