"""Segment sums of the aggregation path: the Hopper kernel and its plain version.

Counterpart of `dask_sql_tpu/ops/pallas_kernels.py`.  There, `segsum_pallas`
(a one-hot block per row block, fed to the TPU's matrix unit) was an opt-in
mode and `segsum_scan_blocked` (f32 block partials under a float64 carry)
the default.  Both compute ``onehot(gid).T @ contribs``; here that function
is one hand-written CUDA kernel (`csrc/segsum.cu`) and the default segment
sum on the card.  Its float sums are the same bits on every run: each
float64 partial cell has one owner that adds in an order fixed by the
call's shape.

- `segsum_typed` is the kernel's wrapper.  It takes typed columns where
  they lie: each a ``(data, mask_or_None)`` pair of float32, float64 or
  bool data under an optional bool row mask.  A CUDA tensor launches the
  kernel or raises; a CPU tensor goes to the plain version.
- `segsum_typed_plain` is the plain PyTorch version: each column cast to
  float64 and selected by its mask, then one float64 ``index_add_``.
- `segsum_columns` (a ``[k, n]`` stack) and `segsum` (the reference's
  ``[n, k]`` layout) call `segsum_typed` with the stack's rows as columns.

The contract is that of `segsum_scan_blocked`: float64 output, float error
at or under `MATMUL_FLOAT_REL_ERR_BOUND`, counts exact.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

#: error bound (max relative, float sums) every segment-sum mode meets
MATMUL_FLOAT_REL_ERR_BOUND = 5e-6

#: `auto` picks the kernel up to this group domain (the reference's cutoff)
KERNEL_DOMAIN_CUTOFF = 2048

#: the largest group domain the kernel takes: one float64 column of
#: partials beside a ring of 128 rows of 13 bytes in a block's shared
#: memory (``kMaxDomain`` in ``csrc/segsum.cu``, whose plan refuses a
#: larger domain)
KERNEL_MAX_DOMAIN = (227 * 1024 - 4096 - 2 * 128 * 13) // 8

#: kernel launches, by wrapper: each adds one where it launches its kernel
LAUNCHES: Dict[str, int] = {"segsum": 0}

_TYPES = {torch.float32: 0, torch.float64: 1, torch.bool: 2}

Column = Tuple[torch.Tensor, Optional[torch.Tensor]]


def split_hi_lo(x64: torch.Tensor):
    """Exact two-float32 decomposition of a float64 tensor (48-bit mantissa)."""
    hi = x64.to(torch.float32)
    lo = (x64 - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def segsum_plain(gid: torch.Tensor, contribs: torch.Tensor, domain: int) -> torch.Tensor:
    """[n] ids + [n, k] contributions -> [domain, k] float64 sums.  Ids
    outside [0, domain) add nothing (a one-hot row of zeros)."""
    keep = (gid >= 0) & (gid < domain)
    if not bool(keep.all()):
        gid, contribs = gid[keep], contribs[keep]
    out = torch.zeros(domain, contribs.shape[1], dtype=torch.float64,
                      device=contribs.device)
    return out.index_add_(0, gid, contribs.to(torch.float64))


class SortedSegments:
    """The float64 scatter of group domains above the kernel's cutoff: the
    ids sorted once (stably), then each column summed group by group by
    ``torch.segment_reduce``, the same bits on every run.  ``index_add_``
    on CUDA adds with atomics in whatever order the threads arrive, so its
    float sums move in their last bits from run to run, and q15's revenue
    then matches no row of ``(SELECT MAX(total_revenue) ...)``;
    ``index_put_`` with ``accumulate`` is repeatable but gives each group
    to one warp, which a skewed id (every unselected row at 0) serializes.
    Ids outside [0, domain) add nothing.  On the CPU each group adds its
    rows in row order, as ``index_add_`` does."""

    def __init__(self, gid: torch.Tensor, domain: int):
        ids, self.perm = torch.sort(gid, stable=True)
        bounds = torch.arange(domain + 1, dtype=ids.dtype, device=ids.device)
        self.offsets = torch.searchsorted(ids, bounds)
        self.n = gid.shape[0]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``[n]`` values (or a scalar, broadcast) -> ``[domain]`` sums."""
        return torch.segment_reduce(x.expand(self.n)[self.perm], "sum",
                                    offsets=self.offsets, unsafe=True)


def segsum_typed_plain(gid: torch.Tensor, columns: Sequence[Column],
                       domain: int) -> torch.Tensor:
    """The plain version of `segsum_typed`: each column in float64, rows
    under a false mask selected away (never multiplied: they may hold NaN),
    stacked, then `segsum_plain`."""
    zero = torch.zeros((), dtype=torch.float64, device=gid.device)
    cols = []
    for data, mask in columns:
        x = data.to(torch.float64)
        cols.append(x if mask is None else torch.where(mask, x, zero))
    if not cols:
        return torch.zeros(domain, 0, dtype=torch.float64, device=gid.device)
    return segsum_plain(gid, torch.stack(cols, dim=1), domain)


class _Call(NamedTuple):
    """A checked call's columns as the kernel takes them.  A buffer id names
    one buffer (the same memory read as the same type) and -1 no mask: the
    kernel stages each distinct buffer once."""
    types: Tuple[int, ...]
    data: List[int]                 # data pointers
    masks: List[Optional[int]]      # mask pointers, None for no mask
    data_ids: Tuple[int, ...]
    mask_ids: Tuple[int, ...]


def _reject(j: int, what: str, t: torch.Tensor, gid: torch.Tensor) -> None:
    if t.shape != gid.shape:
        raise ValueError(f"segsum: column {j} {what} {tuple(t.shape)} "
                         f"does not match gid {tuple(gid.shape)}")
    if t.device != gid.device:
        raise ValueError(f"segsum: column {j} {what} on {t.device}, "
                         f"gid on {gid.device}")
    if what == "data":
        raise ValueError(f"segsum: column {j} is {t.dtype}; the kernel "
                         f"takes float32, float64 or bool")
    raise ValueError(f"segsum: column {j} mask is {t.dtype}, not bool")


def _describe(gid: torch.Tensor, columns: Sequence[Column]) -> _Call:
    """Checks a call's shapes, devices and types in one pass over its
    columns, and describes them."""
    if gid.dim() != 1:
        raise ValueError(f"segsum: gid must be 1-D, got {tuple(gid.shape)}")
    shape, device = gid.shape, gid.device
    ids: Dict[Tuple[int, int], int] = {}
    types, data_ptrs, mask_ptrs, data_ids, mask_ids = [], [], [], [], []
    for j, (data, mask) in enumerate(columns):
        if (data.shape != shape or data.device != device
                or data.dtype not in _TYPES):
            _reject(j, "data", data, gid)
        types.append(_TYPES[data.dtype])
        ptr = data.data_ptr()
        data_ptrs.append(ptr)
        data_ids.append(ids.setdefault((ptr, data.itemsize), len(ids)))
        if mask is None:
            mask_ptrs.append(None)
            mask_ids.append(-1)
            continue
        if (mask.shape != shape or mask.device != device
                or mask.dtype != torch.bool):
            _reject(j, "mask", mask, gid)
        ptr = mask.data_ptr()
        mask_ptrs.append(ptr)
        mask_ids.append(ids.setdefault((ptr, 1), len(ids)))
    return _Call(tuple(types), data_ptrs, mask_ptrs, tuple(data_ids),
                 tuple(mask_ids))


#: ints of the kernel's plan of a call (``Plan`` in ``csrc/segsum.cu``):
#: kc (columns a block sums), warps (float partials a block) and blocks,
#: then the kernel's own
_PLAN_INTS = 16


@functools.lru_cache(maxsize=256)
def _plan(device: int, n: int, domain: int, types: Tuple[int, ...],
          data_ids: Tuple[int, ...], mask_ids: Tuple[int, ...]):
    """The kernel's plan for one shape of call, made once on the card."""
    from .. import _build

    k = len(types)
    plan = (ctypes.c_int * _PLAN_INTS)()
    with torch.cuda.device(device):
        err = _build.library("segsum").dsql_segsum_plan(
            n, domain, k, (ctypes.c_int64 * k)(*data_ids),
            (ctypes.c_int64 * k)(*mask_ids), (ctypes.c_int * k)(*types), plan)
    if err < 0:
        raise ValueError(f"segsum kernel takes 1 <= domain <= "
                         f"{KERNEL_MAX_DOMAIN} and k >= 1, got domain "
                         f"{domain}, k {k}")
    if err != 0:
        raise RuntimeError(f"segsum kernel cannot be planned: CUDA error {err}")
    return plan


def launch_geometry(gid: torch.Tensor, columns: Sequence[Column],
                    domain: int) -> Tuple[int, int, int]:
    """(kc, warps, blocks) the kernel plans for a call on the card:
    columns a block sums, copies of its float partial (one a consumer
    warp), blocks of pass 1."""
    call = _describe(gid, columns)
    plan = _plan(gid.device.index, gid.shape[0], domain, call.types,
                 call.data_ids, call.mask_ids)
    return plan[0], plan[1], plan[2]


def segsum_typed(gid: torch.Tensor, columns: Sequence[Column],
                 domain: int) -> torch.Tensor:
    """Segment sum of typed columns by ``[n]`` int32 ids -> ``[domain, k]``
    float64: ``out[g, j]`` sums ``data_j`` (1 for a bool column) over the
    rows with id g whose ``mask_j`` is true.  The hand-written kernel's
    wrapper."""
    call = _describe(gid, columns)
    if gid.device.type == "cpu":
        return segsum_typed_plain(gid, columns, domain)
    return _launch(gid, columns, domain, call)


def _launch(gid: torch.Tensor, columns: Sequence[Column], domain: int,
            call: _Call) -> torch.Tensor:
    """Launch the kernel on a checked CUDA call."""
    if gid.device.type != "cuda":
        raise ValueError(f"segsum: no kernel for device {gid.device}")
    if gid.dtype != torch.int32:
        raise ValueError(f"segsum kernel takes int32 ids, got {gid.dtype}")
    if not gid.is_contiguous() or not all(
            d.is_contiguous() and (m is None or m.is_contiguous())
            for d, m in columns):
        raise ValueError("segsum kernel takes contiguous ids, columns and masks")
    k, n = len(columns), gid.shape[0]
    device = gid.device
    plan = _plan(device.index, n, domain, call.types, call.data_ids,
                 call.mask_ids)
    from .. import _build

    lib = _build.library("segsum")
    with torch.cuda.device(device):
        scratch = torch.empty((plan[2], domain, k), dtype=torch.float64,
                              device=device)
        out = torch.empty((domain, k), dtype=torch.float64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dsql_segsum_typed(
            gid.data_ptr(), n, domain, k, (ctypes.c_void_p * k)(*call.data),
            (ctypes.c_void_p * k)(*call.masks),
            (ctypes.c_int * k)(*call.types), plan, scratch.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segsum kernel launch failed: CUDA error {err}")
    LAUNCHES["segsum"] += 1
    return out


def segsum_columns(gid: torch.Tensor, cols: torch.Tensor, domain: int) -> torch.Tensor:
    """Segment sum of a ``[k, n]`` column stack by ``[n]`` int32 ids ->
    ``[domain, k]`` float64.  The stack's rows are the kernel's columns, read
    where they lie."""
    if cols.dim() != 2 or gid.dim() != 1 or gid.shape[0] != cols.shape[1]:
        raise ValueError(f"segsum: gid {tuple(gid.shape)} and columns "
                         f"{tuple(cols.shape)} do not match")
    return segsum_typed(gid, [(c, None) for c in cols.unbind(0)], domain)


def segsum(gid: torch.Tensor, contribs: torch.Tensor, domain: int) -> torch.Tensor:
    """[n] int32 ids + [n, k] pre-masked contributions -> [domain, k]
    float64 segment sums (the reference's `segsum_pallas` layout)."""
    return segsum_columns(gid, contribs.t().contiguous(), domain)


def choose_segsum_impl(config, domain: int, device: torch.device) -> str:
    """'kernel' | 'scatter' | 'plain' from config + device + domain.

    auto: the kernel on CUDA up to `KERNEL_DOMAIN_CUTOFF` groups, a float64
    scatter (`SortedSegments`) above it, the plain version on the CPU.
    ``pallas`` and ``matmul`` ask for the kernel wherever its shared-memory
    partial fits; ``scatter`` asks for the scatter.  Counts are exact and
    integer sums use int64 scatter in every mode."""
    mode = str(config.get("sql.compile.segsum", "auto"))
    if mode not in ("auto", "scatter", "matmul", "pallas"):
        raise ValueError(
            f"sql.compile.segsum must be auto/scatter/matmul/pallas, got {mode!r}")
    if mode == "scatter":
        return "scatter"
    if torch.device(device).type == "cpu":
        return "plain"
    limit = KERNEL_DOMAIN_CUTOFF if mode == "auto" else KERNEL_MAX_DOMAIN
    return "kernel" if domain <= limit else "scatter"
