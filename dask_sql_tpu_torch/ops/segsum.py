"""Segment sums of the aggregation path: the Hopper kernel and its plain version.

Counterpart of `dask_sql_tpu/ops/pallas_kernels.py`.  There, `segsum_pallas`
(a one-hot block per row block, fed to the TPU's matrix unit) was an opt-in
mode and `segsum_scan_blocked` (f32 block partials under a float64 carry)
the default.  Both compute ``onehot(gid).T @ contribs``; here that function
is one hand-written CUDA kernel (`csrc/segsum.cu`) and the default segment
sum on the card:

- `segsum_columns` is the kernel's wrapper.  A CUDA tensor launches the
  kernel or raises; a CPU tensor goes to the plain version.
- `segsum_plain` is the plain PyTorch version: a float64 ``index_add_``.
- `segsum` keeps the reference's ``[n, k]`` layout.

The contract is that of `segsum_scan_blocked`: float64 output, float error
at or under `MATMUL_FLOAT_REL_ERR_BOUND`, counts (0/1 columns) exact.
"""
from __future__ import annotations

from typing import Dict

import torch

#: error bound (max relative, float sums) every segment-sum mode meets
MATMUL_FLOAT_REL_ERR_BOUND = 5e-6

#: `auto` picks the kernel up to this group domain (the reference's cutoff)
KERNEL_DOMAIN_CUTOFF = 2048

#: rows one kernel block sums at most (the reference's `_DEFAULT_BLOCK`)
BLOCK_ROWS_CAP = 32768

#: dynamic shared memory one block may use on Hopper (227 KB)
SHARED_BYTES = 232448

#: kernel launches, by wrapper: each adds one where it launches its kernel
LAUNCHES: Dict[str, int] = {"segsum": 0}

_MIN_BLOCK_ROWS = 1024
_BLOCKS_PER_SM = 8
_SCRATCH_BUDGET = 64 << 20


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


def segsum(gid: torch.Tensor, contribs: torch.Tensor, domain: int) -> torch.Tensor:
    """[n] int32 ids + [n, k] float32 pre-masked contributions -> [domain, k]
    float64 segment sums (the reference's `segsum_pallas` layout)."""
    return segsum_columns(gid, contribs.t().contiguous(), domain)


def _block_rows(n: int, domain: int, k: int, device: torch.device) -> int:
    """Rows per kernel block: enough blocks to fill every SM once, and a
    pass-2 scratch of at most `_SCRATCH_BUDGET` bytes where the cap allows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = min(sms * _BLOCKS_PER_SM,
                 max(1, _SCRATCH_BUDGET // (domain * k * 8)))
    rows = -(-n // blocks)
    rows = -(-rows // _MIN_BLOCK_ROWS) * _MIN_BLOCK_ROWS
    return max(_MIN_BLOCK_ROWS, min(rows, BLOCK_ROWS_CAP))


def segsum_columns(gid: torch.Tensor, cols: torch.Tensor, domain: int) -> torch.Tensor:
    """Segment sum of a ``[k, n]`` float32 column stack by ``[n]`` int32 ids
    -> ``[domain, k]`` float64.  The wrapper of the hand-written kernel."""
    if cols.dim() != 2 or gid.dim() != 1 or gid.shape[0] != cols.shape[1]:
        raise ValueError(f"segsum: gid {tuple(gid.shape)} and columns "
                         f"{tuple(cols.shape)} do not match")
    if gid.device != cols.device:
        raise ValueError(f"segsum: gid on {gid.device}, columns on {cols.device}")
    if cols.device.type == "cpu":
        return segsum_plain(gid, cols.t(), domain)
    if cols.device.type != "cuda":
        raise ValueError(f"segsum: no kernel for device {cols.device}")
    if gid.dtype != torch.int32 or cols.dtype != torch.float32:
        raise ValueError(f"segsum kernel takes int32 ids and float32 columns, "
                         f"got {gid.dtype} and {cols.dtype}")
    if not (gid.is_contiguous() and cols.is_contiguous()):
        raise ValueError("segsum kernel takes contiguous ids and columns")
    k, n = cols.shape
    kc = min(k, SHARED_BYTES // (8 * max(domain, 1)))
    if domain < 1 or k < 1 or kc < 1:
        raise ValueError(f"segsum kernel takes 1 <= domain <= "
                         f"{SHARED_BYTES // 8} and k >= 1, got domain "
                         f"{domain}, k {k}")
    from .. import _build

    lib = _build.library("segsum")
    device = cols.device
    rows = _block_rows(n, domain, k, device)
    nb = -(-n // rows)
    scratch = torch.empty((nb, domain, k), dtype=torch.float64, device=device)
    out = torch.empty((domain, k), dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dsql_segsum_f32(gid.data_ptr(), cols.data_ptr(), n, k, domain,
                                  rows, kc, scratch.data_ptr(), out.data_ptr(),
                                  stream)
    if err != 0:
        raise RuntimeError(f"segsum kernel launch failed: CUDA error {err}")
    LAUNCHES["segsum"] += 1
    return out


def choose_segsum_impl(config, domain: int, device: torch.device) -> str:
    """'kernel' | 'scatter' | 'plain' from config + device + domain.

    auto: the kernel on CUDA up to `KERNEL_DOMAIN_CUTOFF` groups, a float64
    scatter (``index_add_``) above it, the plain version on the CPU.
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
    limit = KERNEL_DOMAIN_CUTOFF if mode == "auto" else SHARED_BYTES // 8
    return "kernel" if domain <= limit else "scatter"
