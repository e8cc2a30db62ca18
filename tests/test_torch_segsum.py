"""The port's segment sum (dask_sql_tpu_torch/ops/segsum.py) against the
reference's (dask_sql_tpu/ops/pallas_kernels.py), on the CPU.

On the CPU the port's wrapper runs its plain version (a float64
``index_add_``); the CUDA kernel itself is held against that plain version
on the card by ``chip_smoke.py``.  Inputs are made with numpy from a seed
and handed to both sides.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_sql_tpu.ops import pallas_kernels as ref
from dask_sql_tpu_torch.config import Config
from dask_sql_tpu_torch.ops import segsum as port


def _case(seed, n, domain, k):
    rng = np.random.RandomState(seed)
    gid = rng.randint(0, domain, n).astype(np.int32)
    contribs = rng.rand(n, k).astype(np.float32)
    exact = np.zeros((domain, k), dtype=np.float64)
    np.add.at(exact, gid, contribs.astype(np.float64))
    return gid, contribs, exact


@pytest.mark.parametrize("seed,n,domain,k,block_rows", [
    (1, 700, 19, 2, 256),   # several blocks of the reference kernel
    (2, 301, 1, 1, 128),    # domain 1, n not a multiple of the block
])
def test_segsum_matches_pallas_interpret(seed, n, domain, k, block_rows):
    gid, contribs, exact = _case(seed, n, domain, k)
    got = port.segsum(torch.from_numpy(gid), torch.from_numpy(contribs), domain)
    assert got.dtype == torch.float64 and tuple(got.shape) == (domain, k)
    # the port adds in float64: only float64 rounding separates it from the
    # exact numpy oracle
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-12)
    want = ref.segsum_pallas(jnp.asarray(gid), jnp.asarray(contribs), domain,
                             block_rows=block_rows, interpret=True)
    # the reference kernel accumulates in float32 over the whole input; its
    # own test holds it to 1e-5 relative against the exact sums
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_segsum_matches_scan_blocked():
    rng = np.random.RandomState(7)
    n, domain = 5000, 16
    gid = rng.randint(0, domain, n).astype(np.int32)
    x64 = rng.rand(n) * 1e9 + 0.123456789
    mask = rng.rand(n) < 0.8
    masked = np.where(mask, x64, 0.0)
    hi, lo = ref.split_hi_lo(jnp.asarray(masked))
    want = np.asarray(ref.segsum_scan_blocked(
        jnp.asarray(gid), [jnp.asarray(mask, dtype=jnp.float32), hi, lo],
        domain, block=1024))
    phi, plo = port.split_hi_lo(torch.from_numpy(masked))
    cols = torch.stack([torch.from_numpy(mask).to(torch.float32), phi, plo])
    got = port.segsum_columns(torch.from_numpy(gid), cols, domain).numpy()
    # counts: exact on both sides
    cnt = np.zeros(domain)
    np.add.at(cnt, gid, mask.astype(np.float64))
    assert np.array_equal(got[:, 0], cnt)
    assert np.array_equal(got[:, 0], want[:, 0])
    # float sums: both within the reference's stated bound of the exact sum
    exact = np.zeros(domain)
    np.add.at(exact, gid, masked)
    for side in (got, want):
        s = side[:, 1] + side[:, 2]
        rel = np.max(np.abs(s - exact) / np.abs(exact))
        assert rel <= port.MATMUL_FLOAT_REL_ERR_BOUND, rel
    assert port.MATMUL_FLOAT_REL_ERR_BOUND == ref.MATMUL_FLOAT_REL_ERR_BOUND


def test_segsum_ids_outside_domain_and_empty_input():
    gid = torch.tensor([0, 3, -1, 2, 7], dtype=torch.int32)
    contribs = torch.ones(5, 2)
    got = port.segsum(gid, contribs, 4).numpy()
    # ids outside [0, domain) add nothing, as a one-hot row of zeros
    want = np.asarray(ref.segsum_onehot_jnp(jnp.asarray(gid.numpy()),
                                            jnp.ones((5, 2)), 4))
    np.testing.assert_array_equal(got, want)
    empty = port.segsum(torch.zeros(0, dtype=torch.int32), torch.zeros(0, 3), 5)
    np.testing.assert_array_equal(empty.numpy(), np.zeros((5, 3)))
    with pytest.raises(ValueError):
        port.segsum_columns(gid, torch.ones(2, 4), 4)


def test_split_hi_lo_bit_exact():
    rng = np.random.RandomState(11)
    x = np.concatenate([rng.rand(500) * 1e12 + 0.12345,
                        -rng.rand(500) * 1e-7, [0.0, 1.0, -2.5, 3e38]])
    want_hi, want_lo = ref.split_hi_lo(jnp.asarray(x))
    hi, lo = port.split_hi_lo(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.float32
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  np.asarray(want_hi).view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  np.asarray(want_lo).view(np.uint32))


@pytest.mark.parametrize("mode,device,domain,want", [
    ("auto", "cuda", 12, "kernel"),
    ("auto", "cuda", 2048, "kernel"),
    ("auto", "cuda", 2049, "scatter"),
    ("pallas", "cuda", 4096, "kernel"),
    ("matmul", "cuda", 12, "kernel"),
    ("matmul", "cuda", 1 << 20, "scatter"),
    ("scatter", "cuda", 12, "scatter"),
    ("auto", "cpu", 12, "plain"),
    ("pallas", "cpu", 12, "plain"),
    ("scatter", "cpu", 12, "scatter"),
])
def test_choose_segsum_impl(mode, device, domain, want):
    config = Config()
    config.update({"sql.compile.segsum": mode})
    assert port.choose_segsum_impl(config, domain, torch.device(device)) == want


def test_choose_segsum_impl_rejects_unknown_mode():
    config = Config()
    with config.set({"sql.compile.segsum": "scater"}):
        with pytest.raises(ValueError):
            port.choose_segsum_impl(config, 10, torch.device("cpu"))
