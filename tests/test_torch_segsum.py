"""The port's segment sum (dask_sql_tpu_torch/ops/segsum.py) against the
reference's (dask_sql_tpu/ops/pallas_kernels.py), on the CPU.

On the CPU the port's wrapper runs its plain version (a float64
``index_add_``); the CUDA kernel itself is held against that plain version
on the card by ``chip_smoke.py``.  Inputs are made with numpy from a seed
and handed to both sides.  Tolerances: counts exact; float sums within
MATMUL_FLOAT_REL_ERR_BOUND (5e-6) relative, the bound the reference's own
segment sum is held to.
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


def _typed_case(seed, n, domain):
    """gid with ids outside the domain; two count masks, a float32 and a
    float64 column of spread magnitudes (NaN under their false masks), and
    a bool column under a mask."""
    rng = np.random.RandomState(seed)
    gid = rng.randint(0, domain, n).astype(np.int32)
    gid[::37] = -1
    gid[5::41] = domain
    m0, m1 = rng.rand(n) < 0.9, rng.rand(n) < 0.5
    f32 = (rng.rand(n) * 1e5).astype(np.float32)
    f64 = rng.rand(n) * 10.0 ** rng.uniform(-6, 9, n)
    flag = rng.rand(n) < 0.3
    f32[~m0] = np.nan
    f64[~m1] = np.nan
    return gid, [(m0, None), (m1, None), (f32, m0), (f64, m1), (flag, m1)]


@pytest.mark.parametrize("seed,n,domain", [(3, 4099, 12), (4, 0, 5)])
def test_segsum_typed_matches_oracle_and_scan_blocked(seed, n, domain):
    gid, columns = _typed_case(seed, n, domain)
    got = port.segsum_typed(
        torch.from_numpy(gid),
        [(torch.from_numpy(d), None if m is None else torch.from_numpy(m))
         for d, m in columns], domain).numpy()
    assert got.dtype == np.float64 and got.shape == (domain, len(columns))
    # the oracle and the reference see the columns already selected by
    # their masks: rows under a false mask add nothing, NaN or not
    selected = [d.astype(np.float64) if m is None
                else np.where(m, d.astype(np.float64), 0.0) for d, m in columns]
    keep = (gid >= 0) & (gid < domain)
    exact = np.zeros((domain, len(columns)))
    np.add.at(exact, gid[keep], np.stack(selected, axis=1)[keep])
    ref_cols = [jnp.asarray(c, dtype=jnp.float32)
                for c in (selected[0], selected[1], selected[2], selected[4])]
    hi, lo = ref.split_hi_lo(jnp.asarray(selected[3]))
    want = np.asarray(ref.segsum_scan_blocked(
        jnp.asarray(gid), ref_cols + [hi, lo], domain, block=1024))
    want = np.concatenate([want[:, :3], want[:, 4:5] + want[:, 5:6],
                           want[:, 3:4]], axis=1)
    counts = [0, 1, 4]
    assert np.array_equal(got[:, counts], exact[:, counts])
    assert np.array_equal(want[:, counts], exact[:, counts])
    rel = port.MATMUL_FLOAT_REL_ERR_BOUND
    np.testing.assert_allclose(got, exact, rtol=rel)
    np.testing.assert_allclose(got, want, rtol=rel)


@pytest.mark.parametrize("data,mask,n", [
    (torch.ones(4, dtype=torch.int64), None, 4),      # integer data
    (torch.ones(4), torch.ones(4), 4),                # float mask
    (torch.ones(3), None, 4),                         # length differs
    (torch.ones(4), torch.ones(5, dtype=torch.bool), 4),
])
def test_segsum_typed_rejects(data, mask, n):
    with pytest.raises(ValueError):
        port.segsum_typed(torch.zeros(n, dtype=torch.int32), [(data, mask)], 3)


def _q1_columns(n):
    """Q1's typed call: six count masks, five sums under masks 1..5."""
    masks = [torch.zeros(n, dtype=torch.bool) for _ in range(6)]
    sums = [torch.zeros(n), torch.zeros(n), torch.zeros(n),
            torch.zeros(n, dtype=torch.float64),
            torch.zeros(n, dtype=torch.float64)]
    return [(m, None) for m in masks] + list(zip(sums, masks[1:]))


def _stack_columns(n):
    """The rows of a [4, n] float32 stack: four distinct buffers."""
    return [(c, None) for c in torch.zeros(4, n).unbind(0)]


def _shared_data(n):
    """One float32 column summed under two masks, and one mask counted."""
    x, m0, m1 = torch.zeros(n), torch.ones(n, dtype=torch.bool), \
        torch.zeros(n, dtype=torch.bool)
    return [(x, m0), (x, m1), (m0, None)]


def _reinterpreted(n):
    """One buffer's bytes read as float32 and as bool: two buffers to the
    kernel, which tells them apart by their row width."""
    raw = torch.zeros(4 * n, dtype=torch.uint8)
    return [(raw.view(torch.float32), None), (raw[:n].view(torch.bool), None)]


def _mask_only(n):
    """A float64 column under its own bool data as a mask, and that mask
    counted: the count's data and the sum's mask are one buffer."""
    x, m = torch.zeros(n, dtype=torch.float64), torch.ones(n, dtype=torch.bool)
    return [(x, m), (m, None), (m, m)]


@pytest.mark.parametrize("make,want", [
    (_q1_columns, ((0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
                   (-1, -1, -1, -1, -1, -1, 1, 2, 3, 4, 5))),
    (_stack_columns, ((0, 1, 2, 3), (-1, -1, -1, -1))),
    (_shared_data, ((0, 0, 1), (1, 2, -1))),
    (_reinterpreted, ((0, 1), (-1, -1))),
    (_mask_only, ((0, 1, 1), (1, -1, 1))),
])
def test_buffer_ids(make, want):
    # the kernel's plan sizes its staging ring by the distinct buffers of a
    # call; the wrapper names them by these ids
    call = port._describe(torch.zeros(8, dtype=torch.int32), make(8))
    assert (call.data_ids, call.mask_ids) == want


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


@pytest.mark.parametrize("seed,n,domain,skew", [
    (21, 5000, 10_000, 0.0),  # q15's shape: more groups than rows
    (22, 4001, 37, 0.0),
    (23, 4001, 2500, 0.9),    # most rows at id 0, as unselected probe rows
    (24, 0, 5, 0.0),
])
def test_sorted_segments_add_in_row_order(seed, n, domain, skew):
    # every group's rows add in row order, so the float64 sums equal numpy's
    # unbuffered np.add.at bit for bit, and the reference's segment sum
    # within float64 rounding; one sort serves every column
    import jax

    rng = np.random.RandomState(seed)
    gid = rng.randint(0, domain, n).astype(np.int32)
    gid[rng.rand(n) < skew] = 0
    xs = [rng.rand(n) * 1e5, rng.rand(n) - 0.5]
    segments = port.SortedSegments(torch.from_numpy(gid), domain)
    for x in xs:
        got = segments.sum(torch.from_numpy(x))
        want = np.zeros(domain)
        np.add.at(want, gid, x)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)
        ref_sum = np.asarray(jax.ops.segment_sum(
            jnp.asarray(x), jnp.asarray(gid), num_segments=domain))
        np.testing.assert_allclose(got.numpy(), ref_sum, rtol=1e-12)
    # a scalar broadcasts to every row
    ones = segments.sum(torch.tensor(1.0, dtype=torch.float64))
    np.testing.assert_array_equal(ones.numpy(),
                                  np.bincount(gid, minlength=domain))


def test_sorted_segments_ids_outside_domain():
    gid = torch.tensor([0, 3, -1, 2, 7, 3], dtype=torch.int32)
    x = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0], dtype=torch.float64)
    got = port.SortedSegments(gid, 4).sum(x)
    np.testing.assert_array_equal(got.numpy(), [1.0, 0.0, 8.0, 34.0])


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
