"""The port's shard mesh, sharded tables, collectives and dist_plan functions
(dask_sql_tpu_torch/parallel/) against the reference's (dask_sql_tpu/
parallel/), on the CPU.

The reference runs on the eight virtual devices `tests/conftest.py` makes;
the port on a mesh of eight shards on the CPU, the stand-in for them.  The
same seeded numpy inputs go to both.  Tolerances: keys, counts, row ids,
routing and every integer state exact; float64 sums within 1e-9 relative
(the two sides add in different orders).  The reference's checks that a
compiled program holds an ``all-to-all`` become counts of the port's
exchanges (`collectives.EXCHANGES`).  The reference retries an exchange
that overflows its capacity; the port sizes each exactly after one count,
so the skewed join below runs once (a divergence by design).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_sql_tpu.columnar.column import Column as RefColumn
from dask_sql_tpu.columnar.table import Table as RefTable
from dask_sql_tpu.parallel import collectives as ref_cx
from dask_sql_tpu.parallel import dist_plan as ref_dp
from dask_sql_tpu.parallel import distribute as ref_dist
from dask_sql_tpu.parallel import mesh as ref_mesh
from dask_sql_tpu_torch.columnar.column import Column
from dask_sql_tpu_torch.columnar.encodings import Encoding
from dask_sql_tpu_torch.columnar.table import Table
from dask_sql_tpu_torch.parallel import collectives as cx
from dask_sql_tpu_torch.parallel import dist_plan as dp
from dask_sql_tpu_torch.parallel import distribute
from dask_sql_tpu_torch.parallel import mesh as pm
from dask_sql_tpu_torch.resilience.errors import ResourceExhaustedError

NDEV = 8

pytestmark = pytest.mark.skipif(len(jax.devices()) < NDEV,
                                reason="needs the eight virtual devices")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    return ref_mesh.make_mesh(NDEV), pm.make_mesh(NDEV, devices=["cpu"])


def _exchanges(fn):
    before = dict(cx.EXCHANGES)
    out = fn()
    return out, {k: cx.EXCHANGES[k] - before[k] for k in before
                 if cx.EXCHANGES[k] != before[k]}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_mesh_width_is_its_shards(meshes):
    _, mesh = meshes
    assert mesh.size == len(mesh) == NDEV
    assert set(mesh.devices) == {torch.device("cpu")}
    four = pm.make_mesh(4, devices=["cpu"])
    assert four.size == 4 and four != mesh
    # a pipeline keyed on one mesh is never reused on another
    assert pm.mesh_key(four) != pm.mesh_key(mesh)
    assert pm.mesh_key(mesh) == tuple(("cpu", i) for i in range(NDEV))
    assert pm.make_mesh(devices=["cpu"]).size == 1
    assert repr(four) == "Mesh[4 shards on cpu]"


def test_default_mesh_per_kind_and_set():
    pm.reset_default_mesh("cpu")
    try:
        assert pm.default_mesh("cpu").size == 1  # one host device
        wide = pm.make_mesh(3, devices=["cpu"])
        pm.set_default_mesh(wide)
        assert pm.default_mesh("cpu") is wide
    finally:
        pm.reset_default_mesh("cpu")


@pytest.mark.parametrize("n", [16, 19, 3])
def test_pad_to_multiple_matches_reference(n):
    a = np.arange(n, dtype=np.int64) * 3
    rp, rv = ref_mesh.pad_to_multiple(jnp.asarray(a), NDEV, fill=-1)
    pp, pv = pm.pad_to_multiple(torch.from_numpy(a), NDEV, fill=-1)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


def test_shard_rows_blocks_match_reference_shards(meshes):
    rmesh, mesh = meshes
    a = np.random.RandomState(0).rand(8 * 37)
    ref = ref_mesh.shard_rows(jnp.asarray(a), rmesh)
    ref_blocks = [np.asarray(s.data) for s in
                  sorted(ref.addressable_shards, key=lambda s: s.index[0].start)]
    got = pm.shard_rows(torch.from_numpy(a), mesh)
    assert len(got.parts) == NDEV
    for r, b in zip(ref_blocks, got.parts):
        np.testing.assert_array_equal(b.numpy(), r)
    # blocks on the tensor's device are views of it
    base = got.gather()
    assert dp.array_is_sharded(got)
    np.testing.assert_array_equal(base.numpy(), a)
    rep = pm.replicated(mesh, torch.from_numpy(a))
    assert not dp.array_is_sharded(rep)
    assert all(p is rep.parts[0] for p in rep.parts)


# ---------------------------------------------------------------------------
# sharded tables: uneven blocks, views, encodings
# ---------------------------------------------------------------------------
def _frame(n, seed=3):
    rng = np.random.RandomState(seed)
    return pd.DataFrame({
        "g": rng.randint(0, 5, n).astype(np.int64),
        "x": rng.rand(n),
        "k": rng.randint(0, 50, n).astype(np.int64),
        "s": rng.choice(["a", "b", "c"], n),
    })


def test_shard_table_uneven_blocks_are_views():
    df = _frame(100_003)
    t = Table.from_pandas(df, encode=True)
    mesh = pm.make_mesh(7, devices=["cpu"])
    st = distribute.shard_table(t, mesh)
    sizes = st.sharding.sizes
    assert sum(sizes) == 100_003 and max(sizes) - min(sizes) == 1
    assert sizes == [14_287] + [14_286] * 6
    assert st.num_rows == t.num_rows  # no padding, no row_valid
    for name, col in st.columns.items():
        assert col.data.data_ptr() == t.columns[name].data.data_ptr(), name
        blocks = st.sharding.blocks(st)
        base = col.data.data_ptr()
        for i, b in enumerate(blocks):
            d = b.columns[name].data
            assert d.data_ptr() == base + st.sharding.offsets[i] \
                * d.element_size(), (name, i)
    # DICT/FOR codes shard like values; the encodings survive
    assert st.columns["g"].encoding is t.columns["g"].encoding
    info = distribute.table_sharding_info(st)
    assert "7 shards on cpu" in info["x"]


def test_shard_table_decodes_rle_and_matches_reference(meshes):
    rmesh, _ = meshes
    df = pd.DataFrame({"r": np.repeat(np.arange(40, dtype=np.int64), 250),
                       "x": np.random.RandomState(1).rand(10_000)})
    t = Table.from_pandas(df, encode=True)
    assert t.columns["r"].encoding is Encoding.RLE
    st = distribute.shard_table(t, pm.make_mesh(NDEV, devices=["cpu"]))
    assert st.columns["r"].encoding is Encoding.PLAIN
    rt = ref_dist.shard_table(RefTable.from_pandas(df, encode=True), rmesh)
    for name in ("r", "x"):
        np.testing.assert_array_equal(
            st.columns[name].data.numpy(),
            np.asarray(rt.depad().columns[name].decode().data))


def test_sharded_filter_keeps_each_blocks_survivors():
    df = _frame(1000)
    t = distribute.shard_table(Table.from_pandas(df),
                               pm.make_mesh(7, devices=["cpu"]))
    mask = t.columns["x"].data > 0.5
    out = t.filter(mask)
    want = [int((df.x.to_numpy()[lo:hi] > 0.5).sum()) for lo, hi in
            zip(t.sharding.offsets[:-1], t.sharding.offsets[1:])]
    assert out.sharding.sizes == want
    assert out.num_rows == int((df.x > 0.5).sum())
    assert t.select(["x"]).sharding is t.sharding
    assert t.slice(0, 5).sharding is None and t.unsharded().sharding is None


# ---------------------------------------------------------------------------
# the capacity-bounded collectives
# ---------------------------------------------------------------------------
def test_dist_groupby_matches_reference(meshes):
    rmesh, mesh = meshes
    rng = np.random.RandomState(4)
    n = 128 * NDEV
    keys = rng.randint(0, 64, n).astype(np.int64)
    vals = rng.rand(n) * 10
    valid = rng.rand(n) < 0.9
    ref = ref_cx.make_dist_groupby(rmesh, capacity=256)(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
    got, ex = _exchanges(lambda: cx.make_dist_groupby(mesh, capacity=256)(
        torch.from_numpy(keys), torch.from_numpy(vals),
        torch.from_numpy(valid)))
    assert ex == {"all_gather": 3 * NDEV}
    assert tuple(got[0].shape) == (NDEV, 256)
    assert not bool(np.asarray(ref[3]).any()) and not bool(got[3].any())
    r = ref_cx.finalize_states(*ref[:3])
    p = cx.finalize_states(*got[:3])
    np.testing.assert_array_equal(p[0], r[0])  # keys
    np.testing.assert_array_equal(p[1], r[1])  # counts
    for a, b in zip(p[2:], r[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-9)


def test_dist_groupby_flags_overflow():
    mesh = pm.make_mesh(NDEV, devices=["cpu"])
    keys = torch.arange(NDEV * 40, dtype=torch.int64)
    out = cx.make_dist_groupby(mesh, capacity=16)(
        keys, keys.to(torch.float64), torch.ones(keys.shape[0],
                                                 dtype=torch.bool))
    assert bool(out[3].all())  # 40 distinct keys a shard > 16 slots


def test_hash_shuffle_matches_reference_exactly(meshes):
    rmesh, mesh = meshes
    rng = np.random.RandomState(5)
    n = 64 * NDEV
    keys = rng.randint(0, 1000, n).astype(np.int64)
    payload = rng.rand(n, 2)
    valid = rng.rand(n) < 0.8
    ref = ref_cx.make_hash_shuffle(rmesh, capacity_per_peer=32,
                                   n_payloads=2)(
        jnp.asarray(keys), jnp.asarray(payload), jnp.asarray(valid))
    got, ex = _exchanges(lambda: cx.make_hash_shuffle(
        mesh, capacity_per_peer=32, n_payloads=2)(
        torch.from_numpy(keys), torch.from_numpy(payload),
        torch.from_numpy(valid)))
    assert ex == {"all_to_all": 3}
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_join_counts_match_reference(meshes):
    rmesh, mesh = meshes
    rng = np.random.RandomState(6)
    n = 64 * NDEV
    lk = rng.randint(0, 200, n).astype(np.int64)
    rk = rng.randint(0, 200, n).astype(np.int64)
    lv = rng.rand(n) < 0.9
    rv = rng.rand(n) < 0.9
    args = (lk, lv, rk, rv)
    ref_b = ref_cx.make_broadcast_join_count(rmesh)(
        *[jnp.asarray(a) for a in args])
    got_b = cx.make_broadcast_join_count(mesh)(
        *[torch.from_numpy(a) for a in args])
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))
    ref_d = ref_cx.make_dist_join_count(rmesh, capacity_per_peer=64)(
        *[jnp.asarray(a) for a in args])
    got_d = cx.make_dist_join_count(mesh, capacity_per_peer=64)(
        *[torch.from_numpy(a) for a in args])
    np.testing.assert_array_equal(got_d[0].numpy(), np.asarray(ref_d[0]))
    np.testing.assert_array_equal(got_d[1].numpy(), np.asarray(ref_d[1]))
    assert got_d[2] == bool(np.asarray(ref_d[2]).any())


# ---------------------------------------------------------------------------
# dist_plan: predicates, encodings, routing, kernels
# ---------------------------------------------------------------------------
def test_hash_routes_like_the_reference():
    rng = np.random.RandomState(7)
    a = rng.randint(-2**62, 2**62, 4096).astype(np.int64)
    b = rng.randint(-5, 5, 4096).astype(np.int64)
    ref = np.asarray(ref_dp._hash_keys([jnp.asarray(a), jnp.asarray(b)]))
    got = dp._hash_keys([torch.from_numpy(a), torch.from_numpy(b)]).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        torch.remainder(torch.from_numpy(got), NDEV).numpy(),
        np.mod(ref, NDEV))
    x = np.concatenate([rng.randn(1000) * 1e6, [0.0, -0.0, np.inf, -np.inf]])
    np.testing.assert_array_equal(
        dp._float_to_ordered_i64(torch.from_numpy(x)).numpy(),
        np.asarray(ref_dp._float_to_ordered_i64(jnp.asarray(x))))
    o = dp._float_to_ordered_i64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(dp._ordered_i64_to_float(o),
                                  np.where(x == 0, x, x))


@pytest.mark.parametrize("kind", ["float_nullable", "int", "bool", "string"])
def test_key_and_value_encodings_match_reference(kind):
    rng = np.random.RandomState(8)
    n = 500
    if kind == "float_nullable":
        arr = rng.randn(n)
        arr[::7] = np.nan
        arr[::11] = -0.0
    elif kind == "int":
        arr = rng.randint(-100, 100, n).astype(np.int64)
    elif kind == "bool":
        arr = rng.rand(n) < 0.5
    else:
        arr = rng.choice(["x", "y", "zz"], n).astype(object)
    pcol = Column.from_numpy(arr)
    rcol = RefColumn.from_numpy(arr)
    pk, pinfo = dp.encode_key_column(pcol)
    rk, rinfo = ref_dp.encode_key_column(rcol)
    assert len(pk) == len(rk)
    for a, b in zip(pk, rk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    def plain(info):  # the two packages' SqlType enums by value
        return {k: getattr(v, "value", v) for k, v in info.items()
                if k != "dictionary"}

    assert plain(pinfo) == plain(rinfo)
    back = dp.decode_key_outputs([a.numpy() for a in pk], [pinfo])[0]
    ref_back = ref_dp.decode_key_outputs([np.asarray(b) for b in rk],
                                         [rinfo])[0]
    np.testing.assert_array_equal(back.to_numpy().astype(str),
                                  ref_back.to_numpy().astype(str))
    if kind != "string":
        pi, pf, _ = dp.encode_value_column(pcol)
        ri, rf, _ = ref_dp.encode_value_column(rcol)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pf.numpy(), np.asarray(rf))


def test_capacity_ladders_match_reference():
    for ladder in (dp.GROUP_CAPACITY_LADDER, dp.PEER_CAPACITY_LADDER):
        assert ladder in (ref_dp.GROUP_CAPACITY_LADDER,
                          ref_dp.PEER_CAPACITY_LADDER)
        for v in (0, 1000, ladder[1], ladder[-1] + 1):
            assert dp._ladder_at_least(ladder, v) == \
                ref_dp._ladder_at_least(ladder, v)
        assert dp._ladder_next(ladder, ladder[0]) == ladder[1]
        assert dp._ladder_next_or_none(ladder, ladder[-1]) is None
        with pytest.raises(ResourceExhaustedError):
            dp._ladder_next(ladder, ladder[-1])
    assert set(dp.STATS) == set(ref_dp.STATS)


def test_sorted_probe_and_broadcast_pairs_match_reference():
    rng = np.random.RandomState(9)
    big = rng.randint(0, 60, 3000).astype(np.int64)
    bv = rng.rand(3000) < 0.95
    small = rng.randint(0, 80, 200).astype(np.int64)  # duplicates: sorted
    sv = rng.rand(200) < 0.9
    rp, ro = ref_dp._sorted_probe(*[jnp.asarray(a) for a in
                                    (big, bv, small, sv)])
    pp, po = dp._sorted_probe(*[torch.from_numpy(a) for a in
                                (big, bv, small, sv)])
    np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(po.numpy(), np.asarray(ro))
    for sk in (small, np.arange(80, dtype=np.int64)):  # sorted, then LUT
        skv = np.ones(sk.shape[0], dtype=bool) if sk is not small else sv
        r = ref_dp.broadcast_inner_pairs(*[jnp.asarray(a) for a in
                                           (big, bv, sk, skv)])
        offsets = pm.block_offsets(3000, NDEV)
        p = dp.broadcast_inner_pairs(*[torch.from_numpy(a) for a in
                                       (big, bv, sk, skv)], offsets)
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(r[0]))
        np.testing.assert_array_equal(p[1].numpy(), np.asarray(r[1]))
        np.testing.assert_array_equal(p[2].numpy(), np.asarray(r[2]))
        # the pairs' blocks follow the big side's blocks
        bi = p[0].numpy()
        assert p[3] == tuple(int(np.searchsorted(bi, o)) for o in offsets)


def test_dist_inner_pairs_match_reference_exactly(meshes):
    rmesh, mesh = meshes
    rng = np.random.RandomState(10)
    nl, nr = 800, 640
    lg = rng.randint(0, 300, nl).astype(np.int64)
    rg = rng.randint(0, 300, nr).astype(np.int64)
    lv = rng.rand(nl) < 0.9
    rv = rng.rand(nr) < 0.9
    r = ref_dp.dist_inner_pairs(rmesh, jnp.asarray(lg), jnp.asarray(lv),
                                jnp.asarray(rg), jnp.asarray(rv))
    (li, ri, lmatch, blocks), ex = _exchanges(lambda: dp.dist_inner_pairs(
        mesh, torch.from_numpy(lg), torch.from_numpy(lv),
        torch.from_numpy(rg), torch.from_numpy(rv)))
    assert ex == {"all_to_all": 2, "all_gather": 2}
    # the same owners (the reference's hash), the same order in each
    np.testing.assert_array_equal(li.numpy(), np.asarray(r[0]))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(r[1]))
    np.testing.assert_array_equal(lmatch.numpy(), np.asarray(r[2]))
    assert blocks[-1] == li.shape[0] and len(blocks) == NDEV + 1


def test_skewed_join_runs_once_sized_exactly(meshes):
    """The reference's test_dist_pairs_capacity_retry: one key on every row
    overflows its first capacities and retries; the port counts first and
    runs once."""
    _, mesh = meshes
    n = 6000
    before = dp.STATS["join_kernel"]
    li, ri, lm, _ = dp.dist_inner_pairs(
        mesh, torch.zeros(n, dtype=torch.int64), torch.ones(n, dtype=bool),
        torch.zeros(20, dtype=torch.int64), torch.ones(20, dtype=bool))
    assert int(li.shape[0]) == n * 20 and bool(lm.all())
    assert dp.STATS["join_kernel"] == before + 1


def test_dist_groupby_kernel_exchanges_without_gather(meshes):
    """The agg kernel routes by all-to-all and never all-gathers (the
    reference's HLO check)."""
    _, mesh = meshes
    rng = np.random.RandomState(11)
    keys = torch.from_numpy(rng.randint(0, 64, 1024).astype(np.int64))
    blocks = cx.split_even(keys, mesh)
    ones = [torch.ones((1, b.shape[0]), dtype=torch.bool) for b in blocks]
    out, ex = _exchanges(lambda: dp.run_dist_groupby(
        mesh, [[b] for b in blocks], [b[None] for b in blocks],
        [b[None].to(torch.float64) for b in blocks], ones))
    assert ex == {"all_to_all": 2}
    owned = [set(o[0][0].tolist()) for o in out]
    assert set().union(*owned) == set(keys.tolist())
    assert sum(len(s) for s in owned) == len(set(keys.tolist()))  # disjoint
    for me, keys_me in enumerate(owned):
        for k in keys_me:
            h = dp._hash_keys([torch.tensor([k])])
            assert int(torch.remainder(h, NDEV)) == me


def test_dist_sort_matches_reference_row_for_row(meshes):
    rmesh, mesh = meshes
    rng = np.random.RandomState(12)
    n = 3001
    df = pd.DataFrame({"a": rng.randint(0, 20, n).astype(np.int64),
                       "b": rng.randn(n), "i": np.arange(n, dtype=np.int64)})
    df.loc[rng.rand(n) < 0.05, "b"] = np.nan
    rt = ref_dist.shard_table(RefTable.from_pandas(df, encode=False), rmesh)
    pt = distribute.shard_table(Table.from_pandas(df, encode=False), mesh)
    asc, nf = [True, False], [False, True]
    r = ref_dp.dist_sort_table(rmesh, rt, [rt.columns["a"], rt.columns["b"]],
                               asc, nf)
    p = dp.dist_sort_table(mesh, pt, [pt.columns["a"], pt.columns["b"]],
                           asc, nf)
    np.testing.assert_array_equal(p.columns["i"].data.numpy(),
                                  np.asarray(r.columns["i"].data))
    assert p.sharding.mesh == mesh and p.sharding.sizes[0] == -(-n // NDEV)


def test_sharding_predicates():
    mesh = pm.make_mesh(NDEV, devices=["cpu"])
    t = Table.from_pandas(_frame(100))
    st = distribute.shard_table(t, mesh)
    assert dp.table_is_sharded(st) and dp.mesh_for_table(st) == mesh
    assert not dp.table_is_sharded(t)
    one = distribute.shard_table(t, pm.make_mesh(1, devices=["cpu"]))
    assert one.sharding is not None and not dp.table_is_sharded(one)
