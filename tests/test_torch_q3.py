"""TPC-H Q3 and the compiled join->aggregate pipeline: the port's
`Context(device="cpu")` against the reference `Context`, on the same seeded
frames.

Both sides sum float64 columns in float64 here (the port's plain segment
sum, the reference's scatter), so float results agree within 1e-9
relative; keys, dates and counts must be exact.  The pipeline must fire
where the reference's fires and decline where the reference's declines
(a spy on each side's `CompiledJoinAggregate.run`).  The unit cases hold
the port's join, membership and top-k functions against the reference's
on seeded inputs.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import dask_sql_tpu
import dask_sql_tpu.physical.compiled_join as ref_cj
from dask_sql_tpu.columnar.column import Column as RefColumn
from dask_sql_tpu.ops import join as ref_join
from dask_sql_tpu.ops import membership as ref_membership
from dask_sql_tpu.ops import sorting as ref_sorting
import dask_sql_tpu_torch.physical.compiled_join as port_cj
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.columnar.column import Column
from dask_sql_tpu_torch.ops import join as port_join
from dask_sql_tpu_torch.ops import membership as port_membership
from dask_sql_tpu_torch.ops import sorting as port_sorting
from dask_sql_tpu_torch.utils import TRANSFER_STATS
from chip_smoke import q3_oracle
from tests.tpch import QUERIES, generate

REL = 1e-9


@pytest.fixture
def spies(monkeypatch):
    """Runs of each side's join pipeline: {"ref": [...], "port": [...]}."""
    hits = {"ref": [], "port": []}
    ref_run, port_run = ref_cj.CompiledJoinAggregate.run, port_cj.CompiledJoinAggregate.run

    def ref_spy(self, params=()):
        hits["ref"].append(self)
        return ref_run(self, params)

    def port_spy(self, probe_table, build_tables):
        hits["port"].append(self)
        return port_run(self, probe_table, build_tables)

    monkeypatch.setattr(ref_cj.CompiledJoinAggregate, "run", ref_spy)
    monkeypatch.setattr(port_cj.CompiledJoinAggregate, "run", port_spy)
    return hits


def _contexts(frames):
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    for name, frame in frames.items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    return rc, pc


def _both(frames, sql, spies, contexts=None):
    """(port result, reference result); the pipeline fired on both sides
    or on neither."""
    rc, pc = contexts or _contexts(frames)
    want = rc.sql(sql).compute()
    got = pc.sql(sql).compute()
    assert len(spies["port"]) == len(spies["ref"]), spies
    return got, want


def assert_same_rows(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in got.columns:
        g, w = got[name].reset_index(drop=True), want[name].reset_index(drop=True)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=REL,
                                       err_msg=name)
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True)


ENCODING_COUNTERS = ("columnar.encoding.encoded_columns",
                     "columnar.encoding.decode",
                     "columnar.encoding.codespace_pred",
                     "columnar.encoding.late_rows")


def test_q3_matches_reference(spies):
    """Q3 over the encoded columns both sides load (FOR and DICT keys and
    dates, an RLE `o_shippriority` on a build side): the probe side's
    filter runs on the codes, the build sides decode at their scans, and
    the encoding counters equal the reference's."""
    tables = generate(20_000)
    frames = {n: tables[n] for n in ("customer", "orders", "lineitem")}
    rc, pc = contexts = _contexts(frames)
    orders = pc.schema["root"].tables["orders"].table
    assert orders.columns["o_shippriority"].encoding.value == "RLE"
    got, want = _both(frames, QUERIES[3], spies, contexts)
    assert len(spies["port"]) == 1
    assert len(got) == 10
    assert_same_rows(got, want)
    assert list(got.dtypes) == list(want.dtypes)
    ref_counters = rc.metrics.snapshot()["counters"]
    assert {k: pc.metrics[k] for k in ENCODING_COUNTERS} == \
        {k: ref_counters.get(k, 0) for k in ENCODING_COUNTERS}
    assert pc.metrics["columnar.encoding.codespace_pred"] == 2
    oracle = q3_oracle(frames)
    for key in ("l_orderkey", "o_orderdate", "o_shippriority"):
        assert got[key].tolist() == oracle[key].tolist()
    np.testing.assert_allclose(got["revenue"].to_numpy(),
                               oracle["revenue"].to_numpy(), rtol=REL)


def test_q3_warm_run_hits_the_plan_cache_with_one_transfer(spies):
    tables = generate(5_000, seed=2)
    c = Context(device="cpu")
    for n in ("customer", "orders", "lineitem"):
        c.create_table(n, tables[n])
    cold = c.sql(QUERIES[3]).compute()
    TRANSFER_STATS["d2h"] = 0
    warm = c.sql(QUERIES[3]).compute()
    assert TRANSFER_STATS["d2h"] == 1
    assert c.metrics["query.plan_cache.hit"] == 1
    assert len(spies["port"]) == 2 and spies["port"][0] is spies["port"][1]
    assert warm.equals(cold)


@pytest.fixture
def star():
    rng = np.random.RandomState(3)
    n = 5000
    fact = pd.DataFrame({
        "f_dim1": rng.randint(0, 100, n),
        "f_dim2": rng.randint(1000, 1050, n),
        "f_val": rng.rand(n) * 100,
        "f_qty": rng.randint(1, 10, n),
    })
    dim1 = pd.DataFrame({
        "d1_key": np.arange(100),
        "d1_cat": [f"cat{i % 7}" for i in range(100)],
        "d1_flag": (np.arange(100) % 3 == 0),
    })
    dim2 = pd.DataFrame({
        "d2_key": np.arange(1000, 1050),
        "d2_region": [f"r{i % 5}" for i in range(50)],
    })
    return {"fact": fact, "dim1": dim1, "dim2": dim2}


def test_star_join_agg_fires_and_matches(star, spies):
    q = ("SELECT d1_cat, SUM(f_val) AS s, COUNT(*) AS n "
         "FROM fact JOIN dim1 ON f_dim1 = d1_key "
         "JOIN dim2 ON f_dim2 = d2_key "
         "WHERE d2_region = 'r2' AND f_qty > 3 "
         "GROUP BY d1_cat ORDER BY d1_cat")
    got, want = _both(star, q, spies)
    assert len(spies["port"]) == 1
    assert spies["port"][0].radix_spec is not None  # a radix gid: 7 categories
    assert_same_rows(got, want)
    fact, dim1, dim2 = star["fact"], star["dim1"], star["dim2"]
    m = fact.merge(dim1, left_on="f_dim1", right_on="d1_key")
    m = m.merge(dim2, left_on="f_dim2", right_on="d2_key")
    m = m[(m.d2_region == "r2") & (m.f_qty > 3)]
    exp = m.groupby("d1_cat").agg(s=("f_val", "sum"), n=("f_val", "count"))
    exp = exp.reset_index().sort_values("d1_cat")
    assert list(got["d1_cat"]) == list(exp["d1_cat"])
    np.testing.assert_allclose(got["s"].to_numpy(), exp["s"].to_numpy(), rtol=REL)
    np.testing.assert_array_equal(got["n"].to_numpy(), exp["n"].to_numpy())


def test_group_by_join_key_uses_pointer_gid(star, spies):
    q = ("SELECT f_dim1, AVG(f_val) AS a FROM fact "
         "JOIN dim1 ON f_dim1 = d1_key WHERE d1_flag GROUP BY f_dim1")
    got, want = _both(star, q, spies)
    assert len(spies["port"]) == 1
    assert spies["port"][0].gid_join == 0  # the build-row pointer is the gid
    got = got.sort_values("f_dim1").reset_index(drop=True)
    assert_same_rows(got, want.sort_values("f_dim1").reset_index(drop=True))
    fact, dim1 = star["fact"], star["dim1"]
    m = fact.merge(dim1[dim1.d1_flag], left_on="f_dim1", right_on="d1_key")
    exp = m.groupby("f_dim1").f_val.mean()
    np.testing.assert_array_equal(got["f_dim1"].to_numpy(), exp.index.to_numpy())
    np.testing.assert_allclose(got["a"].to_numpy(), exp.to_numpy(), rtol=REL)


def test_encoded_probe_group_keys_take_their_codes(star, spies):
    """A DICT probe column (`f_qty`, 9 values) and a FOR one (`f_big`) as
    radix group keys: the pipelines read their codes as radix digits and
    the host decode maps them back, as the reference does."""
    rng = np.random.RandomState(6)
    fact = star["fact"].assign(
        f_big=10**9 + rng.randint(0, 3000, len(star["fact"])) * 7)
    frames = dict(star, fact=fact)
    rc, pc = contexts = _contexts(frames)
    table = pc.schema["root"].tables["fact"].table
    assert table.columns["f_qty"].encoding.value == "DICT"
    assert table.columns["f_big"].encoding.value == "FOR"
    for sql in ("SELECT f_qty, f_big, COUNT(*) AS n, SUM(f_val) AS s "
                "FROM fact JOIN dim1 ON f_dim1 = d1_key WHERE d1_flag "
                "GROUP BY f_qty, f_big",
                "SELECT f_big, f_qty, COUNT(*) AS n, SUM(f_val) AS s "
                "FROM fact WHERE f_qty > 3 GROUP BY f_big, f_qty"):
        got, want = _both(frames, sql, spies, contexts)
        keys = list(got.columns[:2])
        got = got.sort_values(keys).reset_index(drop=True)
        want = want.sort_values(keys).reset_index(drop=True)
        assert_same_rows(got, want)
    assert len(spies["port"]) == 1
    assert [s["kind"] for s in spies["port"][0].radix_spec] == ["dict", "int"]
    assert pc.metrics["resilience.rung.compiled_aggregate"] == 1


def test_null_join_keys_never_match(spies):
    frames = {
        "fact": pd.DataFrame({"k": [1.0, 2.0, None, 3.0, None, 1.0],
                              "v": [10.0, 20, 30, 40, 50, 60]}),
        "dim": pd.DataFrame({"dk": [1, 2, 4], "cat": ["a", "b", "c"]}),
    }
    got, want = _both(frames, "SELECT cat, SUM(v) AS s FROM fact JOIN dim "
                              "ON k = dk GROUP BY cat ORDER BY cat", spies)
    assert list(got["cat"]) == ["a", "b"]
    np.testing.assert_allclose(got["s"].to_numpy(), [70.0, 20.0])
    assert_same_rows(got, want)


def test_global_agg_over_join(spies):
    frames = {"fact": pd.DataFrame({"k": np.arange(100) % 10, "v": np.ones(100)}),
              "dim": pd.DataFrame({"dk": np.arange(5)})}  # half the keys
    got, want = _both(frames, "SELECT COUNT(*) AS n, SUM(v) AS s FROM fact "
                              "JOIN dim ON k = dk", spies)
    assert len(spies["port"]) == 1
    assert int(got["n"][0]) == 50 and float(got["s"][0]) == 50.0
    assert_same_rows(got, want)
    # no matching row: still one row, COUNT 0
    got0, want0 = _both(frames, "SELECT COUNT(*) AS n FROM fact JOIN dim "
                                "ON k = dk WHERE v > 99", spies)
    assert len(got0) == 1 and int(got0["n"][0]) == 0
    assert_same_rows(got0, want0)


def test_duplicate_build_keys_fall_back(spies):
    """A build side with repeated keys: the pipeline declines (counted),
    and the eager join feeds the aggregate."""
    frames = {"fact": pd.DataFrame({"k": [1, 2, 2, 3], "v": [1.0, 2, 3, 4]}),
              "dim": pd.DataFrame({"dk": [2, 2, 3], "w": [10.0, 20, 30]})}
    rc, pc = _contexts(frames)
    sql = "SELECT SUM(v * w) AS s FROM fact JOIN dim ON k = dk"
    got, want = pc.sql(sql).compute(), rc.sql(sql).compute()
    assert spies == {"ref": [], "port": []}
    assert pc.metrics["compiled_join.declined"] == 1
    # (2*10)+(2*20)+(3*10)+(3*20)+(4*30)
    assert float(got["s"][0]) == 270.0
    assert_same_rows(got, want)


def test_table_update_invalidates_cache(star, spies):
    q = ("SELECT SUM(f_val) AS s FROM fact JOIN dim1 ON f_dim1 = d1_key "
         "WHERE d1_flag")
    c = Context(device="cpu")
    for name, frame in star.items():
        c.create_table(name, frame)
    r1 = c.sql(q).compute()
    dim1b = star["dim1"].copy()
    dim1b["d1_flag"] = ~dim1b["d1_flag"]
    c.create_table("dim1", dim1b)
    r2 = c.sql(q).compute()
    assert len(spies["port"]) == 2 and spies["port"][0] is not spies["port"][1]
    fact, dim1 = star["fact"], star["dim1"]
    m1 = fact.merge(dim1[dim1.d1_flag], left_on="f_dim1", right_on="d1_key")
    m2 = fact.merge(dim1b[dim1b.d1_flag], left_on="f_dim1", right_on="d1_key")
    np.testing.assert_allclose(float(r1["s"][0]), m1.f_val.sum(), rtol=REL)
    np.testing.assert_allclose(float(r2["s"][0]), m2.f_val.sum(), rtol=REL)


# -- unit cases: the port's functions against the reference's -------------

@pytest.mark.parametrize("case", ["dense", "offset_nulls", "duplicate", "sparse"])
def test_dense_unique_lut_matches_reference(case):
    rng = np.random.RandomState(11)
    if case == "dense":
        key, valid = rng.permutation(5000).astype(np.int64), None
    elif case == "offset_nulls":
        key = rng.permutation(3000).astype(np.int64) + 10**12
        valid = rng.rand(3000) > 0.1
    elif case == "duplicate":
        key, valid = rng.randint(0, 100, 500).astype(np.int64), None
    else:  # a value range past the gate
        key, valid = (rng.permutation(100) * 10**6).astype(np.int64), None
    want = ref_join.dense_unique_lut(
        jnp.asarray(key), None if valid is None else jnp.asarray(valid))
    got = port_join.dense_unique_lut(
        torch.from_numpy(key), None if valid is None else torch.from_numpy(valid))
    assert (got is None) == (want is None)
    if want is not None:
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("case", ["dense", "duplicates", "nulls_and_floats", "strings"])
def test_inner_join_indices_match_reference(case):
    rng = np.random.RandomState(12)
    # one size for every case: the reference's eager ops compile per shape
    nl, nr = 600, 80
    if case == "dense":
        left, right = rng.randint(0, 100, nl), rng.permutation(nr)
    elif case == "duplicates":
        left, right = rng.randint(0, 50, nl), rng.randint(0, 60, nr)
    elif case == "nulls_and_floats":
        left = rng.randint(0, 40, nl).astype(np.float64)
        right = rng.randint(0, 40, nr).astype(np.float64)
    else:
        left = np.array([f"k{i}" for i in rng.randint(0, 30, nl)], dtype=object)
        right = np.array([f"k{i}" for i in rng.randint(10, 50, nr)], dtype=object)
    lmask = rng.rand(len(left)) > 0.1 if case == "nulls_and_floats" else None
    rmask = rng.rand(len(right)) > 0.1 if case == "nulls_and_floats" else None

    def pairs(gids_fn, inner_fn, col_fn):
        lg, rg = gids_fn([col_fn(left, lmask)], [col_fn(right, rmask)])
        li, ri = inner_fn(lg, rg)
        li, ri = np.asarray(li), np.asarray(ri)
        return sorted(zip(li.tolist(), ri.tolist()))

    got = pairs(port_join.join_key_gids, port_join.inner_join_indices,
                lambda a, m: Column.from_numpy(a, m))
    want = pairs(ref_join.join_key_gids, ref_join.inner_join_indices,
                 lambda a, m: RefColumn.from_numpy(a, m))
    assert got == want
    assert len(got) > 0


def test_take_with_nulls_matches_reference():
    rng = np.random.RandomState(13)
    data = rng.rand(50)
    valid = rng.rand(50) > 0.2
    idx = rng.randint(-1, 50, 200)
    got = port_join.take_with_nulls(Column.from_numpy(data, valid),
                                    torch.from_numpy(idx))
    want = ref_join.take_with_nulls(RefColumn.from_numpy(data, valid),
                                    jnp.asarray(idx))
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("dtype,values", [
    (np.int64, np.arange(0, 4000, 3)),
    (np.int32, np.array([1.0, 2.5, 7.0, 1e30])),  # only integral members match
    (np.float64, np.array([0.5, 0.25, np.nan])),
    (np.int64, np.array([], dtype=np.int64)),
])
def test_sorted_membership_matches_reference(dtype, values):
    rng = np.random.RandomState(14)
    if np.dtype(dtype).kind == "f":
        data = rng.choice([0.5, 0.25, 0.75, np.nan], 1000).astype(dtype)
    else:
        data = rng.randint(-5, 5000, 1000).astype(dtype)
    got = port_membership.sorted_membership(torch.from_numpy(data), values)
    want = ref_membership.sorted_membership(jnp.asarray(data), values)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dictionary_membership_matches_reference():
    rng = np.random.RandomState(15)
    dictionary = np.array(["AIR", "MAIL", "RAIL", "SHIP"], dtype=object)
    codes = rng.randint(0, 4, 300).astype(np.int32)
    got = port_membership.dictionary_membership(torch.from_numpy(codes),
                                                dictionary, ["MAIL", "SHIP", "X"])
    want = ref_membership.dictionary_membership(jnp.asarray(codes), dictionary,
                                                ["MAIL", "SHIP", "X"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype,ascending,k,exact_ties", [
    (np.float64, False, 40, True),
    (np.int64, True, 25, False),
    (np.int64, False, 10, True),   # ties across the boundary: ineligible
    (np.float32, True, 5000, False),  # k past the row count
])
def test_topk_permutation_matches_reference(dtype, ascending, k, exact_ties):
    rng = np.random.RandomState(16)
    if np.dtype(dtype).kind == "f":
        data = (rng.rand(3000) * 1e4).astype(dtype)
    else:
        data = rng.randint(0, 500, 3000).astype(dtype)
    got = port_sorting.topk_permutation(Column.from_numpy(data), ascending, k,
                                        exact_ties)
    want = ref_sorting.topk_permutation(RefColumn.from_numpy(data), ascending,
                                        k, exact_ties)
    assert (got is None) == (want is None)
    if want is not None:
        # the same rows (the port keeps them in input order)
        np.testing.assert_array_equal(got.numpy(), np.sort(np.asarray(want)))
