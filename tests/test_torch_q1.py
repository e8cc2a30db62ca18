"""TPC-H Q1 through the port's `Context(device="cpu")` against the reference
`Context`, on the same seeded frames.

The reference runs with ``sql.compile.segsum = "matmul"``: its float64-carry
segment sum, which runs on the CPU (its CPU default, scatter, sums float32
columns in float32).  Group keys, counts and output dtypes must match
exactly; float results within MATMUL_FLOAT_REL_ERR_BOUND relative, the
bound the reference's own segment sum is held to.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from bench import QUERY, gen_lineitem
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.columnar.table import Table
from dask_sql_tpu_torch.ops import segsum as segsum_ops
from dask_sql_tpu_torch.utils import TRANSFER_STATS
from tests.tpch import QUERIES, generate

REL = segsum_ops.MATMUL_FLOAT_REL_ERR_BOUND
KEYS = ["l_returnflag", "l_linestatus"]


def _reference(df, sql):
    c = dask_sql_tpu.Context()
    c.create_table("lineitem", df)
    return c.sql(sql, config_options={"sql.compile.segsum": "matmul"}).compute()


@pytest.fixture
def segsum_calls(monkeypatch):
    """Counts calls of the reducer's segment-sum entry point."""
    calls = []
    inner = segsum_ops.segsum_typed

    def counted(gid, columns, domain):
        calls.append((domain, len(columns)))
        return inner(gid, columns, domain)

    monkeypatch.setattr(segsum_ops, "segsum_typed", counted)
    return calls


def _port(source, sql, segsum_calls):
    c = Context(device="cpu")
    c.create_table("lineitem", source)
    TRANSFER_STATS["d2h"] = 0
    got = c.sql(sql).compute()
    assert TRANSFER_STATS["d2h"] == 1
    assert len(segsum_calls) == 1
    return got


def assert_same_result(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert list(got.dtypes) == list(want.dtypes)
    assert len(got) == len(want)
    for name in got.columns:
        g, w = got[name].reset_index(drop=True), want[name].reset_index(drop=True)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=REL,
                                       err_msg=name)
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True)


@pytest.mark.parametrize("frame", ["bench", "tpch"])
def test_q1_matches_reference(frame, segsum_calls):
    if frame == "bench":
        df, sql = gen_lineitem(20_000), QUERY
    else:
        df, sql = generate(2000)["lineitem"], QUERIES[1]
    got = _port(df, sql, segsum_calls)
    assert_same_result(got, _reference(df, sql))
    assert len(got) == 6
    # one segment sum of 11 typed columns over the 4 x 3 radix domain: five
    # float sums read in their own dtype under their masks, and six count
    # masks, in both frames
    domain, k = segsum_calls[0]
    assert domain == 12
    assert k == 11


def test_q1_null_keys_nan_floats_and_empty_filter(segsum_calls):
    df = gen_lineitem(3000, seed=1)
    rng = np.random.RandomState(5)
    flags = df["l_returnflag"].astype(object)
    flags[rng.rand(len(df)) < 0.05] = None
    df["l_returnflag"] = flags
    price = df["l_extendedprice"].to_numpy().copy()
    price[rng.rand(len(df)) < 0.05] = np.nan
    df["l_extendedprice"] = price
    got = _port(df, QUERY, segsum_calls)
    want = _reference(df, QUERY)
    assert_same_result(got, want)
    assert got["l_returnflag"].isna().sum() == 2  # the NULL key's two groups

    empty = QUERY.replace("DATE '1998-09-02'", "DATE '1900-01-01'")
    segsum_calls.clear()
    got = _port(df, empty, segsum_calls)
    assert len(got) == 0
    assert_same_result(got, _reference(df, empty))

    # a global aggregate over no rows still yields one row: COUNT 0, SUM NULL
    glob = ("SELECT COUNT(*) AS n, SUM(l_quantity) AS s FROM lineitem "
            "WHERE l_shipdate <= DATE '1900-01-01'")
    segsum_calls.clear()
    got = _port(df, glob, segsum_calls)
    assert got["n"].tolist() == [0] and got["s"].isna().all()
    assert_same_result(got, _reference(df, glob))


ENCODING_COUNTERS = ("columnar.encoding.encoded_columns",
                     "columnar.encoding.codespace_pred",
                     "columnar.encoding.late_rows")


def test_q1_on_encoded_columns_counts_as_the_reference(monkeypatch):
    """Q1 over the columns the reference loads (DICT `l_quantity` and
    `l_shipdate`): the date filter runs on the codes, `l_quantity` reaches
    the segment sum as its decoded float32 values, only the 6 group rows
    decode on the host, and the counters equal the reference's."""
    df = gen_lineitem(20_000)
    c = Context(device="cpu")
    c.create_table("lineitem", df)
    table = c.schema["root"].tables["lineitem"].table
    assert table.columns["l_quantity"].data.dtype == torch.int16
    seen = []
    inner = segsum_ops.segsum_typed

    def spy(gid, columns, domain):
        seen.append([d.dtype for d, _ in columns])
        return inner(gid, columns, domain)

    monkeypatch.setattr(segsum_ops, "segsum_typed", spy)
    TRANSFER_STATS["d2h"] = 0
    got = c.sql(QUERY).compute()
    assert TRANSFER_STATS["d2h"] == 1
    assert len(seen) == 1
    assert torch.int16 not in seen[0]  # no code column is summed as a value
    rc = dask_sql_tpu.Context()
    rc.create_table("lineitem", df)
    want = rc.sql(QUERY, config_options={"sql.compile.segsum": "matmul"}).compute()
    assert_same_result(got, want)
    ref_counters = rc.metrics.snapshot()["counters"]
    assert {k: c.metrics[k] for k in ENCODING_COUNTERS} == \
        {k: ref_counters.get(k, 0) for k in ENCODING_COUNTERS} == \
        dict(zip(ENCODING_COUNTERS, (2, 1, 6)))


def test_string_codes_match_reference():
    df = gen_lineitem(5000, seed=3)
    rc = dask_sql_tpu.Context()
    rc.create_table("lineitem", df)
    ref_table = rc.schema["root"].tables["lineitem"].table
    pc = Context(device="cpu")
    pc.create_table("lineitem", df)
    port_table = pc.schema["root"].tables["lineitem"].table
    for name in KEYS:
        r, p = ref_table.columns[name], port_table.columns[name]
        np.testing.assert_array_equal(p.data.numpy(), np.asarray(r.data))
        assert list(p.dictionary) == list(r.dictionary)


def test_from_numpy_columns_carries_reference_table(segsum_calls):
    """The reference's loaded table, decoded column by column, becomes a
    port table with the same codes; Q1 over it matches the reference."""
    df = gen_lineitem(4000, seed=4)
    rc = dask_sql_tpu.Context()
    rc.create_table("lineitem", df)
    ref_table = rc.schema["root"].tables["lineitem"].table
    parts = {}
    for name, col in ref_table.columns.items():
        col = col.decode()
        parts[name] = (np.asarray(col.data),
                       None if col.validity is None else np.asarray(col.validity),
                       col.dictionary, col.sql_type.value)
    table = Table.from_numpy_columns(parts, device="cpu")
    for name in KEYS:
        np.testing.assert_array_equal(table.columns[name].data.numpy(),
                                      np.asarray(ref_table.columns[name].data))
    got = _port(table, QUERY, segsum_calls)
    assert_same_result(got, _reference(df, QUERY))


def test_int_key_wide_domain_matches_reference(segsum_calls):
    """An integer group key: bounds come from one device pull, and a group
    domain past HOST_PULL_DOMAIN compacts to the present groups before its
    one transfer."""
    rng = np.random.RandomState(9)
    df = pd.DataFrame({"k": rng.randint(0, 200_000, 3000).astype(np.int64),
                       "v": rng.rand(3000) * 1e6})
    sql = "SELECT k, COUNT(*) AS n, SUM(v) AS s, MAX(v) AS m FROM t GROUP BY k ORDER BY k"
    c = Context(device="cpu")
    c.create_table("t", df)
    TRANSFER_STATS["d2h"] = 0
    got = c.sql(sql).compute()
    assert TRANSFER_STATS["d2h"] == 2  # the key bounds, then the result
    assert segsum_calls[0][0] > (1 << 16)
    rc = dask_sql_tpu.Context()
    rc.create_table("t", df)
    want = rc.sql(sql, config_options={"sql.compile.segsum": "matmul"}).compute()
    assert_same_result(got, want)


def test_filter_projection_sort_matches_reference():
    """The eager plugins: a filter, an arithmetic projection and a two-key
    sort over the scan, without an aggregate."""
    df = gen_lineitem(2000, seed=6)
    sql = ("SELECT l_returnflag, l_extendedprice * (1 - l_discount) AS net "
           "FROM lineitem WHERE l_shipdate <= DATE '1995-01-01' "
           "AND NOT l_quantity < 10 ORDER BY net DESC, l_returnflag")
    c = Context(device="cpu")
    c.create_table("lineitem", df)
    got = c.sql(sql, return_futures=False)
    rc = dask_sql_tpu.Context()
    rc.create_table("lineitem", df)
    assert_same_result(got, rc.sql(sql).compute())


def test_literal_sum_and_constant_filter(segsum_calls):
    """A literal's sum and a constant filter reach the segment sum as
    0-dim or stride-0 tensors; the reducer hands the kernel [n] rows."""
    df = pd.DataFrame({"k": np.array(["a", "b", "a", "c", "b", "a"]),
                       "v": np.array([1.0, 2.5, np.nan, 4.0, 5.0, 6.0]),
                       "w": np.arange(6, dtype=np.float32)})
    lit = "SELECT k, SUM(1.5) AS s, COUNT(*) AS n FROM t GROUP BY k ORDER BY k"
    got = _port(df, lit.replace("FROM t", "FROM lineitem"), segsum_calls)
    rc = dask_sql_tpu.Context()
    rc.create_table("t", df)
    assert_same_result(got, rc.sql(lit, config_options={
        "sql.compile.segsum": "matmul"}).compute())
    segsum_calls.clear()
    const = ("SELECT k, SUM(v) AS s, AVG(w) AS a FROM lineitem WHERE 1 = 1 "
             "GROUP BY k ORDER BY k")
    got = _port(df, const, segsum_calls)
    want = df.groupby("k").agg(s=("v", "sum"), a=("w", "mean"))
    np.testing.assert_allclose(got["s"], want["s"], rtol=REL)
    np.testing.assert_allclose(got["a"], want["a"], rtol=REL)
