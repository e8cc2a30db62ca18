"""The root SELECT pipeline (dask_sql_tpu_torch/physical/compiled_select.py)
against the reference's, on the CPU.

Both Contexts register the same seeded frames (with their load-time
encodings) and run the same SQL: rows and their order must be equal,
strings, dates and counts exactly, floats within 5e-6 relative
(MATMUL_FLOAT_REL_ERR_BOUND).  Each query must answer on the
``compiled_select`` rung on both sides, with two device-to-host transfers
on the port's (the survivor count, then the packed survivors), and count
the same code-space predicates and late-decoded rows as the reference.
"""
import numpy as np
import pandas as pd
import pytest

import dask_sql_tpu
from bench import gen_lineitem
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.utils import TRANSFER_STATS

REL = 5e-6
SEL_SQL = ("SELECT l_returnflag, l_extendedprice * (1 - l_discount) AS rev "
           "FROM lineitem WHERE l_discount > 0.09 "
           "ORDER BY rev DESC LIMIT 100")  # bench.py's root select line
COUNTERS = ("resilience.rung.compiled_select",
            "columnar.encoding.codespace_pred", "columnar.encoding.late_rows")


@pytest.fixture(scope="module")
def contexts():
    df = gen_lineitem(20_000)
    rng = np.random.RandomState(4)
    nulls = pd.DataFrame({
        "k": np.where(rng.rand(3000) < 0.1, None,
                      rng.choice(["x", "y", "z"], 3000)).astype(object),
        "v": np.where(rng.rand(3000) < 0.1, np.nan, rng.rand(3000)),
        "w": rng.randint(0, 10, 3000),
    })
    pc, rc = Context(device="cpu"), dask_sql_tpu.Context()
    for c in (pc, rc):
        c.create_table("lineitem", df)
        c.create_table("t", nulls)
        c.create_table("empty", df.iloc[:0])
    return pc, rc


def _counters(metrics):
    return {k: metrics.get(k, 0) for k in COUNTERS}


def _ref_counters(rc):
    counters = rc.metrics.snapshot()["counters"]
    return {k: counters.get(k, 0) for k in COUNTERS}


def run_both(contexts, sql, transfers=2, rung=1):
    pc, rc = contexts
    before_p = _counters(pc.metrics.snapshot()["counters"])
    before_r = _ref_counters(rc)
    TRANSFER_STATS["d2h"] = 0
    got = pc.sql(sql).compute()
    assert TRANSFER_STATS["d2h"] == transfers
    want = rc.sql(sql).compute()
    after_p = _counters(pc.metrics.snapshot()["counters"])
    after_r = _ref_counters(rc)
    delta_p = {k: after_p[k] - before_p[k] for k in COUNTERS}
    delta_r = {k: after_r[k] - before_r[k] for k in COUNTERS}
    assert delta_p == delta_r
    assert delta_p["resilience.rung.compiled_select"] == rung
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in got.columns:
        g = got[name].reset_index(drop=True)
        w = want[name].reset_index(drop=True)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=REL,
                                       err_msg=name)
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True)
    return got, delta_p


def test_bench_root_select_matches_reference(contexts):
    got, _ = run_both(contexts, SEL_SQL)
    assert len(got) == 100
    assert got["rev"].is_monotonic_decreasing


def test_dict_filter_with_dict_column_projected(contexts):
    got, delta = run_both(
        contexts, "SELECT l_shipdate, l_quantity, l_extendedprice "
                  "FROM lineitem WHERE l_quantity < 10 "
                  "ORDER BY l_extendedprice DESC LIMIT 50")
    assert delta["columnar.encoding.codespace_pred"] == 1
    assert delta["columnar.encoding.late_rows"] == 50
    assert (got["l_quantity"] < 10).all()


def test_limit_without_order_by(contexts):
    got, _ = run_both(contexts, "SELECT l_returnflag, l_tax FROM lineitem "
                                "WHERE l_tax > 0.07 LIMIT 25")
    assert len(got) == 25


def test_order_by_string_columns(contexts):
    got, _ = run_both(
        contexts, "SELECT l_returnflag, l_linestatus, l_quantity FROM lineitem "
                  "WHERE l_shipdate > DATE '1998-06-01' "
                  "ORDER BY l_linestatus DESC, l_returnflag, l_quantity "
                  "LIMIT 40 OFFSET 5")
    assert len(got) == 40


def test_nulls(contexts):
    got, _ = run_both(contexts, "SELECT k, v, w FROM t WHERE w < 5 "
                                "ORDER BY v DESC, w LIMIT 300")
    assert got["k"].isna().any() and got["v"].isna().any()


def test_zero_survivors(contexts):
    got, _ = run_both(contexts, "SELECT l_returnflag, l_extendedprice "
                                "FROM lineitem WHERE l_discount > 5 "
                                "ORDER BY l_extendedprice",
                      transfers=1)
    assert len(got) == 0
    # a table of no rows: both sides' pipelines decline it
    got, _ = run_both(contexts, "SELECT l_returnflag, l_tax * 2 AS t2 "
                                "FROM empty WHERE l_tax > 0.01", transfers=0,
                      rung=0)
    assert len(got) == 0
