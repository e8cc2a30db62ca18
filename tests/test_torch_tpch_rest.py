"""TPC-H q2, q4, q11, q13, q15, q16, q18, q20, q21 and q22 through the
port's `Context(device="cpu")` and the reference `Context`, on the same
`tests/tpch.py generate(scale_rows=2000)` frames: the queries that need
the outer, semi, anti and mark joins, scalar and EXISTS subqueries and
SUBSTRING.  With `tests/test_torch_tpch.py` and the Q1/Q3 tests, all 22
TPC-H queries are held against the reference.

Every float column of these frames is float64, which the reference's
default segment sum (scatter) adds in float64, as the port does; its
``matmul`` mode is off by 2e-8 relative on q11 and q15 against a float64
pandas sum, where the port and the scatter mode agree with it.  Keys,
dates and counts must be
exact, floats within 1e-9 relative, rows in the same order, and each
query must move the reference's ``resilience.rung.*`` and
``analysis.rung_skip.*`` counters and leave ``resilience.degraded`` at 0.  At this scale q20 and q21 return no rows,
so two variants with wider predicates hold their joins on rows too.
"""
import numpy as np
import pandas as pd
import pytest

import dask_sql_tpu
from dask_sql_tpu_torch import Context
from tests.tpch import QUERIES, generate

REL = 1e-9

#: q20 and q21 with predicates wide enough to keep rows at 2000 rows
VARIANTS = {
    "q20_rows": QUERIES[20]
    .replace("p_name LIKE 'forest%'", "p_name LIKE '%'")
    .replace("n_name = 'CANADA'", "n_name <> 'NOWHERE'")
    .replace("ps_availqty > (", "ps_availqty * 1000 > ("),
    "q21_rows": QUERIES[21].replace("n_name = 'SAUDI ARABIA'",
                                    "n_name <> 'NOWHERE'"),
}
CASES = [2, 4, 11, 13, 15, 16, 18, 20, 21, 22, "q20_rows", "q21_rows"]


def _sql(case):
    return QUERIES[case] if isinstance(case, int) else VARIANTS[case]


def _resilience(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if k.startswith(("resilience.", "analysis.rung_skip"))
            and after[k] != before.get(k, 0)}


@pytest.fixture(scope="module")
def answers():
    """{case: (port frame, reference frame, port counters, reference
    counters)}, each reference answer computed once."""
    tables = generate(2000)
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    for name, frame in tables.items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    out = {}
    for case in CASES:
        before = dict(rc.metrics.snapshot()["counters"])
        want = rc.sql(_sql(case)).compute()
        ref = _resilience(before, rc.metrics.snapshot()["counters"])
        before = pc.metrics.snapshot()["counters"]
        got = pc.sql(_sql(case)).compute()
        out[case] = (got, want, _resilience(
            before, pc.metrics.snapshot()["counters"]), ref)
    return out


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tpch_matches_reference(answers, case):
    got, want, counters, ref_counters = answers[case]
    assert counters == ref_counters
    assert not any(k.startswith("resilience.degraded") for k in counters)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in want.columns:
        g, w = got[name], want[name]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64), rtol=REL,
                                       err_msg=f"{case} {name}")
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True,
                                           obj=f"{case} {name}")


def test_q15_on_the_scatter_route(answers):
    """q15's revenue view through the float64 scatter of large group
    domains (the route its 10,000 suppliers take on the card at a million
    lineitem rows): the supplier whose revenue equals the largest one is
    found, as the reference finds it."""
    want = answers[15][1]
    pc = Context(device="cpu")
    pc.config.update({"sql.compile.segsum": "scatter"})
    for name, frame in generate(2000).items():
        pc.create_table(name, frame)
    got = pc.sql(QUERIES[15]).compute()
    assert len(want) == 1 and list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got.drop(columns="total_revenue"),
                                  want.drop(columns="total_revenue"))
    np.testing.assert_allclose(got["total_revenue"].to_numpy(np.float64),
                               want["total_revenue"].to_numpy(np.float64),
                               rtol=REL)


def test_row_counts(answers):
    """q20 and q21 return no rows at this scale; their variants and every
    other query return some."""
    for case in CASES:
        n = len(answers[case][1])
        assert (n == 0) == (case in (20, 21)), (case, n)
