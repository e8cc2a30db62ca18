"""TPC-H q5, q6, q7, q8, q9, q10, q12, q14, q17 and q19 through the port's
`Context(device="cpu")` and the reference `Context`, on the same
`tests/tpch.py generate(scale_rows=2000)` frames (the size of
`tests/unit/test_queries.py`).

Keys, dates and counts must be exact and floats within 1e-9 relative (both
sides sum float64 columns in float64), in the same row order where the
query orders, and each query must answer on the reference's rungs: the
``resilience.rung.*`` counters it moves are the reference's (q14 and q19
on the join pipeline, q17 on both compiled rungs, q6 on the fused
aggregate, the others on the eager aggregate, which counts no rung).
"""
import numpy as np
import pandas as pd
import pytest

import dask_sql_tpu
from dask_sql_tpu_torch import Context
from tests.tpch import QUERIES, generate

REL = 1e-9
TPCH = (5, 6, 7, 8, 9, 10, 12, 14, 17, 19)


def _rungs(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if k.startswith("resilience.") and after[k] != before.get(k, 0)}


@pytest.fixture(scope="module")
def answers():
    """{query: (port frame, reference frame, port rungs, reference rungs)}."""
    tables = generate(2000)
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    for name, frame in tables.items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    out = {}
    for q in TPCH:
        before = dict(rc.metrics.snapshot()["counters"])
        want = rc.sql(QUERIES[q]).compute()
        ref_rungs = _rungs(before, rc.metrics.snapshot()["counters"])
        before = dict(pc.metrics)
        got = pc.sql(QUERIES[q]).compute()
        out[q] = (got, want, _rungs(before, dict(pc.metrics)), ref_rungs)
    return out


@pytest.mark.parametrize("q", TPCH)
def test_tpch_matches_reference(answers, q):
    got, want, rungs, ref_rungs = answers[q]
    assert rungs == ref_rungs
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for name in want.columns:
        g, w = got[name], want[name]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64), rtol=REL,
                                       err_msg=f"q{q} {name}")
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True,
                                           obj=f"q{q} {name}")


def test_expected_rungs(answers):
    """The rungs the reference answers each query on at this scale."""
    rung = {q: sorted(k[len("resilience.rung."):] for k in answers[q][3])
            for q in TPCH}
    assert rung[6] == ["compiled_aggregate"]
    assert rung[14] == rung[19] == ["compiled_join_aggregate"]
    assert rung[17] == ["compiled_aggregate", "compiled_join_aggregate"]
    for q in (5, 7, 8, 9, 10, 12):
        assert rung[q] == [], q
