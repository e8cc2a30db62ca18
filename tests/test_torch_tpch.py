"""TPC-H q5, q6, q7, q8, q9, q10, q12, q14, q17 and q19 through the port's
`Context(device="cpu")` and the reference `Context`, on the same
`tests/tpch.py generate(scale_rows=2000)` frames (the size of
`tests/unit/test_queries.py`).

Keys, dates and counts must be exact and floats within 1e-9 relative (both
sides sum float64 columns in float64), in the same row order where the
query orders, and each query must answer on the reference's rungs: the
``resilience.rung.*`` and ``analysis.rung_skip.*`` counters it moves are
the reference's (q14 and q19 on the join pipeline, q17 on both compiled
rungs, q6 on the fused aggregate, the others on the eager aggregate, which
counts no rung).  On the same Contexts, EXPLAIN LINT and EXPLAIN ESTIMATE
of q1-q22 give the reference's rows, at plan time only.
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
            if k.startswith(("resilience.", "analysis.rung_skip"))
            and after[k] != before.get(k, 0)}


@pytest.fixture(scope="module")
def contexts():
    """(reference, port, EXPLAIN rows) over the same eight tables.  The
    rows, {(query, LINT | ESTIMATE): (port rows, reference rows)}, are
    taken before either Context runs a query, stem materialization off in
    both (`tests/test_torch_analysis.py` `REF_EXPLAIN`): after it has run
    q6, an engine explains q6's scan with all its rows, and a stem its
    EXPLAINs pinned would change the rungs of q6."""
    from tests.test_torch_analysis import REF_EXPLAIN

    tables = generate(2000)
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    for name, frame in tables.items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    explains = {}
    for q in range(1, 23):
        for kind in ("LINT", "ESTIMATE"):
            sql = f"EXPLAIN {kind} {QUERIES[q]}"
            explains[q, kind] = (
                list(pc.sql(sql, config_options=REF_EXPLAIN).compute()[kind]),
                list(rc.sql(sql, return_futures=False,
                            config_options=REF_EXPLAIN)[kind]))
    return rc, pc, explains


@pytest.fixture(scope="module")
def answers(contexts):
    """{query: (port frame, reference frame, port rungs, reference rungs)}."""
    rc, pc, _ = contexts
    out = {}
    for q in TPCH:
        before = dict(rc.metrics.snapshot()["counters"])
        want = rc.sql(QUERIES[q]).compute()
        ref_rungs = _rungs(before, rc.metrics.snapshot()["counters"])
        before = pc.metrics.snapshot()["counters"]
        got = pc.sql(QUERIES[q]).compute()
        out[q] = (got, want, _rungs(
            before, pc.metrics.snapshot()["counters"]), ref_rungs)
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
    rung = {q: sorted(k[len("resilience.rung."):] for k in answers[q][3]
                      if k.startswith("resilience.rung."))
            for q in TPCH}
    assert rung[6] == ["compiled_aggregate"]
    assert rung[14] == rung[19] == ["compiled_join_aggregate"]
    assert rung[17] == ["compiled_aggregate", "compiled_join_aggregate"]
    for q in (5, 7, 8, 9, 10, 12):
        assert rung[q] == [], q


@pytest.mark.parametrize("q", range(1, 23))
def test_explain_lint_and_estimate_match_reference(contexts, q):
    """EXPLAIN LINT and EXPLAIN ESTIMATE of q1-q22 (Q3 among them) give the
    reference's rows, but for the reworded recompile-hazard messages
    (`tests/test_torch_analysis.py` `REWORDED`) and the port's
    ``peak_bytes.hi``, at least the reference's where a compiled rung runs
    (`assert_estimate_rows`); nothing executes."""
    from tests.test_torch_analysis import assert_estimate_rows, reworded

    got, want = contexts[2][q, "LINT"]
    assert got == reworded(want), (q, "LINT")
    assert_estimate_rows(*contexts[2][q, "ESTIMATE"])
