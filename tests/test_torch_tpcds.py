"""TPC-DS q1-q99 through the port's `Context(device="cpu")` on
`tests/tpcds.py generate(scale_rows=1000)`, each answer held against the
sqlite oracle of `tests/ds_oracle.py` (q67, which sqlite cannot parse,
against the pandas oracle of `tests/unit/test_queries_ds.py`), as the
reference's own TPC-DS test holds the reference.

The query with its top-level LIMIT runs first (the top-k path), then the
LIMIT-stripped query, whose full multiset is the well-defined comparand.
No query may step down the degradation ladder (`resilience.degraded`).

Set operations (the binder expands every ROLLUP and GROUPING SETS into a
Union), DISTINCT, INTERSECT, EXCEPT, window functions, string compares
between columns, string-valued expressions (literals, CONCAT, UPPER,
string CASE and COALESCE) and ROUND made q2, q4-q6, q8, q11, q12, q14,
q18-q20, q22-q24, q27, q33, q36, q38, q41, q44, q46, q47, q49, q51, q53,
q54, q56, q57, q60, q63, q64, q66-q68, q70, q71, q74-q78, q80, q84, q86,
q87, q89 and q98 answerable; every other query answered before them.
None is blocked now, so none is marked xfail.
"""
import pandas as pd
import pytest
import torch

from dask_sql_tpu_torch import Context
from tests.ds_oracle import (
    assert_same_result,
    cross_check,
    make_sqlite,
    strip_top_limit,
    translate,
)
from tests.tpcds import generate
from tests.tpcds_queries import QUERIES
from tests.unit.test_queries_ds import INF_IS_NULL, _pandas_q67


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At 1000 rows the port's tensors are small: one thread runs them
    fastest on a machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return generate(scale_rows=1000)


@pytest.fixture(scope="module")
def port(tables):
    c = Context(device="cpu")
    for name, df in tables.items():
        c.create_table(name, df)
    return c


@pytest.fixture(scope="module")
def sqlite_oracle(tables):
    conn = make_sqlite(tables)
    yield conn
    conn.close()


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_query_matches_oracle(port, tables, sqlite_oracle, qnum):
    before = dict(port.metrics)
    result = port.sql(QUERIES[qnum]).compute()
    assert len(result.columns) > 0
    sql = strip_top_limit(QUERIES[qnum])
    if sql != QUERIES[qnum].rstrip():
        result = port.sql(sql).compute()
    degraded = {k: v - before.get(k, 0) for k, v in port.metrics.items()
                if k.startswith("resilience.degraded")
                and v != before.get(k, 0)}
    assert not degraded, degraded
    if qnum == 67:
        expected = _pandas_q67(tables)[list(result.columns)]
        assert_same_result(result, expected, qnum)
        return
    tsql = translate(sql)
    assert tsql is not None, f"q{qnum}: translator declined"
    cross_check(result, [("sqlite",
                          lambda s: pd.read_sql_query(tsql, sqlite_oracle))],
                sql, qnum, inf_is_null=qnum in INF_IS_NULL)
