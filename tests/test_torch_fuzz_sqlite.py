"""The reference's sqlite oracles against the port: the seeded random
query trees of `tests/integration/test_fuzz_sqlite.py` (plain, hard shapes,
NULLs) and the fixed queries of `tests/integration/test_compatibility.py`,
run through `Context(device="cpu")` and compared with sqlite on the same
frames, as those files compare the reference.  The generators are imported
from the reference's test modules.  The duckdb case is left out (duckdb is
not installed everywhere the port runs).  Floats compare with
`tests.utils.assert_eq`'s tolerance, as the reference's cases do.
"""
import sqlite3

import pandas as pd
import pytest
import torch

from dask_sql_tpu_torch import Context
from tests.integration.test_compatibility import QUERIES as COMPAT_QUERIES
from tests.integration.test_compatibility import _random_df
from tests.integration.test_fuzz_sqlite import (
    QueryGen,
    QueryGen2,
    _explicit_null_order,
    _frames,
    _null_frames,
)
from tests.utils import assert_eq


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The frames are tiny: one thread runs them fastest on a machine
    whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _against_sqlite(query, sort=True, check_names=False, **frames):
    conn = sqlite3.connect(":memory:")
    c = Context(device="cpu")
    for name, df in frames.items():
        df.to_sql(name, conn, index=False)
        c.create_table(name, df)
    expected = pd.read_sql_query(query, conn)
    got = c.sql(query, return_futures=False)
    if sort:
        expected = expected.sort_values(
            list(expected.columns)).reset_index(drop=True)
        got = got.sort_values(list(got.columns)).reset_index(drop=True)
    try:
        assert_eq(got, expected, check_dtype=False, check_names=check_names)
    except AssertionError as e:
        raise AssertionError(f"query={query!r}\n{e}") from e


@pytest.mark.parametrize("seed", range(40))
def test_fuzz_vs_sqlite(seed):
    t, u = _frames(seed)
    query = QueryGen(seed).query()
    _against_sqlite(query, sort="ORDER BY" not in query, t=t, u=u)


@pytest.mark.parametrize("seed", range(300, 325))
def test_fuzz_hard_shapes_vs_sqlite(seed):
    t, u = _frames(seed)
    query = QueryGen2(seed).query()
    _against_sqlite(query, sort="ORDER BY" not in query, t=t, u=u)


@pytest.mark.parametrize("seed", range(500, 530))
def test_fuzz_nulls_vs_sqlite(seed):
    t, u = _null_frames(seed)
    query = _explicit_null_order((QueryGen2 if seed % 2 else QueryGen)(
        seed).query())
    assert "ORDER BY" not in query or "NULLS" in query, query
    _against_sqlite(query, sort="ORDER BY" not in query, t=t, u=u)


@pytest.mark.parametrize("query", COMPAT_QUERIES)
def test_vs_sqlite(query):
    _against_sqlite(query, check_names=True, t=_random_df(1),
                    u=_random_df(2, n=40))


def test_window_vs_sqlite():
    t = _random_df(3)
    for query in (
            "SELECT a, b, ROW_NUMBER() OVER (PARTITION BY a ORDER BY b) "
            "AS rn FROM t",
            "SELECT a, b, SUM(b) OVER (PARTITION BY a ORDER BY b) AS cs "
            "FROM t",
            "SELECT a, RANK() OVER (ORDER BY a) AS r, LAG(b) OVER "
            "(ORDER BY b) AS lb FROM t"):
        _against_sqlite(query, check_names=True, t=t)


def test_nulls_vs_sqlite():
    t = pd.DataFrame({
        "a": [1.0, None, 3.0, None, 5.0],
        "c": ["x", None, "y", "x", None],
    })
    for query in (
            "SELECT a FROM t WHERE a IS NULL",
            "SELECT a FROM t WHERE a IS NOT NULL",
            "SELECT COUNT(a) AS ca, COUNT(*) AS cs FROM t",
            "SELECT c, COUNT(*) AS n FROM t GROUP BY c",
            "SELECT COALESCE(a, -1) AS f FROM t"):
        _against_sqlite(query, check_names=True, t=t)
