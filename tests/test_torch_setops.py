"""The set operations and the rest of `basic.py` in the port: UNION [ALL],
DISTINCT, INTERSECT [ALL] and EXCEPT [ALL] over seeded frames with NULLs
and string columns whose dictionaries differ on each side, empty inputs,
VALUES, SELECT without FROM, DISTRIBUTE BY and EXPLAIN, through the port's
`Context(device="cpu")`.  One of each kind is held against the reference
`Context` on the same frames: answers equal exactly, rows in the same
order, the same dtypes, the reference's `resilience.rung.*` counters and
`resilience.degraded` at 0.  The reference compiles each new operation
shape (seconds a query on the CPU), so the other cases are held exactly
against a multiset oracle of the frames' rows.

TABLESAMPLE draws from a `torch.Generator`, which cannot pick the rows
`jax.random` picks, so it is held to its statistics instead: BERNOULLI's
kept fraction within five binomial standard deviations, SYSTEM keeping
whole blocks, and a seed repeating its rows.
"""
import re
from collections import Counter

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.physical.rel.logical.basic import SAMPLE_BLOCKS


def _frame(n: int, seed: int, letters) -> pd.DataFrame:
    r = np.random.default_rng(seed)
    a = r.integers(0, 5, n).astype(float)
    a[r.random(n) < 0.2] = np.nan
    s = r.choice(letters + [None], n).astype(object)
    return pd.DataFrame({"a": a, "s": s, "b": r.integers(0, 3, n),
                         "f": r.normal(size=n).round(1)})


#: each side's string column holds other values (other dictionaries)
FRAMES = {"l": _frame(50, 1, ["x", "y", "z"]),
          "r": _frame(50, 2, ["w", "y", "z"])}

#: checked against the reference: the answer exactly, rows in order, dtypes
#: and the rung counters
REFERENCE_CASES = {
    "distinct": "SELECT DISTINCT a, s FROM l",
    "intersect_all": "SELECT a, s FROM l INTERSECT ALL SELECT a, s FROM r",
    "except_all": "SELECT a, s FROM l EXCEPT ALL SELECT a, s FROM r",
    "union_under_aggregate": ("SELECT s, COUNT(*) AS n, SUM(a) AS t FROM "
                              "(SELECT a, s FROM l UNION ALL "
                              "SELECT a, s FROM r) u GROUP BY s"),
    "values": ("SELECT * FROM (VALUES (1, 'a', 2.5), (2, 'b', NULL), "
               "(3, NULL, -1.0)) AS t(x, y, z)"),
    "explain": "EXPLAIN SELECT a, SUM(f) FROM l WHERE b > 1 GROUP BY a",
}


def _rows(df: pd.DataFrame, cols=None):
    """The rows of `df` as tuples, NULL and NaN as None."""
    df = df if cols is None else df[cols]
    return [tuple(None if pd.isna(v) else v for v in row)
            for row in df.itertuples(index=False)]


def _distinct(rows):
    return Counter(set(rows))


L, R = _rows(FRAMES["l"], ["a", "s"]), _rows(FRAMES["r"], ["a", "s"])
L_B1 = FRAMES["r"]["b"].eq(1).sum()

#: checked against a multiset oracle over the frames (NULLs equal, as set
#: operations compare rows); the reference answers each on the
#: interpreted walk, which moves no rung counter
ORACLE_CASES = {
    "union_all": ("SELECT a, s FROM l UNION ALL SELECT a, s FROM r",
                  Counter(L + R)),
    "union": ("SELECT a, s FROM l UNION SELECT a, s FROM r",
              _distinct(L + R)),
    "union_cast": ("SELECT b, s FROM l UNION ALL SELECT f, s FROM r",
                   Counter(_rows(FRAMES["l"], ["b", "s"])
                           + _rows(FRAMES["r"], ["f", "s"]))),
    "union_three": ("SELECT s FROM l UNION ALL SELECT s FROM r "
                    "UNION ALL SELECT 'v' AS s FROM r WHERE b = 1",
                    Counter(_rows(FRAMES["l"], ["s"]) + _rows(FRAMES["r"], ["s"])
                            + [("v",)] * L_B1)),
    "intersect": ("SELECT a, s FROM l INTERSECT SELECT a, s FROM r",
                  _distinct(set(L) & set(R))),
    "except": ("SELECT a, s FROM l EXCEPT SELECT a, s FROM r",
               _distinct(set(L) - set(R))),
    "empty_union": ("SELECT a, s FROM l WHERE b > 5 "
                    "UNION ALL SELECT a, s FROM r WHERE b > 5", Counter()),
    "empty_left_intersect": ("SELECT a, s FROM l WHERE b > 5 "
                             "INTERSECT SELECT a, s FROM r", Counter()),
    "empty_right_except": ("SELECT a, s FROM l "
                           "EXCEPT SELECT a, s FROM r WHERE b > 5",
                           _distinct(L)),
    "empty_right_except_all": ("SELECT a, s FROM l "
                               "EXCEPT ALL SELECT a, s FROM r WHERE b > 5",
                               Counter(L)),
    "empty_distinct": ("SELECT DISTINCT a FROM l WHERE b > 5", Counter()),
    "select_without_from": ("SELECT 1 + 2 AS x, 2.5 * 2 AS y",
                            Counter([(3, 5.0)])),
    "distribute_by": ("SELECT a, b FROM l DISTRIBUTE BY b",
                      Counter(_rows(FRAMES["l"], ["a", "b"]))),
}


def _resilience(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if k.startswith("resilience.") and after[k] != before.get(k, 0)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are tiny: one thread runs them fastest on
    a machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def contexts():
    rc, pc = dask_sql_tpu.Context(), Context(device="cpu")
    for c in (rc, pc):
        for name, frame in FRAMES.items():
            c.create_table(name, frame)
    return rc, pc


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_matches_reference(contexts, case):
    rc, pc = contexts
    sql = REFERENCE_CASES[case]
    rb = dict(rc.metrics.snapshot()["counters"])
    want = rc.sql(sql).compute().reset_index(drop=True)
    ref_rungs = _resilience(rb, rc.metrics.snapshot()["counters"])
    pb = pc.metrics.snapshot()["counters"]
    got = pc.sql(sql).compute().reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert [str(d) for d in got.dtypes] == [str(d) for d in want.dtypes]
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    rungs = _resilience(pb, pc.metrics.snapshot()["counters"])
    assert rungs == ref_rungs
    assert not any(k.startswith("resilience.degraded") for k in rungs)


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_matches_oracle(contexts, case):
    _, pc = contexts
    sql, want = ORACLE_CASES[case]
    before = pc.metrics.snapshot()["counters"]
    got = pc.sql(sql).compute()
    assert Counter(_rows(got)) == want
    assert _resilience(before, pc.metrics.snapshot()["counters"]) == {}
    if case == "distribute_by":
        # equal keys come out together
        keys = got["b"].tolist()
        assert len(set(keys)) == sum(
            1 for i, k in enumerate(keys) if i == 0 or k != keys[i - 1])


@pytest.mark.parametrize("flag", ["ANALYZE", "LINT", "ESTIMATE"])
def test_explain_variants_name_what_they_need(contexts, flag):
    """EXPLAIN LINT and ESTIMATE answer (analysis/), and EXPLAIN ANALYZE
    (observability/): its node tree has the reference's labels and rows
    (`_label  [ms, rows]`, the ms aside)."""
    rc, pc = contexts
    got = pc.sql(f"EXPLAIN {flag} SELECT a FROM l").compute()
    if flag == "ANALYZE":
        want = rc.sql(f"EXPLAIN {flag} SELECT a FROM l").compute()
        assert list(got.columns) == list(want.columns) == ["PLAN"]
        tree = [re.sub(r"\[[0-9.]+ ms, ", "[", line)
                for df in (got, want) for line in df["PLAN"]
                if line.endswith(" rows]")]
        half = len(tree) // 2
        assert tree[:half] == tree[half:] and half >= 2
        return
    assert list(got.columns) == [flag]
    assert got[flag].iloc[0].startswith(
        {"LINT": "info[shape-bucket]", "ESTIMATE": "estimate:"}[flag])


SAMPLE_ROWS = 20_000


@pytest.fixture(scope="module")
def sample_context():
    c = Context(device="cpu")
    c.create_table("t", pd.DataFrame({"i": np.arange(SAMPLE_ROWS)}))
    return c


def _sampled(c, method: str, pct: float, seed: int) -> np.ndarray:
    return c.sql(f"SELECT i FROM t TABLESAMPLE {method} ({pct}) "
                 f"REPEATABLE ({seed})").compute()["i"].to_numpy()


@pytest.mark.parametrize("pct", [10.0, 30.0, 75.0])
def test_bernoulli_fraction(sample_context, pct):
    kept = _sampled(sample_context, "BERNOULLI", pct, 7)
    p = pct / 100
    sd = np.sqrt(SAMPLE_ROWS * p * (1 - p))
    assert abs(len(kept) - SAMPLE_ROWS * p) <= 5 * sd
    assert np.all(np.diff(kept) > 0)  # a filter: input order, no repeats


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_system_keeps_whole_blocks(sample_context, seed):
    kept = set(_sampled(sample_context, "SYSTEM", 50.0, seed).tolist())
    bounds = np.linspace(0, SAMPLE_ROWS, SAMPLE_BLOCKS + 1).astype(np.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        block = set(range(lo, hi))
        assert block <= kept or not (block & kept)


@pytest.mark.parametrize("method", ["BERNOULLI", "SYSTEM"])
def test_sample_seed_repeats_its_rows(sample_context, method):
    first = _sampled(sample_context, method, 40.0, 11)
    assert np.array_equal(first, _sampled(sample_context, method, 40.0, 11))
    others = [_sampled(sample_context, method, 40.0, s) for s in (12, 13, 14)]
    assert any(not np.array_equal(first, o) for o in others)
