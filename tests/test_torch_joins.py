"""Every join type of the port's eager path against the reference's, on
small seeded frames with NULL keys, duplicate keys on both sides and string
keys of two different dictionaries.

Each case runs one SQL through the port's `Context(device="cpu")` and the
reference `Context` over the same frames: the rows, in the same order, and
the ``resilience.*`` counters must be the reference's, and the port's plan
must hold the join type the case is about (LEFT, RIGHT, FULL with and
without an ON residual and with an empty side; LEFTSEMI and LEFTANTI with
and without a residual; the null-aware anti join of ``NOT IN`` over a set
with a NULL, without one, empty and correlated; LEFTMARK for EXISTS under
OR; IN and NOT IN over a subquery under OR, which the evaluator answers
from the subquery's rows; scalar subqueries, empty ones and one in a
projection included).
"""
import numpy as np
import pandas as pd
import pytest

import dask_sql_tpu
from dask_sql_tpu_torch import Context

REL = 1e-9

CASES = {
    "inner_residual": ("INNER", "SELECT a.id, b.id AS bid FROM a JOIN b "
                       "ON a.k = b.k AND a.v > b.w"),
    "left": ("LEFT", "SELECT a.id, a.k, b.id AS bid, b.w FROM a "
             "LEFT JOIN b ON a.k = b.k"),
    "left_residual": ("LEFT", "SELECT a.id, b.id AS bid, b.w FROM a "
                      "LEFT JOIN b ON a.k = b.k AND b.w > a.v"),
    "left_empty_right": ("LEFT", "SELECT a.id, e.id AS eid, e.w FROM a "
                         "LEFT JOIN (SELECT * FROM b WHERE w > 1e9) e "
                         "ON a.k = e.k"),
    "left_string_keys": ("LEFT", "SELECT a.id, a.s, b.id AS bid FROM a "
                         "LEFT JOIN b ON a.s = b.s"),
    "right": ("RIGHT", "SELECT a.id, b.id AS bid, b.k FROM a "
              "RIGHT JOIN b ON a.k = b.k"),
    "right_residual": ("RIGHT", "SELECT a.id, b.id AS bid FROM a "
                       "RIGHT JOIN b ON a.k = b.k AND a.v < b.w"),
    "full": ("FULL", "SELECT a.id, b.id AS bid, a.k, b.k AS bk FROM a "
             "FULL JOIN b ON a.k = b.k"),
    "full_residual": ("FULL", "SELECT a.id, b.id AS bid FROM a "
                      "FULL JOIN b ON a.k = b.k AND a.g = b.g"),
    "full_empty_left": ("FULL", "SELECT e.id, b.id AS bid FROM "
                        "(SELECT * FROM a WHERE v > 1e9) e "
                        "FULL JOIN b ON e.k = b.k"),
    "count_after_left": ("LEFT", "SELECT a.g, COUNT(b.id) AS n, "
                         "COUNT(*) AS m FROM a LEFT JOIN b ON a.k = b.k "
                         "GROUP BY a.g ORDER BY a.g"),
    "semi_exists": ("LEFTSEMI", "SELECT a.id FROM a WHERE EXISTS "
                    "(SELECT 1 FROM b WHERE b.k = a.k)"),
    "semi_residual": ("LEFTSEMI", "SELECT a.id FROM a WHERE EXISTS "
                      "(SELECT 1 FROM b WHERE b.k = a.k AND b.w > a.v)"),
    "semi_in": ("LEFTSEMI", "SELECT a.id, a.k FROM a "
                "WHERE a.k IN (SELECT k FROM b)"),
    "semi_in_strings": ("LEFTSEMI", "SELECT a.id, a.s FROM a "
                        "WHERE a.s IN (SELECT s FROM b)"),
    "anti_not_exists": ("LEFTANTI", "SELECT a.id FROM a WHERE NOT EXISTS "
                        "(SELECT 1 FROM b WHERE b.k = a.k)"),
    "anti_residual": ("LEFTANTI", "SELECT a.id FROM a WHERE NOT EXISTS "
                      "(SELECT 1 FROM b WHERE b.k = a.k AND b.w > a.v)"),
    "not_in_with_null": ("LEFTANTI null_aware", "SELECT a.id FROM a "
                         "WHERE a.k NOT IN (SELECT k FROM b)"),
    "not_in_without_null": ("LEFTANTI null_aware", "SELECT a.id, a.k FROM a WHERE a.k "
                            "NOT IN (SELECT k FROM b WHERE k IS NOT NULL)"),
    "not_in_empty": ("LEFTANTI null_aware", "SELECT a.id, a.k FROM a WHERE a.k "
                     "NOT IN (SELECT k FROM b WHERE w > 1e9)"),
    "not_in_correlated": ("LEFTANTI null_aware", "SELECT a.id FROM a WHERE a.k NOT IN "
                          "(SELECT b.k FROM b WHERE b.g = a.g)"),
    "mark_exists_or": ("LEFTMARK", "SELECT a.id FROM a WHERE a.v > 80 OR "
                       "EXISTS (SELECT 1 FROM b WHERE b.k = a.k)"),
    "mark_residual_or": ("LEFTMARK", "SELECT a.id FROM a WHERE a.v > 80 OR "
                         "EXISTS (SELECT 1 FROM b WHERE b.k = a.k "
                         "AND b.w > a.v)"),
    "in_subquery_or": (None, "SELECT a.id FROM a WHERE a.v > 80 OR "
                       "a.k IN (SELECT k FROM b)"),
    "not_in_subquery_or": (None, "SELECT a.id FROM a WHERE a.v > 80 OR a.k "
                           "NOT IN (SELECT k FROM b WHERE k IS NOT NULL)"),
    "scalar_in_projection": (None, "SELECT a.id, (SELECT MAX(w) FROM b) "
                             "AS m FROM a"),
    "scalar_subquery": (None, "SELECT a.id, a.v FROM a "
                        "WHERE a.v > (SELECT AVG(w) FROM b)"),
    "scalar_subquery_empty": (None, "SELECT a.id FROM a WHERE a.v > "
                              "(SELECT MAX(w) FROM b WHERE w > 1e9)"),
}


def frames():
    rng = np.random.RandomState(11)
    na, nb = 60, 40
    ak = rng.randint(0, 25, na).astype(float)
    ak[rng.rand(na) < 0.15] = np.nan
    bk = rng.randint(10, 40, nb).astype(float)
    bk[rng.rand(nb) < 0.1] = np.nan
    a = pd.DataFrame({
        "id": np.arange(na),
        "k": pd.array(ak, dtype="Int64"),
        "g": rng.randint(0, 4, na),
        "v": rng.rand(na) * 100,
        "s": rng.choice(["ant", "bee", "cat", "dog", "eel"], na),
    })
    b = pd.DataFrame({
        "id": np.arange(100, 100 + nb),
        "k": pd.array(bk, dtype="Int64"),
        "g": rng.randint(0, 4, nb),
        "w": rng.rand(nb) * 100,
        "s": rng.choice(["bee", "dog", "fox", "gnu"], nb),
    })
    return {"a": a, "b": b}


def _resilience(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if k.startswith("resilience.") and after[k] != before.get(k, 0)}


@pytest.fixture(scope="module")
def answers():
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    for name, frame in frames().items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    out = {}
    for case, (_, sql) in CASES.items():
        before = dict(rc.metrics.snapshot()["counters"])
        want = rc.sql(sql).compute()
        ref = _resilience(before, rc.metrics.snapshot()["counters"])
        before = pc.metrics.snapshot()["counters"]
        frame = pc.sql(sql)
        got = frame.compute()
        out[case] = (got, want, _resilience(
            before, pc.metrics.snapshot()["counters"]), ref,
                     frame._plan.explain())
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_join_matches_reference(answers, case):
    got, want, counters, ref_counters, plan = answers[case]
    join_type = CASES[case][0]
    if join_type is not None:
        assert f"Join({join_type})" in plan
    assert counters == ref_counters
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in want.columns:
        g, w = got[name], want[name]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64), rtol=REL,
                                       err_msg=f"{case} {name}")
        else:
            assert g.tolist() == w.tolist(), f"{case} {name}"


def test_null_semantics(answers):
    """The three-valued cases give what SQL says on these frames."""
    a = frames()["a"]
    assert len(answers["not_in_with_null"][1]) == 0
    # an empty set passes every row, a NULL argument too
    assert len(answers["not_in_empty"][1]) == len(a)
    assert answers["not_in_empty"][1]["k"].isna().any()
    # NOT IN over a set without NULL drops the NULL arguments
    assert not answers["not_in_without_null"][1]["k"].isna().any()
    # an empty scalar subquery is NULL: no row compares true
    assert len(answers["scalar_subquery_empty"][1]) == 0
    # COUNT of the right side after a LEFT join counts matched rows only
    counts = answers["count_after_left"][1]
    assert (counts["n"] < counts["m"]).any()
