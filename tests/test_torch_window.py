"""Window functions in the port against the reference: every function and
every frame kind over one seeded frame with ties, NULL order keys (first
and last), NULL values, a NULL partition, no partition at all, RANGE
offsets and IGNORE NULLS.  The port's `Context(device="cpu")` and the
reference `Context` each answer one SELECT holding all of them once;
each column is then a case.

Integers, ranks and the rank quotients are exact.  Frame sums difference
a table-wide prefix sum (``P[hi] - P[lo]``), so two engines that add the
prefix in other orders differ by up to about eps * max|P| on any frame,
however small: sums and averages are held within 1e-12 * sum|x| absolute
(1e-12 * sum x^2 for the variances), and 1e-9 relative.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.physical.rel.logical import window as port_window

N = 300


def _frame() -> pd.DataFrame:
    r = np.random.default_rng(5)
    g = r.integers(0, 6, N).astype(float)
    g[r.random(N) < 0.05] = np.nan  # a NULL partition
    o = r.integers(0, 25, N).astype(float)  # ties
    o[r.random(N) < 0.1] = np.nan  # NULL order keys
    x = (r.normal(size=N) * 100).round(3)
    x[r.random(N) < 0.15] = np.nan
    return pd.DataFrame({
        "g": g, "o": o, "x": x, "i": r.integers(-50, 50, N),
        "k": np.arange(N),  # a unique tiebreak
        "s": r.choice(["aa", "bb", "cc", None], N).astype(object)})


P = "PARTITION BY g ORDER BY o, k"
#: name -> (window expression, comparison): "exact", "sum" (the prefix-sum
#: tolerance over x, or "sum2" over x^2), or "str"
WINDOWS = {
    "row_number": (f"ROW_NUMBER() OVER ({P})", "exact"),
    "row_number_no_partition": ("ROW_NUMBER() OVER (ORDER BY i, k)", "exact"),
    "rank_ties": ("RANK() OVER (PARTITION BY g ORDER BY o)", "exact"),
    "rank_nulls_first": ("RANK() OVER (PARTITION BY g ORDER BY o NULLS FIRST)",
                         "exact"),
    "dense_rank": ("DENSE_RANK() OVER (PARTITION BY g ORDER BY o DESC)",
                   "exact"),
    "percent_rank": ("PERCENT_RANK() OVER (PARTITION BY g ORDER BY o)",
                     "exact"),
    "cume_dist_nulls_last": ("CUME_DIST() OVER (ORDER BY o DESC NULLS LAST)",
                             "exact"),
    "ntile": ("NTILE(4) OVER (PARTITION BY g ORDER BY i, k)", "exact"),
    "lag_default": (f"LAG(i, 2, -1) OVER ({P})", "exact"),
    "lead": (f"LEAD(x) OVER ({P})", "exact"),
    "lag_string_default": (f"LAG(s, 1, 'zz') OVER ({P})", "str"),
    "lag_ignore_nulls": (f"LAG(x) IGNORE NULLS OVER ({P})", "exact"),
    "lead_ignore_nulls": (f"LEAD(x, 2) IGNORE NULLS OVER ({P})", "exact"),
    "first_value": (f"FIRST_VALUE(x) OVER ({P})", "exact"),
    "last_value_whole": (f"LAST_VALUE(x) OVER ({P} ROWS BETWEEN UNBOUNDED "
                         "PRECEDING AND UNBOUNDED FOLLOWING)", "exact"),
    "first_value_ignore_nulls": (f"FIRST_VALUE(x) IGNORE NULLS OVER ({P})",
                                 "exact"),
    "last_value_ignore_nulls": (f"LAST_VALUE(x) IGNORE NULLS OVER ({P})",
                                "exact"),
    "nth_value": (f"NTH_VALUE(i, 3) OVER ({P})", "exact"),
    "nth_value_string": (f"NTH_VALUE(s, 2) OVER ({P})", "str"),
    "count_star_partition": ("COUNT(*) OVER (PARTITION BY g)", "exact"),
    "count_range_peers": ("COUNT(x) OVER (PARTITION BY g ORDER BY o)",
                          "exact"),
    "count_star_rows": (f"COUNT(*) OVER ({P} ROWS BETWEEN 2 PRECEDING AND "
                        "2 FOLLOWING)", "exact"),
    "sum_int_range_offsets": ("SUM(i) OVER (PARTITION BY g ORDER BY i RANGE "
                              "BETWEEN 5 PRECEDING AND 5 FOLLOWING)", "exact"),
    "sum_rows": (f"SUM(x) OVER ({P} ROWS BETWEEN 2 PRECEDING AND 1 "
                 "FOLLOWING)", "sum"),
    "sum_rows_following": (f"SUM(x) OVER ({P} ROWS BETWEEN CURRENT ROW AND "
                           "UNBOUNDED FOLLOWING)", "sum"),
    "sum_range_current_on": ("SUM(x) OVER (PARTITION BY g ORDER BY o RANGE "
                             "BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING)",
                             "sum"),
    "sum_range_offsets": ("SUM(x) OVER (PARTITION BY g ORDER BY i RANGE "
                          "BETWEEN 10 PRECEDING AND 3 FOLLOWING)", "sum"),
    "avg_partition": ("AVG(x) OVER (PARTITION BY g)", "sum"),
    "avg_no_partition": ("AVG(x) OVER ()", "sum"),
    "avg_int_running": ("AVG(i) OVER (ORDER BY k)", "sum"),
    "max_rows": (f"MAX(x) OVER ({P} ROWS BETWEEN 3 PRECEDING AND CURRENT "
                 "ROW)", "exact"),
    "max_rows_ahead": (f"MAX(x) OVER ({P} ROWS BETWEEN 1 FOLLOWING AND 4 "
                       "FOLLOWING)", "exact"),
    "min_string_rows": (f"MIN(s) OVER ({P} ROWS BETWEEN 2 PRECEDING AND 2 "
                        "FOLLOWING)", "str"),
    "max_range_offsets": ("MAX(x) OVER (PARTITION BY g ORDER BY i RANGE "
                          "BETWEEN 10 PRECEDING AND CURRENT ROW)", "exact"),
    "stddev_samp": ("STDDEV_SAMP(x) OVER (PARTITION BY g)", "sum2"),
    "var_pop_rows": ("VAR_POP(i) OVER (PARTITION BY g ORDER BY i, k ROWS "
                     "BETWEEN 1 PRECEDING AND 1 FOLLOWING)", "sum2"),
}

#: prefix-frame MIN and MAX (a running scan within each partition), held
#: against a numpy running min and max in ROW_NUMBER's order: the
#: reference compiles its associative scan for 18 s on the CPU
RUNNING = {
    "min_running": (f"MIN(x) OVER ({P})", np.fmin),
    "max_running_int": (f"MAX(i) OVER ({P})", np.fmax),
}


def _select(windows) -> str:
    return ("SELECT k, " + ", ".join(f"{e} AS {name}"
                                     for name, (e, _) in windows.items())
            + " FROM t ORDER BY k")


SQL = _select(WINDOWS)
#: the same windows over no rows
EMPTY_SQL = ("SELECT k, ROW_NUMBER() OVER (PARTITION BY g ORDER BY o) AS rn, "
             "SUM(x) OVER (PARTITION BY g) AS sx, LAG(x) OVER (ORDER BY k) "
             "AS ls FROM t WHERE i > 1000")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are tiny: one thread runs them fastest on
    a machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def answers():
    frame = _frame()
    rc, pc = dask_sql_tpu.Context(), Context(device="cpu")
    out = {}
    for name, c, sql in (("ref", rc, SQL),
                         ("port", pc, _select({**WINDOWS, **RUNNING}))):
        c.create_table("t", frame)
        out[name] = (c.sql(sql).compute(), c.sql(EMPTY_SQL).compute())
    out["frame"] = frame
    x = frame["x"].to_numpy()
    i = frame["i"].to_numpy(np.float64)
    out["scale"] = {"sum": 1e-12 * np.nansum(np.abs(x)),
                    "sum2": 1e-12 * max(np.nansum(x * x), np.sum(i * i))}
    return out


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_matches_reference(answers, name):
    got, want = answers["port"][0], answers["ref"][0]
    assert got["k"].tolist() == want["k"].tolist()
    g, w = got[name], want[name]
    assert str(g.dtype) == str(w.dtype), (g.dtype, w.dtype)
    kind = WINDOWS[name][1]
    if kind in ("sum", "sum2"):
        np.testing.assert_allclose(g.to_numpy(np.float64),
                                   w.to_numpy(np.float64), rtol=1e-9,
                                   atol=answers["scale"][kind])
    else:
        pd.testing.assert_series_equal(g, w, check_exact=True)
    assert g.isna().tolist() == w.isna().tolist()


@pytest.mark.parametrize("name", list(RUNNING))
def test_running_min_max(answers, name):
    frame, got = answers["frame"], answers["port"][0]
    col = "x" if name == "min_running" else "i"
    want = np.full(N, np.nan)
    for _, rows in got.groupby(frame["g"].fillna(-1.0).to_numpy()):
        order = rows.index[np.argsort(rows["row_number"].to_numpy())]
        values = frame[col].to_numpy(np.float64)[order]
        want[order] = RUNNING[name][1].accumulate(values)
    np.testing.assert_array_equal(got[name].to_numpy(np.float64), want)


def test_windows_over_no_rows(answers):
    got, want = answers["port"][1], answers["ref"][1]
    assert len(got) == len(want) == 0
    assert list(got.columns) == list(want.columns)


# -- the window module's scans and searches against brute force ----------


def _segments(rng, n):
    """Random segment starts (row 0 always one) and values with ties."""
    flags = rng.random(n) < 0.1
    flags[0] = True
    return flags, rng.integers(-20, 20, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("is_min", [True, False])
def test_segmented_scan_is_a_running_extreme(seed, is_min):
    rng = np.random.default_rng(seed)
    flags, vals = _segments(rng, 257)
    got = port_window._segmented_scan(torch.from_numpy(vals),
                                      torch.from_numpy(flags), is_min).numpy()
    acc = np.minimum if is_min else np.maximum
    starts = np.flatnonzero(flags).tolist() + [len(vals)]
    want = np.concatenate([acc.accumulate(vals[a:b])
                           for a, b in zip(starts[:-1], starts[1:])])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("is_min", [True, False])
def test_range_minmax_over_any_frame(seed, is_min):
    rng = np.random.default_rng(seed)
    n = 200
    vals = rng.normal(size=n)
    lo = rng.integers(0, n, n)
    hi = np.minimum(lo + rng.integers(1, 40, n), n)
    got = port_window._range_minmax(torch.from_numpy(vals),
                                    torch.from_numpy(lo), torch.from_numpy(hi),
                                    is_min).numpy()
    pick = np.min if is_min else np.max
    want = [pick(vals[a:b]) for a, b in zip(lo, hi)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_segmented_searchsorted_within_each_segment(side):
    rng = np.random.default_rng(4)
    flags, _ = _segments(rng, 300)
    starts = np.flatnonzero(flags).tolist() + [300]
    vals = np.concatenate([np.sort(rng.integers(0, 30, b - a))
                           for a, b in zip(starts[:-1], starts[1:])])
    seg_start = np.concatenate([[a] * (b - a)
                                for a, b in zip(starts[:-1], starts[1:])])
    seg_end = np.concatenate([[b] * (b - a)
                              for a, b in zip(starts[:-1], starts[1:])])
    targets = vals + rng.integers(-5, 6, 300)
    got = port_window._segmented_searchsorted(
        torch.from_numpy(vals), torch.from_numpy(seg_start),
        torch.from_numpy(seg_end), torch.from_numpy(targets), side).numpy()
    want = [a + np.searchsorted(vals[a:b], t, side=side)
            for a, b, t in zip(seg_start, seg_end, targets)]
    np.testing.assert_array_equal(got, want)
