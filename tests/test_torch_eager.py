"""The eager aggregate rung, the rest of the expression evaluator and the
degradation ladder of the port, against the reference.

- Every aggregate function of the eager rung runs over one seeded frame
  (NULL group keys, NULL and NaN values, FILTER, DISTINCT) through the
  port's `Context(device="cpu")` and the reference `Context`, both with
  ``sql.compile`` off so both answer on their eager rung: keys and counts
  exact, floats within 1e-9 relative.  The radix group id (a string key)
  and the sorted one (a float key) both run.
- The evaluator's expressions (CASE with NULL branches, IN lists with
  NULL, every EXTRACT unit on dates before 1970, integer division and
  remainder by zero, LIKE with an escape, datetime arithmetic) run as one
  root select on each side.  The port answers it on its compiled select;
  the reference's compiled select declines a FLOOR/CEIL unit and answers
  on its eager evaluator, whose SQL semantics the port holds (its fused
  evaluator drops NULL items of an IN list).
- String-valued expressions (literals, CONCAT, UPPER, string CASE and
  COALESCE), compares of two string columns with other dictionaries and
  ROUND run as a second root select, on the eager evaluator in both.
- With ``sql.compile`` off the eager rung gives the compiled rungs'
  answers (Q1, Q3, Q6 and a star join).
- A rung that fails degradably steps down and is counted; any other
  failure propagates, and with the ladder off every failure does.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
import dask_sql_tpu_torch.physical.rel.logical.aggregate as port_aggregate
from chip_smoke import QUERY as Q1, gen_lineitem, gen_star
from dask_sql_tpu.columnar.column import Column as RefColumn
from dask_sql_tpu.columnar.dtypes import SqlType as RefSqlType
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.columnar.column import Column
from dask_sql_tpu_torch.columnar.dtypes import SqlType
from dask_sql_tpu_torch.columnar.table import Table
from dask_sql_tpu_torch.ops import datetime as dt_ops
from dask_sql_tpu_torch.planner.expressions import AggExpr, ColumnRef
from dask_sql_tpu_torch.resilience.errors import (
    ExecutionError,
    ResourceExhaustedError,
    classify,
)
from tests.tpch import QUERIES, generate

REL = 1e-9
EAGER = {"sql.compile": False}


def assert_same_column(got: pd.Series, want: pd.Series, name: str):
    got, want = got.reset_index(drop=True), want.reset_index(drop=True)
    if want.dtype.kind == "f" or got.dtype.kind == "f":
        g = got.to_numpy(np.float64)
        w = want.to_numpy(np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=REL, atol=1e-12,
                                   err_msg=name)
    else:
        pd.testing.assert_series_equal(got, want, check_exact=True,
                                       check_names=False, obj=name)


def assert_same_frame(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in want.columns:
        assert_same_column(got[name], want[name], name)


def _contexts(frames):
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    for name, frame in frames.items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    return rc, pc


# -- every aggregate function of the eager rung -------------------------------
def agg_frame(n: int = 3000, seed: int = 11) -> pd.DataFrame:
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(n) * 100, 3)
    x[rng.rand(n) < 0.1] = np.nan  # NULL values
    d = rng.randint(0, 4, n).astype(np.float64)  # zeros: x / d gives inf, NaN
    x0 = np.where(rng.rand(n) < 0.05, 0.0, x)
    s = rng.choice(["ant", "bee", "cat", "dog", "eel"], n).astype(object)
    s[rng.rand(n) < 0.08] = None  # NULL string keys
    kf = rng.randint(0, 7, n).astype(np.float64)
    kf[rng.rand(n) < 0.08] = np.nan  # NULL float keys
    t = rng.choice(["pear", "fig", "kiwi", "lime"], n).astype(object)
    t[rng.rand(n) < 0.1] = None
    return pd.DataFrame({
        "s": s, "kf": kf, "x": x, "x0": x0, "d": d,
        "i": rng.randint(-50, 1000, n).astype(np.int64),
        "b": rng.rand(n) < 0.7,
        "y": np.round(rng.randn(n) * 3 + 1, 4),
        "t": t,
    })


AGGS = {
    "count_star": "COUNT(*)",
    "count": "COUNT(x)",
    "count_distinct": "COUNT(DISTINCT i)",
    "count_distinct_str": "COUNT(DISTINCT t)",
    "sum_float": "SUM(x)",
    "sum_int": "SUM(i)",
    "sum_distinct": "SUM(DISTINCT i)",
    "sum_filter": "SUM(x) FILTER (WHERE i > 300)",
    "count_filter": "COUNT(*) FILTER (WHERE b)",
    "min_float": "MIN(x)",
    "max_int": "MAX(i)",
    "min_string": "MIN(t)",
    "max_string": "MAX(t)",
    "avg_nan": "AVG(x0 / d)",
    "avg_distinct": "AVG(DISTINCT i)",
    "var_samp": "VAR_SAMP(x)",
    "var_pop": "VAR_POP(x)",
    "stddev_samp": "STDDEV_SAMP(x)",
    "stddev_pop": "STDDEV_POP(y)",
    "every": "EVERY(b)",
    "bool_or": "BOOL_OR(i > 900)",
    "bit_and": "BIT_AND(i)",
    "bit_or": "BIT_OR(i)",
    "bit_xor": "BIT_XOR(i)",
    "single_value": "SINGLE_VALUE(i)",
    "first_value": "FIRST_VALUE(x)",
    "last_value": "LAST_VALUE(t)",
    "median": "MEDIAN(x)",
    "percentile": "APPROX_PERCENTILE(y, 0.25)",
    "approx_count_distinct": "APPROX_COUNT_DISTINCT(i)",
    "regr_count": "REGR_COUNT(y, x)",
    "regr_sxx": "REGR_SXX(y, x)",
    "regr_syy": "REGR_SYY(y, x)",
}


@pytest.fixture(scope="module")
def agg_results():
    """{group key: (port frame, reference frame)}: every aggregate in one
    query per key, each side on its eager rung."""
    rc, pc = _contexts({"t": agg_frame()})
    out = {}
    select = ", ".join(f"{sql} AS {name}" for name, sql in AGGS.items())
    for key in ("s", "kf"):
        sql = f"SELECT {key}, {select} FROM t GROUP BY {key} ORDER BY {key}"
        out[key] = (pc.sql(sql, config_options=EAGER).compute(),
                    rc.sql(sql, config_options=EAGER).compute())
    assert not any(k.startswith("resilience.rung")
                   for k in pc.metrics.snapshot()["counters"])
    return out


@pytest.mark.parametrize("key", ["s", "kf"], ids=["radix_key", "sorted_key"])
@pytest.mark.parametrize("name", list(AGGS))
def test_eager_aggregate_matches_reference(agg_results, key, name):
    got, want = agg_results[key]
    assert len(got) == len(want)
    assert_same_column(got[key], want[key], key)
    assert want[key].isna().any()  # the NULL group is there
    assert_same_column(got[name], want[name], name)


@pytest.mark.parametrize("group", ["GROUP BY s", ""], ids=["grouped", "global"])
def test_eager_aggregate_of_no_rows(group):
    """No input rows: no groups under GROUP BY, one row of COUNT 0 and
    NULL sums without it, as the reference answers."""
    rc, pc = _contexts({"t": agg_frame(200)})
    keys = "s, " if group else ""
    sql = (f"SELECT {keys}COUNT(*) AS n, SUM(x) AS sx, MIN(t) AS mt, "
           f"AVG(i) AS ai FROM t WHERE x > 1e9 {group}")
    got = pc.sql(sql, config_options=EAGER).compute()
    want = rc.sql(sql, config_options=EAGER).compute()
    assert len(got) == (0 if group else 1)
    assert_same_frame(got, want)


# -- the evaluator's expressions ----------------------------------------------
def expr_frame(n: int = 400, seed: int = 5) -> pd.DataFrame:
    rng = np.random.RandomState(seed)
    days = rng.randint(-40_000, 25_000, n)  # 1860 .. 2038
    dt = np.datetime64("1970-01-01") + days.astype("timedelta64[D]")
    ts = dt.astype("datetime64[ns]") + rng.randint(
        0, 86_400 * 10**9, n).astype("timedelta64[ns]")
    s = rng.choice(["a_b", "axb", "ab%", "Abc", "cd", "x"], n).astype(object)
    s[rng.rand(n) < 0.1] = None
    fx = np.round(rng.randn(n) * 4, 3)
    fx[rng.rand(n) < 0.1] = np.nan
    return pd.DataFrame({
        "dt": dt, "dt2": dt[::-1].copy(), "ts": ts,
        "a": rng.randint(-9, 10, n).astype(np.int64),
        "z": rng.randint(-2, 3, n).astype(np.int64),  # zeros: x / 0 is NULL
        "fx": fx, "fy": np.round(rng.rand(n) * 3, 2), "s": s,
    })


EXTRACT_UNITS = ("YEAR", "MONTH", "DAY", "QUARTER", "WEEK", "DOW", "DOY",
                 "ISODOW", "ISOYEAR", "DECADE", "CENTURY", "MILLENNIUM",
                 "EPOCH", "HOUR", "MINUTE", "SECOND", "MILLISECOND",
                 "MICROSECOND", "NANOSECOND")

EXPRS = {
    "case_null_branch": "CASE WHEN a > 2 THEN fx WHEN a < -3 THEN NULL END",
    "case_else": "CASE WHEN s IS NULL THEN -1 WHEN s = 'cd' THEN a ELSE a * 2 END",
    "case_on_null_cond": "CASE WHEN fx > 0 THEN 1 ELSE 0 END",
    "in_with_null": "a IN (1, 3, NULL)",
    "not_in": "a NOT IN (2, 5, -7)",
    "not_in_with_null": "a NOT IN (1, NULL)",
    "in_strings": "s IN ('cd', 'x', NULL)",
    "in_floats": "fy IN (0.5, 1.25, 2.0)",
    "div_int_by_zero": "a / z",
    "mod_int_by_zero": "a % z",
    "div_float": "fx / fy",
    "mod_float": "MOD(fx, 1.5)",
    "like": "s LIKE 'a%'",
    "like_escape": "s LIKE 'a!_%' ESCAPE '!'",
    "like_percent_escape": "s LIKE '%!%' ESCAPE '!'",
    "not_like": "s NOT LIKE '_b%'",
    "ilike": "s ILIKE 'a%'",
    "similar": "s SIMILAR TO '(a|c)%'",
    "is_null": "fx IS NULL",
    "is_not_null": "s IS NOT NULL",
    "is_true": "(fx > 0) IS TRUE",
    "is_not_false": "(fx > 0) IS NOT FALSE",
    "is_false": "(fx > 0) IS FALSE",
    "is_not_true": "(fx > 0) IS NOT TRUE",
    "abs": "ABS(a)",
    "sqrt": "SQRT(fy)",
    "floor": "FLOOR(fx)",
    "ceil": "CEIL(fx)",
    "sign": "SIGN(a)",
    "ln": "LN(fy + 1)",
    "exp": "EXP(fy)",
    "add_months": "dt + INTERVAL '14' MONTH",
    "sub_months": "dt - INTERVAL '1' YEAR",
    "sub_days": "dt - INTERVAL '3' DAY",
    "add_int_days": "dt + a",
    "datetime_sub": "dt - dt2",
    "floor_month": "FLOOR(ts TO MONTH)",
    "ceil_day": "CEIL(ts TO DAY)",
    "ceil_quarter": "CEIL(dt TO QUARTER)",
    "floor_week": "FLOOR(dt TO WEEK)",
    "coalesce": "COALESCE(fx, fy, 0)",
    "cast_float_int": "CAST(fx AS INTEGER)",
    "cast_ts_date": "CAST(ts AS DATE)",
}
EXPRS.update({f"extract_{u.lower()}": f"EXTRACT({u} FROM ts)"
              for u in EXTRACT_UNITS})


@pytest.fixture(scope="module")
def expr_results():
    rc, pc = _contexts({"e": expr_frame()})
    sql = "SELECT " + ", ".join(f"{e} AS {n}" for n, e in EXPRS.items()) \
        + " FROM e"
    got = pc.sql(sql).compute()
    assert pc.metrics.counter("resilience.rung.compiled_select") == 1
    return got, rc.sql(sql).compute()


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_reference(expr_results, name):
    got, want = expr_results
    assert_same_column(got[name], want[name], name)


#: string-valued expressions, compares of two string columns (their
#: dictionaries differ) and ROUND; the port's fused pipelines decline the
#: string-valued ones, as the reference's do, so the eager evaluator
#: answers them
STRING_EXPRS = {
    "string_ne_columns": "s <> t",
    "string_lt_columns": "s < t",
    "string_ge_literal": "s >= 'ab'",
    "string_literal": "'lit'",
    "concat": "s || '-' || t",
    "concat_function": "CONCAT(t, s)",
    "upper": "UPPER(s)",
    "upper_compare": "UPPER(s) = t",
    "substring_compare": "SUBSTRING(s FROM 1 FOR 1) <> SUBSTRING(t FROM 1 FOR 1)",
    "string_case": "CASE WHEN a > 0 THEN s WHEN a < -5 THEN t ELSE 'mid' END",
    "string_coalesce": "COALESCE(s, t, 'none')",
    "string_null_cast": "CAST(NULL AS VARCHAR)",
    "round": "ROUND(fx, 1)",
    "round_no_digits": "ROUND(fx)",
    "round_int": "ROUND(a)",
    "round_negative_digits": "ROUND(fy * 1000, -2)",
}


@pytest.fixture(scope="module")
def string_results():
    frame = expr_frame()
    rng = np.random.RandomState(9)
    t = rng.choice(["AB%", "ab%", "x", "CD", "zz"], len(frame)).astype(object)
    t[rng.rand(len(frame)) < 0.1] = None
    rc, pc = _contexts({"e": frame.assign(t=t)})
    sql = "SELECT " + ", ".join(f"{e} AS {n}"
                                for n, e in STRING_EXPRS.items()) + " FROM e"
    before = dict(rc.metrics.snapshot()["counters"])
    want = rc.sql(sql).compute()
    ref_rungs = {k: v - before.get(k, 0)
                 for k, v in rc.metrics.snapshot()["counters"].items()
                 if k.startswith("resilience.") and v != before.get(k, 0)}
    got = pc.sql(sql).compute()
    rungs = {k: v for k, v in pc.metrics.snapshot()["counters"].items()
             if k.startswith("resilience.")}
    return got, want, rungs, ref_rungs


@pytest.mark.parametrize("name", list(STRING_EXPRS))
def test_string_expression_matches_reference(string_results, name):
    got, want, rungs, ref_rungs = string_results
    assert rungs == ref_rungs
    assert str(got[name].dtype) == str(want[name].dtype)
    assert_same_column(got[name], want[name], name)


def test_extract_before_1970_is_the_calendar():
    """EXTRACT over dates before the epoch against numpy's calendar (a
    floor-division fault would move them by a day)."""
    dates = np.array(["1969-12-31", "1900-03-01", "1700-02-28", "1969-01-01",
                      "2000-02-29", "1970-01-01"], dtype="datetime64[D]")
    ns = torch.from_numpy(dates.astype("datetime64[ns]").view(np.int64))
    years = dates.astype("datetime64[Y]").astype(int) + 1970
    months = dates.astype("datetime64[M]").astype(int) % 12 + 1
    days = (dates - dates.astype("datetime64[M]")).astype(int) + 1
    assert dt_ops.extract("year", ns).tolist() == years.tolist()
    assert dt_ops.extract("month", ns).tolist() == months.tolist()
    assert dt_ops.extract("day", ns).tolist() == days.tolist()
    back = dt_ops.days_from_civil(*dt_ops.civil_from_days(
        dt_ops.days_from_ns(ns)))
    assert back.tolist() == dates.astype(np.int64).tolist()


# -- the eager rung against the compiled rungs ------------------------------
STAR_SQL = ("SELECT d1_cat, SUM(f_val) AS s, COUNT(*) AS n, AVG(f_qty) AS q "
            "FROM fact JOIN dim1 ON f_dim1 = d1_key "
            "JOIN dim2 ON f_dim2 = d2_key WHERE d2_region = 'r2' "
            "GROUP BY d1_cat ORDER BY d1_cat")


@pytest.mark.parametrize("case", ["q1", "q3", "q6", "star"])
def test_eager_rung_gives_the_compiled_answer(case):
    if case == "q1":
        frames, sql = {"lineitem": gen_lineitem(20_000)}, Q1
    elif case == "star":
        frames, sql = gen_star(20_000), STAR_SQL
    else:
        tables = generate(20_000)
        frames = {n: tables[n] for n in ("customer", "orders", "lineitem")}
        sql = QUERIES[int(case[1:])]
    pc = Context(device="cpu")
    for name, frame in frames.items():
        pc.create_table(name, frame)
    compiled = pc.sql(sql).compute()
    rungs = {k: v for k, v in pc.metrics.snapshot()["counters"].items()
             if k.startswith("resilience")}
    assert rungs and set(rungs) <= {"resilience.rung.compiled_aggregate",
                                    "resilience.rung.compiled_join_aggregate"}
    eager = pc.sql(sql, config_options=EAGER).compute()
    assert {k: v for k, v in pc.metrics.snapshot()["counters"].items()
            if k.startswith("resilience")} == rungs
    assert_same_frame(eager, compiled)


# -- the degradation ladder ---------------------------------------------------
def test_ladder_steps_down_only_on_degradable_failures(monkeypatch):
    frames = {"lineitem": gen_lineitem(5_000)}
    pc = Context(device="cpu")
    pc.config.update({"serving.cache.enabled": False})  # every run executes
    pc.create_table("lineitem", frames["lineitem"])
    want = pc.sql(Q1).compute()
    assert pc.metrics.counter("resilience.rung.compiled_aggregate") == 1

    def oom(rel, executor):
        raise ResourceExhaustedError("CUDA out of memory")

    monkeypatch.setattr(port_aggregate, "try_compiled_aggregate", oom)
    got = pc.sql(Q1).compute()
    assert pc.metrics.counter("resilience.degraded") == 1
    assert pc.metrics.counter("resilience.degraded.compiled_aggregate") == 1
    assert pc.metrics.counter("resilience.rung.compiled_aggregate") == 1
    assert_same_frame(got, want)

    def kernel_fault(rel, executor):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(port_aggregate, "try_compiled_aggregate", kernel_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pc.sql(Q1).compute()
    assert pc.metrics.counter("resilience.degraded") == 1

    assert isinstance(classify(RuntimeError("segsum kernel launch failed: "
                                            "CUDA error 700")),
                      ExecutionError)
    monkeypatch.setattr(port_aggregate, "try_compiled_aggregate", oom)
    with pytest.raises(ResourceExhaustedError):
        pc.sql(Q1, config_options={"resilience.ladder.enabled": False}).compute()
    assert pc.metrics.counter("resilience.degraded") == 1


def test_compact_dictionary_sorts_an_unsorted_dictionary():
    """An Arrow-style dictionary in insertion order re-encodes as the
    reference's does (sorted, only the values in use); a sorted one stays."""
    codes = np.array([3, 0, 2, 3, 0], dtype=np.int32)
    dictionary = np.array(["pear", "fig", "apple", "kiwi"], dtype=object)
    got = Column(torch.from_numpy(codes), SqlType.VARCHAR, None,
                 dictionary).compact_dictionary()
    want = RefColumn(jnp.asarray(codes), RefSqlType.VARCHAR, None,
                     dictionary).compact_dictionary()
    assert got.dictionary.tolist() == want.dictionary.tolist() == [
        "apple", "kiwi", "pear"]
    assert got.data.tolist() == np.asarray(want.data).tolist()
    assert got.compact_dictionary() is got


def test_udaf_is_named_as_not_in_the_port():
    """A UDAF call names its function when the schema does not hold it;
    once registered, it aggregates (on the host, as in the reference)."""
    from dask_sql_tpu_torch.physical.executor import Executor

    table = Table.from_pandas(pd.DataFrame({"v": [1.0, 2.0]}))
    agg = AggExpr("udaf:my_fn", (ColumnRef(0, "v", SqlType.DOUBLE),),
                  SqlType.DOUBLE)
    ctx = Context(device="cpu")
    executor = Executor(ctx)
    gid = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(KeyError, match="my_fn"):
        port_aggregate.AggregatePlugin()._compute_agg(
            agg, table, gid, 1, "plain", executor)
    ctx.register_aggregation(lambda g: g.sum(), "my_fn", [("v", np.float64)],
                             np.float64)
    got = port_aggregate.AggregatePlugin()._compute_agg(
        agg, table, gid, 1, "plain", executor)
    assert got.data.tolist() == [3.0]
