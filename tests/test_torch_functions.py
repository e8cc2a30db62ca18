"""Registered functions in the port: `Context.register_function` (tensor
and row functions) and `Context.register_aggregation`, through
`Context(device="cpu")`.

The cases and pandas expectations of the reference's `tests/integration/
test_function.py` are copied here.  A tensor function takes torch tensors
on the context's device (the reference hands it jax arrays), so its
traceable case calls `torch.tanh`.  Beyond them: the reference's overload
and ``replace=`` rules, an overload of another arity (which the reference
cannot call, ROADMAP.md Queue 3), NULL arguments, a function of a function,
a row function over strings, and aggregations with FILTER and a GROUP BY
of several keys.  The fused pipelines decline a user function, as the
reference's do.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu_torch import Context
from tests.utils import assert_eq


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are tiny: one thread runs them fastest on
    a machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def df():
    np.random.seed(42)
    return pd.DataFrame({"a": [1.0] * 100 + [2.0] * 200 + [3.0] * 400,
                         "b": 10 * np.random.rand(700)})


@pytest.fixture
def c(df):
    ctx = Context(device="cpu")
    ctx.create_table("df", df)
    return ctx


def test_scalar_udf(c, df):
    def f(x):
        return x ** 2

    c.register_function(f, "f", [("x", np.float64)], np.float64)
    result = c.sql("SELECT f(b) AS r FROM df").compute()
    np.testing.assert_allclose(result["r"], df.b ** 2)


def test_udf_two_args(c, df):
    def g(x, y):
        return x + 10 * y

    c.register_function(g, "g", [("x", np.float64), ("y", np.float64)],
                        np.float64)
    result = c.sql("SELECT g(a, b) AS r FROM df").compute()
    np.testing.assert_allclose(result["r"], df.a + 10 * df.b)


def test_udf_in_where_and_groupby(c, df):
    def h(x):
        return x * 2

    c.register_function(h, "h", [("x", np.float64)], np.float64)
    declined = c.metrics.counter("compiled_aggregate.declined")
    result = c.sql("SELECT SUM(h(b)) AS s FROM df WHERE h(a) > 2").compute()
    sel = df[df.a * 2 > 2]
    np.testing.assert_allclose(result["s"][0], (sel.b * 2).sum())
    # the fused aggregate declines the call, as the reference's does
    assert c.metrics.counter("compiled_aggregate.declined") == declined + 1
    nested = c.sql("SELECT h(h(b)) AS r FROM df").compute()
    np.testing.assert_allclose(nested["r"], df.b * 4)


def test_udf_replace_and_overload_guard(c):
    def f1(x):
        return x + 1

    c.register_function(f1, "dup", [("x", np.float64)], np.float64)
    with pytest.raises(ValueError):
        c.register_function(f1, "dup", [("x", np.float64)], np.float64)
    c.register_function(f1, "dup", [("x", np.float64)], np.float64,
                        replace=True)


def test_overloads_and_replace(c, df):
    """Another signature adds an overload, and each call runs the one the
    binder picked; ``replace=True`` leaves only the new registration."""
    c.register_function(lambda x: x + 1, "ov", [("x", np.float64)],
                        np.float64)
    c.register_function(lambda x, y: x * y, "ov",
                        [("x", np.float64), ("y", np.float64)], np.float64)
    got = c.sql("SELECT ov(b) AS one, ov(a, b) AS two FROM df").compute()
    np.testing.assert_allclose(got["one"], df.b + 1)
    np.testing.assert_allclose(got["two"], df.a * df.b)
    assert len(c.schema["root"].function_lists["ov"]) == 2
    c.register_function(lambda x: x - 1, "ov", [("x", np.float64)],
                        np.float64, replace=True)
    assert len(c.schema["root"].function_lists["ov"]) == 1
    got = c.sql("SELECT ov(b) AS one FROM df").compute()
    np.testing.assert_allclose(got["one"], df.b - 1)


def test_row_udf(c, df):
    def row_f(row):
        return row["x"] + row["y"]

    c.register_function(row_f, "row_f", [("x", np.float64), ("y", np.float64)],
                        np.float64, row_udf=True)
    result = c.sql("SELECT row_f(a, b) AS r FROM df").compute()
    np.testing.assert_allclose(result["r"], df.a + df.b)


def test_row_udf_over_strings_and_nulls():
    c = Context(device="cpu")
    c.create_table("t", pd.DataFrame({"s": ["ab", None, "cde", "ab"],
                                      "x": [1.0, 2.0, None, 4.0]}))
    c.register_function(lambda row: None if pd.isna(row["s"])
                        else row["s"].upper() * 2, "twice",
                        [("s", str)], str, row_udf=True)
    c.register_function(lambda x: x * 10, "tens", [("x", np.float64)],
                        np.float64)
    got = c.sql("SELECT twice(s) AS t, tens(x) AS x10 FROM t").compute()
    assert got["t"].tolist()[0] == "ABAB" and pd.isna(got["t"][1])
    assert got["t"].tolist()[2:] == ["CDECDE", "ABAB"]
    assert got["x10"][0] == 10.0 and pd.isna(got["x10"][2])
    grouped = c.sql("SELECT twice(s) AS t, COUNT(*) AS n FROM t "
                    "WHERE s IS NOT NULL GROUP BY twice(s) ORDER BY t"
                    ).compute()
    assert grouped["t"].tolist() == ["ABAB", "CDECDE"]
    assert grouped["n"].tolist() == [2, 1]


def test_udaf(c, df):
    def my_range(grouped):
        return grouped.max() - grouped.min()

    c.register_aggregation(my_range, "my_range", [("x", np.float64)],
                           np.float64)
    result = c.sql("SELECT a, my_range(b) AS r FROM df GROUP BY a").compute()
    expected = (df.groupby("a").b.max() - df.groupby("a").b.min()
                ).reset_index(name="r")
    assert_eq(result.sort_values("a").reset_index(drop=True),
              expected, check_dtype=False, check_names=False)


def test_udaf_with_filter_and_two_keys(c, df):
    c.register_aggregation(lambda g: g.median(), "med", [("x", np.float64)],
                           np.float64)
    got = c.sql("SELECT a, b > 5 AS hi, med(b) FILTER (WHERE b < 9) AS m, "
                "COUNT(*) AS n FROM df GROUP BY a, b > 5 ORDER BY a, hi"
                ).compute()
    frame = df.assign(hi=df.b > 5)
    want = frame.groupby(["a", "hi"]).agg(n=("b", "size")).reset_index()
    want["m"] = [frame[(frame.a == a) & (frame.hi == hi) & (frame.b < 9)]
                 .b.median() for a, hi in zip(want.a, want.hi)]
    assert got["a"].tolist() == want["a"].tolist()
    assert got["hi"].tolist() == want["hi"].tolist()
    assert got["n"].tolist() == want["n"].tolist()
    np.testing.assert_allclose(got["m"], want["m"])


def test_torch_tensor_udf(c, df):
    """The port's counterpart of the reference's jax-traceable function: a
    tensor function gets torch tensors on the context's device."""
    seen = []

    def smooth(x):
        seen.append((type(x), x.device))
        return torch.tanh(x / 10.0)

    c.register_function(smooth, "smooth", [("x", np.float64)], np.float64)
    result = c.sql("SELECT smooth(b) AS r FROM df").compute()
    np.testing.assert_allclose(result["r"], np.tanh(df.b / 10.0), rtol=1e-12)
    assert seen == [(torch.Tensor, c.device)]
