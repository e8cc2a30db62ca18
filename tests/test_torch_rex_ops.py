"""The reference's scalar-function registry in the port
(`dask_sql_tpu_torch/physical/rex/operations.py` and the core of
`physical/compiled.py` `_TraceEval`), through `Context(device="cpu")`.

Every name of the reference's `OPERATION_MAPPING`
(`dask_sql_tpu/physical/rex/operations.py`) runs in a port query over one
seeded frame with NULLs, and its answer is held against a Python oracle of
the same semantics row by row: exactly, or floats within 1e-9 relative.
String functions whose arguments vary by row (SUBSTRING with a column
offset, RIGHT, REPEAT, RPAD and SPLIT_PART with a column count, LIKE with
a column pattern) take the distinct-tuple path; the others map the
dictionary.  The expectations of the reference's `tests/integration/
test_rex.py` are copied here and held too.  Casts of numbers, dates and
booleans to VARCHAR are held against the reference's own cast, text for
text.  RAND and RAND_INTEGER draw from a `torch.Generator`, so they are
held to their statistics: a seed repeats its values, a uniform mean within
five standard deviations, every integer of the range drawn.  The fused
pipelines decline the registry's names, as the reference's do.
"""
import datetime as dt
import hashlib
import math
import re

import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu.columnar.column import Column as RefColumn
from dask_sql_tpu.physical.rex.operations import \
    OPERATION_MAPPING as REF_OPERATIONS
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.columnar.column import Column
from dask_sql_tpu_torch.columnar.dtypes import SqlType

N = 40


def _frame() -> pd.DataFrame:
    r = np.random.default_rng(0)
    f = r.normal(size=N) * 10
    f[r.random(N) < 0.2] = np.nan
    return pd.DataFrame({
        "i": r.integers(-5, 20, N),
        "f": f,
        "u": r.random(N),
        "s": r.choice(["  apple pie ", "Banana", "cherry-tart", "date", "",
                       None], N).astype(object),
        "t": r.choice(["a,b,c", "x", "p,q"], N).astype(object),
        "p": r.choice(["%a%", "B%", "_a%", "date", None], N).astype(object),
        "k": r.integers(1, 4, N),
        "ts": pd.to_datetime("2020-01-15")
        + pd.to_timedelta(r.integers(0, 800, N), unit="D")
        + pd.to_timedelta(r.integers(0, 86400, N), unit="s"),
    })


FRAME = _frame()


def _py(v):
    """A frame value as Python: NULL (None, NaN, NaT) as None."""
    if v is None or (isinstance(v, float) and math.isnan(v)) or v is pd.NaT:
        return None
    if isinstance(v, np.generic):
        return v.item()
    return v


def rows(fn, *cols):
    """`fn` of each row's values of `cols`, NULL where any is NULL."""
    out = []
    for vals in zip(*(FRAME[c] for c in cols)):
        vals = [_py(v) for v in vals]
        out.append(None if any(v is None for v in vals) else fn(*vals))
    return out


def _and3(a, b):
    if a is False or b is False:
        return False
    if a is None or b is None:
        return None
    return True


def _or3(a, b):
    if a is True or b is True:
        return True
    if a is None or b is None:
        return None
    return False


def _gt0(col):
    return [None if v is None else v > 0 for v in rows(lambda x: x, col)]


def _round_half_away(x, d):
    f = 10.0 ** d
    return math.copysign(math.floor(abs(x * f) + 0.5), x * f) / f


def _substring(x, s, ln=None):
    begin = max(s - 1, 0) if s > 0 else max(len(x) + s, 0) if s < 0 else 0
    return x[begin:] if ln is None else x[begin:begin + max(ln, 0)]


def _pad(x, k, c, left):
    if left:
        return (c * k + x)[-k:] if len(x) < k else x[:k]
    return (x + c * k)[:k]


def _like(x, p):
    rx = "".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                 for ch in p)
    return re.fullmatch(rx, x, re.S) is not None


def _hash64():
    """The reference's factorize id of (s, k): the rank of each row's
    distinct key tuple, NULL keyed as (0, invalid) just below the value
    whose code is 0 (the empty string)."""
    keys = [("" if _py(s) is None else s, _py(s) is not None, k)
            for s, k in zip(FRAME["s"], FRAME["k"])]
    rank = {key: i for i, key in enumerate(sorted(set(keys)))}
    return [rank[key] for key in keys]


def _ts(fn):
    return [fn(pd.Timestamp(v)) for v in FRAME["ts"]]


T0 = pd.Timestamp("2020-03-01")


def _days_toward_zero(v):
    return int((v - T0) / pd.Timedelta(days=1))


def _iso(fn):
    return _ts(lambda v: fn(v.isocalendar()))


def _near_now(got, day=False):
    now = pd.Timestamp.now()
    want = now.normalize() if day else now
    return all(abs((pd.Timestamp(v) - want).total_seconds()) < 120
               for v in got)


#: name -> (SQL expression over t, oracle rows or a check of the column)
CASES = {
    "add": ("i + 1", rows(lambda i: i + 1, "i")),
    "sub": ("i - f", rows(lambda i, f: i - f, "i", "f")),
    "mul": ("i * u", rows(lambda i, u: i * u, "i", "u")),
    "div": ("f / 2", rows(lambda f: f / 2, "f")),
    "mod": ("MOD(i, 3)", rows(lambda i: int(math.fmod(i, 3)), "i")),
    "neg": ("-f", rows(lambda f: -f, "f")),
    "eq": ("i = 1", rows(lambda i: i == 1, "i")),
    "ne": ("i <> 1", rows(lambda i: i != 1, "i")),
    "lt": ("f < 0", rows(lambda f: f < 0, "f")),
    "le": ("f <= 0", rows(lambda f: f <= 0, "f")),
    "gt": ("i > 3", rows(lambda i: i > 3, "i")),
    "ge": ("i >= 3", rows(lambda i: i >= 3, "i")),
    "is_distinct_from": ("f IS DISTINCT FROM 1.0",
                         [_py(f) != 1.0 for f in FRAME["f"]]),
    "is_not_distinct_from": ("f IS NOT DISTINCT FROM u",
                             [_py(f) == u for f, u in zip(FRAME["f"],
                                                          FRAME["u"])]),
    "and": ("(i > 1) AND (f > 0)",
            [_and3(i > 1, g) for i, g in zip(FRAME["i"], _gt0("f"))]),
    "or": ("(i > 1) OR (f > 0)",
           [_or3(i > 1, g) for i, g in zip(FRAME["i"], _gt0("f"))]),
    "not": ("NOT (i > 1)", rows(lambda i: not i > 1, "i")),
    "is_null": ("f IS NULL", [_py(f) is None for f in FRAME["f"]]),
    "is_not_null": ("s IS NOT NULL", [_py(s) is not None for s in FRAME["s"]]),
    "is_true": ("(f > 0) IS TRUE", [g is True for g in _gt0("f")]),
    "is_false": ("(f > 0) IS FALSE", [g is False for g in _gt0("f")]),
    "is_not_true": ("(f > 0) IS NOT TRUE", [g is not True for g in _gt0("f")]),
    "is_not_false": ("(f > 0) IS NOT FALSE",
                     [g is not False for g in _gt0("f")]),
    "abs": ("ABS(i)", rows(abs, "i")),
    "acos": ("ACOS(u)", rows(math.acos, "u")),
    "asin": ("ASIN(u)", rows(math.asin, "u")),
    "atan": ("ATAN(f)", rows(math.atan, "f")),
    "atan2": ("ATAN2(f, u)", rows(math.atan2, "f", "u")),
    "cbrt": ("CBRT(f)", rows(lambda f: math.copysign(abs(f) ** (1 / 3), f),
                             "f")),
    "ceil": ("CEIL(f)", rows(lambda f: float(math.ceil(f)), "f")),
    "floor": ("FLOOR(f)", rows(lambda f: float(math.floor(f)), "f")),
    "cos": ("COS(f)", rows(math.cos, "f")),
    "cot": ("COT(u)", rows(lambda u: 1 / math.tan(u), "u")),
    "degrees": ("DEGREES(f)", rows(math.degrees, "f")),
    "exp": ("EXP(u)", rows(math.exp, "u")),
    "ln": ("LN(u)", rows(math.log, "u")),
    "log": ("LOG(2, u)", rows(lambda u: math.log(u) / math.log(2), "u")),
    "log10": ("LOG10(u)", rows(math.log10, "u")),
    "log2": ("LOG2(u)", rows(math.log2, "u")),
    "power": ("POWER(f, 2)", rows(lambda f: f ** 2, "f")),
    "radians": ("RADIANS(f)", rows(math.radians, "f")),
    "round": ("ROUND(f, 1)", rows(lambda f: _round_half_away(f, 1), "f")),
    "sign": ("SIGN(f)", rows(lambda f: math.copysign(1.0, f) if f else 0.0,
                             "f")),
    "sin": ("SIN(f)", rows(math.sin, "f")),
    "sqrt": ("SQRT(u)", rows(math.sqrt, "u")),
    "tan": ("TAN(f)", rows(math.tan, "f")),
    "truncate": ("TRUNCATE(f, 1)", rows(lambda f: math.trunc(f * 10) / 10,
                                        "f")),
    "rand": ("RAND(42)", lambda got: all(0 <= v < 1 for v in got)),
    "rand_integer": ("RAND_INTEGER(42, 10)",
                     lambda got: set(got) <= set(range(10))),
    "pi": ("PI()", [math.pi] * N),
    "coalesce": ("COALESCE(f, u)", [u if _py(f) is None else f
                                    for f, u in zip(FRAME["f"], FRAME["u"])]),
    "nullif": ("NULLIF(i, 3)", [None if i == 3 else i for i in FRAME["i"]]),
    "greatest": ("GREATEST(f, u, i)", rows(max, "f", "u", "i")),
    "least": ("LEAST(f, u)", rows(min, "f", "u")),
    "char_length": ("CHAR_LENGTH(s)", rows(len, "s")),
    "upper": ("UPPER(s)", rows(str.upper, "s")),
    "lower": ("LOWER(s)", rows(str.lower, "s")),
    "initcap": ("INITCAP(s)", rows(lambda x: re.sub(
        r"[a-zA-Z]+", lambda m: m.group(0).capitalize(), x), "s")),
    "reverse": ("REVERSE(s)", rows(lambda x: x[::-1], "s")),
    "concat": ("CONCAT(s, '!', t)", rows(lambda s, t: s + "!" + t, "s", "t")),
    "substring": ("SUBSTRING(s FROM k FOR 2)",
                  rows(lambda s, k: _substring(s, k, 2), "s", "k")),
    "btrim": ("TRIM(s)", rows(str.strip, "s")),
    "ltrim": ("LTRIM(s)", rows(str.lstrip, "s")),
    "rtrim": ("RTRIM(s)", rows(str.rstrip, "s")),
    "like": ("s LIKE p", rows(_like, "s", "p")),
    "ilike": ("s ILIKE '%A%'", rows(lambda s: "a" in s.lower(), "s")),
    "similar": ("s SIMILAR TO '.*an.*'",
                rows(lambda s: re.fullmatch(".*an.*", s) is not None, "s")),
    "position": ("POSITION('a' IN s)", rows(lambda s: s.find("a") + 1, "s")),
    "overlay": ("OVERLAY(s PLACING 'XX' FROM 2 FOR 3)",
                rows(lambda s: s[:1] + "XX" + s[4:], "s")),
    "replace": ("REPLACE(s, 'a', 'X')", rows(lambda s: s.replace("a", "X"),
                                             "s")),
    "left": ("LEFT(s, 3)", rows(lambda s: s[:3], "s")),
    "right": ("RIGHT(s, k)", rows(lambda s, k: s[-k:], "s", "k")),
    "repeat_str": ("REPEAT(s, k)", rows(lambda s, k: s * k, "s", "k")),
    "lpad": ("LPAD(s, 8, '*')", rows(lambda s: _pad(s, 8, "*", True), "s")),
    "rpad": ("RPAD(s, k)", rows(lambda s, k: _pad(s, k, " ", False),
                                "s", "k")),
    "ascii": ("ASCII(s)", rows(lambda s: ord(s[0]) if s else 0, "s")),
    "chr": ("CHR(i + 70)", rows(lambda i: chr(i + 70), "i")),
    "split_part": ("SPLIT_PART(t, ',', k)",
                   rows(lambda t, k: (t.split(",") + [""] * 3)[k - 1],
                        "t", "k")),
    "md5": ("MD5(s)", rows(lambda s: hashlib.md5(s.encode()).hexdigest(),
                           "s")),
    "hash64": ("HASH(s, k)", _hash64()),
    "datetime_add": ("ts + INTERVAL '2' DAY",
                     _ts(lambda v: v + pd.Timedelta(days=2))),
    "datetime_sub_interval": ("ts - INTERVAL '3' HOUR",
                              _ts(lambda v: v - pd.Timedelta(hours=3))),
    "datetime_sub": ("ts - TIMESTAMP '2020-01-01 00:00:00'",
                     _ts(lambda v: v - pd.Timestamp("2020-01-01"))),
    "int_to_interval_days": ("ts + k", [pd.Timestamp(v) + pd.Timedelta(days=k)
                                        for v, k in zip(FRAME["ts"],
                                                        FRAME["k"])]),
    "datetime_floor": ("FLOOR(ts TO MONTH)", _ts(lambda v: v.replace(
        day=1).normalize())),
    "datetime_ceil": ("CEIL(ts TO DAY)", _ts(lambda v: v.ceil("D"))),
    "date_trunc": ("DATE_TRUNC('week', ts)", _ts(
        lambda v: (v - pd.Timedelta(days=v.weekday())).normalize())),
    "timestampadd": ("TIMESTAMPADD(MONTH, 2, ts)",
                     _ts(lambda v: v + pd.DateOffset(months=2))),
    "timestampdiff": ("TIMESTAMPDIFF(DAY, TIMESTAMP '2020-03-01 00:00:00', ts)",
                      _ts(_days_toward_zero)),
    "last_day": ("LAST_DAY(ts)", _ts(lambda v: (v + pd.offsets.MonthEnd(0))
                                     .normalize())),
    "to_timestamp": ("TO_TIMESTAMP(i)",
                     rows(lambda i: pd.Timestamp(i, unit="s"), "i")),
    "current_timestamp": ("CURRENT_TIMESTAMP", _near_now),
    "current_date": ("CURRENT_DATE", lambda got: _near_now(got, day=True)),
    "extract_year": ("EXTRACT(YEAR FROM ts)", _ts(lambda v: v.year)),
    "extract_month": ("EXTRACT(MONTH FROM ts)", _ts(lambda v: v.month)),
    "extract_day": ("EXTRACT(DAY FROM ts)", _ts(lambda v: v.day)),
    "extract_hour": ("EXTRACT(HOUR FROM ts)", _ts(lambda v: v.hour)),
    "extract_minute": ("EXTRACT(MINUTE FROM ts)", _ts(lambda v: v.minute)),
    "extract_second": ("EXTRACT(SECOND FROM ts)", _ts(lambda v: v.second)),
    "extract_quarter": ("EXTRACT(QUARTER FROM ts)", _ts(lambda v: v.quarter)),
    "extract_week": ("EXTRACT(WEEK FROM ts)", _iso(lambda c: c.week)),
    "extract_dow": ("EXTRACT(DOW FROM ts)",
                    _ts(lambda v: (v.weekday() + 1) % 7 + 1)),
    "extract_isodow": ("EXTRACT(ISODOW FROM ts)", _iso(lambda c: c.weekday)),
    "extract_doy": ("EXTRACT(DOY FROM ts)", _ts(lambda v: v.dayofyear)),
    "extract_epoch": ("EXTRACT(EPOCH FROM ts)", _ts(lambda v: v.value // 10**9)),
    "extract_century": ("EXTRACT(CENTURY FROM ts)",
                        _ts(lambda v: (v.year - 1) // 100 + 1)),
    "extract_decade": ("EXTRACT(DECADE FROM ts)", _ts(lambda v: v.year // 10)),
    "extract_millennium": ("EXTRACT(MILLENNIUM FROM ts)",
                           _ts(lambda v: (v.year - 1) // 1000 + 1)),
    "extract_millisecond": ("EXTRACT(MILLISECOND FROM ts)", [0] * N),
    "extract_microsecond": ("EXTRACT(MICROSECOND FROM ts)", [0] * N),
    "extract_nanosecond": ("EXTRACT(NANOSECOND FROM ts)", [0] * N),
    "extract_isoyear": ("EXTRACT(ISOYEAR FROM ts)", _iso(lambda c: c.year)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are tiny: one thread runs them fastest on
    a machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def c():
    ctx = Context(device="cpu")
    ctx.create_table("t", FRAME)
    return ctx


def _same(got, want) -> bool:
    got, want = _py(got), _py(want)
    if got is None or want is None:
        return got is None and want is None
    if isinstance(want, float) or isinstance(got, float):
        return math.isclose(float(got), float(want), rel_tol=1e-9,
                            abs_tol=1e-12)
    if isinstance(want, (pd.Timestamp, dt.datetime)):
        return pd.Timestamp(got) == pd.Timestamp(want)
    if isinstance(want, pd.Timedelta):
        return pd.Timedelta(got) == want
    return got == want


def test_every_registry_name_has_a_case():
    assert set(CASES) == set(REF_OPERATIONS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_registry_name_evaluates(c, name):
    """Each name of the reference's registry runs in a port query and
    equals its oracle row by row; a name with no evaluation raises."""
    sql, want = CASES[name]
    got = c.sql(f"SELECT {sql} AS x FROM t").compute()["x"].tolist()
    assert len(got) == N
    if callable(want):
        assert want(got), (name, got[:5])
        return
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
           if not _same(g, w)]
    assert not bad, (name, bad[:3])


@pytest.fixture(scope="module")
def rex():
    """The fixture frames of the reference's `tests/integration/
    test_rex.py`."""
    np.random.seed(42)
    ctx = Context(device="cpu")
    ctx.create_table("df", pd.DataFrame({
        "a": [1.0] * 100 + [2.0] * 200 + [3.0] * 400,
        "b": 10 * np.random.rand(700)}))
    ctx.create_table("string_table", pd.DataFrame(
        {"a": ["a normal string", "%_%", "^|()-*[]$"]}))
    ctx.create_table("datetime_table", pd.DataFrame({"no_timezone": pd.date_range(
        start="2014-08-01 09:00", freq="8h", periods=6)}))
    return ctx


def test_rex_string_functions(rex):
    result = rex.sql(
        """SELECT UPPER(a) AS u, LOWER(a) AS l, CHAR_LENGTH(a) AS n,
                  SUBSTRING(a FROM 2 FOR 3) AS sub, CONCAT(a, '!') AS cc,
                  REPLACE(a, 'a', 'X') AS rep, TRIM(a) AS tr,
                  POSITION('n' IN a) AS pos, INITCAP(a) AS ic, REVERSE(a) AS rv,
                  LEFT(a, 3) AS lft, RIGHT(a, 3) AS rgt
           FROM string_table""").compute()
    s = pd.Series(["a normal string", "%_%", "^|()-*[]$"])
    assert list(result["u"]) == list(s.str.upper())
    assert list(result["l"]) == list(s.str.lower())
    assert list(result["n"]) == list(s.str.len())
    assert list(result["sub"]) == list(s.str[1:4])
    assert list(result["cc"]) == list(s + "!")
    assert list(result["rep"]) == list(s.str.replace("a", "X"))
    assert list(result["pos"]) == [x.find("n") + 1 for x in s]
    assert list(result["rv"]) == [x[::-1] for x in s]
    assert list(result["lft"]) == [x[:3] for x in s]
    assert list(result["rgt"]) == [x[-3:] for x in s]


def test_rex_math_casts_and_nulls(rex):
    df = rex.sql("SELECT a, b FROM df").compute()
    result = rex.sql(
        "SELECT POWER(a, 2) AS v8, ATAN(b) AS v12, CAST(b AS BIGINT) AS i, "
        "CAST(a AS VARCHAR) AS s, CAST(a AS BOOLEAN) AS bo, "
        "GREATEST(a, b) AS g, LEAST(a, b) AS l FROM df").compute()
    np.testing.assert_allclose(result["v8"], df.a ** 2, rtol=1e-9)
    np.testing.assert_allclose(result["v12"], np.arctan(df.b), rtol=1e-9)
    assert list(result["i"]) == list(df.b.astype("int64"))
    assert list(result["s"]) == [f"{x:.1f}" for x in df.a]
    assert all(result["bo"])
    np.testing.assert_allclose(result["g"], np.maximum(df.a, df.b))
    np.testing.assert_allclose(result["l"], np.minimum(df.a, df.b))
    rex.create_table("cn", pd.DataFrame({"a": [1.0, None, 3.0],
                                         "b": [10.0, 20.0, 30.0]}))
    got = rex.sql("SELECT COALESCE(a, b) AS co, NULLIF(b, 10) AS ni "
                  "FROM cn").compute()
    assert list(got["co"]) == [1.0, 20.0, 3.0]
    assert pd.isna(got["ni"][0]) and got["ni"][1] == 20.0


def test_rex_datetime_and_strings(rex):
    result = rex.sql(
        """SELECT TIMESTAMPADD(MONTH, 2, no_timezone) AS am,
                  TIMESTAMPDIFF(DAY, TIMESTAMP '2014-08-01 00:00', no_timezone) AS dd
           FROM datetime_table""").compute()
    src = pd.Series(pd.date_range(start="2014-08-01 09:00", freq="8h",
                                  periods=6))
    assert list(result["am"]) == list(src + pd.DateOffset(months=2))
    assert list(result["dd"]) == list(
        ((src - pd.Timestamp("2014-08-01")).dt.total_seconds() // 86400)
        .astype(int))
    rex.create_table("ov", pd.DataFrame({"s": ["abcdef"]}))
    assert rex.sql("SELECT OVERLAY(s PLACING 'XX' FROM 2 FOR 3) AS r "
                   "FROM ov").compute()["r"][0] == "aXXef"
    rex.create_table("lgs", pd.DataFrame({"p": ["pear", "apple"],
                                          "q": ["fig", "quince"]}))
    got = rex.sql("SELECT LEAST(p, q) AS lo, GREATEST(p, q) AS hi "
                  "FROM lgs").compute()
    assert list(got["lo"]) == ["fig", "apple"]
    assert list(got["hi"]) == ["pear", "quince"]


@pytest.mark.parametrize("values", [
    np.array([1.5, -2.0, 0.1, np.nan, 1e20, 3.0], dtype=np.float32),
    np.array([1.5, -2.0, 0.1, np.nan, 1e20, 1 / 3]),
    np.array([7, -3, 0, 12, 7], dtype=np.int64),
    np.array([True, False, True]),
    np.array(["2020-01-01", "1999-12-31T23:59:59.5", "NaT"],
             dtype="datetime64[ns]"),
], ids=["float32", "float64", "int64", "bool", "timestamp"])
def test_cast_to_varchar_gives_the_reference_text(values):
    """The port's text of each value is the reference's, float formatting
    included; the dictionary is sorted and unique."""
    ref = RefColumn.from_numpy(values).cast(
        type(RefColumn.from_numpy(values).sql_type).VARCHAR)
    got = Column.from_numpy(values).cast(SqlType.VARCHAR)
    assert list(got.to_numpy()) == list(ref.to_numpy())
    d = got.dictionary.astype(str)
    assert list(d) == sorted(set(d))


def test_dates_cast_and_group_by_a_cast(c):
    got = c.sql("SELECT CAST(CAST(ts AS DATE) AS VARCHAR) AS d, "
                "CAST(k AS VARCHAR) || '/' || CAST(i > 3 AS VARCHAR) AS g "
                "FROM t").compute()
    assert list(got["d"]) == [str(pd.Timestamp(v).date()) for v in FRAME["ts"]]
    assert list(got["g"]) == [f"{k}/{str(i > 3).lower()}"
                              for k, i in zip(FRAME["k"], FRAME["i"])]
    grouped = c.sql("SELECT CAST(k AS VARCHAR) AS kk, COUNT(*) AS n FROM t "
                    "GROUP BY CAST(k AS VARCHAR) ORDER BY kk").compute()
    want = FRAME["k"].astype(str).value_counts().sort_index()
    assert list(grouped["kk"]) == list(want.index)
    assert list(grouped["n"]) == list(want)


def test_isoyear_and_truncate_types():
    """ISO years at the turn of a year (the reference answers the calendar
    year, ROADMAP.md Queue 3), and TRUNCATE in its plan's type (the
    reference's is DOUBLE; the values are equal)."""
    days = pd.to_datetime(["2020-12-31", "2021-01-01", "2021-01-03",
                           "2021-01-04", "2024-12-30"])
    c = Context(device="cpu")
    c.create_table("d", pd.DataFrame({"ts": days, "i": [17, -23, 5, 0, 9],
                                      "f": np.float32([1.25, -2.75, 3.5,
                                                       0.0, 9.99])}))
    got = c.sql("SELECT EXTRACT(ISOYEAR FROM ts) AS y, "
                "EXTRACT(WEEK FROM ts) AS w, TRUNCATE(i, -1) AS ti, "
                "TRUNCATE(f, 1) AS tf FROM d").compute()
    assert got["y"].tolist() == [d.isocalendar()[0] for d in days]
    assert got["y"].tolist() == [2020, 2020, 2020, 2021, 2025]
    assert got["w"].tolist() == [d.isocalendar()[1] for d in days]
    assert got["ti"].tolist() == [10, -20, 0, 0, 0]
    assert got["ti"].dtype == np.int64 and got["tf"].dtype == np.float32
    np.testing.assert_allclose(got["tf"], [1.2, -2.7, 3.5, 0.0, 9.9],
                               rtol=1e-6)


def test_string_valued_scalar_subquery(c):
    got = c.sql("SELECT COUNT(*) AS n FROM t WHERE s = "
                "(SELECT MAX(s) FROM t)").compute()
    top = max(v for v in FRAME["s"] if _py(v) is not None)
    assert got["n"][0] == sum(v == top for v in FRAME["s"])
    got = c.sql("SELECT i, (SELECT MIN(t) FROM t WHERE k = 9) AS none, "
                "UPPER((SELECT MIN(t) FROM t)) AS lo FROM t").compute()
    assert got["none"].isna().all()
    assert set(got["lo"]) == {min(FRAME["t"]).upper()}


def test_rand_draws_from_the_statements_seed(c):
    """RAND(seed) repeats its values; its mean over 4000 rows is within
    five standard deviations of 1/2; RAND_INTEGER draws every value of its
    range; without a seed two runs differ."""
    big = Context(device="cpu")
    big.create_table("r", pd.DataFrame({"x": np.arange(4000)}))
    sql = "SELECT RAND(7) AS r, RAND_INTEGER(7, 5) AS ri, RAND() AS fresh FROM r"
    a, b = big.sql(sql).compute(), big.sql(sql).compute()
    assert a["r"].tolist() == b["r"].tolist()
    assert a["ri"].tolist() == b["ri"].tolist()
    assert a["fresh"].tolist() != b["fresh"].tolist()
    assert abs(a["r"].mean() - 0.5) < 5 * math.sqrt(1 / 12 / 4000)
    assert set(a["ri"]) == set(range(5))
    other = big.sql("SELECT RAND(8) AS r FROM r").compute()
    assert other["r"].tolist() != a["r"].tolist()


def test_fused_pipelines_decline_the_registry(c):
    """An aggregate over a scan chain whose filter calls a registry name
    answers on the eager rung (the fused pipeline declines, as the
    reference's does) with the oracle's answer."""
    before = c.metrics.counter("compiled_aggregate.declined")
    got = c.sql("SELECT k, COUNT(*) AS n, SUM(POWER(u, 2)) AS p FROM t "
                "WHERE POSITION('a' IN LOWER(s)) > 0 GROUP BY k "
                "ORDER BY k").compute()
    assert c.metrics.counter("compiled_aggregate.declined") == before + 1
    sel = FRAME[[_py(s) is not None and "a" in s.lower() for s in FRAME["s"]]]
    want = sel.groupby("k").agg(n=("u", "size"), p=("u", lambda u: (u ** 2).sum()))
    assert list(got["k"]) == list(want.index)
    assert list(got["n"]) == list(want["n"])
    np.testing.assert_allclose(got["p"], want["p"], rtol=1e-12)
