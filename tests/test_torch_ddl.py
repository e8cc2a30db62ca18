"""The rest of the SQL surface in the port: DDL, SHOW, DESCRIBE, ALTER,
USE, INSERT INTO, ANALYZE TABLE and several statements in one call,
through `Context(device="cpu")`.

The statements and expectations of the reference's `tests/integration/
test_ddl.py` are copied here (the file-backed CREATE TABLE WITH (location
= ...) is in `tests/test_torch_files.py`); the statements whose subsystem
is a later item of ROADMAP.md's Queue 1 raise `NotImplementedError`
naming it, and SHOW MODELS lists what the reference lists.  INSERT INTO appends to
PLAIN, DICT, FOR and RLE columns, with a new dictionary value and a new
group.  One short script (CREATE TABLE AS, INSERT INTO, an aggregate with
a registered function) runs through the port and the reference `Context`
alike: the same answers, rungs and `columnar.encoding.*` counts.  After
appends, cached plans and compiled pipelines of TPC-H Q1 and Q3 (whose
plan carries a dynamic-partition-pruning filter read at plan time) are
not reused: the answers equal the reference's on the appended frames.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.columnar.encodings import Encoding
from dask_sql_tpu_torch.physical import compiled, compiled_join
from tests.tpch import QUERIES, generate
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
def df_simple():
    return pd.DataFrame({"a": [1, 2, 3], "b": [1.1, 2.2, 3.3]})


@pytest.fixture
def df():
    np.random.seed(42)
    return pd.DataFrame({"a": [1.0] * 100 + [2.0] * 200 + [3.0] * 400,
                         "b": 10 * np.random.rand(700)})


@pytest.fixture
def c(df_simple, df):
    ctx = Context(device="cpu")
    ctx.create_table("df_simple", df_simple)
    ctx.create_table("df", df)
    ctx.create_table("user_table_1", pd.DataFrame({"user_id": [2, 1, 2, 3],
                                                   "b": [3, 3, 1, 3]}))
    return ctx


# -- the reference's test_ddl.py ---------------------------------------------
def test_create_table_as(c, df):
    c.sql("CREATE TABLE new_table AS (SELECT a, b FROM df WHERE a = 1)")
    result = c.sql("SELECT * FROM new_table").compute()
    assert_eq(result, df[df.a == 1], check_dtype=False)


def test_create_view_lazy(c, df):
    c.sql("CREATE VIEW my_view AS (SELECT a, b FROM df WHERE a = 2)")
    result = c.sql("SELECT COUNT(*) AS n FROM my_view").compute()
    assert result["n"][0] == (df.a == 2).sum()


def test_create_or_replace(c):
    c.sql("CREATE TABLE t1 AS (SELECT a FROM df)")
    with pytest.raises(RuntimeError):
        c.sql("CREATE TABLE t1 AS (SELECT b FROM df)")
    c.sql("CREATE OR REPLACE TABLE t1 AS (SELECT b FROM df)")
    assert list(c.sql("SELECT * FROM t1").compute().columns) == ["b"]
    c.sql("CREATE TABLE IF NOT EXISTS t1 AS (SELECT a FROM df)")
    assert list(c.sql("SELECT * FROM t1").compute().columns) == ["b"]


def test_drop_table(c):
    c.sql("CREATE TABLE to_drop AS (SELECT a FROM df)")
    c.sql("DROP TABLE to_drop")
    with pytest.raises(Exception):
        c.sql("SELECT * FROM to_drop")
    c.sql("DROP TABLE IF EXISTS to_drop")  # no error


def test_schemas(c):
    c.sql("CREATE SCHEMA other")
    assert "other" in c.schema
    c.sql("USE SCHEMA other")
    assert c.schema_name == "other"
    c.sql("USE SCHEMA root")
    c.sql("ALTER SCHEMA other RENAME TO other2")
    assert "other2" in c.schema and "other" not in c.schema
    c.sql("DROP SCHEMA other2")
    assert "other2" not in c.schema


def test_show_schemas_tables_columns(c):
    assert "root" in list(c.sql("SHOW SCHEMAS").compute()["Schema"])
    assert "df_simple" in list(c.sql("SHOW TABLES FROM root").compute()["Table"])
    result = c.sql("SHOW COLUMNS FROM df_simple").compute()
    assert set(result["Column"]) == {"a", "b"}
    assert list(result["Type"]) == ["bigint", "double"]


def test_alter_table(c, df_simple):
    c.create_table("alter_me", df_simple)
    c.sql("ALTER TABLE alter_me RENAME TO altered")
    assert "altered" in c.schema["root"].tables
    assert_eq(c.sql("SELECT * FROM altered").compute(), df_simple)
    c.sql("DROP TABLE altered")
    assert "altered" not in c.schema["root"].tables


def test_analyze_table(c, df):
    result = c.sql("ANALYZE TABLE df COMPUTE STATISTICS FOR ALL COLUMNS"
                   ).compute()
    assert "col_name" in result.columns
    assert "a" in result.columns
    stats = df.describe()
    assert list(result["col_name"]) == [
        "count", "mean", "std", "min", "percentile_25", "percentile_50",
        "percentile_75", "max", "data_type", "col_name"]
    assert list(result["b"][:8]) == [str(v) for v in stats["b"]]
    assert list(result["b"][8:]) == ["float64", "b"]


def test_distribute_by(c):
    result = c.sql("SELECT * FROM user_table_1 DISTRIBUTE BY user_id").compute()
    assert len(result) == 4
    ids = list(result["user_id"])
    assert [k for i, k in enumerate(ids) if i == 0 or ids[i - 1] != k] \
        == sorted(set(ids), key=ids.index)


def test_explain(c):
    assert "TableScan" in c.explain("SELECT a FROM df WHERE a > 1")
    assert "PLAN" in c.sql("EXPLAIN SELECT a FROM df").compute().columns


def test_sample(c, df):
    result = c.sql("SELECT * FROM df TABLESAMPLE BERNOULLI (50) WHERE a >= 1"
                   ).compute()
    assert 0 < len(result) < len(df)
    result = c.sql("SELECT * FROM df TABLESAMPLE SYSTEM (50) REPEATABLE (42)"
                   ).compute()
    assert 0 <= len(result) <= len(df)


def test_multiple_statements(c, df):
    result = c.sql("CREATE TABLE ms1 AS (SELECT a FROM df); "
                   "SELECT COUNT(*) AS n FROM ms1")
    assert result.compute()["n"][0] == len(df)


def test_case_insensitive_identifiers(c):
    result = c.sql("SELECT A FROM DF LIMIT 1", config_options={
        "sql.identifier.case_sensitive": False}).compute()
    assert list(result.columns) == ["a"]


def test_syntax_error_raises_parsing_exception():
    from dask_sql_tpu_torch.planner.parser import ParsingException

    with pytest.raises(ParsingException):
        Context(device="cpu").sql("SELEC 1")


# -- beyond the reference's cases ----------------------------------------------
def test_views_describe_and_drop_view(c, df):
    """A view is listed and described like a table, reads the rows of its
    base table as they are when it is read, and drops."""
    got = c.sql("CREATE VIEW v AS (SELECT a, b * 2 AS b2 FROM df WHERE a > 1); "
                "SHOW TABLES").compute()
    assert set(got["Table"]) == {"df_simple", "df", "user_table_1", "v"}
    described = c.sql("DESCRIBE v").compute()
    assert list(described["Column"]) == ["a", "b2"]
    assert list(described["Type"]) == ["double", "double"]
    c.sql("INSERT INTO df VALUES (5.0, 1.0)")
    got = c.sql("SELECT a, SUM(b2) AS s FROM v GROUP BY a ORDER BY a").compute()
    assert list(got["a"]) == [2.0, 3.0, 5.0]
    np.testing.assert_allclose(got["s"][:2], [2 * df.b[df.a == 2].sum(),
                                              2 * df.b[df.a == 3].sum()])
    c.sql("DROP VIEW v")
    assert "v" not in c.sql("SHOW TABLES").compute()["Table"].tolist()
    with pytest.raises(Exception):
        c.sql("SELECT * FROM v")


@pytest.mark.parametrize("sql, needs", [
    ("SHOW REPLICAS", "fleet router"),
])
def test_statements_of_later_items_raise(c, sql, needs):
    with pytest.raises(NotImplementedError, match=needs):
        c.sql(sql, return_futures=False)


def test_show_models_matches_reference(df):
    """SHOW MODELS (its stub replaced by the model registry): the
    reference's columns Model, Tier, ParamBytes and Shape, empty and with
    models of both tiers."""
    got = {}
    for engine in ("port", "ref"):
        c = Context(device="cpu") if engine == "port" \
            else dask_sql_tpu.Context()
        c.create_table("df", df)
        empty = c.sql("SHOW MODELS", return_futures=False)
        c.sql("""CREATE MODEL lin WITH (model_class = 'LinearRegression',
                 target_column = 'b') AS (SELECT a, b FROM df)""")
        c.sql("""CREATE MODEL wrapped WITH (
                 model_class = 'sklearn.linear_model.LinearRegression',
                 wrap_predict = True, target_column = 'b')
                 AS (SELECT a, b FROM df)""")
        got[engine] = (list(empty.columns), len(empty),
                       c.sql("SHOW MODELS", return_futures=False))
    assert got["port"][:2] == got["ref"][:2] == (
        ["Model", "Tier", "ParamBytes", "Shape"], 0)
    pd.testing.assert_frame_equal(got["port"][2], got["ref"][2])
    assert list(got["port"][2]["Tier"]) == ["compiled", "host"]


@pytest.mark.parametrize("statement", ["SHOW METRICS", "SHOW PROFILES",
                                       "EXPLAIN ANALYZE", "SHOW QUERIES",
                                       "CANCEL QUERY 'q1'",
                                       "SHOW MATERIALIZED"])
def test_observability_statements_answer(c, statement):
    """The statements that raised before the observability, serving and
    reuse slices answer: the registry, the profile store, the traced node
    tree of the query run just before, the in-flight table, a cancel of an
    unknown qid and the reuse state (`tests/test_torch_observability.py`,
    `tests/test_torch_live.py` and `tests/test_torch_reuse.py` hold them
    against the reference)."""
    sql = "SELECT a, SUM(b) AS s FROM df GROUP BY a"
    c.sql(sql, return_futures=False)
    if statement == "EXPLAIN ANALYZE":
        lines = c.sql(f"EXPLAIN ANALYZE {sql}").compute()["PLAN"].tolist()
        assert lines[0].startswith("-- query lifecycle")
        assert any(line.lstrip().startswith("Aggregate: ")
                   and line.endswith("3 rows]")
                   for line in lines)
        return
    got = c.sql(statement, return_futures=False)
    if statement == "SHOW QUERIES":
        rows = set(zip(got["Field"], got["Value"]))
        assert ("state", "done") in rows and ("stage", "execute") in rows
        assert ("reservedBytes", "0") in rows  # the ledger's block
        return
    if statement.startswith("CANCEL"):
        assert got.to_dict("list") == {"Qid": ["q1"], "Cancelled": ["false"]}
        return
    if statement == "SHOW MATERIALIZED":
        # one aggregate registered, no append yet: no state to list
        assert list(got.columns) == ["Kind", "Fingerprint", "Table", "Rows",
                                     "Bytes", "Hits", "Epoch"]
        assert len(got) == 0
        return
    if statement == "SHOW METRICS":
        values = dict(zip(got["Metric"], got["Value"]))
        assert values["query.executed"] == "1"
        assert values["query.execute_ms.count"] == "1"
        assert values["plan_cache.entries"] == "1"
        assert values["resilience.breaker.open"] == "0"
    else:
        assert list(got.columns) == ["Fingerprint", "Family", "Metric",
                                     "Value"]
        rows = {(m, v) for m, v in zip(got["Metric"], got["Value"])}
        assert ("hits", "1") in rows and ("rows.observed.last", "3") in rows


def _encoded_frame(n: int = 4096) -> pd.DataFrame:
    """Columns that load PLAIN (s, p), DICT (q, d, day), FOR (big) and RLE
    (run), as the reference encodes them."""
    r = np.random.RandomState(21)
    return pd.DataFrame({
        "s": r.choice(["A", "N", "R"], n),
        "q": r.randint(1, 51, n).astype(np.float32),
        "big": r.randint(10**9, 10**9 + 90_000, n).astype(np.int64) * 3,
        "run": np.repeat(np.arange(8, dtype=np.int64), n // 8),
        "p": r.rand(n) * 1000,
        "d": r.choice([0.0, 0.05, 0.1], n),
        "day": (np.datetime64("1995-01-01") + r.randint(0, 300, n).astype(
            "timedelta64[D]")).astype("datetime64[ns]"),
    })


NEW_ROW = ("('X', CAST(60.0 AS REAL), 3000000000, 9, 1.5, 0.2, "
           "TIMESTAMP '1996-02-29 00:00:00')")


def test_insert_into_encoded_columns():
    """INSERT INTO appends in place to PLAIN, DICT, FOR and RLE columns
    (the table keeps its uid; the encoded columns decode, the string
    dictionary merges), with a value no dictionary held and a new group."""
    frame = _encoded_frame()
    c = Context(device="cpu")
    c.create_table("enc", frame)
    dc = c.schema["root"].tables["enc"]
    uid = dc.uid
    assert {n: col.encoding for n, col in dc.table.columns.items()} == {
        "s": Encoding.PLAIN, "q": Encoding.DICT, "big": Encoding.FOR,
        "run": Encoding.RLE, "p": Encoding.PLAIN, "d": Encoding.DICT,
        "day": Encoding.DICT}
    got = c.sql("INSERT INTO enc SELECT * FROM enc WHERE q < 3").compute()
    added = frame[frame.q < 3]
    assert got["Inserted"].tolist() == [str(len(added))]
    c.sql(f"INSERT INTO enc VALUES {NEW_ROW}")
    assert dc.uid == uid and c.table_epoch("root", "enc") == 3
    new = pd.DataFrame({"s": ["X"], "q": np.float32([60.0]),
                        "big": [3_000_000_000], "run": [9], "p": [1.5],
                        "d": [0.2], "day": [pd.Timestamp("1996-02-29")]})
    want = pd.concat([frame, added, new], ignore_index=True)
    assert_eq(c.sql("SELECT * FROM enc").compute(), want)
    assert not dc.table.has_encoded_columns()
    assert list(dc.table.columns["s"].dictionary) == ["A", "N", "R", "X"]
    groups = c.sql("SELECT s, COUNT(*) AS n, MAX(q) AS mq FROM enc GROUP BY s "
                   "ORDER BY s").compute()
    counts = want.groupby("s").size()
    assert groups["s"].tolist() == list(counts.index)
    assert groups["n"].tolist() == list(counts)
    assert groups["mq"].tolist()[-1] == 60.0
    assert c.metrics.counter("columnar.encoding.encoded_columns") == 5


SCRIPT = f"""
CREATE TABLE agg AS (SELECT s, COUNT(*) AS n, SUM(p) AS rev FROM enc
                     WHERE q < 40 GROUP BY s);
INSERT INTO enc VALUES {NEW_ROW};
SELECT s, COUNT(*) AS n, SUM(disc_price(p, d)) AS rev FROM enc GROUP BY s
ORDER BY s
"""


def _counters(metrics):
    return {k: v for k, v in metrics.items()
            if k.startswith(("resilience.", "columnar.encoding."))}


def test_script_matches_the_reference():
    """One multi-statement call in both engines: CREATE TABLE AS (on the
    fused aggregate), INSERT INTO over encoded columns with a new group, an
    aggregate with a registered function (on the eager rung); the answers,
    the tables, the rungs and the encoding counts are the reference's."""
    frame = _encoded_frame(1024)
    rc, pc = dask_sql_tpu.Context(), Context(device="cpu")
    for ctx in (rc, pc):
        ctx.create_table("enc", frame)
        ctx.register_function(lambda p, d: p * (1 - d), "disc_price",
                              [("p", np.float64), ("d", np.float64)],
                              np.float64)
    rb = dict(rc.metrics.snapshot()["counters"])
    want = rc.sql(SCRIPT).compute()
    got = pc.sql(SCRIPT).compute()
    assert_eq(got, want, check_dtype=True)
    for name in ("agg", "enc"):
        assert_eq(pc.get_table_data("root", name).to_pandas(),
                  rc.get_table_data("root", name).to_pandas(),
                  sort_results=True)
    ref = _counters(rc.metrics.snapshot()["counters"])
    ref = {k: v - rb.get(k, 0) for k, v in ref.items() if v != rb.get(k, 0)}
    ref["columnar.encoding.encoded_columns"] = \
        rc.metrics.snapshot()["counters"]["columnar.encoding.encoded_columns"]
    assert _counters(pc.metrics.snapshot()["counters"]) == ref
    assert not any(k.startswith("resilience.degraded") for k in ref)


def _appended(tables):
    """New orders (keys past the last) of the BUILDING segment before Q3's
    date, their lineitems at three times the price, and lineitems of a new
    return flag: they enter Q3's top ten and Q1's groups."""
    orders, lineitem = tables["orders"], tables["lineitem"]
    building = tables["customer"].query("c_mktsegment == 'BUILDING'").c_custkey
    new_orders = orders[orders.o_custkey.isin(building)
                        & (orders.o_orderdate < "1995-03-15")].head(20).copy()
    shift = int(orders.o_orderkey.max()) + 1
    new_li = lineitem[lineitem.l_orderkey.isin(new_orders.o_orderkey)
                      & (lineitem.l_shipdate > "1995-03-15")].copy()
    new_orders["o_orderkey"] += shift
    new_li["l_orderkey"] += shift
    new_li["l_extendedprice"] *= 3
    flag = lineitem.head(3).copy()
    flag["l_returnflag"] = "X"
    return new_orders, pd.concat([new_li, flag], ignore_index=True)


def test_appends_reach_cached_plans_and_pipelines():
    """Q1 and Q3 run twice (the second from the plan cache and the cached
    pipelines); then rows append to orders and lineitem in place.  The
    next runs miss the plan cache, build new pipelines, and answer as the
    reference does on the appended frames; Q3's pruning filter takes the
    new order keys."""
    tables = generate(2000)
    names = ("customer", "orders", "lineitem")
    pc = Context(device="cpu")
    for n in names:
        pc.create_table(n, tables[n])
    for q in (1, 3, 1, 3):
        pc.sql(QUERIES[q]).compute()
    assert pc.metrics.counter("query.plan_cache.hit") == 2
    assert "InArray" in pc.explain(QUERIES[3]) or "IN (" in pc.explain(
        QUERIES[3])
    owner = compiled.pipeline_owner(pc)

    def built_for_pc():
        # the caches are shared by every Context and evict a collected
        # Context's entries at any time: count this Context's
        return tuple(sum(1 for key in cache if key[0] == owner)
                     for cache in (compiled._cache, compiled_join._cache))

    built = built_for_pc()
    new_orders, new_li = _appended(tables)
    pc.append_rows("orders", new_orders)
    pc.append_rows("lineitem", new_li)
    misses = pc.metrics.counter("query.plan_cache.miss")
    got1, got3 = pc.sql(QUERIES[1]).compute(), pc.sql(QUERIES[3]).compute()
    assert pc.metrics.counter("query.plan_cache.miss") == misses + 2
    assert built_for_pc() == (built[0] + 1, built[1] + 1)
    rc = dask_sql_tpu.Context()
    rc.create_table("customer", tables["customer"])
    rc.create_table("orders", pd.concat([tables["orders"], new_orders],
                                        ignore_index=True))
    rc.create_table("lineitem", pd.concat([tables["lineitem"], new_li],
                                          ignore_index=True))
    assert_eq(got1, rc.sql(QUERIES[1]).compute(), check_dtype=True)
    want3 = rc.sql(QUERIES[3]).compute()
    assert_eq(got3, want3, check_dtype=True)
    assert "X" in got1["l_returnflag"].tolist()
    assert set(got3["l_orderkey"]) & set(new_orders["o_orderkey"])
