"""The port stands alone: neither `dask_sql_tpu_torch` nor its scripts for
the card (`chip_smoke.py`, `profile_q1.py`) import JAX or the JAX package,
even as it plans through its own build of the native planner and runs the
outer, semi and anti joins, subqueries, SUBSTRING, the set operations,
window functions, the statements (DDL, INSERT INTO), a registered
function, a lazy parquet table streamed through the out-of-core
aggregate, EXPLAIN LINT, EXPLAIN ESTIMATE, a query down the degradation
ladder under ``compile:always``, EXPLAIN ANALYZE (text and FORMAT JSON),
SHOW METRICS and SHOW PROFILES, a Q1 family burst on the serving runtime
with SHOW QUERIES and CANCEL QUERY, the semantic reuse tiers with SHOW
MATERIALIZED, a statement over the Presto-wire server and the REPL's
runner; and the port's entry points refuse to run on the CPU unless asked
to."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(code: str, **env):
    full_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full_env.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full_env,
                          capture_output=True, text=True, timeout=120)


IMPORT_ALL = """
import importlib, pkgutil, sys
import dask_sql_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dask_sql_tpu_torch.__path__,
                                               "dask_sql_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, profile_q1
# what the Q3, Q1 and root select paths import as they run (DPP's
# executor at plan time, the join pipeline, the eager join, the encodings,
# the compiled select) stays in the port too
from tests.tpch import QUERIES, generate
c = dask_sql_tpu_torch.Context(device="cpu")
tables = generate(400)
for t in ("customer", "orders", "lineitem"):
    c.create_table(t, tables[t])
c.sql(QUERIES[3]).compute()
# repeated build keys: the pipeline declines and the eager join runs
c.sql("SELECT COUNT(*) AS n FROM orders a JOIN orders b "
      "ON a.o_custkey = b.o_custkey").compute()
assert c.metrics.counter("compiled_join.run") == 1, \
    c.metrics.snapshot()["counters"]
assert c.metrics.counter("compiled_join.declined") == 1, \
    c.metrics.snapshot()["counters"]
# Q1 over encoded columns and the root select (the compiled select rung)
c.create_table("li", chip_smoke.gen_lineitem(12_000))
c.sql(chip_smoke.QUERY.replace("FROM lineitem", "FROM li")).compute()
c.sql("SELECT l_returnflag, l_extendedprice * (1 - l_discount) AS rev "
      "FROM li WHERE l_discount > 0.09 ORDER BY rev DESC LIMIT 100").compute()
assert c.metrics.counter("columnar.encoding.codespace_pred") >= 1, \
    c.metrics.snapshot()["counters"]
assert c.metrics.counter("resilience.rung.compiled_select") == 1, \
    c.metrics.snapshot()["counters"]
# q9 (the eager aggregate over a LIKE filter and EXTRACT) and q14 (CASE
# over LIKE in the join pipeline) with every TPC-H table
for t in ("region", "nation", "supplier", "part", "partsupp"):
    c.create_table(t, tables[t])
assert len(c.sql(QUERIES[9]).compute()) > 0
assert len(c.sql(QUERIES[14]).compute()) == 1
assert c.metrics.counter("resilience.rung.compiled_join_aggregate") == 2, \
    c.metrics.snapshot()["counters"]
# q13 (a LEFT join with an ON residual) and q22 (SUBSTRING, a scalar
# subquery, an anti join), every plan from the native planner built out of
# native/*.cpp
assert len(c.sql(QUERIES[13]).compute()) > 0
assert list(c.sql(QUERIES[22]).compute().columns) == [
    "cntrycode", "numcust", "totacctbal"]
# the set operations and window functions (rel/logical/window.py), and
# the string-valued expressions
c.sql("SELECT n_name FROM nation UNION SELECT r_name FROM region").compute()
c.sql("SELECT n_regionkey FROM nation INTERSECT SELECT r_regionkey "
      "FROM region EXCEPT SELECT 1").compute()
w = c.sql("SELECT n_name, RANK() OVER (PARTITION BY n_regionkey ORDER BY "
          "n_name) AS r, SUM(n_nationkey) OVER (ORDER BY n_nationkey ROWS "
          "BETWEEN 1 PRECEDING AND CURRENT ROW) AS s, UPPER(n_name) || '!' "
          "AS u FROM nation").compute()
assert len(w) == 25 and w["r"].min() == 1, w
assert c.metrics.counter("planner.python.bind") == 0, \
    c.metrics.snapshot()["counters"]
assert c.metrics.counter("planner.native.plan") >= 8, \
    c.metrics.snapshot()["counters"]
from dask_sql_tpu_torch.planner import native_bridge
assert native_bridge.get_lib() is not None
# the statements, a registered function and the function registry
# (rex/operations.py) in one multi-statement call (a script binds in
# Python, as in the reference)
import numpy as np
c.register_function(lambda x: x * 2, "twice", [("x", np.float64)], np.float64)
got = c.sql("CREATE TABLE n2 AS (SELECT n_name, twice(n_nationkey) AS k2 "
            "FROM nation); INSERT INTO n2 VALUES ('x', 1.0); "
            "SELECT COUNT(*) AS n, MAX(LPAD(n_name, 30, '*')) AS m, "
            "SUM(k2) AS k FROM n2").compute()
assert got["n"][0] == 26 and got["k"][0] == 601.0, got
assert got["m"][0] == "*" * 16 + "UNITED KINGDOM", got
c.sql("DROP TABLE n2")
assert "n2" not in c.schema["root"].tables
# a lazy parquet table (footers at registration, pyarrow at the scan) and
# the streamed aggregate over it, in batches of fewer rows than it holds
import tempfile
with tempfile.TemporaryDirectory() as d:
    li = chip_smoke.gen_lineitem(3_000)
    li.to_parquet(f"{d}/li.parquet", row_group_size=1_000)
    c.create_table("li_pq", f"{d}/li.parquet")
    lazy = c.schema["root"].tables["li_pq"]
    from dask_sql_tpu_torch.physical import streaming
    batches, scan = [], streaming._iter_batches
    streaming._iter_batches = lambda *a: (
        b for b in scan(*a) if not batches.append(b.num_rows))
    got = c.sql(chip_smoke.QUERY.replace("FROM lineitem", "FROM li_pq"),
                config_options={"sql.streaming.batch_rows": 1_000}).compute()
    assert got["count_order"].sum() == (
        li.l_shipdate <= np.datetime64("1998-09-02")).sum(), got
    assert len(batches) == 3 and lazy._table is None, batches
# the plan verifier and the estimator (EXPLAIN LINT, EXPLAIN ESTIMATE) and
# the degradation ladder under an injected compile failure
lint = list(c.sql("EXPLAIN LINT " + chip_smoke.QUERY.replace(
    "FROM lineitem", "FROM li")).compute()["LINT"])
assert any("DICT" in ln for ln in lint), lint
est = c.sql("EXPLAIN ESTIMATE " + QUERIES[3]).compute()["ESTIMATE"]
assert est[0].startswith("estimate: rows_lo="), est
before = c.metrics.counter("resilience.degraded")
c.sql(chip_smoke.QUERY.replace("FROM lineitem", "FROM li"), config_options={
    "resilience.inject": "compile:always"}).compute()
assert c.metrics.counter("resilience.degraded") == before + 3, \
    c.metrics.snapshot()["counters"]
# query tracing: EXPLAIN ANALYZE, SHOW METRICS and SHOW PROFILES
plan = list(c.sql("EXPLAIN ANALYZE " + QUERIES[3]).compute()["PLAN"])
assert plan[0].startswith("-- query lifecycle"), plan
assert c.sql("EXPLAIN ANALYZE FORMAT JSON " + QUERIES[3]).compute()[
    "PLAN"][0].startswith('{"displayTimeUnit"')
metrics = c.sql("SHOW METRICS", return_futures=False)
assert "query.execute_ms.count" in set(metrics["Metric"]), metrics
profiles = c.sql("SHOW PROFILES", return_futures=False)
assert "hits" in set(profiles["Metric"]), profiles
# the serving path: two members of Q1's family submitted at once to a
# ServingRuntime answer with one stacked run; SHOW QUERIES lists them and
# CANCEL QUERY answers
from dask_sql_tpu_torch.serving import ServingRuntime
rt = ServingRuntime(workers=2, metrics=c.metrics, batch_queries=2,
                    batch_window_ms=5_000.0)
c.serving = rt
q1 = chip_smoke.QUERY.replace("FROM lineitem", "FROM li")
try:
    futs = [c.submit(q1.replace("1998-09-02", d), config_options={
        "serving.cache.enabled": False})[1]
        for d in ("1998-08-01", "1998-07-01")]
    assert all(len(f.result(120)) > 0 for f in futs)
finally:
    rt.shutdown(wait=True)
c.serving = None
assert c.metrics.counter("serving.batch.launches") == 1, \
    c.metrics.snapshot()["counters"]
rows = c.sql("SHOW QUERIES", return_futures=False)
assert {"leader x2", "member x2"} <= set(rows["Value"]), rows
assert c.sql("CANCEL QUERY 'none'").compute()["Cancelled"][0] == "false"
# semantic reuse (materialize/): a stem pinned by two siblings and scanned
# by a third, a tighter literal served by subsumption, an aggregate state
# folded by an append and answered from it; SHOW MATERIALIZED
import pandas as pd
rng = np.random.default_rng(0)
r = pd.DataFrame({"a": rng.integers(0, 100, 2000),
                  "k": rng.integers(0, 5, 2000)})
c.create_table("r", r)
REUSE = ("serving.materialize.stored", "serving.materialize.hits",
         "serving.materialize.refreshed", "serving.reuse.subsumption.hits",
         "serving.reuse.incremental.folds", "serving.reuse.incremental.hits")
before = {k: c.metrics.counter(k) for k in REUSE}
for q in ("SELECT a FROM r WHERE a > 3", "SELECT k FROM r WHERE a > 3",
          "SELECT a, k FROM r WHERE a > 3", "SELECT a, k FROM r WHERE a > 50"):
    c.sql(q).compute()
agg = "SELECT k, SUM(a) AS s FROM r GROUP BY k"
c.sql(agg).compute()
c.append_rows("r", r.iloc[:10])
assert c.sql(agg).compute()["s"].sum() == r.a.sum() + r.a[:10].sum()
reuse = {k: c.metrics.counter(k) - before[k] for k in REUSE}
assert set(reuse.values()) == {1}, reuse
assert set(c.sql("SHOW MATERIALIZED").compute()["Kind"]) == {
    "stem", "incremental"}
# the front ends: a statement over the Presto wire, and the REPL's runner
import json, time, urllib.request
from dask_sql_tpu_torch.cmd import _run_query
from dask_sql_tpu_torch.server.app import run_server
srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
try:
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/statement",
        data=b"SELECT COUNT(*) AS n FROM r", method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        payload = json.loads(resp.read())
    while "nextUri" in payload:
        time.sleep(0.02)
        with urllib.request.urlopen(payload["nextUri"], timeout=30) as resp:
            payload = json.loads(resp.read())
    assert payload["data"] == [[2010]], payload
finally:
    srv.shutdown()
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()) as printed:
    _run_query(c, "SELECT 1 AS one")
assert "one" in printed.getvalue()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dask_sql_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax():
    out = _run(IMPORT_ALL)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 33  # every module of the port imported


def test_context_defaults_to_the_card(monkeypatch):
    from dask_sql_tpu_torch import Context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Context()
    assert Context(device="cpu").device == torch.device("cpu")


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
