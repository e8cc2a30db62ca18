"""The port stands alone: neither `dask_sql_tpu_torch` nor its scripts for
the card (`chip_smoke.py`, `profile_q1.py`) import JAX or the JAX package,
even as it plans through its own build of the native planner and runs the
outer, semi and anti joins, subqueries, SUBSTRING, the set operations and
window functions; and the port's entry points refuse to run on the CPU
unless asked to."""
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
assert c.metrics["compiled_join.run"] == 1, dict(c.metrics)
assert c.metrics["compiled_join.declined"] == 1, dict(c.metrics)
# Q1 over encoded columns and the root select (the compiled select rung)
c.create_table("li", chip_smoke.gen_lineitem(12_000))
c.sql(chip_smoke.QUERY.replace("FROM lineitem", "FROM li")).compute()
c.sql("SELECT l_returnflag, l_extendedprice * (1 - l_discount) AS rev "
      "FROM li WHERE l_discount > 0.09 ORDER BY rev DESC LIMIT 100").compute()
assert c.metrics["columnar.encoding.codespace_pred"] >= 1, dict(c.metrics)
assert c.metrics["resilience.rung.compiled_select"] == 1, dict(c.metrics)
# q9 (the eager aggregate over a LIKE filter and EXTRACT) and q14 (CASE
# over LIKE in the join pipeline) with every TPC-H table
for t in ("region", "nation", "supplier", "part", "partsupp"):
    c.create_table(t, tables[t])
assert len(c.sql(QUERIES[9]).compute()) > 0
assert len(c.sql(QUERIES[14]).compute()) == 1
assert c.metrics["resilience.rung.compiled_join_aggregate"] == 2, dict(c.metrics)
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
assert c.metrics["planner.python.bind"] == 0, dict(c.metrics)
assert c.metrics["planner.native.plan"] >= 8, dict(c.metrics)
from dask_sql_tpu_torch.planner import native_bridge
assert native_bridge.get_lib() is not None
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
