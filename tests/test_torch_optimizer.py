"""The port's optimizer and plan cache against the reference's, on the CPU.

Both contexts register the same seeded TPC-H frames
(`tests/tpch.py generate(2000)`); the reference plans with its native
binder off, which is the Python path the port copied.  The optimized plan
text (`explain()`) must be equal: for q1-q22 with dynamic partition pruning
(DPP) off, and for Q1 and Q3 with DPP on, where Q3's lineitem scan carries
the InArray filter DPP derives from the filtered orders.  No query may fall
back to its unoptimized plan (`planner.optimize.fallback` stays 0).
"""
import pytest

import dask_sql_tpu
from dask_sql_tpu.planner.parser import parse_sql as ref_parse
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.planner.parser import parse_sql as port_parse
from tests.tpch import QUERIES, generate

NO_DPP = {"sql.dynamic_partition_pruning": False}


@pytest.fixture(scope="module")
def contexts():
    tables = generate(2000)
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    for name, frame in tables.items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    return rc, pc


def _plans(contexts, q, options):
    rc, pc = contexts
    with rc.config.set(dict(options, **{"sql.native.binder": "off"})):
        want = rc._get_ral(ref_parse(QUERIES[q])[0])
    with pc.config.set(options):
        got = pc._get_ral(port_parse(QUERIES[q])[0])
    assert pc.metrics.counter("planner.optimize.fallback") == 0
    return got.explain(), want.explain()


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_optimized_plan_matches_reference(contexts, q):
    got, want = _plans(contexts, q, NO_DPP)
    assert got == want


@pytest.mark.parametrize("q", [1, 3])
def test_dpp_plan_matches_reference(contexts, q):
    got, want = _plans(contexts, q, {})
    assert got == want
    scans = [line for line in got.splitlines() if "TableScan: root.lineitem" in line]
    assert len(scans) == 1
    assert ("InArray(" in scans[0]) == (q == 3)


def test_plan_cache_hits_and_misses_on_reregistration():
    tables = generate(500, seed=3)
    c = Context(device="cpu")
    for name in ("customer", "orders", "lineitem"):
        c.create_table(name, tables[name])
    first = c.sql(QUERIES[3])
    assert c.metrics.counter("query.plan_cache.miss") == 1
    again = c.sql(QUERIES[3])
    assert c.metrics.counter("query.plan_cache.hit") == 1
    assert again._plan is first._plan
    # other per-query options plan anew
    c.sql(QUERIES[3], config_options=NO_DPP)
    assert c.metrics.counter("query.plan_cache.miss") == 2
    # a table registered again has a new uid: the catalog signature changes
    c.create_table("orders", tables["orders"])
    third = c.sql(QUERIES[3])
    assert c.metrics.counter("query.plan_cache.miss") == 3
    assert third._plan is not first._plan
    assert c.metrics.counter("planner.optimize.fallback") == 0
    assert third.compute().equals(first.compute())


def test_optimizer_fallback_is_counted(monkeypatch):
    """A failing rule leaves the plan as it was before the Python optimizer
    (the native planner's, or the unoptimized one) and counts the
    fallback."""
    from dask_sql_tpu_torch.planner.optimizer import driver

    def broken(plan, config, catalog, **kwargs):
        raise RuntimeError("rule failure")

    monkeypatch.setattr(driver, "optimize_core", broken)
    monkeypatch.setattr(driver, "optimize_post", broken)
    tables = generate(500, seed=4)
    c = Context(device="cpu")
    c.create_table("lineitem", tables["lineitem"])
    got = c.sql(QUERIES[1]).compute()
    assert c.metrics.counter("planner.optimize.fallback") == 1
    assert len(got) > 0
