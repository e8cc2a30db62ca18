"""The port's Plan stage against the reference's, plans only (nothing runs).

Both contexts register the same seeded TPC-H frames (`tests/tpch.py
generate(2000)`).  For `bench.py`'s query and TPC-H q1-q22, the port's
optimized plan text (`explain()`) and its plan-family identity (the
literal-stripped fingerprint and the parameter values) must equal the
reference's, with the native C++ planner (``sql.native.binder = "auto"``,
the default of both) and with the Python planner (``"off"``).  The port
builds its own copy of the native planner from `native/*.cpp` into its
`_build/` directory; its tokens and syntax trees must equal the Python
lexer's and parser's, and the ``planner.*`` counters say which binder ran.
"""
import pytest

import bench
import dask_sql_tpu
from dask_sql_tpu import families as ref_families
from dask_sql_tpu.planner.parser import parse_sql as ref_parse
from dask_sql_tpu_torch import Context, _build, families
from dask_sql_tpu_torch.planner import lexer, native_bridge, parser
from tests.tpch import QUERIES, generate

CASES = [("bench", bench.QUERY)] + [(f"q{q}", QUERIES[q]) for q in sorted(QUERIES)]
BINDERS = ("planner.native.plan", "planner.native.bind", "planner.python.bind")


@pytest.fixture(scope="module")
def contexts():
    tables = generate(2000)
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    for name, frame in tables.items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    # bench.py's query reads a lineitem table of its own generator
    rc.create_table("bench_lineitem", bench.gen_lineitem(1000))
    pc.create_table("bench_lineitem", bench.gen_lineitem(1000))
    return rc, pc


def _sql(name, sql):
    if name == "bench":
        return sql.replace("FROM lineitem", "FROM bench_lineitem")
    return sql


def _binders(c):
    return {k: c.metrics.counter(k) for k in BINDERS if c.metrics.counter(k)}


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("name,sql", CASES, ids=[n for n, _ in CASES])
def test_plan_and_family_match_reference(contexts, name, sql, mode):
    rc, pc = contexts
    sql = _sql(name, sql)
    options = {"sql.native.binder": mode}
    with rc.config.set(options):
        want = rc._get_ral(ref_parse(sql)[0], sql_text=sql)
    before = _binders(pc)
    with pc.config.set(options):
        got = pc._get_ral(parser.parse_sql(sql)[0], sql_text=sql)
    after = _binders(pc)
    ran = {k: after[k] - before.get(k, 0) for k in after
           if after[k] != before.get(k, 0)}
    assert ran == ({"planner.native.plan": 1} if mode == "auto"
                   else {"planner.python.bind": 1})
    assert pc.metrics.counter("planner.optimize.fallback") == 0
    assert got.explain() == want.explain()
    fam = families.family_of(got, pc.config)
    ref_fam = ref_families.compute_family(want)
    assert (fam.fingerprint, fam.key_values, fam.n_params) == (
        ref_fam.fingerprint, ref_fam.key_values, ref_fam.n_params)


@pytest.mark.parametrize("name,sql", CASES, ids=[n for n, _ in CASES])
def test_native_tokens_and_ast_match_python(monkeypatch, name, sql):
    tokens = native_bridge.native_tokenize(sql)
    assert tokens is not None, "the native planner library did not load"
    python = lexer.tokenize(sql)
    assert [(t.type, t.value) for t in tokens] == [(t.type, t.value)
                                                  for t in python]
    # a quoted token's native position is its first character past the
    # quote, as in the reference's build of the same tokenizer
    quoted = ("STRING", "QUOTED_IDENT")
    assert [t.pos - (t.type in quoted) for t in tokens] == [t.pos for t in python]
    native_ast = native_bridge.native_parse(sql)
    monkeypatch.setattr(parser.Parser, "_tokenize", staticmethod(lexer.tokenize))
    assert repr(native_ast) == repr(parser.Parser(sql).parse_statements())


def test_library_is_built_from_the_native_sources():
    path = _build.native_library()
    assert path.parent == _build.BUILD_DIR
    assert path.name == _build.native_library_path().name
    assert native_bridge.get_lib() is not None


def test_binder_counters_and_strict_mode(contexts):
    _, pc = contexts
    sql = QUERIES[6]
    before = _binders(pc)
    pc.sql(sql, config_options={"sql.optimize": False})
    pc.sql(sql, config_options={"sql.native.binder": "on"})
    after = _binders(pc)
    assert after["planner.native.bind"] == before.get("planner.native.bind", 0) + 1
    assert after["planner.native.plan"] == before.get("planner.native.plan", 0) + 1
    # a plan with literals counts in families.parameterized; families off
    # leaves the counter
    n = pc.metrics.counter("families.parameterized")
    pc.sql(sql, config_options={"families.enabled": False})
    assert pc.metrics.counter("families.parameterized") == n
