"""The plan verifier, the estimator and EXPLAIN LINT / EXPLAIN ESTIMATE in
the port (`dask_sql_tpu_torch/analysis/`), through `Context(device="cpu")`.

The reference's verifier and estimator cases (`tests/unit/test_analysis.py`,
`tests/unit/test_estimator.py`) run against the port, and the port's LINT
and ESTIMATE rows are held against the reference's at plan time, on fresh
Contexts over the same frames: `bench.QUERY`, `bench.py`'s root select and
a GROUP BY whose two string keys overflow the radix gate.  The rows must be
equal, except for the ``recompile-hazard`` messages the port rewords
(`REWORDED`): the reference's name XLA recompiles, which the port does not
pay.  A lazy parquet table is never loaded by planning, LINT, ESTIMATE or a
streamed query.
"""
import re

import numpy as np
import pandas as pd
import pytest
import torch

import bench
import dask_sql_tpu
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.analysis import (
    RADIX_DOMAIN_LIMIT,
    check_plan,
    estimator,
    verify_plan,
)
from dask_sql_tpu_torch.analysis.estimator import Interval
from dask_sql_tpu_torch.columnar.dtypes import SqlType
from dask_sql_tpu_torch.columnar.encodings import encoded_nbytes
from dask_sql_tpu_torch.config import parse_byte_budget
from dask_sql_tpu_torch.datacontainer import LazyParquetContainer
from dask_sql_tpu_torch.planner import plan as p
from dask_sql_tpu_torch.planner.expressions import (
    ColumnRef,
    Field,
    InArrayExpr,
    Literal,
    ScalarFunc,
)
from dask_sql_tpu_torch.planner.parser import parse_sql
from dask_sql_tpu_torch.resilience import faults
from dask_sql_tpu_torch.resilience.errors import PlanError

SELECT_QUERY = ("SELECT l_returnflag, l_extendedprice * (1 - l_discount) AS rev "
                "FROM lineitem WHERE l_discount > 0.09 "
                "ORDER BY rev DESC LIMIT 100")
WIDE_QUERY = "SELECT k1, k2, SUM(v) AS s FROM big GROUP BY k1, k2"

#: the reference's recompile-hazard messages (XLA recompiles) and the
#: port's rewording of each (analysis/verifier.py): the only rows allowed
#: to differ
REWORDED = [
    (r"sampled row count changes across runs; every execution presents a "
     r"new shape to the compiled paths",
     "sampled row count changes across runs; the operators above run "
     "eagerly on each new shape, with no pipeline rebuilt for it"),
    (r"scan window (\d+) is not a power of two; each distinct window size "
     r"keys a fresh compile of the inner-limit kernel \(bucketing covers "
     r"only pow2 survivor counts\)",
     r"scan window \1 is not a power of two; each distinct window size keys "
     r"its own compiled-select pipeline, planned and trial-run on its first "
     r"query (survivor counts share pow2 buckets)"),
    (r"membership array of (\d+) value\(s\) is not a power of two; each "
     r"distinct length keys a fresh compile of the lookup kernel",
     r"membership array of \1 value(s) is not a power of two; the lookup "
     r"runs eagerly at any length, and each distinct array keys its own "
     r"compiled pipeline"),
]


#: stem materialization (the serving tier, materialize/) is off for the
#: EXPLAINs of both engines: an EXPLAIN observes its plan's scan stem, so a
#: stem seen twice would be pinned, that is run, and the pin would change
#: what the Context explains and runs next
REF_EXPLAIN = {"serving.materialize.enabled": False}


def reworded(rows):
    """The reference's EXPLAIN rows as the port words them."""
    out = []
    for row in rows:
        for pattern, port in REWORDED:
            row = re.sub(pattern, port, row)
        out.append(row)
    return out


_HI = re.compile(r"( bytes_hi=| scratch_hi=)(\d+|unbounded)")


def _his(row: str):
    """The row with its hi fields blanked, and those fields' values (a
    node line without ``scratch_hi`` has 0, ``unbounded`` is None)."""
    his = [None if v == "unbounded" else int(v) for _, v in _HI.findall(row)]
    if row.startswith("node ") and " scratch_hi=" not in row:
        his.append(0)
    return _HI.sub(r"\1", row), his


def assert_estimate_rows(got, want):
    """EXPLAIN ESTIMATE rows of the port against the reference's: every
    field equal but ``peak_bytes.hi``, which the port charges with its
    fused programs' temporaries (`analysis/fused.py`) on the nodes a
    compiled rung runs (an Aggregate, or the root select chain's root):
    there, and in the header's ``bytes_hi``, the port's hi is at least the
    reference's (a deliberate divergence, ROADMAP.md Queue 3)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        (g_row, g_his), (w_row, w_his) = _his(g), _his(w)
        assert g_row.replace(" scratch_hi=", "") == \
            w_row.replace(" scratch_hi=", ""), (g, w)
        for gh, wh in zip(g_his, w_his):
            if gh != wh:
                assert wh is not None and (gh is None or gh > wh), (g, w)
                assert g.startswith(("estimate:", "node Aggregate:")) or (
                    i == 2 and g.startswith("node ")), g


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are tiny: one thread runs them fastest on
    a machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_injector():
    faults.reset()
    yield
    faults.reset()


def _wide_frame() -> pd.DataFrame:
    """Two string group keys whose dictionary product (2501 * 2501 with the
    NULL sentinel) provably exceeds the 1 << 22 radix gate."""
    n = 5000
    return pd.DataFrame({
        "k1": [f"a{i % 2500}" for i in range(n)],
        "k2": [f"b{i % 2500}" for i in range(n)],
        "v": np.arange(n, dtype=np.float64),
    })


@pytest.fixture
def ctx():
    c = Context(device="cpu")
    c.create_table("t", pd.DataFrame({
        "a": np.array([1, 2, 3, 2], dtype=np.int64),
        "b": ["x", "y", "x", "z"],
        "v": [1.0, 2.0, 3.0, 4.0],
    }))
    return c


@pytest.fixture
def wide_ctx():
    c = Context(device="cpu")
    c.create_table("big", _wide_frame())
    return c


@pytest.fixture
def est_ctx():
    c = Context(device="cpu")
    c.create_table("t", pd.DataFrame({
        "a": np.arange(100, dtype=np.int64),
        "b": [f"k{i % 7}" for i in range(100)],
        "v": np.arange(100, dtype=np.float64),
    }))
    return c


def _lines(c, sql, **kw):
    out = c.sql(sql, **kw).compute()
    return list(out[out.columns[0]])


def _estimate(c, sql):
    plan = c._get_ral(parse_sql(sql)[0], sql_text=sql)
    return estimator.estimate_plan(plan, context=c)


def _table_nbytes(table) -> int:
    """Resident bytes of a Table, the rule of the reference's
    `serving/cache.py` `table_nbytes` (the port's Tables have no row mask)."""
    return sum(encoded_nbytes(col) for col in table.columns.values())


# ------------------------------------------------------- plan verifier
def test_verifier_clean_plan(ctx):
    assert any("ok: plan verified clean" in ln
               for ln in _lines(ctx, "EXPLAIN LINT SELECT 1 AS x"))


def test_explain_lint_reports_shape_buckets(ctx):
    text = "\n".join(_lines(ctx, "EXPLAIN LINT SELECT b, SUM(v) FROM t "
                                 "GROUP BY b"))
    assert "shape-bucket" in text and "bucket=4" in text
    assert "0 error(s), 0 warning(s)" in text


def test_explain_lint_native_binder_path(ctx):
    out = ctx.sql("EXPLAIN LINT SELECT b, SUM(v) FROM t GROUP BY b",
                  config_options={"sql.native.binder": "on"}).compute()
    assert list(out.columns) == ["LINT"]
    assert "summary:" in "\n".join(out["LINT"])
    assert ctx.metrics.counter("analysis.explain_lint") == 1


def test_dtype_mismatch_raises_plan_error(ctx):
    scan = p.TableScan("root", "t",
                       [Field("a", SqlType.BIGINT), Field("v", SqlType.DOUBLE)],
                       projection=["a", "v"])
    bad = p.Projection(scan, [ColumnRef(1, "v", SqlType.DOUBLE)],
                       [Field("v", SqlType.VARCHAR)])
    verdict = verify_plan(bad, context=ctx)
    assert any(f.rule == "dtype-mismatch" for f in verdict.errors)
    with pytest.raises(PlanError) as ei:
        check_plan(bad, context=ctx)
    assert ei.value.code == "PLAN_VERIFY_ERROR"
    assert ei.value.payload()["errorType"] == "INTERNAL_ERROR"


def test_column_out_of_range_and_unknown_op(ctx):
    scan = p.TableScan("root", "t", [Field("a", SqlType.BIGINT)],
                       projection=["a"])
    oob = p.Projection(scan, [ColumnRef(7, "zz", SqlType.BIGINT)],
                       [Field("zz", SqlType.BIGINT)])
    assert any(f.rule == "column-out-of-range"
               for f in verify_plan(oob, context=ctx).errors)
    ghost = p.Projection(
        scan,
        [ScalarFunc("no_such_kernel", (ColumnRef(0, "a", SqlType.BIGINT),),
                    SqlType.BIGINT)],
        [Field("x", SqlType.BIGINT)])
    assert any(f.rule == "unknown-op"
               for f in verify_plan(ghost, context=ctx).errors)


def test_known_ops_are_the_references():
    """The verifier's ``unknown-op`` table: the evaluator's core and its
    registry together hold every name of the reference's mapping."""
    from dask_sql_tpu.physical.rex.operations import OPERATION_MAPPING as ref
    from dask_sql_tpu_torch.analysis.verifier import _known_ops

    assert _known_ops() == frozenset(ref)


def _compared_names(tree, subject) -> set:
    """The string constants compared with `subject` (a name, or any
    ``.subject`` attribute) by ``==`` or ``in`` in an `ast` tree."""
    import ast

    def is_subject(n):
        return (isinstance(n, ast.Name) and n.id == subject) or (
            isinstance(n, ast.Attribute) and n.attr == subject)

    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare) and is_subject(node.left):
            for c in node.comparators:
                elts = c.elts if isinstance(c, (ast.Tuple, ast.Set,
                                                ast.List)) else [c]
                names |= {e.value for e in elts if isinstance(e, ast.Constant)
                          and isinstance(e.value, str)}
    return names


def test_core_ops_are_the_evaluators():
    """`CORE_OPS` is every name `compiled.py` evaluates itself, read off
    its source: the op names it compares, its op tables and the units of
    ``extract_*``.  An op added to the evaluator and not to `CORE_OPS`
    would be an ``unknown-op`` error at bind time."""
    import ast
    import inspect

    from dask_sql_tpu_torch.ops import datetime as dt_ops
    from dask_sql_tpu_torch.physical import compiled
    from dask_sql_tpu_torch.physical.rex.operations import (
        CORE_OPS,
        OPERATION_MAPPING,
    )

    evaluated = _compared_names(ast.parse(inspect.getsource(compiled)), "op")
    for table in (compiled._MATH_UNARY, compiled._NUMERIC_BINOPS,
                  compiled._STRING_MAPS):
        evaluated |= set(table)
    units = _compared_names(ast.parse(inspect.getsource(dt_ops.extract)),
                            "unit")
    evaluated |= {f"extract_{u}" for u in units}
    assert evaluated - set(OPERATION_MAPPING) == CORE_OPS


def test_explain_lint_radix_overflow(wide_ctx):
    text = "\n".join(_lines(wide_ctx, "EXPLAIN LINT " + WIDE_QUERY))
    assert "radix-overflow" in text
    assert "compiled_aggregate" in text
    assert str(RADIX_DOMAIN_LIMIT) not in text  # the message says 1<<22


def test_radix_overflow_skips_rungs_and_still_answers(wide_ctx):
    out = wide_ctx.sql(WIDE_QUERY).compute()
    assert len(out) == 2500
    m = wide_ctx.metrics
    assert m.counter("analysis.rung_skip.compiled_aggregate") == 1
    assert m.counter("analysis.findings.radix-overflow") == 1
    assert m.counter("resilience.degraded") == 0  # skipped, not attempted


def test_radix_overflow_raises_at_bind_time_under_strict(wide_ctx):
    with pytest.raises(PlanError):
        wide_ctx.sql(WIDE_QUERY, config_options={"analysis.verify": "strict"})
    out = wide_ctx.sql(WIDE_QUERY,
                       config_options={"analysis.verify": "off"}).compute()
    assert len(out) == 2500


def test_explain_lint_recompile_hazard_limit(ctx):
    text = "\n".join(_lines(ctx, "EXPLAIN LINT SELECT a FROM t ORDER BY a "
                                 "LIMIT 1000"))
    assert "recompile-hazard" in text and "1000" in text
    assert "recompile-hazard" not in "\n".join(
        _lines(ctx, "EXPLAIN LINT SELECT a FROM t ORDER BY a LIMIT 1024"))


def test_in_array_hazard_direct():
    scan = p.TableScan("root", "t", [Field("a", SqlType.BIGINT)],
                       projection=["a"])
    pred = InArrayExpr(ColumnRef(0, "a", SqlType.BIGINT),
                       np.array([1, 2, 3], dtype=np.int64))
    filt = p.Filter(scan, pred, scan.schema)
    assert any(f.rule == "recompile-hazard"
               for f in verify_plan(filt).findings)


def test_explain_plain_still_works(ctx):
    assert "TableScan" in "\n".join(_lines(ctx, "EXPLAIN SELECT a FROM t"))


def test_setop_arity_error():
    one = p.Values([[Literal(1, SqlType.BIGINT)]],
                   [Field("x", SqlType.BIGINT)])
    two = p.Values([[Literal(1, SqlType.BIGINT), Literal(2, SqlType.BIGINT)]],
                   [Field("x", SqlType.BIGINT), Field("y", SqlType.BIGINT)])
    bad = p.Union([one, two], all=True, schema=[Field("x", SqlType.BIGINT)])
    assert any(f.rule == "schema-arity" for f in verify_plan(bad).errors)


# ------------------------------------------------------------ estimator
def test_interval_arithmetic_saturates_unbounded():
    a = Interval(2, 10)
    b = Interval(3, None)
    assert (a + b) == Interval(5, None)
    assert (a * b) == Interval(6, None)
    assert (a + Interval(1, 1)) == Interval(3, 11)
    assert a.clamp_hi(4) == Interval(2, 4)
    assert Interval(100, 100).clamp_hi(10) == Interval(10, 10)
    assert b.clamp_hi(7) == Interval(3, 7)
    assert a.drop_lo() == Interval(0, 10)
    assert Interval.exact(5).fmt() == "[5, 5]"
    assert b.fmt() == "[3, unbounded]"


@pytest.mark.parametrize("sql, rows", [
    ("SELECT * FROM t", Interval(100, 100)),
    ("SELECT a FROM t WHERE v > 50", Interval(0, 100)),
    ("SELECT a FROM t LIMIT 7", Interval(7, 7)),
    ("SELECT a FROM t WHERE v > 50 LIMIT 7", Interval(0, 7)),
    ("SELECT t1.a FROM t t1, t t2", Interval(100 * 100, 100 * 100)),
    ("SELECT t1.a FROM t t1 JOIN t t2 ON t1.a = t2.a", Interval(0, 100 * 100)),
    # b has 7 values: a dictionary of 7, +1 NULL sentinel
    ("SELECT b, SUM(v) FROM t GROUP BY b", Interval(1, 8)),
    ("SELECT SUM(v) FROM t", Interval(1, 1)),
    ("SELECT a FROM t UNION ALL SELECT a FROM t", Interval(200, 200)),
    ("SELECT a FROM t UNION SELECT a FROM t", Interval(1, 200)),
    ("SELECT * FROM (VALUES (1), (2), (3)) AS w(x)", Interval(3, 3)),
], ids=["scan", "filter", "limit", "filter_limit", "cross", "inner",
        "aggregate_domain", "global_aggregate", "union_all", "union",
        "values"])
def test_row_intervals(est_ctx, sql, rows):
    est = _estimate(est_ctx, sql)
    assert est.rows == rows
    assert est.result_bytes.lo >= 0 and est.result_bytes.hi is not None


def test_outer_join_bound_survives_empty_side():
    c = Context(device="cpu")
    c.create_table("l", pd.DataFrame({"k": np.array([1, 2, 3],
                                                    dtype=np.int64)}))
    c.create_table("r", pd.DataFrame({"k": pd.Series([], dtype="int64"),
                                      "w": pd.Series([], dtype="float64")}))
    for jt, lo, hi in [("LEFT", 3, 3), ("RIGHT", 0, 0), ("FULL", 3, 3)]:
        sql = f"SELECT l.k FROM l {jt} JOIN r ON l.k = r.k"
        est = _estimate(c, sql)
        actual = len(c.sql(sql).compute())
        assert (est.rows.lo, est.rows.hi) == (lo, hi), jt
        assert est.rows.lo <= actual <= est.rows.hi, jt


def test_global_aggregate_scratch_not_charged_the_radix_gate(est_ctx):
    est = _estimate(est_ctx, "SELECT SUM(v) FROM t")
    assert est.peak_bytes.hi is not None and est.peak_bytes.hi < 1 << 20


def test_direct_node_construction_sort_fetch():
    scan = p.TableScan("root", "t", [Field("a", SqlType.BIGINT)],
                       projection=["a"])
    srt = p.Sort(scan, [], [Field("a", SqlType.BIGINT)], fetch=5)
    assert estimator.estimate_plan(srt).rows.hi == 5


def test_unknown_scan_is_unbounded():
    scan = p.TableScan("root", "missing", [Field("a", SqlType.BIGINT)],
                       projection=["a"])
    est = estimator.estimate_plan(scan)
    assert est.rows == Interval(0, None)
    assert est.peak_bytes.hi is None


def test_lower_bound_never_charges_validity_masks(est_ctx):
    est = _estimate(est_ctx, "SELECT * FROM t")
    actual = _table_nbytes(est_ctx.schema["root"].tables["t"].table)
    assert est.peak_bytes.lo <= actual <= est.peak_bytes.hi


def test_explain_analyze_estimate_is_bounded(est_ctx):
    sql = "EXPLAIN ANALYZE SELECT b, SUM(v) FROM t GROUP BY b"
    plan = est_ctx._get_ral(parse_sql(sql)[0], sql_text=sql)
    est = getattr(plan, "_dsql_estimate", None)
    assert est is not None
    assert est.rows.hi is not None and est.peak_bytes.hi is not None
    # and it answers: the traced tree's Aggregate shows the groups
    rows = est_ctx.sql(sql).compute()["PLAN"].tolist()
    groups = est_ctx.sql("SELECT DISTINCT b FROM t").compute()
    assert any(r.lstrip().startswith("Aggregate: ")
               and r.endswith(f" {len(groups)} rows]") for r in rows), rows


def test_peak_lower_bound_counts_resident_scans(est_ctx):
    est = _estimate(est_ctx, "SELECT a FROM t WHERE v > 1e9")
    assert est.peak_bytes.lo >= 100 * 16
    assert est.peak_bytes.hi >= est.peak_bytes.lo


def test_explain_estimate_shape(est_ctx):
    out = est_ctx.sql("EXPLAIN ESTIMATE SELECT b, SUM(v) FROM t "
                      "GROUP BY b").compute()
    assert list(out.columns) == ["ESTIMATE"]
    head = out["ESTIMATE"][0]
    assert head.startswith("estimate: rows_lo=")
    for token in ("rows_lo=", "rows_hi=", "bytes_lo=", "bytes_hi="):
        assert token in head
    text = "\n".join(out["ESTIMATE"])
    assert "result: bytes=" in text and "node " in text
    assert est_ctx.metrics.counter("analysis.explain_estimate") == 1


def test_explain_estimate_native_python_parity(est_ctx):
    sql = "EXPLAIN ESTIMATE SELECT b, SUM(v) FROM t GROUP BY b"
    native = est_ctx.sql(sql, config_options={
        "sql.native.binder": "on"}).compute()
    python = est_ctx.sql(sql, config_options={
        "sql.native.binder": "off"}).compute()
    assert native["ESTIMATE"][0] == python["ESTIMATE"][0]


def test_explain_estimate_never_executes(est_ctx):
    """Running the input would reach the armed ``oom`` site."""
    opts = {"resilience.inject": "oom:always"}
    out = est_ctx.sql("EXPLAIN ESTIMATE SELECT b, SUM(v) FROM t GROUP BY b",
                      config_options=opts).compute()
    with est_ctx.config.set(opts):
        inj = faults.get_injector(est_ctx.config)
    assert inj is not None and inj.fired("oom") == 0
    assert out["ESTIMATE"][0].startswith("estimate:")


def test_explain_estimate_reports_under_an_admission_budget(est_ctx):
    """EXPLAIN ESTIMATE answers under ``max_estimated_bytes``; a query that
    runs is shed by the admission gate, its provable floor over the
    budget."""
    from dask_sql_tpu_torch.serving import EstimatedBytesExceededError

    opts = {"serving.admission.max_estimated_bytes": 1}
    out = est_ctx.sql("EXPLAIN ESTIMATE SELECT t1.a FROM t t1, t t2",
                      config_options=opts).compute()
    assert out["ESTIMATE"][0].startswith("estimate:")
    with pytest.raises(EstimatedBytesExceededError) as ei:
        est_ctx.sql("SELECT a FROM t", config_options=opts).compute()
    assert ei.value.budget_bytes == 1 and ei.value.estimated_bytes_lo > 1


def test_gate_disabled_by_default(est_ctx):
    assert len(est_ctx.sql("SELECT t1.a FROM t t1, t t2 LIMIT 5").compute()) == 5


def test_budget_string_zero_means_disabled(est_ctx):
    for off in (None, "", 0, "0", " 0 ", "none", "OFF", "false", -1):
        assert parse_byte_budget(off) is None, off
    assert parse_byte_budget("1024") == 1024
    assert parse_byte_budget(1 << 20) == 1 << 20
    assert parse_byte_budget("64MB") == 64 << 20
    assert parse_byte_budget("2 GiB") == 2 << 30
    assert parse_byte_budget("sixty-four") is None
    for bad in ("0", "sixty-four"):
        out = est_ctx.sql("SELECT a FROM t LIMIT 3", config_options={
            "serving.admission.max_estimated_bytes": bad}).compute()
        assert len(out) == 3


def test_rung_proof_preskips_compiled_aggregate(est_ctx):
    out = est_ctx.sql("SELECT b, SUM(v) AS s FROM t GROUP BY b",
                      config_options={
                          "analysis.estimate.device_budget_bytes": 16}
                      ).compute()
    assert len(out) == 7
    m = est_ctx.metrics
    assert m.counter("analysis.estimate.rung_proof") == 1
    assert m.counter("analysis.rung_skip.compiled_aggregate") == 1
    assert m.counter("resilience.degraded") == 0


def test_explain_estimate_renders_rung_proof(est_ctx):
    text = "\n".join(_lines(
        est_ctx, "EXPLAIN ESTIMATE SELECT b, SUM(v) FROM t GROUP BY b",
        config_options={"analysis.estimate.device_budget_bytes": 16}))
    assert "rungs pre-skipped" in text and "compiled_aggregate" in text


def test_rung_proof_absent_with_roomy_budget(est_ctx):
    est_ctx.sql("SELECT b, SUM(v) AS s FROM t GROUP BY b", config_options={
        "analysis.estimate.device_budget_bytes": 1 << 34}).compute()
    assert est_ctx.metrics.counter("analysis.estimate.rung_proof") == 0
    assert est_ctx.metrics.counter("resilience.rung.compiled_aggregate") == 1


def test_family_members_share_an_estimate():
    c = Context(device="cpu")
    c.create_table("lineitem", bench.gen_lineitem(2_000, seed=0))
    c.sql(bench.QUERY).compute()
    c.sql(bench.QUERY.replace("1998-09-02", "1998-08-01")).compute()
    assert c.metrics.counter("analysis.estimate.runs") == 1
    assert c.metrics.counter("families.estimate.hit") == 1


def test_upper_bound_dominates_actual_q1_shape():
    """Resident inputs and the materialized result coexist at the end of
    Q1: the estimate's lower bound stays below them, its model bound
    ``hi`` above."""
    c = Context(device="cpu")
    c.create_table("lineitem", bench.gen_lineitem(50_000, seed=0))
    plan = c._get_ral(parse_sql(bench.QUERY)[0], sql_text=bench.QUERY)
    est = estimator.estimate_plan(plan, context=c)
    frame = c.sql(bench.QUERY)
    result = frame.compute()
    measured = sum(_table_nbytes(dc.table)
                   for dc in c.schema["root"].tables.values())
    measured += _table_nbytes(frame.execute())
    assert len(result) > 0
    assert est.peak_bytes.lo <= measured <= est.peak_bytes.hi
    assert est.rows.lo <= len(result) <= est.rows.hi


# ------------------------------------------- the reference, plan time only
@pytest.fixture(scope="module")
def both():
    """Fresh reference and port Contexts over the same frames; only EXPLAIN
    runs on them, so no plan of theirs executes."""
    frames = {"lineitem": bench.gen_lineitem(20_000, seed=0),
              "big": _wide_frame()}
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    for name, frame in frames.items():
        rc.create_table(name, frame)
        pc.create_table(name, frame)
    return rc, pc


@pytest.mark.parametrize("kind", ["LINT", "ESTIMATE"])
@pytest.mark.parametrize("sql", [bench.QUERY, SELECT_QUERY, WIDE_QUERY],
                         ids=["q1", "select", "radix_overflow"])
def test_explain_rows_match_reference(both, kind, sql):
    rc, pc = both
    want = rc.sql(f"EXPLAIN {kind} {sql}", return_futures=False,
                  config_options=REF_EXPLAIN)
    got = pc.sql(f"EXPLAIN {kind} {sql}",
                 config_options=REF_EXPLAIN).compute()
    assert list(got.columns) == list(want.columns) == [kind]
    if kind == "ESTIMATE":
        assert_estimate_rows(list(got[kind]), list(want[kind]))
    else:
        assert list(got[kind]) == reworded(list(want[kind]))


def test_q1_rows_are_the_references_numbers(both):
    """The rows the reference gives for Q1 at 20,000 rows, as recorded, but
    for ``bytes_hi``: the reference's 638149 plus the port's fused
    aggregate at its peak over the 20,000 rows (`analysis/fused.py`) in
    place of the reference's gid and matrix."""
    _, pc = both
    lint = _lines(pc, "EXPLAIN LINT " + bench.QUERY)
    assert "l_quantity=DICT(50)" in lint[0] and "l_shipdate=DICT(2526)" in \
        lint[0] and "encoded=500453B decoded=640045B" in lint[0]
    assert lint[1].endswith("rows=20000 bucket=32768")
    est = _lines(pc, "EXPLAIN ESTIMATE " + bench.QUERY)
    assert est[0] == ("estimate: rows_lo=0 rows_hi=12 bytes_lo=500453 "
                      "bytes_hi=1649477")
    assert est[1] == "result: bytes=[0, 1152] (d2h transfer)"


# ----------------------------------------------------------- lazy tables
def test_lazy_table_is_never_loaded(tmp_path, monkeypatch):
    """Planning (the verifier and the estimator), EXPLAIN LINT, EXPLAIN
    ESTIMATE and a streamed query all run without loading the location:
    its row count comes from the footers, its string keys' radix is
    unknown."""
    frame = pd.DataFrame({"g": [f"g{i % 4}" for i in range(6000)],
                          "v": np.arange(6000, dtype=np.float64)})
    path = tmp_path / "t.parquet"
    frame.to_parquet(path, row_group_size=2000)
    c = Context(device="cpu")
    c.create_table("lazy", str(path))
    dc = c.schema["root"].tables["lazy"]
    assert isinstance(dc, LazyParquetContainer)
    monkeypatch.setattr(LazyParquetContainer, "table", property(
        lambda self: pytest.fail("the lazy table was loaded")))
    sql = "SELECT g, SUM(v) AS s, COUNT(*) AS n FROM lazy GROUP BY g"
    lint = _lines(c, "EXPLAIN LINT " + sql)
    assert any(ln.endswith("rows=6000 bucket=8192") for ln in lint), lint
    est = _lines(c, "EXPLAIN ESTIMATE " + sql)
    assert est[0].startswith("estimate: rows_lo=1 rows_hi=6000 ")
    got = c.sql(sql, config_options={"sql.streaming.batch_rows": 2000}
                ).compute().sort_values("g")
    assert list(got["n"]) == [1500] * 4
    np.testing.assert_allclose(
        got["s"], frame.groupby("g")["v"].sum().sort_index().to_numpy())
    assert c.metrics.counter("analysis.verify.runs") == 1
    assert c.metrics.counter("analysis.estimate.runs") == 1
    assert dc._table is None
