"""Plan families in the port: literals lift into runtime parameters, and
the compiled pipelines key their caches on the parameterized expressions.

Q1 with three date literals is one family: the port counts the reference's
``families.parameterized`` and ``families.hit``, answers as it does
(floats within MATMUL_FLOAT_REL_ERR_BOUND of the reference's float64-carry
``matmul`` segment sum), and makes one device-to-host transfer a query.
IN lists of lengths in one power-of-two bucket share a pipeline, and a
ninth item starts a new one.  A parameter's code-space compare on a DICT
column selects the rows its value-space compare selects, and the rows the
same literal baked in selects, at float32 members such as 10.1f too.
"""
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import dask_sql_tpu
from chip_smoke import QUERY, gen_lineitem
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.columnar.column import Column
from dask_sql_tpu_torch.columnar.dtypes import SqlType, sql_to_np
from dask_sql_tpu_torch.columnar.encodings import Encoding
from dask_sql_tpu_torch.columnar.table import Table
from dask_sql_tpu_torch.families import pow2_bucket
from dask_sql_tpu_torch.ops.segsum import MATMUL_FLOAT_REL_ERR_BOUND
from dask_sql_tpu_torch.physical import compiled
from dask_sql_tpu_torch.planner.expressions import (
    ColumnRef,
    Literal,
    ParamRef,
    ScalarFunc,
)
from dask_sql_tpu_torch.utils import TRANSFER_STATS

REF_OPTIONS = {"sql.compile.segsum": "matmul"}
DATES = ("1998-08-01", "1997-06-30", "1995-03-15")
IN_SQL = ("SELECT l_returnflag, COUNT(*) AS n, SUM(l_extendedprice) AS s "
          "FROM lineitem WHERE l_quantity IN ({}) "
          "GROUP BY l_returnflag ORDER BY l_returnflag")
#: item counts 5 and 7 share the bucket of 8; 9 starts the bucket of 16
IN_LISTS = ((1, 2, 3, 4, 5), (6, 7, 8, 9, 10, 11, 12), tuple(range(20, 29)))


def _families(counters):
    return {k: counters.get(k, 0)
            for k in ("families.parameterized", "families.hit")}


def _same(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for name in want.columns:
        g, w = got[name], want[name]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64),
                                       rtol=MATMUL_FLOAT_REL_ERR_BOUND)
        else:
            assert g.tolist() == w.tolist(), name


@pytest.fixture(scope="module")
def contexts():
    df = gen_lineitem(20_000)
    rc = dask_sql_tpu.Context()
    pc = Context(device="cpu")
    rc.create_table("lineitem", df)
    pc.create_table("lineitem", df)
    return rc, pc


def _pipelines(pc) -> int:
    """The fused pipelines cached for `pc`: the caches are shared by every
    Context and evict a collected Context's entries at any time."""
    owner = compiled.pipeline_owner(pc)
    return sum(1 for key in compiled._cache if key[0] == owner)


def _run(contexts, sqls):
    """Each SQL through both contexts; returns the families counters each
    moved, and the port's pipelines built."""
    rc, pc = contexts
    ref_before = dict(rc.metrics.snapshot()["counters"])
    before = pc.metrics.snapshot()["counters"]
    cached = _pipelines(pc)
    for sql in sqls:
        TRANSFER_STATS["d2h"] = 0
        got = pc.sql(sql).compute()
        assert TRANSFER_STATS["d2h"] == 1
        _same(got, rc.sql(sql, config_options=REF_OPTIONS).compute())
    ref_after = dict(rc.metrics.snapshot()["counters"])
    ref = {k: v - _families(ref_before)[k]
           for k, v in _families(ref_after).items()}
    port = {k: v - _families(before)[k]
            for k, v in _families(pc.metrics.snapshot()["counters"]).items()}
    return port, ref, _pipelines(pc) - cached


def test_q1_dates_share_one_pipeline(contexts):
    sqls = [QUERY.replace("DATE '1998-09-02'", f"DATE '{d}'") for d in DATES]
    port, ref, built = _run(contexts, sqls)
    assert port == ref == {"families.parameterized": 3, "families.hit": 2}
    assert built == 1


def test_in_lists_share_a_pipeline_per_bucket(contexts):
    assert [pow2_bucket(len(x)) for x in IN_LISTS] == [8, 8, 16]
    sqls = [IN_SQL.format(", ".join(map(str, items))) for items in IN_LISTS]
    port, ref, built = _run(contexts, sqls)
    assert port == ref == {"families.parameterized": 3, "families.hit": 1}
    assert built == 2


def test_families_off_keys_on_literals(contexts):
    _, pc = contexts
    pc.config.update({"families.enabled": False})
    try:
        before = pc.metrics.snapshot()["counters"]
        cached = _pipelines(pc)
        for d in ("1996-01-01", "1996-01-02"):
            pc.sql(QUERY.replace("DATE '1998-09-02'", f"DATE '{d}'")).compute()
        assert _families(pc.metrics.snapshot()["counters"]) == \
            _families(before)
        assert _pipelines(pc) - cached == 2
    finally:
        pc.config.update({"families.enabled": True})


@pytest.mark.parametrize("literal", ["10.1", "CAST(10.1 AS FLOAT)", "0.3",
                                     "7", "-1", "1000000000"])
@pytest.mark.parametrize("op", ["<", "<=", "=", "<>", ">", ">="])
def test_parameter_compare_on_a_float32_dict_column(op, literal):
    """One float32 DICT column holding 10.1f and 0.3f: the fused aggregate
    with the literal as a parameter (code space), with it baked in (families
    off) and over the PLAIN column (value space) count the same rows."""
    rng = np.random.RandomState(5)
    members = np.array([0.3, 1.5, 7.0, 10.1, 12.25, 40.0], dtype=np.float32)
    frame = {"x": members[rng.randint(0, len(members), 4096)]}
    sql = f"SELECT COUNT(*) AS n FROM t WHERE x {op} {literal}"
    counts = []
    for options in ({}, {"families.enabled": False},
                    {"columnar.encoding": "off"}):
        c = Context(device="cpu")
        c.config.update(options)
        c.create_table("t", pd.DataFrame(frame))
        encoded = c.schema["root"].tables["t"].table.columns["x"].encoding
        assert encoded is (Encoding.PLAIN if options.get("columnar.encoding")
                           else Encoding.DICT)
        counts.append(int(c.sql(sql).compute()["n"][0]))
        assert c.metrics.counter("resilience.rung.compiled_aggregate") == 1
        if not options:
            assert c.metrics.counter("families.parameterized") == 1
            assert c.metrics.counter("columnar.encoding.codespace_pred") == 1
    assert counts[0] == counts[1] == counts[2]


_VALUES = {
    "int": (np.arange(0, 600, 3, dtype=np.int64), SqlType.BIGINT),
    "float": (np.linspace(0.1, 50.1, 120).astype(np.float32), SqlType.FLOAT),
}


def _dict_table(kind):
    values, sql_type = _VALUES[kind]
    rng = np.random.RandomState(8)
    col = Column.from_numpy(values[rng.randint(0, len(values), 2048)],
                            rng.rand(2048) > 0.05, encode=True)
    assert col.encoding is Encoding.DICT
    return Table({"x": col}, 2048), values, sql_type


_TABLES = {kind: _dict_table(kind) for kind in _VALUES}


@settings(max_examples=120, deadline=None, derandomize=True)
@given(kind=st.sampled_from(sorted(_VALUES)),
       op=st.sampled_from(("eq", "ne", "lt", "le", "gt", "ge")),
       flipped=st.booleans(), pick=st.integers(0, 10**6),
       where=st.sampled_from(["member", "between", "below", "above"]),
       wide=st.booleans())
def test_parameter_codespace_equals_literal_and_value_space(
        kind, op, flipped, pick, where, wide):
    """``wide``: the parameter typed DOUBLE against the FLOAT column."""
    table, values, sql_type = _TABLES[kind]
    if where == "member":
        lit = values[pick % len(values)]
    elif where == "between":
        i = pick % (len(values) - 1)
        lit = values[i] + (values[i + 1] - values[i]) / 2
    elif where == "below":
        lit = values[0] - 1 - pick % 5
    else:
        lit = values[-1] + 1 + pick % 5
    lit = float(lit) if sql_type == SqlType.FLOAT else lit.item()
    lit_type = SqlType.DOUBLE if wide and sql_type == SqlType.FLOAT else sql_type
    ref = ColumnRef(0, "x", sql_type, True)

    def call(operand):
        return ScalarFunc(op, (operand, ref) if flipped else (ref, operand),
                          SqlType.BOOLEAN)

    param = np.asarray(lit, dtype=sql_to_np(lit_type))
    expr = call(ParamRef(0, lit_type))
    assert compiled.count_codespace_predicates([expr], table) == 1
    col = table.columns["x"]
    slots = {0: (col.data, col.validity), compiled.PARAMS_SLOT: (param,)}
    got = compiled._TraceEval(table)._call(expr, slots)
    baked = compiled._TraceEval(table)._call(
        call(Literal(lit, lit_type)), {0: (col.data, col.validity)})
    plain = table.decode()
    pcol = plain.columns["x"]
    want = compiled._TraceEval(plain)._call(
        expr, {0: (pcol.data, pcol.validity), compiled.PARAMS_SLOT: (param,)})
    valid = pcol.validity
    for other in (baked, want):
        assert torch.equal(got[1], other[1])
        assert torch.equal(got[0].expand(2048) & valid,
                           other[0].expand(2048) & valid)


@pytest.mark.parametrize("sql_type,value", [(SqlType.FLOAT, 10.1),
                                            (SqlType.BIGINT, 7),
                                            (SqlType.DATE, 820454400000000000),
                                            (SqlType.BOOLEAN, True)])
def test_parameter_evaluates_as_its_literal(sql_type, value):
    """A parameter is the 0-dim tensor its literal would be: same dtype,
    same value, no shape of its own."""
    table, _, _ = _TABLES["int"]
    ev = compiled._TraceEval(table)
    param = np.asarray(value, dtype=sql_to_np(sql_type))
    got, got_valid = ev.eval(ParamRef(0, sql_type),
                             {compiled.PARAMS_SLOT: (param,)})
    want, want_valid = ev.eval(Literal(value, sql_type), {})
    assert got.dim() == want.dim() == 0
    assert got.dtype == want.dtype and got.item() == want.item()
    assert got_valid is want_valid is None
