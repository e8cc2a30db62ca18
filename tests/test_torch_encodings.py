"""The port's load-time column encodings (dask_sql_tpu_torch/columnar/
encodings.py) against the reference's, on the CPU.

Each frame goes through both sides' ``Table.from_pandas(df, encode=True)``:
every column's encoding, code dtype, codes, dictionary values and affine
must be equal.  The operations on encoded columns (decode, host decode,
take, filter, slice, casts, concatenation, the packed transfer) must give
what the same operations give on PLAIN columns, exactly.  A comparison of
a DICT column with a literal runs on the codes; a hypothesis test holds it
against the same comparison in value space.  Run-length-encoded columns
make the row-positional pipelines decline, and the answer still equals the
reference's.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import dask_sql_tpu
from bench import gen_lineitem
from dask_sql_tpu.columnar.table import Table as RefTable
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.columnar.column import Column
from dask_sql_tpu_torch.columnar.concat import concat_columns
from dask_sql_tpu_torch.columnar.dtypes import SqlType
from dask_sql_tpu_torch.columnar.encodings import Encoding
from dask_sql_tpu_torch.columnar.table import Table
from dask_sql_tpu_torch.physical import compiled
from dask_sql_tpu_torch.planner.expressions import ColumnRef, Literal, ScalarFunc
from tests.tpch import generate


@pytest.fixture(scope="module")
def frames():
    tables = generate(20_000, seed=7)
    tables["bench_lineitem"] = gen_lineitem(20_000)
    return tables


@pytest.mark.parametrize("name", ["bench_lineitem", "lineitem", "orders",
                                  "customer", "part", "partsupp"])
def test_encodings_match_reference(frames, name):
    df = frames[name]
    ref = RefTable.from_pandas(df, encode=True)
    got = Table.from_pandas(df, encode=True)
    assert got.column_names == ref.column_names
    for n in got.column_names:
        g, r = got.columns[n], ref.columns[n]
        assert g.encoding.value == r.encoding.value, n
        assert g.data.numpy().dtype == np.dtype(r.data.dtype), n
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(r.data),
                                      err_msg=n)
        if r.enc_values is None:
            assert g.enc_values is None, n
        else:
            assert g.enc_values.dtype == r.enc_values.dtype, n
            np.testing.assert_array_equal(g.enc_values, r.enc_values, err_msg=n)
        assert (g.enc_ref, g.enc_scale, g.enc_rows) == \
            (r.enc_ref, r.enc_scale, r.enc_rows), n
        if r.enc_lengths is not None:
            np.testing.assert_array_equal(g.enc_lengths.numpy(),
                                          np.asarray(r.enc_lengths))
        assert (g.validity is None) == (r.validity is None), n
        assert len(g) == len(r)
        # the host decode of the codes gives the PLAIN column's values
        np.testing.assert_array_equal(g.to_numpy(), r.to_numpy(), err_msg=n)


def test_arrow_and_dict_inputs_load_as_the_reference(frames):
    """The Arrow and dict input plugins: the same columns, encodings and
    values as the reference's ingest of the same inputs, and the Arrow
    round trip gives the frame back."""
    import pyarrow as pa

    at = pa.Table.from_pandas(frames["orders"], preserve_index=False)
    cols = {"a": np.arange(3000) % 7, "b": np.linspace(0, 1, 3000)}
    c, rc = Context(device="cpu"), dask_sql_tpu.Context()
    for ctx in (c, rc):
        ctx.create_table("orders", at)
        ctx.create_table("d", cols)
    for name in ("orders", "d"):
        got = c.schema["root"].tables[name].table
        ref = rc.schema["root"].tables[name].table
        assert got.column_names == ref.column_names
        for n in got.column_names:
            g, r = got.columns[n], ref.columns[n]
            assert (g.encoding.value, g.sql_type.value) == \
                (r.encoding.value, r.sql_type.value), n
            np.testing.assert_array_equal(g.to_numpy(), r.to_numpy(), err_msg=n)
    back = c.schema["root"].tables["orders"].table.to_arrow().to_pandas()
    for n in back.columns:
        np.testing.assert_array_equal(back[n].to_numpy(),
                                      frames["orders"][n].to_numpy(), err_msg=n)


def test_encoding_off_and_outside_a_registration_stay_plain(frames):
    df = frames["bench_lineitem"]
    c = Context(device="cpu")
    c.config.update({"columnar.encoding": "off"})
    c.create_table("lineitem", df)
    table = c.schema["root"].tables["lineitem"].table
    assert not table.has_encoded_columns()
    assert "columnar.encoding.encoded_columns" not in c.metrics
    assert not Table.from_pandas(df).has_encoded_columns()
    c.config.update({"columnar.encoding": "auto"})
    c.create_table("lineitem", df)
    encoded = [n for n, col in c.schema["root"].tables["lineitem"].table
               .columns.items() if col.encoding is not Encoding.PLAIN]
    assert encoded == ["l_quantity", "l_shipdate"]
    assert c.metrics["columnar.encoding.encoded_columns"] == 2
    enc_b, dec_b = (c.metrics.observed[f"columnar.encoding.{k}_bytes"][-1]
                    for k in ("encoded", "decoded"))
    assert enc_b < dec_b


def _columns():
    """(encoding, host values, validity) cases, 4096 rows each."""
    rng = np.random.RandomState(21)
    n = 4096
    nulls = rng.rand(n) > 0.1
    days = np.datetime64("1995-01-01") + rng.randint(0, 300, n).astype(
        "timedelta64[D]")
    return {
        "dict_float32": (Encoding.DICT, rng.randint(1, 51, n).astype(np.float32),
                         None),
        "dict_float64_nulls": (Encoding.DICT, rng.choice([0.5, 1.25, 7.0], n),
                               nulls),
        "dict_datetime": (Encoding.DICT, days.astype("datetime64[ns]"), None),
        "for_int64_nulls": (Encoding.FOR, rng.randint(10**9, 10**9 + 90_000, n)
                            .astype(np.int64) * 3, nulls),
        "rle_int64_nulls": (Encoding.RLE, np.repeat(np.arange(8, dtype=np.int64),
                                                    n // 8),
                            np.repeat(np.arange(8) != 3, n // 8)),
    }


@pytest.mark.parametrize("case", sorted(_columns()))
def test_encoded_column_operations_equal_plain(case):
    encoding, values, valid = _columns()[case]
    enc = Column.from_numpy(values, valid, encode=True)
    plain = Column.from_numpy(values, valid, encode=False)
    assert enc.encoding is encoding and plain.encoding is Encoding.PLAIN
    assert len(enc) == len(plain)

    def same(a: Column, b: Column):
        assert a.sql_type == b.sql_type
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())

    dec = enc.decode()
    assert dec.encoding is Encoding.PLAIN
    assert torch.equal(dec.data[plain.valid_mask()],
                       plain.data[plain.valid_mask()])
    assert torch.equal(enc.valid_mask(), plain.valid_mask())
    same(enc, plain)
    rng = np.random.RandomState(3)
    idx = torch.from_numpy(rng.randint(0, len(plain), 500))
    same(enc.take(idx), plain.take(idx))
    mask = torch.from_numpy(rng.rand(len(plain)) > 0.5)
    same(enc.filter(mask), plain.filter(mask))
    same(enc.slice(100, 1100), plain.slice(100, 1100))
    if encoding is not Encoding.RLE:
        # codes gather like values: the encoding survives
        assert enc.take(idx).encoding is encoding
    targets = [SqlType.DOUBLE, SqlType.VARCHAR]
    if plain.sql_type != SqlType.TIMESTAMP:
        targets.append(SqlType.BIGINT)
    for target in targets:
        same(enc.cast(target), plain.cast(target))
    same(concat_columns([enc, plain.slice(0, 10), enc.slice(5, 50)]),
         concat_columns([plain, plain.slice(0, 10), plain.slice(5, 50)]))
    # one packed transfer of codes and masks, decoded on the host
    table = Table({"x": enc, "y": plain}, len(plain))
    host = table._host_columns(packed=True)
    np.testing.assert_array_equal(host["x"], plain.to_numpy())
    np.testing.assert_array_equal(host["y"], plain.to_numpy())


_OPS = ("eq", "ne", "lt", "le", "gt", "ge")
_DICTS = {
    "int": (np.arange(0, 600, 3, dtype=np.int64), SqlType.BIGINT),
    "float": (np.linspace(0.1, 50.1, 120).astype(np.float32), SqlType.FLOAT),
    "date": ((np.datetime64("1995-01-01", "ns")
              + np.arange(0, 400, 2).astype("timedelta64[D]")).view(np.int64),
             SqlType.TIMESTAMP),
}


def _dict_table(kind):
    values, sql_type = _DICTS[kind]
    rng = np.random.RandomState(8)
    codes = rng.randint(0, len(values), 2048)
    valid = rng.rand(2048) > 0.05
    data = values[codes]
    if sql_type == SqlType.TIMESTAMP:
        data = data.view("datetime64[ns]")
    col = Column.from_numpy(data, valid, encode=True)
    assert col.encoding is Encoding.DICT
    return Table({"x": col}, 2048), values, sql_type


_TABLES = {kind: _dict_table(kind) for kind in _DICTS}


@settings(max_examples=200, deadline=None, derandomize=True)
@given(kind=st.sampled_from(sorted(_DICTS)), op=st.sampled_from(_OPS),
       flipped=st.booleans(), pick=st.integers(0, 10**6),
       where=st.sampled_from(["member", "near", "between", "below", "above"]),
       wide=st.booleans())
def test_codespace_compare_equals_value_space(kind, op, flipped, pick, where,
                                              wide):
    """``wide``: a float literal typed DOUBLE against the FLOAT column (the
    compare then runs in float64); "near" literals lie between a member and
    its float32 neighbour."""
    table, values, sql_type = _TABLES[kind]
    if where in ("member", "near"):
        lit = values[pick % len(values)]
        if where == "near":
            lit = float(lit) * (1 + 1e-9) + 1e-12
    elif where == "between":
        i = pick % (len(values) - 1)
        lit = values[i] + (values[i + 1] - values[i]) / 2
    elif where == "below":
        lit = values[0] - 1 - pick % 5
    else:
        lit = values[-1] + 1 + pick % 5
    lit = float(lit) if sql_type == SqlType.FLOAT or where == "near" \
        else lit.item()
    ref = ColumnRef(0, "x", sql_type, True)
    literal = Literal(lit, SqlType.DOUBLE if wide and sql_type == SqlType.FLOAT
                      else sql_type)
    expr = ScalarFunc(op, (literal, ref) if flipped else (ref, literal),
                      SqlType.BOOLEAN)
    assert compiled.count_codespace_predicates([expr], table) == 1
    ev = compiled._TraceEval(table)
    slots = {0: (table.columns["x"].data, table.columns["x"].validity)}
    got = ev._call(expr, slots)
    assert got[0].dtype == torch.bool
    plain = table.decode()
    want = compiled._TraceEval(plain)._call(
        expr, {0: (plain.columns["x"].data, plain.columns["x"].validity)})
    valid = plain.columns["x"].validity
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].expand(2048) & valid, want[0] & valid)


@pytest.fixture(scope="module")
def rle_frames(frames):
    return {n: frames[n] for n in ("customer", "orders")}


def test_check_no_rle_tests_the_encoding_enum(rle_frames):
    """`o_shippriority` (one run) loads RLE; the guard must see it (a
    comparison of the enum with the string "RLE" never holds)."""
    table = Table.from_pandas(rle_frames["orders"], encode=True)
    assert table.columns["o_shippriority"].encoding is Encoding.RLE
    with pytest.raises(compiled._Unsupported):
        compiled.check_no_rle(table)
    compiled.check_no_rle(table.select(["o_orderkey", "o_orderdate"]))


@pytest.mark.parametrize("sql,declined", [
    ("SELECT o_shippriority, COUNT(*) AS n, SUM(o_totalprice) AS s "
     "FROM orders GROUP BY o_shippriority", "compiled_aggregate.declined"),
    ("SELECT o_shippriority, COUNT(*) AS n, SUM(o_totalprice) AS s "
     "FROM orders JOIN customer ON o_custkey = c_custkey "
     "WHERE c_mktsegment = 'BUILDING' GROUP BY o_shippriority",
     "compiled_join.declined"),
])
def test_rle_probe_column_declines_with_the_reference_answer(rle_frames, sql,
                                                            declined):
    c = Context(device="cpu")
    rc = dask_sql_tpu.Context()
    for name, frame in rle_frames.items():
        c.create_table(name, frame)
        rc.create_table(name, frame)
    got = c.sql(sql).compute()
    want = rc.sql(sql).compute()
    assert c.metrics[declined] == 1
    assert c.metrics["columnar.encoding.decode"] >= 1
    assert list(got.columns) == list(want.columns)
    assert got["o_shippriority"].tolist() == want["o_shippriority"].tolist()
    assert got["n"].tolist() == want["n"].tolist()
    np.testing.assert_allclose(got["s"].to_numpy(), want["s"].to_numpy(),
                               rtol=1e-9)
