"""The eager evaluator's scalar functions beyond its core.

Counterpart of `dask_sql_tpu/physical/rex/operations.py`: the math
(`:184-340`), string (`:341-590`), datetime (`:587-690`) and misc
(`:693-705`) entries of its `OPERATION_MAPPING`, under the same names.
`physical/compiled.py` `_TraceEval` evaluates the core itself (arithmetic,
compares, logic, the IS predicates, the unary math of `_MATH_UNARY`, ROUND,
EXTRACT, the datetime arithmetic and FLOOR/CEIL TO, COALESCE, CONCAT,
UPPER, LIKE against a literal) and, in the eager evaluator only, sends
every other name here.  The fused pipelines decline these names, as the
reference's do.

Each entry takes the evaluator, the call and the run's slots, and returns
``(data, validity)``, or for a string-valued call the evaluator's string
operand ``(codes, validity, dictionary, key)``.  String functions map the
host dictionary, not the rows: with constant arguments each dictionary
value is mapped once (`_TraceEval._mapped`, the reference's `map_unary`)
or becomes a lookup table gathered by the codes (`_lut_values`, its
`map_unary_value`); where an argument varies by row, the distinct argument
tuples of the rows are found on the device, brought to the host in one
transfer and evaluated once each (`_rowwise_fallback`).
"""
from __future__ import annotations

import hashlib
import math
import re
import time
from typing import Callable, Dict

import numpy as np
import torch

from ...columnar.column import Column, torch_dtype
from ...columnar.dtypes import (
    FLOAT_TYPES,
    INTEGER_TYPES,
    STRING_TYPES,
    SqlType,
    sql_to_np,
)
from ...ops import datetime as dt_ops
from ...ops import strings as str_ops
from ...planner.expressions import Cast, Literal

#: an argument that is not a constant of the plan
_NOT_CONST = object()


def _const(expr):
    """The host value of a constant argument (None for NULL): a literal,
    or a cast of one; else `_NOT_CONST`."""
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, Cast) and isinstance(expr.arg, Literal):
        v = expr.arg.value
        if v is None:
            return None
        if expr.sql_type in INTEGER_TYPES:
            return int(float(v))
        if expr.sql_type in FLOAT_TYPES:
            return float(v)
        if expr.sql_type in STRING_TYPES:
            return str(v)
        return v
    return _NOT_CONST


def _unit(expr) -> str:
    """A datetime unit argument (a string literal of the plan)."""
    v = _const(expr)
    if not isinstance(v, str):
        raise ValueError(f"datetime unit must be a constant, got {expr}")
    return v


def _typed(expr, data: torch.Tensor) -> torch.Tensor:
    """A value result in the dtype of the call's SQL type."""
    return data.to(torch_dtype(sql_to_np(expr.sql_type)))


def _rows(ev) -> int:
    return int(ev.table.num_rows)


def _and_valid(*vs):
    from ..compiled import _and_valid as and_valid

    return and_valid(*vs)


def _null_result(ev, expr):
    """An all-NULL result of the call's type (a NULL constant argument)."""
    off = torch.zeros((), dtype=torch.bool, device=ev.device)
    if expr.sql_type in STRING_TYPES:
        return (torch.zeros((), dtype=torch.int32, device=ev.device), off,
                np.array([""], dtype=object), ("null",))
    return torch.zeros((), dtype=torch_dtype(sql_to_np(expr.sql_type)),
                       device=ev.device), off


def _text(ev, arg, slots):
    """The string operand of an argument; a number, date or boolean first
    becomes its text, as the reference casts it to VARCHAR."""
    if arg.sql_type in STRING_TYPES or (isinstance(arg, Literal)
                                        and isinstance(arg.value, str)):
        return ev._require_string(arg, slots, "string function")
    return cast_text(ev, arg, slots)


def cast_text(ev, arg, slots):
    """``CAST(arg AS VARCHAR)`` of a non-string argument as a string
    operand: the distinct values are found on the device and formatted on
    the host (`columnar/casts.py`)."""
    from ...columnar.casts import cast_column

    d, v = ev.eval(arg, slots)
    scalar = d.dim() == 0
    if scalar:
        d = d.reshape(1)
        v = None if v is None else v.reshape(1)
    elif v is not None and v.dim() == 0:
        v = v.expand(d.shape[0])
    col = cast_column(Column(d, arg.sql_type, v), SqlType.VARCHAR)
    codes, valid = col.data, col.validity
    if scalar:
        codes = codes.reshape(())
        valid = None if valid is None else valid.reshape(())
    return codes, valid, col.dictionary, ("cast", id(arg))


def _lut_values(ev, src, fn, dtype, tag):
    """A value-valued function of a string operand: `fn` over its host
    dictionary, a lookup table gathered by the codes (the reference's
    `map_unary_value`).  The table is kept by (tag, operand)."""
    codes, valid, dictionary, skey = src
    key = tag + (skey,)
    lut = ev._luts.get(key)
    if lut is None:
        d = dictionary if dictionary is not None and len(dictionary) \
            else np.array([""], dtype=object)
        lut = ev._luts[key] = torch.from_numpy(
            np.array([fn(str(x)) for x in d], dtype=dtype)).to(ev.device)
    lut = lut.to(codes.device)
    return lut[torch.clamp(codes, 0, lut.shape[0] - 1)], valid


def _rowwise_fallback(ev, parts, fn, result, tag):
    """`fn` over rows whose arguments vary by row (the reference evaluates
    these row by row on the host, `_rowwise_fallback` `:420`).  Here the
    distinct argument tuples are found on the device, come to the host in
    one transfer, and `fn` runs once a tuple; the rows gather their answer
    by the tuple's index.  `parts` holds ``("str", operand)`` or
    ``("num", (data, validity))`` per argument.  Any NULL argument gives a
    NULL row.  `result` is ``"str"`` (a string operand comes back) or a
    numpy dtype of the values."""
    from ...utils import count_d2h

    keys, decoders, valids = [], [], []
    for kind, got in parts:
        if kind == "str":
            codes, valid, d, _ = got
            d = d if d is not None and len(d) else np.array([""], dtype=object)
            keys.append(torch.clamp(codes, 0, len(d) - 1).to(torch.int64))
            decoders.append(lambda x, d=d: str(d[x]))
        else:
            data, valid = got
            if data.is_floating_point():
                keys.append(data.to(torch.float64).view(torch.int64))
                decoders.append(
                    lambda x: float(np.int64(x).view(np.float64)))
            else:
                keys.append(data.to(torch.int64))
                decoders.append(int)
        valids.append(valid)
    valid = _and_valid(*valids)
    keys = list(torch.broadcast_tensors(*keys))
    shape = keys[0].shape
    if valid is not None:
        ok = torch.broadcast_to(valid, shape)
        # a NULL row keys as one tuple, never evaluated
        keys = [torch.where(ok, k, torch.zeros_like(k)) for k in keys]
        keys.append(ok.to(torch.int64))
    else:
        keys.append(torch.ones(shape, dtype=torch.int64, device=ev.device))
    stacked = torch.stack([k.reshape(-1) for k in keys], dim=1)
    if stacked.shape[0]:
        uniq, inverse = torch.unique(stacked, dim=0, return_inverse=True)
    else:
        uniq = stacked
        inverse = torch.zeros(0, dtype=torch.int64, device=stacked.device)
    if uniq.device.type != "cpu":
        count_d2h()
    host = uniq.cpu().numpy()
    empty = "" if result == "str" else 0
    vals = [fn(*[dec(x) for dec, x in zip(decoders, row[:-1])])
            if row[-1] else empty for row in host]
    if result == "str":
        strs = np.array(vals, dtype=object).astype(str) if vals \
            else np.array([""], dtype=str)
        uniq_s, lut = np.unique(strs, return_inverse=True)
        lut_t = torch.from_numpy(lut.astype(np.int32)).to(stacked.device)
        codes = lut_t[inverse].reshape(shape) if len(vals) \
            else torch.zeros(shape, dtype=torch.int32, device=stacked.device)
        return codes, valid, uniq_s.astype(object), tag
    lut_t = torch.from_numpy(np.array(vals, dtype=result)).to(stacked.device)
    data = lut_t[inverse].reshape(shape) if len(vals) \
        else torch.zeros(shape, dtype=lut_t.dtype, device=stacked.device)
    return data, valid


def _part(ev, kind, arg, slots):
    if kind == "s":
        return ("str", _text(ev, arg, slots))
    return ("num", ev.eval(arg, slots))


def _as(kind, v):
    return str(v) if kind == "s" else int(v)


def _string_call(ev, expr, slots, fn, kinds, result="str"):
    """``fn(x, *rest)`` of a call whose first argument is a string and the
    rest of kinds `kinds[1:]` (``"s"`` a string, ``"i"`` an integer): with
    constant rest, a map of the first argument's dictionary; else the
    distinct row tuples.  A NULL constant gives NULL."""
    args = expr.args
    consts = [_const(a) for a in args[1:]]
    if all(c is not _NOT_CONST for c in consts):
        if any(c is None for c in consts):
            return _null_result(ev, expr)
        rest = [_as(k, c) for k, c in zip(kinds[1:], consts)]
        src = _text(ev, args[0], slots)
        tag = (expr.op,) + tuple(rest)
        if result == "str":
            return ev._mapped(src, lambda x: fn(x, *rest), tag)
        return _lut_values(ev, src, lambda x: fn(x, *rest), result, tag)
    parts = [_part(ev, k, a, slots) for k, a in zip(kinds, args)]
    return _rowwise_fallback(ev, parts, fn, result, (expr.op, id(expr)))


def _unary_string(fn) -> Callable:
    def op(ev, expr, slots):
        return _string_call(ev, expr, slots, fn, "s")

    return op


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------
def _mathf(fn) -> Callable:
    def op(ev, expr, slots):
        d, v = ev.eval(expr.args[0], slots)
        return fn(d.to(torch.float64)), v

    return op


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root, one Newton step past the power."""
    y = torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)
    nz = y != 0
    safe = torch.where(nz, y, torch.ones_like(y))
    better = safe - (safe * safe * safe - x) / (3.0 * safe * safe)
    return torch.where(nz & torch.isfinite(y), better, y)


def _binary_float(fn) -> Callable:
    def op(ev, expr, slots):
        (ad, av), (bd, bv) = [ev.eval(a, slots) for a in expr.args]
        return fn(ad.to(torch.float64), bd.to(torch.float64)), \
            _and_valid(av, bv)

    return op


def _op_log(ev, expr, slots):
    """LOG(x) is base 10; LOG(base, x) the log of x in `base`."""
    vals = [ev.eval(a, slots) for a in expr.args]
    if len(vals) == 1:
        d, v = vals[0]
        return torch.log10(d.to(torch.float64)), v
    (bd, bv), (xd, xv) = vals
    return (torch.log(xd.to(torch.float64)) / torch.log(bd.to(torch.float64)),
            _and_valid(bv, xv))


def _op_truncate(ev, expr, slots):
    """TRUNCATE(x [, digits]): toward zero at `digits` decimals; an integer
    without digits as it stands."""
    vals = [ev.eval(a, slots) for a in expr.args]
    ad, av = vals[0]
    if len(vals) == 1 and expr.args[0].sql_type in INTEGER_TYPES:
        return ad, av
    factor = torch.tensor(1.0, dtype=torch.float64, device=ad.device)
    if len(vals) > 1:
        factor = torch.pow(10.0, vals[1][0].to(torch.float64))
    out = torch.trunc(ad.to(torch.float64) * factor) / factor
    return _typed(expr, out), av


def _generator(ev, seed):
    """A generator on the evaluator's device, seeded from the statement's
    seed, or from fresh entropy without one.  (The reference draws from
    `jax.random.PRNGKey(seed)`: a seed repeats its values in each engine,
    but the engines draw other values.)"""
    g = torch.Generator(device=ev.device)
    if seed is None:
        g.seed()
    else:
        g.manual_seed(int(seed))
    return g


def _seed(expr):
    v = _const(expr)
    if v is _NOT_CONST:
        raise ValueError(f"RAND seed must be a constant, got {expr}")
    return v


def _op_rand(ev, expr, slots):
    seed = _seed(expr.args[0]) if expr.args else None
    g = _generator(ev, seed)
    return torch.rand(_rows(ev), generator=g, dtype=torch.float64,
                      device=ev.device), None


def _op_rand_integer(ev, expr, slots):
    """RAND_INTEGER([seed,] bound): integers in [0, bound)."""
    *seed, bound = expr.args
    g = _generator(ev, _seed(seed[0]) if seed else None)
    n = _const(bound)
    if n is _NOT_CONST or n is None:
        raise ValueError(f"RAND_INTEGER bound must be a constant, got {bound}")
    out = torch.randint(0, max(int(n), 1), (_rows(ev),), generator=g,
                        dtype=torch.int64, device=ev.device)
    return out.to(torch.int32), None


def _op_pi(ev, expr, slots):
    return torch.tensor(math.pi, dtype=torch.float64, device=ev.device), None


# ---------------------------------------------------------------------------
# conditional, distinctness
# ---------------------------------------------------------------------------
def _compare_operands(ev, expr, slots):
    """The arguments as comparable tensors: strings in one merged
    dictionary (code order is string order), numbers promoted.  Returns
    ([data...], [validity...], merged dictionary or None)."""
    from ..compiled import _merged

    if any(a.sql_type in STRING_TYPES for a in expr.args):
        ops = [_text(ev, a, slots) for a in expr.args]
        dictionary, codes = _merged(ops)
        return codes, [o[1] for o in ops], dictionary
    vals = [ev.eval(a, slots) for a in expr.args]
    data = [d for d, _ in vals]
    dt = data[0].dtype
    for d in data[1:]:
        dt = torch.promote_types(dt, d.dtype)
    return [d.to(dt) for d in data], [v for _, v in vals], None


def _ones_like(valid, like):
    if valid is not None:
        return valid
    return torch.ones(like.shape, dtype=torch.bool, device=like.device)


def _op_nullif(ev, expr, slots):
    """NULLIF(a, b): a, NULL where a equals b."""
    (ad, bd), (av, bv), dictionary = _compare_operands(ev, expr, slots)
    ad, bd = torch.broadcast_tensors(ad, bd)
    va, vb = _ones_like(av, ad), _ones_like(bv, bd)
    valid = va & ~((ad == bd) & va & vb)
    if dictionary is not None:
        return ad, valid, dictionary, ("nullif", id(expr))
    return _typed(expr, ad), valid


def _minmax_n(take_max: bool) -> Callable:
    def op(ev, expr, slots):
        data, valids, dictionary = _compare_operands(ev, expr, slots)
        out = data[0]
        for d in data[1:]:
            out = torch.maximum(out, d) if take_max else torch.minimum(out, d)
        valid = _and_valid(*valids)
        if dictionary is not None:
            return out, valid, dictionary, (expr.op, id(expr))
        return _typed(expr, out), valid

    return op


def _op_is_distinct_from(ev, expr, slots):
    (ad, bd), (av, bv), _ = _compare_operands(ev, expr, slots)
    ad, bd = torch.broadcast_tensors(ad, bd)
    va, vb = _ones_like(av, ad), _ones_like(bv, bd)
    return (va != vb) | (va & vb & (ad != bd)), None


def _op_is_not_distinct_from(ev, expr, slots):
    d, _ = _op_is_distinct_from(ev, expr, slots)
    return ~d, None


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------
def _op_trim(ev, expr, slots):
    strip = str_ops.TRIMS[expr.op]
    if len(expr.args) == 1:
        return _string_call(ev, expr, slots, lambda x: strip(x), "s")
    return _string_call(ev, expr, slots, lambda x, ch: strip(x, ch), "ss")


def _op_substring(ev, expr, slots):
    return _string_call(ev, expr, slots, str_ops.substring,
                        "sii"[:len(expr.args)])


def _op_overlay(ev, expr, slots):
    return _string_call(ev, expr, slots,
                        lambda x, r, s, ln=None: str_ops.overlay(x, r, s, ln),
                        "ssii"[:len(expr.args)])


def _pad_op(on_left: bool) -> Callable:
    def op(ev, expr, slots):
        return _string_call(
            ev, expr, slots,
            lambda x, k, c=" ": str_ops.pad(x, k, c, on_left),
            "sis"[:len(expr.args)])

    return op


def _op_position(ev, expr, slots):
    """POSITION(needle IN hay): 1-based, 0 when absent."""
    needle, hay = expr.args
    c = _const(needle)
    if c is None:
        return _null_result(ev, expr)
    if c is not _NOT_CONST:
        nd = str(c)
        return _lut_values(ev, _text(ev, hay, slots),
                           lambda h: h.find(nd) + 1, np.int32,
                           ("position", nd))
    parts = [_part(ev, "s", hay, slots), _part(ev, "s", needle, slots)]
    return _rowwise_fallback(ev, parts, lambda h, n: h.find(n) + 1,
                             np.int32, ("position", id(expr)))


def _like(case_insensitive: bool, similar: bool) -> Callable:
    """LIKE, ILIKE, SIMILAR TO whose pattern or escape is not a string
    literal (the evaluator's core takes the literal pattern)."""
    flags = re.IGNORECASE if case_insensitive else 0
    to_rx = str_ops.similar_to_regex if similar else str_ops.like_to_regex

    def fn(x, p, e=None):
        return re.compile(to_rx(p, e), flags).match(x) is not None

    def op(ev, expr, slots):
        return _string_call(ev, expr, slots, fn, "sss"[:len(expr.args)],
                            result=np.bool_)

    return op


def _op_chr(ev, expr, slots):
    """CHR(code): the character, or the empty string out of range."""
    parts = [_part(ev, "i", expr.args[0], slots)]
    return _rowwise_fallback(
        ev, parts, lambda v: chr(int(v)) if 0 < v < 0x110000 else "", "str",
        ("chr", id(expr)))


def _op_md5(ev, expr, slots):
    return _string_call(
        ev, expr, slots, lambda x: hashlib.md5(x.encode()).hexdigest(), "s")


def _op_hash64(ev, expr, slots):
    """HASH(a, ...): the reference's factorize id of the argument tuple
    (`ops/grouping.py` `factorize` over `key_arrays`): the rank of the
    row's distinct tuple in sorted order."""
    from ...ops.grouping import factorize, key_arrays

    n = _rows(ev)
    cols = []
    for a in expr.args:
        if a.sql_type in STRING_TYPES:
            codes, valid, dictionary, _ = _text(ev, a, slots)
            data = codes
        else:
            (data, valid), dictionary = ev.eval(a, slots), None
        data = data.expand(n) if data.dim() == 0 else data
        if valid is not None and valid.dim() == 0:
            valid = valid.expand(n)
        cols.append(Column(data, a.sql_type, valid, dictionary))
    gid, _, _ = factorize(key_arrays(cols))
    return gid.to(torch.int64), None


# ---------------------------------------------------------------------------
# datetime
# ---------------------------------------------------------------------------
def _op_date_trunc(ev, expr, slots):
    d, v = ev.eval(expr.args[1], slots)
    return dt_ops.truncate(_unit(expr.args[0]), d), v


def _op_timestampadd(ev, expr, slots):
    (nd, nv), (td, tv) = [ev.eval(a, slots) for a in expr.args[1:]]
    return dt_ops.timestampadd(_unit(expr.args[0]), nd, td), \
        _and_valid(nv, tv)


def _op_timestampdiff(ev, expr, slots):
    (ad, av), (bd, bv) = [ev.eval(a, slots) for a in expr.args[1:]]
    return dt_ops.timestampdiff(_unit(expr.args[0]), ad, bd), \
        _and_valid(av, bv)


def _op_last_day(ev, expr, slots):
    d, v = ev.eval(expr.args[0], slots)
    return dt_ops.last_day(d), v


_BAD_TS = np.iinfo(np.int64).min


def _op_to_timestamp(ev, expr, slots):
    """TO_TIMESTAMP(text [, format]) parses each dictionary value (an
    unparseable one gives NULL); TO_TIMESTAMP(integer) reads seconds since
    the epoch."""
    a = expr.args[0]
    if a.sql_type in STRING_TYPES:
        fmt = _const(expr.args[1]) if len(expr.args) > 1 else None
        if fmt is _NOT_CONST:
            raise ValueError("TO_TIMESTAMP format must be a constant")
        import datetime as _dt

        def parse(x: str) -> int:
            try:
                if fmt is not None:
                    return int(np.datetime64(_dt.datetime.strptime(x, str(fmt)),
                                             "ns").astype(np.int64))
                return int(np.datetime64(x.strip(), "ns").astype(np.int64))
            except ValueError:
                return _BAD_TS

        d, v = _lut_values(ev, _text(ev, a, slots), parse, np.int64,
                           ("to_timestamp", fmt))
        return d, _and_valid(v, d != _BAD_TS)
    d, v = ev.eval(a, slots)
    if a.sql_type in INTEGER_TYPES:
        return d.to(torch.int64) * dt_ops.NS_PER_SECOND, v
    return d.to(torch.int64), v


def _op_current_timestamp(ev, expr, slots):
    return torch.tensor(int(time.time() * 1e9), dtype=torch.int64,
                        device=ev.device), None


def _op_current_date(ev, expr, slots):
    now_ns = int(time.time() * 1e9)
    day_ns = (now_ns // dt_ops.NS_PER_DAY) * dt_ops.NS_PER_DAY
    return torch.tensor(day_ns, dtype=torch.int64, device=ev.device), None


OPERATION_MAPPING: Dict[str, Callable] = {
    # distinctness
    "is_distinct_from": _op_is_distinct_from,
    "is_not_distinct_from": _op_is_not_distinct_from,
    # math
    "acos": _mathf(torch.acos),
    "asin": _mathf(torch.asin),
    "atan": _mathf(torch.atan),
    "atan2": _binary_float(torch.atan2),
    "cbrt": _mathf(_cbrt),
    "cot": _mathf(lambda x: 1.0 / torch.tan(x)),
    "degrees": _mathf(torch.rad2deg),
    "log": _op_log,
    "power": _binary_float(torch.pow),
    "radians": _mathf(torch.deg2rad),
    "truncate": _op_truncate,
    "rand": _op_rand,
    "rand_integer": _op_rand_integer,
    "pi": _op_pi,
    # conditional
    "nullif": _op_nullif,
    "greatest": _minmax_n(True),
    "least": _minmax_n(False),
    # strings
    "char_length": lambda ev, expr, slots: _string_call(
        ev, expr, slots, len, "s", result=np.int64),
    "lower": _unary_string(str.lower),
    "initcap": _unary_string(str_ops.initcap),
    "reverse": _unary_string(lambda x: x[::-1]),
    "substring": _op_substring,
    "btrim": _op_trim,
    "ltrim": _op_trim,
    "rtrim": _op_trim,
    "like": _like(False, False),
    "ilike": _like(True, False),
    "similar": _like(False, True),
    "position": _op_position,
    "overlay": _op_overlay,
    "replace": lambda ev, expr, slots: _string_call(
        ev, expr, slots, lambda x, f, t: x.replace(f, t), "sss"),
    "left": lambda ev, expr, slots: _string_call(
        ev, expr, slots, str_ops.left, "si"),
    "right": lambda ev, expr, slots: _string_call(
        ev, expr, slots, str_ops.right, "si"),
    "repeat_str": lambda ev, expr, slots: _string_call(
        ev, expr, slots, str_ops.repeat, "si"),
    "lpad": _pad_op(True),
    "rpad": _pad_op(False),
    "ascii": lambda ev, expr, slots: _string_call(
        ev, expr, slots, lambda x: ord(x[0]) if x else 0, "s",
        result=np.int32),
    "chr": _op_chr,
    "split_part": lambda ev, expr, slots: _string_call(
        ev, expr, slots, str_ops.split_part, "ssi"),
    "md5": _op_md5,
    "hash64": _op_hash64,
    # datetime
    "date_trunc": _op_date_trunc,
    "timestampadd": _op_timestampadd,
    "timestampdiff": _op_timestampdiff,
    "last_day": _op_last_day,
    "to_timestamp": _op_to_timestamp,
    "current_timestamp": _op_current_timestamp,
    "current_date": _op_current_date,
}

#: the names whose result is a string: they answer the evaluator's
#: `string_operand`, the others its `_call`
STRING_VALUED = frozenset({
    "lower", "initcap", "reverse", "substring", "btrim", "ltrim", "rtrim",
    "overlay", "replace", "left", "right", "repeat_str", "lpad", "rpad",
    "chr", "split_part", "md5", "nullif", "greatest", "least"})

#: the names the evaluator's `_call` hands over: the value-valued ones, and
#: the three that take numbers as well as strings
CALL_VALUED = (frozenset(OPERATION_MAPPING) - STRING_VALUED) | {
    "nullif", "greatest", "least"}


#: the names `physical/compiled.py` `_TraceEval` evaluates itself (the
#: core above); with `OPERATION_MAPPING` they are every name of the
#: reference's `OPERATION_MAPPING`, which the plan verifier checks calls
#: against (`analysis/verifier.py` ``unknown-op``)
CORE_OPS = frozenset({
    "abs", "add", "and", "ceil", "coalesce", "concat", "cos", "datetime_add",
    "datetime_ceil", "datetime_floor", "datetime_sub",
    "datetime_sub_interval", "div", "eq", "exp", "extract_century",
    "extract_day", "extract_decade", "extract_dow", "extract_doy",
    "extract_epoch", "extract_hour", "extract_isodow", "extract_isoyear",
    "extract_microsecond", "extract_millennium", "extract_millisecond",
    "extract_minute", "extract_month", "extract_nanosecond",
    "extract_quarter", "extract_second", "extract_week", "extract_year",
    "floor", "ge", "gt", "int_to_interval_days", "is_false", "is_not_false",
    "is_not_null", "is_not_true", "is_null", "is_true", "le", "ln", "log10",
    "log2", "lt", "mod", "mul", "ne", "neg", "not", "or", "round", "sign",
    "sin", "sqrt", "sub", "tan", "upper"})
