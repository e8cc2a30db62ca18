"""Column casts between SQL types.

Counterpart of `dask_sql_tpu/columnar/casts.py` on torch tensors: the same
rules, the DICT fast path that casts only the host value array, and the
string casts through the (small) host dictionary.
"""
from __future__ import annotations

import numpy as np
import torch

from .column import Column, torch_dtype
from .dtypes import (
    DATETIME_TYPES,
    FLOAT_TYPES,
    INTEGER_TYPES,
    INTERVAL_TYPES,
    NUMERIC_TYPES,
    STRING_TYPES,
    SqlType,
    sql_to_np,
)

_NS_PER_DAY = 86_400_000_000_000


def _to(data: torch.Tensor, target: SqlType) -> torch.Tensor:
    return data.to(torch_dtype(sql_to_np(target)))


def cast_column(col: Column, target: SqlType) -> Column:
    src = col.sql_type
    if src == target:
        return col
    col = _cast_encoded(col, target)
    if col.sql_type == target:
        return col
    # string -> anything: through the host dictionary (it is small)
    if src in STRING_TYPES:
        if target in STRING_TYPES:
            return Column(col.data, target, col.validity, col.dictionary)
        return _cast_from_string(col, target)
    if target in STRING_TYPES:
        return _cast_to_string(col, target)
    if src in DATETIME_TYPES and target in DATETIME_TYPES:
        if target == SqlType.DATE:
            # truncate to midnight
            days = torch.div(col.data, _NS_PER_DAY, rounding_mode="floor")
            return Column(days * _NS_PER_DAY, SqlType.DATE, col.validity)
        return Column(col.data, target, col.validity)
    if src in DATETIME_TYPES and target in NUMERIC_TYPES:
        return Column(_to(col.data, target), target, col.validity)
    if src in NUMERIC_TYPES and target in DATETIME_TYPES:
        return Column(col.data.to(torch.int64), target, col.validity)
    if src in INTERVAL_TYPES and target in NUMERIC_TYPES:
        return Column(_to(col.data, target), target, col.validity)
    if src == SqlType.BOOLEAN and target in NUMERIC_TYPES:
        return Column(_to(col.data, target), target, col.validity)
    if src in NUMERIC_TYPES and target == SqlType.BOOLEAN:
        return Column(col.data != 0, target, col.validity)
    if src in NUMERIC_TYPES and target in NUMERIC_TYPES:
        data = col.data
        if src in FLOAT_TYPES and target in INTEGER_TYPES:
            # SQL CAST truncates toward zero; NaN hides under the validity
            data = torch.nan_to_num(torch.trunc(data))
        return Column(_to(data, target), target, col.validity)
    if src == SqlType.NULL:
        n = len(col)
        return Column(
            torch.zeros(n, dtype=torch_dtype(sql_to_np(target)),
                        device=col.device),
            target,
            torch.zeros(n, dtype=torch.bool, device=col.device),
            np.array([""], dtype=object) if target in STRING_TYPES else None,
        )
    raise NotImplementedError(f"cast {src} -> {target}")


def _cast_encoded(col: Column, target: SqlType) -> Column:
    """Casts of compressed columns (columnar/encodings.py).

    DICT: cast the host value array by the same rules and keep the codes,
    so the row-sized buffer is untouched.  Sound only while the cast values
    stay STRICTLY increasing (code-space predicates rely on sorted unique
    values); a collapsing cast (float -> int merging 1.2 and 1.8) decodes
    first, as do FOR, RLE and every other shape."""
    from dataclasses import replace

    from .encodings import Encoding

    if col.encoding is Encoding.PLAIN:
        return col
    if col.encoding is Encoding.DICT and target not in STRING_TYPES \
            and col.sql_type not in STRING_TYPES:
        casted = cast_column(
            Column(torch.from_numpy(np.ascontiguousarray(col.enc_values)),
                   col.sql_type, None), target)
        if casted.dictionary is None and casted.validity is None:
            vals = casted.data.numpy()
            if len(vals) <= 1 or bool(np.all(vals[1:] > vals[:-1])):
                return replace(col, sql_type=target, enc_values=vals)
    return col.decode()


def _cast_from_string(col: Column, target: SqlType) -> Column:
    """Cast through the (small) host dictionary, then gather on the device."""
    d = col.dictionary if col.dictionary is not None and len(col.dictionary) \
        else np.array([""], dtype=object)
    strs = d.astype(str)
    bad = None
    if target in INTEGER_TYPES:
        vals = np.zeros(len(strs), dtype=np.int64)
        bad = np.zeros(len(strs), dtype=bool)
        for i, s in enumerate(strs):
            t = s.strip()
            try:
                # int(t) first: int(float(t)) loses precision above 2^53
                vals[i] = int(t) if t else 0
                bad[i] = not t
            except ValueError:
                try:
                    vals[i] = int(float(t))
                except (ValueError, OverflowError):
                    bad[i] = True
        vals = vals.astype(sql_to_np(target))
    elif target in FLOAT_TYPES:
        vals = np.zeros(len(strs), dtype=np.float64)
        bad = np.zeros(len(strs), dtype=bool)
        for i, s in enumerate(strs):
            try:
                vals[i] = float(s) if s.strip() else 0.0
                bad[i] = not s.strip()
            except ValueError:
                bad[i] = True
        vals = vals.astype(sql_to_np(target))
    elif target in DATETIME_TYPES:
        vals = np.zeros(len(strs), dtype=np.int64)
        bad = np.zeros(len(strs), dtype=bool)
        for i, s in enumerate(strs):
            try:
                vals[i] = np.datetime64(s.strip(), "ns").astype(np.int64)
            except ValueError:
                bad[i] = True
        if target == SqlType.DATE:
            vals = (vals // _NS_PER_DAY) * _NS_PER_DAY
    elif target == SqlType.BOOLEAN:
        low = np.char.lower(np.char.strip(strs.astype(str)))
        vals = np.isin(low, ("true", "t", "1", "yes"))
        bad = ~np.isin(low, ("true", "t", "1", "yes", "false", "f", "0", "no"))
    else:
        raise NotImplementedError(f"cast VARCHAR -> {target}")
    codes = torch.clamp(col.data, 0, len(strs) - 1)
    data = torch.from_numpy(vals).to(col.device)[codes]
    validity = col.validity
    if bad is not None and bad.any():
        ok = torch.from_numpy(~bad).to(col.device)[codes]
        validity = ok if validity is None else (validity & ok)
    return Column(data, target, validity)


def _cast_to_string(col: Column, target: SqlType) -> Column:
    """Numeric/datetime -> string: unique values on the host, formatted
    there, codes uploaded."""
    vals = col.data.cpu().numpy()
    uniq, codes = np.unique(vals, return_inverse=True)
    if col.sql_type in DATETIME_TYPES:
        if col.sql_type == SqlType.DATE:
            strs = np.array([str(np.datetime64(int(v), "ns").astype("datetime64[D]"))
                             for v in uniq], dtype=object)
        else:
            strs = np.array([_fmt_ts(int(v)) for v in uniq], dtype=object)
    elif col.sql_type == SqlType.BOOLEAN:
        strs = np.array(["false", "true"], dtype=object)
        codes = vals.astype(np.int32)
        return Column(torch.from_numpy(codes).to(col.device), target,
                      col.validity, strs)
    elif uniq.dtype.kind == "f":
        strs = np.array([_fmt_float(v) for v in uniq], dtype=object)
    else:
        strs = np.array([str(v) for v in uniq], dtype=object)
    if len(strs) == 0:
        strs = np.array([""], dtype=object)
        codes = np.zeros(len(vals), dtype=np.int32)
    return Column(torch.from_numpy(codes.astype(np.int32)).to(col.device),
                  target, col.validity, strs)


def _fmt_ts(ns: int) -> str:
    dt = np.datetime64(ns, "ns")
    s = str(dt.astype("datetime64[s]")).replace("T", " ")
    frac = ns % 1_000_000_000
    if frac:
        s += f".{frac:09d}".rstrip("0")
    return s


def _fmt_float(v: float) -> str:
    if np.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e16:
        return f"{v:.1f}"
    return repr(float(v))
