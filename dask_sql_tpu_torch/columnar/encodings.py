"""Column encodings of the PyTorch port: compressed storage chosen at load.

Counterpart of `dask_sql_tpu/columnar/encodings.py`, with the same
encodings, heuristics, ``columnar.encoding*`` keys and defaults:

- ``DICT``   low-cardinality numerics and datetimes: an int16/int32 code
  tensor on the device plus a host SORTED array of the unique values
  (``enc_values``).  Sortedness turns comparisons and IN lists into
  integer predicates over the codes (``x < lit  <=>  code <
  searchsorted(values, lit)``), and the codes are a group-by radix domain
  of ``len(enc_values)`` with no device min/max pull.
- ``FOR``    frame of reference for narrow-range integers (and epoch-ns
  datetimes, whose day-granularity gcd divides out): ``value = code *
  enc_scale + enc_ref``, codes in the narrowest int dtype that fits.
- ``RLE``    run-length for sorted or clustered columns: ``data`` holds the
  run values, ``enc_lengths`` the int32 run lengths, ``enc_rows`` the row
  count; ``validity`` is per run.  Row-positional consumers decode first.
- ``PLAIN``  the dense buffer.

Selection is host numpy over the host array before upload, so the decoded
buffer never reaches the device.  It applies inside `load_scope` (table
registration through `input_utils`), which carries the registering
Context's `Config`.  torch indexes only with int32/int64 tensors, so a
decode widens int16 codes to int32 at the gather; the stored codes stay
narrow.
"""
from __future__ import annotations

import contextlib
import contextvars
import enum
from typing import Optional, Tuple

import numpy as np
import torch

from .dtypes import STRING_TYPES, SqlType, sql_to_np


class Encoding(enum.Enum):
    """Physical encoding of a Column's device buffer."""

    PLAIN = "PLAIN"
    DICT = "DICT"
    RLE = "RLE"
    FOR = "FOR"

    def __str__(self) -> str:
        return self.value


#: the Config of the registration in progress (None outside one): only
#: table ingest auto-encodes, and it reads the registering Context's keys
_load_scope: contextvars.ContextVar = contextvars.ContextVar(
    "dsql_torch_encoding_load_scope", default=None)


class _Defaults:
    """The ``columnar.encoding*`` defaults, for a scope opened without a
    Config and for forced encodes outside any scope."""

    @staticmethod
    def get(key, default=None):
        from ..config import DEFAULTS

        return DEFAULTS.get(key, default)


@contextlib.contextmanager
def load_scope(config=None):
    token = _load_scope.set(config if config is not None else _Defaults())
    try:
        yield
    finally:
        _load_scope.reset(token)


def in_load_scope() -> bool:
    return _load_scope.get() is not None


def _config():
    scope = _load_scope.get()
    return scope if scope is not None else _Defaults()


def auto_enabled() -> bool:
    """True when load-time auto-selection is configured on."""
    return str(_config().get("columnar.encoding", "auto")).lower() == "auto"


def should_auto_encode() -> bool:
    return in_load_scope() and auto_enabled()


# ---------------------------------------------------------------------------
# selection heuristics (host-side, over the device-representation array)
# ---------------------------------------------------------------------------
_INT16_MAX_CODES = 1 << 15


def _code_dtype(n_codes: int) -> Optional[np.dtype]:
    """Narrowest signed int dtype holding codes ``[0, n_codes)`` with one
    spare slot (radix NULL code headroom)."""
    if n_codes < _INT16_MAX_CODES:
        return np.dtype(np.int16)
    if n_codes < (1 << 31) - 1:
        return np.dtype(np.int32)
    return None


def maybe_encode(values: np.ndarray, valid: Optional[np.ndarray],
                 sql_type: SqlType, force: bool = False, device="cpu"):
    """Pick and build an encoded Column on `device` from a HOST array in its
    device representation (ints/floats; datetimes already epoch-ns int64),
    or return None (the caller builds PLAIN).  ``valid`` is a host bool
    mask (True = valid) or None.  ``force=True`` bypasses the load-scope
    and config gate (tests), not the heuristics."""
    from .column import Column, _upload_mask, _host_tensor

    if not force and not should_auto_encode():
        return None
    config = _config()
    if sql_type in STRING_TYPES or sql_type in (SqlType.BOOLEAN, SqlType.NULL,
                                                SqlType.ANY):
        return None
    values = np.asarray(values)
    if values.ndim != 1 or values.dtype.kind not in "if":
        return None
    n = values.shape[0]
    if n < int(config.get("columnar.encoding.min_rows", 1024)):
        return None
    valid_vals = values if valid is None else values[np.asarray(valid, bool)]
    if valid_vals.shape[0] == 0:
        return None
    if values.dtype.kind == "f" and np.isnan(valid_vals).any():
        return None  # NaN-bearing valid values stay dense
    plain_width = values.dtype.itemsize
    plain_bytes = n * plain_width

    def upload(arr):
        return _host_tensor(arr).to(device)

    candidates = []  # (bytes, preference rank, build function)

    # DICT: sorted uniques of the VALID values (invalid rows code to 0)
    if config.get("columnar.encoding.dict", True):
        uniques = np.unique(valid_vals)
        cd = _code_dtype(len(uniques))
        if cd is not None and len(uniques) <= int(
                config.get("columnar.encoding.dict_max_card", 1 << 15)) \
                and len(uniques) <= max(n // 4, 1):
            u = uniques

            def build_dict(u=u, cd=cd):
                filled = values if valid is None else \
                    np.where(np.asarray(valid, bool), values, u[0])
                codes = np.searchsorted(u, filled).astype(cd)
                return Column(upload(codes), sql_type,
                              _upload_mask(valid, device), None,
                              encoding=Encoding.DICT,
                              enc_values=u.astype(sql_to_np(sql_type)))

            candidates.append((n * cd.itemsize, 0, build_dict))

    # FOR: affine frame of reference for integer representations
    if config.get("columnar.encoding.for", True) and values.dtype.kind == "i":
        lo = int(valid_vals.min())
        hi = int(valid_vals.max())
        offs = valid_vals.astype(np.int64) - lo
        scale = int(np.gcd.reduce(offs)) if offs.shape[0] else 1
        scale = max(scale, 1)
        span_codes = (hi - lo) // scale
        cd = _code_dtype(span_codes + 1)
        if cd is not None and cd.itemsize < plain_width:

            def build_for(lo=lo, scale=scale, cd=cd):
                filled = values if valid is None else \
                    np.where(np.asarray(valid, bool), values, lo)
                codes = ((filled.astype(np.int64) - lo) // scale).astype(cd)
                return Column(upload(codes), sql_type,
                              _upload_mask(valid, device), None,
                              encoding=Encoding.FOR, enc_ref=lo,
                              enc_scale=scale)

            candidates.append((n * cd.itemsize, 1, build_for))

    # RLE: only when extreme (runs pay for the lengths array and for the
    # decode before every positional use)
    if config.get("columnar.encoding.rle", True):
        v = np.asarray(valid, bool) if valid is not None else None
        change = values[1:] != values[:-1]
        if v is not None:
            change = change | (v[1:] != v[:-1])
        n_runs = 1 + int(change.sum())
        rle_bytes = n_runs * (plain_width + 4)
        if rle_bytes * 8 <= plain_bytes:

            def build_rle(change=change, v=v):
                starts = np.concatenate(
                    [[0], np.flatnonzero(change) + 1]).astype(np.int64)
                lengths = np.diff(np.concatenate(
                    [starts, [n]])).astype(np.int32)
                run_vals = values[starts]
                run_valid = None if v is None else v[starts]
                if run_valid is not None and bool(run_valid.all()):
                    run_valid = None
                return Column(
                    upload(run_vals), sql_type,
                    None if run_valid is None else upload(run_valid),
                    None, encoding=Encoding.RLE,
                    enc_lengths=upload(lengths), enc_rows=n)

            candidates.append((rle_bytes, -1, build_rle))

    # a real saving (>= 25%) or nothing: borderline columns stay PLAIN
    candidates = [c for c in candidates if c[0] * 4 <= plain_bytes * 3]
    if not candidates:
        return None
    candidates.sort(key=lambda c: (c[0], c[1]))
    return candidates[0][2]()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_host_buffers(col, data: np.ndarray, aligned=None):
    """The host decode rule, shared by ``Column.decode_host`` (transferred
    codes) and the host-resident branch of `decode_column`: DICT maps codes
    through the value array, FOR applies the affine, RLE expands runs and
    ``aligned`` (a per-run mask or its inverse) with them.  PLAIN passes
    through.  Returns ``(values, aligned)``."""
    if col.encoding is Encoding.DICT:
        data = col.enc_values[np.clip(data, 0, len(col.enc_values) - 1)]
    elif col.encoding is Encoding.FOR:
        data = data.astype(sql_to_np(col.sql_type))
        if col.enc_scale != 1:
            data = data * col.enc_scale
        if col.enc_ref:
            data = data + col.enc_ref
    elif col.encoding is Encoding.RLE:
        lengths = _host_array(col.enc_lengths)
        data = np.repeat(np.asarray(data), lengths)
        if aligned is not None:
            aligned = np.repeat(np.asarray(aligned), lengths)
    return data, aligned


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def dict_lut(values: np.ndarray, device) -> torch.Tensor:
    """A DICT column's value array as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(device)


def gather_codes(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``lut[codes]`` for stored codes of any int width: clamped, and
    widened to int32, the narrowest index dtype torch takes."""
    codes = torch.clamp(codes, 0, lut.shape[0] - 1)
    if codes.dtype not in (torch.int32, torch.int64):
        codes = codes.to(torch.int32)
    return lut[codes]


def decode_for(codes: torch.Tensor, sql_type: SqlType, ref: int,
               scale: int) -> torch.Tensor:
    """``code * scale + ref`` in the column's value dtype."""
    from .column import torch_dtype

    data = codes.to(torch_dtype(sql_to_np(sql_type)))
    if scale != 1:
        data = data * scale
    if ref:
        data = data + ref
    return data


def decode_column(col):
    """The column as PLAIN: device ops for device buffers.  Identity for
    PLAIN columns."""
    from dataclasses import replace

    if col.encoding is Encoding.PLAIN:
        return col
    plain = dict(encoding=Encoding.PLAIN, enc_values=None, enc_ref=0,
                 enc_scale=1, enc_lengths=None, enc_rows=None)
    if col.encoding is Encoding.DICT:
        data = gather_codes(dict_lut(col.enc_values, col.device), col.data)
        return replace(col, data=data, **plain)
    if col.encoding is Encoding.FOR:
        data = decode_for(col.data, col.sql_type, col.enc_ref, col.enc_scale)
        return replace(col, data=data, **plain)
    # RLE: expand runs back to rows
    n = col.enc_rows
    data = torch.repeat_interleave(col.data, col.enc_lengths, output_size=n)
    validity = None if col.validity is None else torch.repeat_interleave(
        col.validity, col.enc_lengths, output_size=n)
    return replace(col, data=data, validity=validity, **plain)


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------
def _nbytes(x: Optional[torch.Tensor]) -> int:
    return 0 if x is None else int(x.numel() * x.element_size())


def encoded_nbytes(col) -> int:
    """Resident bytes of a column as stored: data buffer, validity mask and
    RLE lengths, plus the host dictionaries (strings and DICT values), part
    of the working set."""
    total = _nbytes(col.data) + _nbytes(col.validity) + _nbytes(col.enc_lengths)
    if col.enc_values is not None:
        total += int(col.enc_values.nbytes)
    dictionary = col.dictionary
    if dictionary is not None:
        # host object array of uniques: nbytes counts only pointers
        total += sum(len(str(v)) for v in dictionary) + dictionary.nbytes
    return total


def decoded_nbytes(col) -> int:
    """Bytes the same column would take fully decoded (dense buffer and its
    validity mask).  String columns are int32 codes either way."""
    n = len(col)
    total = n * sql_to_np(col.sql_type).itemsize
    if col.validity is not None:
        total += n  # bool mask, expanded for RLE
    if col.dictionary is not None:
        total += sum(len(str(v)) for v in col.dictionary) \
            + col.dictionary.nbytes
    return total


def scan_bytes(table, names=None) -> Tuple[int, int]:
    """(encoded, decoded) resident bytes of the named columns of a table."""
    names = list(names) if names is not None else list(table.column_names)
    enc = sum(encoded_nbytes(table.columns[n]) for n in names)
    dec = sum(decoded_nbytes(table.columns[n]) for n in names)
    return enc, dec


# ---------------------------------------------------------------------------
# code-space predicate translation (copied from the reference; DICT
# columns, sorted enc_values)
# ---------------------------------------------------------------------------
#: operator mirror for `lit OP col` -> `col OP' lit`
FLIP_CMP = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge",
            "gt": "lt", "ge": "le"}


def dict_literal_bounds(values: np.ndarray, op: str, literal):
    """Host translation of ``col OP literal`` into code space for a SORTED
    dictionary.  Returns (kind, code) where kind/code describe a pure
    integer predicate over the codes:

    - ("lt", L)      codes <  L
    - ("ge", L)      codes >= L
    - ("eq", i)      codes == i      (exact dictionary member)
    - ("none", _)    no code matches (eq of an absent literal)
    - ("all", _)     every code matches
    """
    lit = literal
    left = int(np.searchsorted(values, lit, side="left"))
    right = int(np.searchsorted(values, lit, side="right"))
    if op == "lt":
        return ("lt", left)
    if op == "le":
        return ("lt", right)
    if op == "gt":
        return ("ge", right)
    if op == "ge":
        return ("ge", left)
    present = left < len(values) and left < right
    if op == "eq":
        return ("eq", left) if present else ("none", 0)
    if op == "ne":
        # ne of an absent literal is TRUE for every (valid) row
        return ("ne", left) if present else ("all", 0)
    raise ValueError(f"untranslatable op {op!r}")
