"""Column of the PyTorch port: a data tensor on an explicit device.

Counterpart of `dask_sql_tpu/columnar/column.py`:

- the values are one flat torch tensor on the column's device;
- NULLs are a bool validity tensor on the same device (True = valid), or
  None when every row is valid;
- strings are dictionary-encoded exactly as the reference does it: a sorted
  ``np.unique`` host dictionary plus int32 codes, NULL as ``""`` plus a
  validity bit, so code order is string order;
- datetimes are int64 nanoseconds since the epoch;
- numeric and datetime columns may carry a compressed ``encoding`` (DICT,
  FOR, RLE; `columnar/encodings.py`): ``data`` then holds codes (or run
  values) and the ``enc_*`` fields describe the mapping.  The compiled
  pipelines and the host decode read the codes; everything else calls
  ``decode()`` first.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from .dtypes import DATETIME_TYPES, STRING_TYPES, SqlType, np_to_sql
from .encodings import Encoding


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dt))).dtype


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dt).numpy().dtype


@dataclass(frozen=True)
class Column:
    data: torch.Tensor  # 1-D values (codes for strings and encoded columns)
    sql_type: SqlType
    validity: Optional[torch.Tensor] = None  # bool, True = valid; None = all valid
    dictionary: Optional[np.ndarray] = None  # host uniques for STRING_TYPES
    #: physical encoding of `data` (columnar/encodings.py); PLAIN = dense
    encoding: Encoding = Encoding.PLAIN
    #: DICT: host SORTED unique values in the device representation
    enc_values: Optional[np.ndarray] = None
    #: FOR: value = code * enc_scale + enc_ref
    enc_ref: int = 0
    enc_scale: int = 1
    #: RLE: int32 run lengths on the device and the row count; `data` holds
    #: the run values and `validity` is per run
    enc_lengths: Optional[torch.Tensor] = None
    enc_rows: Optional[int] = None

    def __post_init__(self):
        if self.validity is not None and self.validity.device != self.data.device:
            raise ValueError(
                f"validity on {self.validity.device}, data on {self.data.device}")

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_numpy(arr: np.ndarray, mask: Optional[np.ndarray] = None,
                   device="cpu", encode: Optional[bool] = None) -> "Column":
        """Build a Column from a host numpy array (+ optional validity mask).

        ``encode`` controls load-time compression (columnar/encodings.py):
        None consults the registration load scope and ``columnar.encoding``
        (so only table ingest encodes), True runs the heuristics anyway,
        False never encodes.  An encoded column never uploads the dense
        buffer."""
        from . import encodings

        def finish(vals, msk, sql_type):
            if encode is not False:
                col = encodings.maybe_encode(vals, msk, sql_type,
                                             force=bool(encode), device=device)
                if col is not None:
                    return col
            return _upload(vals, msk, sql_type, device)

        kind = arr.dtype.kind
        if kind == "M":  # datetime64 -> ns int64
            ns = arr.astype("datetime64[ns]").view("int64")
            mask = _merge_mask(mask, ns != np.iinfo(np.int64).min)
            return finish(ns, mask, SqlType.TIMESTAMP)
        if kind == "m":  # timedelta64 -> ns int64
            ns = arr.astype("timedelta64[ns]").view("int64")
            mask = _merge_mask(mask, ns != np.iinfo(np.int64).min)
            return finish(ns, mask, SqlType.INTERVAL_DAY_TIME)
        if kind in ("O", "U", "S"):
            return Column._encode_strings(arr, mask, device)
        if kind == "f":
            nan = np.isnan(arr)
            if nan.any():
                mask = _merge_mask(mask, ~nan)
        return finish(arr, mask, np_to_sql(arr.dtype))

    @staticmethod
    def _encode_strings(arr: np.ndarray, mask: Optional[np.ndarray],
                        device) -> "Column":
        obj = np.asarray(arr, dtype=object)
        isnull = np.array([v is None or (isinstance(v, float) and np.isnan(v))
                           for v in obj], dtype=bool)
        mask = _merge_mask(mask, ~isnull)
        filled = obj.copy()
        filled[isnull] = ""
        uniques, codes = np.unique(filled.astype(str), return_inverse=True)
        col = _upload(codes.astype(np.int32), mask, SqlType.VARCHAR, device)
        return Column(col.data, SqlType.VARCHAR, col.validity,
                      uniques.astype(object))

    @staticmethod
    def from_parts(values: np.ndarray, validity: Optional[np.ndarray],
                   dictionary: Optional[np.ndarray], sql_type: SqlType,
                   device="cpu") -> "Column":
        """A column from its stored representation as it stands: values
        (codes for strings), validity, string dictionary and SQL type."""
        col = _upload(np.asarray(values), validity, sql_type, device)
        if dictionary is not None:
            dictionary = np.asarray(dictionary, dtype=object)
        return Column(col.data, sql_type, col.validity, dictionary)

    # -- basic properties ---------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.data.device

    def __len__(self) -> int:
        if self.encoding is Encoding.RLE:
            return int(self.enc_rows)
        return int(self.data.shape[0])

    def valid_mask(self) -> torch.Tensor:
        """Always-materialized ROW-length validity mask."""
        if self.validity is None:
            return torch.ones(len(self), dtype=torch.bool, device=self.device)
        if self.encoding is Encoding.RLE:  # per-run mask: expand to rows
            return torch.repeat_interleave(self.validity, self.enc_lengths,
                                           output_size=self.enc_rows)
        return self.validity

    # -- encoding -----------------------------------------------------------
    def decode(self) -> "Column":
        """The column as PLAIN (identity if it is already)."""
        from . import encodings

        return encodings.decode_column(self)

    def device_nbytes(self) -> int:
        """Resident bytes of this column as stored (encoded widths)."""
        from . import encodings

        return encodings.encoded_nbytes(self)

    def compact_dictionary(self) -> "Column":
        """The column with a sorted dictionary of unique strings, so that
        code order is string order (min/max and sort keys compare codes).
        A sorted dictionary (pandas ingest's ``np.unique``) returns as it
        stands; any other (an Arrow dictionary, in insertion order) is
        re-encoded to the values the codes use, sorted, as the reference
        does (on the host)."""
        if self.dictionary is None or _sorted_unique(self.dictionary):
            return self
        from ..utils import count_d2h

        if self.device.type != "cpu":
            count_d2h()
        codes = self.data.cpu().numpy()
        used = np.unique(codes)
        used = used[(used >= 0) & (used < len(self.dictionary))]
        sub = self.dictionary[used].astype(str)
        order = np.argsort(sub, kind="stable")
        remap = np.zeros(max(len(self.dictionary), 1), dtype=np.int32)
        remap[used[order]] = np.arange(len(used), dtype=np.int32)
        new_codes = remap[np.clip(codes, 0, len(remap) - 1)]
        return replace(self, data=_host_tensor(new_codes).to(self.device),
                       dictionary=sub[order].astype(object))

    def to(self, device) -> "Column":
        """The column with its buffers on `device`."""
        if self.device == torch.device(device):
            return self

        def move(t):
            return None if t is None else t.to(device)

        return replace(self, data=move(self.data), validity=move(self.validity),
                       enc_lengths=move(self.enc_lengths))

    def cast(self, target: SqlType) -> "Column":
        from . import casts

        return casts.cast_column(self, target)

    # -- transformations ----------------------------------------------------
    def take(self, indices: torch.Tensor) -> "Column":
        """Row gather.  DICT and FOR codes gather like values (the encoding
        survives); RLE is run-aligned, so positional access decodes first."""
        if self.encoding is Encoding.RLE:
            return self.decode().take(indices)
        validity = None if self.validity is None else self.validity[indices]
        return replace(self, data=self.data[indices], validity=validity)

    def filter(self, mask: torch.Tensor) -> "Column":
        """Rows where mask is True."""
        if self.encoding is Encoding.RLE:
            return self.decode().filter(mask)
        return self.take(torch.nonzero(mask).flatten())

    def slice(self, start: int, stop: int) -> "Column":
        if self.encoding is Encoding.RLE:
            return self.decode().slice(start, stop)
        validity = None if self.validity is None else self.validity[start:stop]
        return replace(self, data=self.data[start:stop], validity=validity)

    # -- host materialization ----------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Host numpy array with NULLs as None/NaN/NaT.  A column on an
        accelerator counts one device-to-host transfer."""
        if self.device.type != "cpu":
            from ..utils import count_d2h

            count_d2h()
        data = self.data.cpu().numpy()
        mask = None if self.validity is None else ~self.validity.cpu().numpy()
        return self.decode_host(data, mask)

    def decode_host(self, data: np.ndarray,
                    mask: Optional[np.ndarray]) -> np.ndarray:
        """Host decode of transferred buffers (mask = ~validity).  Encoded
        columns transfer their narrow codes and decode here."""
        if self.encoding is not Encoding.PLAIN:
            from .encodings import decode_host_buffers

            data, mask = decode_host_buffers(self, data, mask)
        if self.sql_type in STRING_TYPES:
            if len(self.dictionary):
                codes = np.clip(data, 0, len(self.dictionary) - 1)
                out = self.dictionary[codes].astype(object)
            else:
                out = np.full(len(data), "", dtype=object)
            if mask is not None:
                out[mask] = None
            return out
        if self.sql_type in DATETIME_TYPES:
            out = data.view("datetime64[ns]").copy()
            if mask is not None:
                out[mask] = np.datetime64("NaT")
            return out
        if self.sql_type == SqlType.INTERVAL_DAY_TIME:
            out = data.view("timedelta64[ns]").copy()
            if mask is not None:
                out[mask] = np.timedelta64("NaT")
            return out
        if mask is not None and mask.any():
            if data.dtype.kind == "f":
                out = data.copy()
                out[mask] = np.nan
                return out
            if data.dtype.kind == "b":
                out = data.astype(object)
                out[mask] = None
                return out
            # int with NULLs -> float64 + NaN (pandas behaviour)
            out = data.astype(np.float64)
            out[mask] = np.nan
            return out
        return data


#: sortedness verdicts of host dictionaries, by id (the array is kept
#: alive by a weak reference check, so a reused id cannot alias)
_SORTED: dict = {}


def _sorted_unique(dictionary: np.ndarray) -> bool:
    """Whether a string dictionary is strictly ascending (sorted, unique);
    the verdict is kept per array, since columns share their dictionary."""
    import weakref

    got = _SORTED.get(id(dictionary))
    if got is not None and got[0]() is dictionary:
        return got[1]
    d = dictionary.astype(str)
    ok = len(d) < 2 or bool(np.all(d[1:] > d[:-1]))
    if len(_SORTED) > 4096:
        _SORTED.clear()
    _SORTED[id(dictionary)] = (weakref.ref(dictionary), ok)
    return ok


def _merge_mask(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _upload_mask(mask: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    """A host validity mask on `device`, or None when every row is valid."""
    if mask is None:
        return None
    mask = np.asarray(mask, dtype=bool)
    if mask.all():
        return None
    return _host_tensor(mask).to(device)


def _upload(values: np.ndarray, mask: Optional[np.ndarray], sql_type: SqlType,
            device) -> Column:
    return Column(_host_tensor(values).to(device), sql_type,
                  _upload_mask(mask, device))
