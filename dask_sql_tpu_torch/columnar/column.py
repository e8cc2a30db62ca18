"""Column of the PyTorch port: a data tensor on an explicit device.

Counterpart of `dask_sql_tpu/columnar/column.py`, PLAIN encoding only:

- the values are one flat torch tensor on the column's device;
- NULLs are a bool validity tensor on the same device (True = valid), or
  None when every row is valid;
- strings are dictionary-encoded exactly as the reference does it: a sorted
  ``np.unique`` host dictionary plus int32 codes, NULL as ``""`` plus a
  validity bit, so code order is string order;
- datetimes are int64 nanoseconds since the epoch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .dtypes import DATETIME_TYPES, STRING_TYPES, SqlType, np_to_sql


@dataclass(frozen=True)
class Column:
    data: torch.Tensor  # 1-D values (dictionary codes for strings)
    sql_type: SqlType
    validity: Optional[torch.Tensor] = None  # bool, True = valid; None = all valid
    dictionary: Optional[np.ndarray] = None  # host uniques for STRING_TYPES

    def __post_init__(self):
        if self.validity is not None and self.validity.device != self.data.device:
            raise ValueError(
                f"validity on {self.validity.device}, data on {self.data.device}")

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_numpy(arr: np.ndarray, mask: Optional[np.ndarray] = None,
                   device="cpu") -> "Column":
        """Build a Column from a host numpy array (+ optional validity mask)."""
        kind = arr.dtype.kind
        if kind == "M":  # datetime64 -> ns int64
            ns = arr.astype("datetime64[ns]").view("int64")
            mask = _merge_mask(mask, ns != np.iinfo(np.int64).min)
            return _upload(ns, mask, SqlType.TIMESTAMP, device)
        if kind == "m":  # timedelta64 -> ns int64
            ns = arr.astype("timedelta64[ns]").view("int64")
            mask = _merge_mask(mask, ns != np.iinfo(np.int64).min)
            return _upload(ns, mask, SqlType.INTERVAL_DAY_TIME, device)
        if kind in ("O", "U", "S"):
            return Column._encode_strings(arr, mask, device)
        if kind == "f":
            nan = np.isnan(arr)
            if nan.any():
                mask = _merge_mask(mask, ~nan)
        return _upload(arr, mask, np_to_sql(arr.dtype), device)

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
        return int(self.data.shape[0])

    def valid_mask(self) -> torch.Tensor:
        """Always-materialized validity mask."""
        if self.validity is None:
            return torch.ones(len(self), dtype=torch.bool, device=self.device)
        return self.validity

    def take(self, indices: torch.Tensor) -> "Column":
        validity = None if self.validity is None else self.validity[indices]
        return Column(self.data[indices], self.sql_type, validity,
                      self.dictionary)

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
        """Host decode of transferred buffers (mask = ~validity)."""
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


def _upload(values: np.ndarray, mask: Optional[np.ndarray], sql_type: SqlType,
            device) -> Column:
    data = _host_tensor(values).to(device)
    validity = None
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        if not mask.all():
            validity = _host_tensor(mask).to(device)
    return Column(data, sql_type, validity)
