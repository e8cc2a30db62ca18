"""Columnar table of the PyTorch port: named Columns on one explicit device.

Counterpart of `dask_sql_tpu/columnar/table.py` for unpadded, PLAIN tables.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .column import Column
from .dtypes import SqlType


def normalize_device(device) -> torch.device:
    """A torch.device with its index: tensors on "cuda" report "cuda:N"."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Table:
    __slots__ = ("columns", "_num_rows", "device")

    def __init__(self, columns: Dict[str, Column], num_rows: Optional[int] = None,
                 device=None):
        self.columns: Dict[str, Column] = dict(columns)
        if num_rows is None:
            num_rows = len(next(iter(self.columns.values()))) if self.columns else 0
        self._num_rows = num_rows
        if device is None:
            device = (next(iter(self.columns.values())).device if self.columns
                      else torch.device("cpu"))
        self.device = normalize_device(device)
        for name, col in self.columns.items():
            if len(col) != num_rows:
                raise ValueError(f"column {name}: {len(col)} rows != {num_rows}")
            if col.device != self.device:
                raise ValueError(f"column {name} on {col.device}, table on {self.device}")

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_pandas(df, device="cpu") -> "Table":
        """Same dtype rules as the reference's pandas ingest
        (`Table.from_pandas` there, minus the load-time encodings)."""
        cols = {}
        for name in df.columns:
            ser = df[name]
            isna = ser.isna()
            mask = ~isna.to_numpy() if isna.any() else None
            values = ser.to_numpy()
            if str(ser.dtype) in ("string", "str") or ser.dtype == object \
                    or values.dtype.kind not in ("O", "U", "S", "M", "m", "f",
                                                 "i", "u", "b"):
                values = ser.astype(object).to_numpy()
            cols[str(name)] = Column.from_numpy(values, mask, device=device)
        return Table(cols, len(df), device)

    @staticmethod
    def from_numpy_columns(columns: Dict[str, Tuple[np.ndarray, Optional[np.ndarray],
                                                    Optional[np.ndarray], str]],
                           device="cpu") -> "Table":
        """A table from stored column parts, per name ``(values, validity,
        dictionary, SQL type name)``: values are the codes for strings and
        int64 epoch-ns for datetimes; validity and dictionary may be None."""
        cols = {name: Column.from_parts(v, m, d, SqlType(t), device)
                for name, (v, m, d, t) in columns.items()}
        n = len(next(iter(cols.values()))) if cols else 0
        return Table(cols, n, device)

    # -- basic properties ---------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def column_names(self) -> List[str]:
        return list(self.columns.keys())

    def __len__(self) -> int:
        return self._num_rows

    # -- transformations (all return new Tables) ----------------------------
    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.columns[n] for n in names}, self._num_rows,
                     self.device)

    def take(self, indices: torch.Tensor) -> "Table":
        indices = torch.as_tensor(indices, device=self.device)
        return Table({n: c.take(indices) for n, c in self.columns.items()},
                     int(indices.shape[0]), self.device)

    def slice(self, start: int, stop: int) -> "Table":
        stop = min(stop, self._num_rows)
        start = min(start, stop)
        cols = {}
        for n, c in self.columns.items():
            v = None if c.validity is None else c.validity[start:stop]
            cols[n] = Column(c.data[start:stop], c.sql_type, v, c.dictionary)
        return Table(cols, stop - start, self.device)

    def filter(self, mask: torch.Tensor) -> "Table":
        return self.take(torch.nonzero(mask).flatten())

    # -- host materialization ----------------------------------------------
    def to_pandas(self):
        import pandas as pd

        if not self.columns:
            return pd.DataFrame(index=range(self._num_rows))
        return pd.DataFrame({n: c.to_numpy() for n, c in self.columns.items()})

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.sql_type.value}" for n, c in self.columns.items())
        return f"Table[{self._num_rows} rows on {self.device}]({cols})"
