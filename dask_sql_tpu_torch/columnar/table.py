"""Columnar table of the PyTorch port: named Columns on one explicit device.

Counterpart of `dask_sql_tpu/columnar/table.py` for unpadded tables.
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
    def from_pandas(df, device="cpu", encode=None) -> "Table":
        """Same dtype rules as the reference's pandas ingest.  ``encode``:
        load-time compressed encodings (columnar/encodings.py): None
        consults the registration load scope and its config, True runs the
        heuristics anyway, False stays dense."""
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
            cols[str(name)] = Column.from_numpy(values, mask, device=device,
                                                encode=encode)
        return Table(cols, len(df), device)

    @staticmethod
    def from_arrow(arrow_table, device="cpu") -> "Table":
        from . import interop

        return interop.arrow_to_table(arrow_table, device)

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

    def decode(self) -> "Table":
        """Every encoded column as PLAIN (the eager operators' view);
        identity when nothing is encoded."""
        if not self.has_encoded_columns():
            return self
        return Table({n: c.decode() for n, c in self.columns.items()},
                     self._num_rows, self.device)

    def has_encoded_columns(self) -> bool:
        from .encodings import Encoding

        return any(c.encoding is not Encoding.PLAIN
                   for c in self.columns.values())

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
        return Table({n: c.slice(start, stop) for n, c in self.columns.items()},
                     stop - start, self.device)

    def to(self, device) -> "Table":
        """The table with every buffer on `device` (identity when there)."""
        device = normalize_device(device)
        if device == self.device:
            return self
        return Table({n: c.to(device) for n, c in self.columns.items()},
                     self._num_rows, device)

    def filter(self, mask: torch.Tensor) -> "Table":
        # one nonzero for the whole table, then a gather per column
        return self.take(torch.nonzero(mask).flatten())

    # -- host materialization ----------------------------------------------
    def to_pandas(self):
        import pandas as pd

        data = self._host_columns()
        if not data:
            return pd.DataFrame(index=range(self._num_rows))
        return pd.DataFrame(data)

    def _host_columns(self, packed: Optional[bool] = None):
        """{name: numpy} with NULLs decoded.  On an accelerator (or with
        ``packed=True``) every buffer rides ONE packed transfer
        (`columnar/pack.py`): encoded columns cross as their codes and
        decode on the host.  On the CPU each column converts in place."""
        cols = self.columns
        if packed is None:
            packed = self.device.type != "cpu"
        if not cols or self._num_rows == 0 or not packed:
            return {n: c.to_numpy() for n, c in cols.items()}
        from .pack import packed_host_arrays

        bufs = []
        for c in cols.values():
            bufs.append(c.data)
            if c.validity is not None:
                bufs.append(c.validity)
        host = packed_host_arrays(bufs)
        if host is None:
            return {n: c.to_numpy() for n, c in cols.items()}
        out = {}
        i = 0
        for n, c in cols.items():
            data = host[i]
            i += 1
            mask = None
            if c.validity is not None:
                mask = ~host[i]
                i += 1
            out[n] = c.decode_host(data, mask)
        return out

    def to_arrow(self):
        from . import interop

        return interop.table_to_arrow(self)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.sql_type.value}" for n, c in self.columns.items())
        return f"Table[{self._num_rows} rows on {self.device}]({cols})"
