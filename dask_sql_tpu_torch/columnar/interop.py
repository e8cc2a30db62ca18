"""Arrow <-> Table conversion.

Counterpart of `dask_sql_tpu/columnar/interop.py`: pyarrow -> numpy ->
torch tensors on the table's device, Arrow dictionary arrays mapping onto
the dictionary-encoded string columns.  ``pyarrow`` is imported inside the
functions only: the port runs without it wherever no Arrow data is read.
"""
from __future__ import annotations

import numpy as np
import torch

from .column import Column, _upload_mask
from .dtypes import STRING_TYPES, SqlType
from .table import Table


def arrow_to_table(at, device="cpu") -> Table:
    import pyarrow as pa

    cols = {}
    for name, col in zip(at.column_names, at.columns):
        arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        cols[name] = _arrow_array_to_column(arr, device)
    return Table(cols, at.num_rows, device)


def _arrow_array_to_column(arr, device) -> Column:
    import pyarrow as pa
    import pyarrow.compute as pc

    mask = None
    if arr.null_count:
        mask = np.asarray(pc.is_valid(arr))
    t = arr.type
    if pa.types.is_dictionary(t):
        codes = np.asarray(arr.indices.fill_null(0)).astype(np.int32)
        uniques = np.asarray(arr.dictionary.to_pylist(), dtype=object)
        if len(uniques) == 0:
            uniques = np.array([""], dtype=object)
        return Column(torch.from_numpy(codes).to(device), SqlType.VARCHAR,
                      _upload_mask(mask, device), uniques)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return _arrow_array_to_column(pc.dictionary_encode(arr), device)
    if pa.types.is_timestamp(t) or pa.types.is_date(t):
        ns = np.asarray(arr.cast(pa.timestamp("ns")).fill_null(0)).astype(
            "datetime64[ns]").view(np.int64)
        return _build(ns, mask, SqlType.DATE if pa.types.is_date(t)
                      else SqlType.TIMESTAMP, device)
    if pa.types.is_decimal(t):
        vals = np.asarray(arr.cast(pa.float64()).fill_null(0.0))
        return _build(vals, mask, SqlType.DECIMAL, device)
    if pa.types.is_boolean(t):
        vals = np.asarray(arr.fill_null(False))
        return Column(torch.from_numpy(vals).to(device), SqlType.BOOLEAN,
                      _upload_mask(mask, device))
    vals = np.asarray(arr.fill_null(0)) if arr.null_count else np.asarray(arr)
    return Column.from_numpy(vals, mask, device=device)


def _build(vals, mask, sql_type, device) -> Column:
    """A column from a host array already in the device representation;
    the load scope may pick a compressed encoding (columnar/encodings.py)."""
    from .column import _upload
    from .encodings import maybe_encode

    col = maybe_encode(vals, mask, sql_type, device=device)
    if col is not None:
        return col
    return _upload(vals, mask, sql_type, device)


def table_to_arrow(table: Table):
    import pyarrow as pa

    arrays, names = [], []
    for name, col in table.columns.items():
        names.append(name)
        if col.sql_type in STRING_TYPES:
            codes = col.data.cpu().numpy()
            d = col.dictionary if col.dictionary is not None \
                else np.array([""], dtype=object)
            codes = np.clip(codes, 0, len(d) - 1).astype(np.int32)
            valid = None if col.validity is None else col.validity.cpu().numpy()
            ind = pa.array(codes, mask=None if valid is None else ~valid)
            arrays.append(pa.DictionaryArray.from_arrays(ind, pa.array(d.astype(str))))
        else:
            arrays.append(pa.array(col.to_numpy()))
    return pa.table(arrays, names=names)
