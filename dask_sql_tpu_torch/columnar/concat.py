"""Vertical concatenation of Tables (the UNION ALL primitive).

Counterpart of `dask_sql_tpu/columnar/concat.py` on torch tensors.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .column import Column
from .dtypes import STRING_TYPES, promote
from .table import Table


def concat_columns(cols: Sequence[Column]) -> Column:
    """Concatenate columns, promoting types and merging string dictionaries."""
    # codes of different tables live in different code spaces: decode first
    # (identity for PLAIN; strings keep their dictionaries)
    cols = [c.decode() for c in cols]
    target = cols[0].sql_type
    for c in cols[1:]:
        target = promote(target, c.sql_type)
    cols = [c.cast(target) for c in cols]
    device = cols[0].device
    if target in STRING_TYPES:
        # one merged dictionary; each block's codes remapped into it
        dicts = [c.dictionary if c.dictionary is not None
                 else np.array([], dtype=object) for c in cols]
        merged = np.unique(np.concatenate([d.astype(str) for d in dicts]))
        if len(merged) == 0:
            merged = np.array([""], dtype=str)
        parts = []
        for c, d in zip(cols, dicts):
            if len(d) == 0:
                parts.append(torch.zeros(len(c), dtype=torch.int32,
                                         device=device))
                continue
            remap = torch.from_numpy(np.searchsorted(
                merged, d.astype(str)).astype(np.int32)).to(device)
            parts.append(remap[torch.clamp(c.data, 0, len(d) - 1)])
        return Column(torch.cat(parts), target, _concat_validity(cols),
                      merged.astype(object))
    return Column(torch.cat([c.data for c in cols]), target,
                  _concat_validity(cols))


def _concat_validity(cols: Sequence[Column]):
    if all(c.validity is None for c in cols):
        return None
    return torch.cat([c.valid_mask() for c in cols])


def concat_tables(tables: Sequence[Table]) -> Table:
    if len(tables) == 1:
        return tables[0]
    names = tables[0].column_names
    out = {}
    for i, name in enumerate(names):
        # positional alignment (SQL UNION), names from the first table
        cols = [t.columns[t.column_names[i]] for t in tables]
        out[name] = concat_columns(cols)
    return Table(out, sum(t.num_rows for t in tables), tables[0].device)
