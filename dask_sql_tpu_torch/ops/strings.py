"""SQL string patterns as Python regular expressions, the per-value string
functions, and the merge of string dictionaries.

Copied from `like_to_regex` and `similar_to_regex` of
`dask_sql_tpu/ops/strings.py` (pure `re`), and the per-value functions of
`dask_sql_tpu/physical/rex/operations.py` (`_op_substring`,
`_overlay_one`, `_split_one`, `_left_one`, `_right_one`, `_pad_one`, the
INITCAP and TRIM lambdas).  The evaluator applies them to a column's host
dictionary once and gathers the answer by the codes on the device
(`physical/rex/operations.py`, the counterpart of the reference's
`map_unary` and `map_unary_value`), or to the distinct argument tuples of
the rows where an argument varies by row.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def merge_dictionaries(parts: Sequence[Tuple[Optional[np.ndarray],
                                             torch.Tensor]]
                       ) -> Tuple[np.ndarray, List[torch.Tensor]]:
    """String ``(dictionary, codes)`` parts in one merged dictionary,
    sorted and unique, so that code order stays string order: (merged
    dictionary, each part's codes in it).  A missing or empty dictionary
    counts as ``[""]``."""
    dicts = [np.asarray(d if d is not None and len(d) else [""], dtype=object)
             for d, _ in parts]
    merged = np.unique(np.concatenate([d.astype(str) for d in dicts]))
    out = []
    for d, (_, codes) in zip(dicts, parts):
        remap = torch.from_numpy(np.searchsorted(merged, d.astype(str))
                                 .astype(np.int32)).to(codes.device)
        out.append(remap[torch.clamp(codes, 0, len(d) - 1)])
    return merged.astype(object), out


def like_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    """Translate SQL LIKE pattern to an anchored python regex."""
    out = []
    i = 0
    esc = escape if escape else None
    while i < len(pattern):
        ch = pattern[i]
        if esc and ch == esc and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


def similar_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    """SQL SIMILAR TO: regex-ish with %/_ wildcards kept as SQL."""
    out = []
    i = 0
    esc = escape if escape else None
    while i < len(pattern):
        ch = pattern[i]
        if esc and ch == esc and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(ch)  # keep regex metacharacters
        i += 1
    return "^" + "".join(out) + "$"


def substring(x: str, start: int, length: Optional[int] = None) -> str:
    """SQL SUBSTRING(x FROM start [FOR length]): 1-based start, a
    non-positive start counts from the end (as the reference), a negative
    length gives the empty string."""
    begin = max(start - 1, 0) if start > 0 else \
        max(len(x) + start, 0) if start < 0 else 0
    if length is None:
        return x[begin:]
    return x[begin: begin + max(length, 0)] if length >= 0 else ""


def overlay(x: str, r: str, s: int, ln: Optional[int]) -> str:
    """OVERLAY(x PLACING r FROM s [FOR ln])."""
    begin = int(s) - 1
    ln = len(r) if ln is None else int(ln)
    return x[:begin] + r + x[begin + ln:]


def split_part(x: str, d: str, k: int) -> str:
    """SPLIT_PART(x, d, k): the k-th (1-based) field, or the empty string."""
    parts = x.split(d)
    return parts[k - 1] if 1 <= k <= len(parts) else ""


def left(x: str, k: int) -> str:
    return x[:k] if k >= 0 else x[: max(len(x) + k, 0)]


def right(x: str, k: int) -> str:
    if k == 0:
        return ""
    return x[-k:] if k > 0 else x[min(-k, len(x)):]


def repeat(x: str, k: int) -> str:
    return x * max(k, 0)


def pad(x: str, k: int, c: str, on_left: bool) -> str:
    """LPAD / RPAD to length k with the fill string c (a space if empty);
    a longer string is cut to k."""
    if not c:
        c = " "
    if on_left:
        return (c * k + x)[-k:] if len(x) < k else x[:k]
    return (x + c * k)[:k]


def initcap(x: str) -> str:
    return re.sub(r"[a-zA-Z]+", lambda m: m.group(0).capitalize(), x)


#: TRIM's three forms, by the evaluator's op name
TRIMS = {"btrim": str.strip, "ltrim": str.lstrip, "rtrim": str.rstrip}
