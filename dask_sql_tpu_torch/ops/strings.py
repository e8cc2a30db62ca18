"""SQL string patterns as Python regular expressions, and SUBSTRING.

Copied from `like_to_regex` and `similar_to_regex` of
`dask_sql_tpu/ops/strings.py` (pure `re`), and the per-value SUBSTRING of
`dask_sql_tpu/physical/rex/operations.py` `_op_substring`.  The evaluator
applies them to a column's host dictionary once and gathers the answer by
the codes on the device (`physical/compiled.py` `_TraceEval`); the rest of
the reference's string operations is not in the port yet.
"""
from __future__ import annotations

import re
from typing import Optional


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
