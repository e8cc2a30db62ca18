"""DSQL703 — config-key registry coverage (the DSQL401 design for config).

Every string-literal key at a ``config.get("...")`` site must appear in
``config.py DOCUMENTED_KEYS`` (built from the commented DEFAULTS table):
a typo'd key never errors — it silently reads the fallback default for
the lifetime of the deployment, which is exactly how an unregistered
metric name silently splits a time series.  Receiver matching mirrors
DSQL401: any dotted receiver whose last segment is ``config``
(``config.get``, ``self.config.get``, ``executor.config.get``,
``ctx.config.get``) plus the materialize manager's ``self._cfg``
forwarder.  Dynamic keys (plain variables) make no claim — the runtime
half of the rule (``analysis.strict_config`` in config.py) covers them.

The repo-wide half reports *dead* registry keys: a documented key whose
literal appears in no source file outside config.py is configuration
nobody can reach — delete it or wire it up.  The occurrence scan is
textual on purpose: keys read through named constants
(``RETRY_AFTER_CAP_KEY = "serving.retry_after.cap_s"``) or listed in
docs-in-code tables still count as alive.  The dead-key pass only runs
when config.py itself is among the linted files, so linting a lone
synthetic module does not report the entire registry dead.

Suppress either direction with ``# dsql: allow-config-key``.

Copied from `dask_sql_tpu/analysis/configkeys.py`; the registry is the
port's `config.py`.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence

from .selflint import LintFinding, _SUPPRESS, _name_of, _suppressed

#: receiver last-segments that mean "the engine config" at a .get site
_CONFIG_RECEIVERS = {"config"}
#: same-class forwarders whose first argument is a config key
_CONFIG_WRAPPERS = {"_cfg"}

_CONFIG_FILE_SUFFIX = os.path.join("dask_sql_tpu_torch", "config.py")


def _literal_key(call: ast.Call) -> Optional[str]:
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


def _is_config_get(call: ast.Call) -> bool:
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "get":
        recv = _name_of(f.value)
        return recv is not None \
            and recv.split(".")[-1] in _CONFIG_RECEIVERS
    if f.attr in _CONFIG_WRAPPERS:
        return isinstance(f.value, ast.Name) and f.value.id == "self"
    return False


def config_key_findings(tree: ast.AST, path: str,
                        lines: Sequence[str]) -> List[LintFinding]:
    """Per-file half: literal ``config.get`` keys must be registered."""
    from ..config import is_documented_key

    if path.endswith(_CONFIG_FILE_SUFFIX):
        return []  # the registry's own module (fallback plumbing)
    out: List[LintFinding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not _is_config_get(node):
            continue
        key = _literal_key(node)
        if key is None or is_documented_key(key):
            continue
        if _suppressed(lines, node.lineno, "DSQL703"):
            continue
        out.append(LintFinding(
            "DSQL703", path, node.lineno,
            f"config key {key!r} is not in config.py DOCUMENTED_KEYS; a "
            f"typo here silently reads the fallback default forever — "
            f"register the key with a default and type or annotate "
            f"`# {_SUPPRESS['DSQL703']}`"))
    return out


def _key_mentioned(key: str, sources: Sequence[str]) -> bool:
    """True when any source mentions the key literally, or reads its
    family through an f-string (``config.get(f"parallel.spmd.{short}")``
    keeps every ``parallel.spmd.*`` key alive) — the DSQL401 prefix
    mechanism, done textually."""
    needles = [f'"{key}"', f"'{key}'"]
    idx = key.find(".")
    while idx != -1:
        prefix = key[: idx + 1]
        needles.append(f'"{prefix}{{')
        needles.append(f"'{prefix}{{")
        idx = key.find(".", idx + 1)
    return any(n in src for src in sources for n in needles)


def dead_config_key_findings(
        sources: Dict[str, str]) -> List[LintFinding]:
    """Repo-wide half: registered keys no source ever mentions are dead.
    Anchored at the key's line in config.py so the suppression (and its
    reason) lives next to the registry row it keeps."""
    from ..config import DOCUMENTED_KEYS

    config_path = next(
        (p for p in sources if p.endswith(_CONFIG_FILE_SUFFIX)), None)
    if config_path is None:
        return []
    config_lines = sources[config_path].splitlines()
    others = [src for p, src in sources.items() if p != config_path]

    out: List[LintFinding] = []
    for key in sorted(DOCUMENTED_KEYS):
        if _key_mentioned(key, others):
            continue
        needle_d, needle_s = f'"{key}"', f"'{key}'"
        line = next(
            (i + 1 for i, text in enumerate(config_lines)
             if needle_d in text or needle_s in text), 0)
        # same-line suppression ONLY: registry rows are annotated with
        # trailing comments, and the generic line-above rule would let
        # one row's annotation silently cover its neighbour below
        if line and _SUPPRESS["DSQL703"] in config_lines[line - 1]:
            continue
        out.append(LintFinding(
            "DSQL703", config_path, line,
            f"registered config key {key!r} is read by no source file — "
            f"dead configuration; delete the registry row or wire it up "
            f"(suppress a deliberately-reserved key with "
            f"`# {_SUPPRESS['DSQL703']}`)"))
    return out
