"""Finding records of the plan verifier.

Copied from `dask_sql_tpu/analysis/findings.py`.  Import-light on purpose
(no planner imports).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet

SEV_ERROR = "error"  # engine inconsistency: raises taxonomy PlanError at bind
SEV_WARN = "warn"    # statically-doomed rung / suspect construct; strict raises
SEV_INFO = "info"    # advisory (shape buckets, recompile hazards)

_SEV_ORDER = {SEV_ERROR: 0, SEV_WARN: 1, SEV_INFO: 2}


@dataclass(frozen=True)
class Finding:
    """One plan-verifier finding, displayed by ``EXPLAIN LINT``."""

    rule: str       # stable rule id, e.g. "dtype-mismatch", "radix-overflow"
    severity: str   # SEV_ERROR | SEV_WARN | SEV_INFO
    node: str       # plan node label the finding anchors to
    message: str
    #: compiled ladder rungs this finding proves doomed (skipped, not attempted)
    rungs: FrozenSet[str] = field(default_factory=frozenset)

    def format(self) -> str:
        return f"{self.severity}[{self.rule}] {self.node}: {self.message}"


def sort_findings(findings):
    return sorted(findings, key=lambda f: (_SEV_ORDER.get(f.severity, 9),
                                           f.rule, f.node, f.message))
