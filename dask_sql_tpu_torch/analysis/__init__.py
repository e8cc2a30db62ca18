"""Static analysis of bound plans: the plan verifier and the cost and
memory estimator.

Counterpart of `dask_sql_tpu/analysis/__init__.py`:

- **Plan verifier** (`verifier.py`): an independent re-inference of every
  plan node's output schema (names, dtype categories, nullability, shape
  buckets) cross-checked against what the bound plan declares.
  Inconsistencies raise a taxonomy ``PlanError`` at bind time; compiled
  rungs doomed by a radix-domain overflow of the ``1 << 22`` gate are
  marked on the plan, so the degradation ladder skips them without an
  attempt.  ``EXPLAIN LINT`` shows the findings.
- **Cost and memory estimator** (`estimator.py`): a bottom-up abstract
  interpreter of cardinality and byte intervals per node, with a provable
  lower bound and a conservative upper bound on peak device bytes.
  ``EXPLAIN ESTIMATE`` shows it; budget proofs pre-skip compiled rungs.
- **Engine self-lint** (`selflint.py`, `concurrency.py`, `dataflow.py`,
  `effects.py`, `configkeys.py`): an AST analyzer over the port's own
  source (``python -m dask_sql_tpu_torch.analysis --self``) with the
  reference's rules DSQL101-703: broad exception handlers, lock coverage,
  host syncs on a compiled pipeline's run path, metric, flight-event and
  config-key registry drift, lock-order cycles, blocking calls under a
  lock, the ``_locked`` suffix, paired effects released on every path and
  bare exceptions escaping a serving boundary.
"""
from .estimator import (
    Interval,
    PlanEstimate,
    estimate_and_apply,
    estimate_plan,
)
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARN
from .selflint import LintFinding, RULES, lint_paths, self_lint
from .verifier import (
    PlanVerdict,
    RADIX_DOMAIN_LIMIT,
    check_plan,
    verify_and_apply,
    verify_plan,
)

__all__ = [
    "Finding",
    "Interval",
    "LintFinding",
    "PlanEstimate",
    "PlanVerdict",
    "RADIX_DOMAIN_LIMIT",
    "RULES",
    "SEV_ERROR",
    "SEV_INFO",
    "SEV_WARN",
    "check_plan",
    "estimate_and_apply",
    "estimate_plan",
    "lint_paths",
    "self_lint",
    "verify_and_apply",
    "verify_plan",
]
