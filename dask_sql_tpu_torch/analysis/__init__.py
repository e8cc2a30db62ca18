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

The reference's engine self-lint (`selflint.py`, `concurrency.py`,
`dataflow.py`, `effects.py`, `configkeys.py`, `__main__.py`) waits for
ROADMAP.md Queue 1 item 8: its DSQL401/501 rules read the serving-metric
and flight-event registries.
"""
from .estimator import (
    Interval,
    PlanEstimate,
    estimate_and_apply,
    estimate_plan,
)
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARN
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
    "PlanEstimate",
    "PlanVerdict",
    "RADIX_DOMAIN_LIMIT",
    "SEV_ERROR",
    "SEV_INFO",
    "SEV_WARN",
    "check_plan",
    "estimate_and_apply",
    "estimate_plan",
    "verify_and_apply",
    "verify_plan",
]
