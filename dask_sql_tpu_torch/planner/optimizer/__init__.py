"""Logical plan optimizer driver.

Copied from `dask_sql_tpu/planner/optimizer/__init__.py`; only import paths differ.

Role parity: reference src/sql/optimizer.rs (19-rule DataFusion pipeline,
optimizer.rs:53-98) + preoptimizer.rs.  Rules live in `rules.py`; JoinReorder
in `join_reorder.py`; DynamicPartitionPruning in `dpp.py`.
"""
from __future__ import annotations

from .driver import optimize_plan

__all__ = ["optimize_plan"]
