"""Compiled in-plan inference: CREATE MODEL artifacts as tensor programs.

Counterpart of `dask_sql_tpu/inference/`, over torch tensors on the
Context's device.

Two halves (docs/ml.md):

- `programs`  — the model -> tensor-program compiler (`try_lower`):
                linear/logistic/StandardScaler as matmul+bias, KMeans as
                distance-argmin, and fitted sklearn tree ensembles lowered
                into split matrices navigated by vectorized
                gather/compare (arXiv:2306.08367, arXiv:2009.00524);
- `registry`  — the per-context serving discipline: device-resident
                params, lazy lowering with swap detection
                (``model.lower`` / ``model.swap`` flight events,
                ``inference.*`` metrics), card-byte ledger accounting
                (``serving.ledger.model_bytes``), and the SHOW MODELS /
                DESCRIBE MODEL lowering verdicts.

The fused execution rung lives in physical/compiled_predict.py: it runs
the PREDICT input's scan->filter->project body as the compiled select's two
programs and applies the model program inside the gather program, model
params entering as runtime arguments — one cached pipeline per (plan
family, model shape), a retrain swaps weights with no build.
"""
from .programs import MAX_TREE_DEPTH, MAX_TREE_NODES, ModelProgram, try_lower
from .registry import (
    context_model_bytes,
    invalidate,
    lowering_verdict,
    predict_scratch_bytes,
    program_for,
)

__all__ = [
    "MAX_TREE_DEPTH",
    "MAX_TREE_NODES",
    "ModelProgram",
    "context_model_bytes",
    "invalidate",
    "lowering_verdict",
    "predict_scratch_bytes",
    "program_for",
    "try_lower",
]
