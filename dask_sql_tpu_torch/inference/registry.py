"""Per-context lowered-model registry: device-resident programs, swap
detection, ledger accounting.

Counterpart of `dask_sql_tpu/inference/registry.py`: params commit to the
Context's device with ``torch.as_tensor`` and are sized by
``Tensor.nbytes``, with no device-to-host copy.

`programs.try_lower` is pure; this module gives the Context the serving
discipline around it:

- one lowering per registered model object — the verdict (program or
  decline reason) is cached on ``context._model_programs`` keyed by
  ``(schema, name)`` and invalidated by re-registration / DROP MODEL; the
  entry holds the model object itself (a bare ``id()`` could be reused by
  a later allocation and silently serve a stale program);
- params are committed to the device once (``torch.as_tensor``) on
  FIRST fused use, so PREDICT launches pass device-resident weights
  instead of re-uploading — the bytes surface in the card-byte ledger as
  ``serving.ledger.model_bytes``.  Advisory readers (SHOW MODELS,
  DESCRIBE MODEL, the estimator) lower WITHOUT committing: a catalog
  statement must not consume card memory for models that never PREDICT;
- a re-registered model (retrain, ``CREATE OR REPLACE MODEL``) re-lowers
  on first use; when the new program's ``shape_key`` matches the old one
  the swap builds nothing (the compiled-predict pipeline keys on the
  shape, weights are runtime args) and is recorded as a ``model.swap``
  flight event + ``inference.model.swap`` metric; a shape change is just a
  fresh ``model.lower``;
- everything is failure-isolated: a lowering bug declines the model to
  the host path, never fails the query.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..runtime import locks
from .programs import ModelProgram, try_lower, walk_bytes_per_row

logger = logging.getLogger(__name__)

#: registry value: (model_object, program_or_None, reason, committed).
#: The model object is held strongly so identity stays valid — the entry
#: is replaced on next use after a swap and dropped by `invalidate`.
_Entry = Tuple[Any, Optional[ModelProgram], str, bool]

# rank 70: the publish lock.  Lowering AND the h2d weight commit run
# OUTSIDE it (see program_for) — only dict publishes happen under it,
# so it nests safely inside any serving/fleet lock
_lock = locks.named_lock("inference.registry")


def _registry(context) -> Dict[Tuple[str, str], _Entry]:
    reg = getattr(context, "_model_programs", None)
    if reg is None:
        reg = context._model_programs = {}
    return reg


def _commit(program: ModelProgram, device) -> ModelProgram:
    """Move the params to ``device`` once; later PREDICT launches pass
    the committed tensors (no per-query h2d of model weights)."""
    import dataclasses

    return dataclasses.replace(
        program, params=tuple(torch.as_tensor(p, device=device)
                              for p in program.params))


def _host(p):
    """A committed param back on the host, as numpy."""
    if isinstance(p, torch.Tensor):
        # dsql: allow-host-sync — a de-commit (pressure reclaim), not a run
        return p.cpu().numpy()
    return np.asarray(p)


def _stamp_use(context, key: Tuple[str, str]) -> None:
    """Record a fused (committing) use — the idleness signal
    `reclaim_idle_models` reads.  Plain dict assignment is GIL-atomic; the
    stamp is advisory, so a torn read only delays one reclaim."""
    uses = getattr(context, "_model_last_use", None)
    if uses is None:
        uses = context._model_last_use = {}
    uses[key] = time.monotonic()


def _still_registered(context, schema_name: str, name: str, model) -> bool:
    """A DROP MODEL (or replacement) racing a lowering must not let the
    lowering re-insert an entry for the gone object — it would pin
    committed weights the ledger charges with no DROP left to evict
    them."""
    try:
        entry = context.schema[schema_name].models.get(name)
    except Exception:  # dsql: allow-broad-except — a torn schema read is
        # a "not registered" verdict, never a query error
        return False
    return entry is not None and entry[0] is model


def program_for(context, schema_name: str, name: str, model: Any,
                commit: bool = False) -> Tuple[Optional[ModelProgram], str]:
    """``(program, reason)`` for a registered model, lowering on first use
    and re-lowering when the registered object changed (model swap).

    ``commit=True`` (the fused rung) moves the params to device on first
    use and keeps the committed pytree cached; advisory callers (SHOW
    MODELS / DESCRIBE MODEL / the estimator) leave the params host-side
    so catalog statements never consume card memory.  Lowering AND the
    h2d commit both run outside ``_lock`` — the lock only publishes — so
    a large ensemble upload never blocks other models' lowerings or the
    ledger scrape."""
    reg = _registry(context)
    key = (schema_name, name)
    metrics = getattr(context, "metrics", None)
    if commit:
        _stamp_use(context, key)
    with _lock:
        entry = reg.get(key)
    if entry is not None and entry[0] is model:
        _model, program, reason, committed = entry
        if not commit or committed or program is None:
            return program, reason
        # h2d outside the lock; the charge is custodied by the registry
        # entry — DROP MODEL / reclaim_idle_models drops the reference and
        # the scrape-based ledger self-corrects
        # dsql: allow-unpaired-effect — registry-entry custody
        program = _commit(program, context.device)
        with _lock:
            cur = reg.get(key)
            if cur is not None and cur[0] is model and cur[3]:
                return cur[1], cur[2]  # another thread committed first
            if _still_registered(context, schema_name, name, model):
                reg[key] = (model, program, reason, True)
        return program, reason
    program, reason = try_lower(model)
    if program is not None and commit:
        # dsql: allow-unpaired-effect — registry-entry custody (above)
        program = _commit(program, context.device)
    from ..observability import flight

    inserted = False
    with _lock:
        prior = reg.get(key)
        if prior is not None and prior[0] is model:
            # two threads raced the same first lowering (e.g. the advisory
            # estimator vs the committing fused rung): keep the richer
            # entry — never let an uncommitted write demote a committed
            # one (the ledger would under-report) — and emit nothing (the
            # first writer already recorded the model.lower)
            if not (commit and program is not None) or prior[3]:
                return prior[1], prior[2]
            if _still_registered(context, schema_name, name, model):
                reg[key] = (model, program, reason, True)
            return program, reason
        if _still_registered(context, schema_name, name, model):
            reg[key] = (model, program, reason,
                        commit and program is not None)
            inserted = True
    if not inserted:
        # dropped (or replaced) mid-lowering: serve this caller, cache and
        # record nothing — there is no DROP left to evict an entry
        return program, reason
    swapped = prior is not None and prior[0] is not model
    if swapped and program is not None and prior[1] is not None \
            and prior[1].shape_key == program.shape_key:
        # same hyper-shape: the compiled-predict pipeline keyed on the
        # shape serves the NEW weights with no build
        if metrics is not None:
            metrics.inc("inference.model.swap")
        flight.record("model.swap", model=f"{schema_name}.{name}",
                      kind=program.kind,
                      param_bytes=program.param_bytes)
    else:
        if metrics is not None:
            metrics.inc("inference.model.lowered" if program is not None
                        else "inference.model.declined")
        flight.record("model.lower", model=f"{schema_name}.{name}",
                      tier="compiled" if program is not None else "host",
                      kind=program.kind if program is not None else None,
                      reason=None if program is not None else reason,
                      param_bytes=program.param_bytes
                      if program is not None else None)
    return program, reason


def invalidate(context, schema_name: str, name: str) -> None:
    """Drop a cached lowering (re-registration / DROP MODEL): the next use
    re-lowers against the current model object; the ledger stops charging
    the dropped params, and the fused-rung pipeline cache evicts the
    model's pipelines."""
    reg = getattr(context, "_model_programs", None)
    if reg is None:
        return
    with _lock:
        reg.pop((schema_name, name), None)
    from ..physical.compiled_predict import drop_model_pipelines

    drop_model_pipelines(context, schema_name, name)


def reclaim_idle_models(context, idle_s: float = 120.0,
                        bytes_needed: Optional[int] = None) -> int:
    """Pressure reclaim (resilience/pressure.py, tier 3 of the cross-tier
    walk): de-commit committed model params whose last fused use is at
    least ``idle_s`` seconds old.  The params move back to host numpy —
    the next PREDICT re-commits them (the compiled-predict pipeline keys
    on the shape, weights are runtime args) — and the model's
    pipeline-cache entries are dropped.  Returns device bytes freed; stops early once
    ``bytes_needed`` is met.  Models with a fresh stamp are hot (actively
    serving fused PREDICTs) and are never touched."""
    import dataclasses

    reg = getattr(context, "_model_programs", None)
    if not reg:
        return 0
    uses = getattr(context, "_model_last_use", {}) or {}
    now = time.monotonic()
    freed = 0
    with _lock:
        entries = list(reg.items())
    for key, (model, program, reason, committed) in entries:
        if bytes_needed is not None and freed >= bytes_needed:
            break
        if program is None or not committed:
            continue
        last = uses.get(key)
        if last is not None and now - last < idle_s:
            continue
        demoted = dataclasses.replace(
            program, params=tuple(_host(p) for p in program.params))
        with _lock:
            cur = reg.get(key)
            if cur is None or cur[0] is not model or not cur[3]:
                continue  # raced a swap / drop / concurrent reclaim
            reg[key] = (model, demoted, reason, False)
        freed += int(program.param_bytes)
        from ..physical.compiled_predict import drop_model_pipelines

        drop_model_pipelines(context, key[0], key[1])
        logger.info("pressure reclaim de-committed idle model %s.%s "
                    "(%d bytes)", key[0], key[1], program.param_bytes)
    return freed


def context_model_bytes(context) -> int:
    """Device bytes of every lowered model's committed params — the
    card-byte ledger's ``serving.ledger.model_bytes`` component.
    Uncommitted lowerings (advisory verdicts that never served a fused
    PREDICT) hold no device memory and are not charged."""
    reg = getattr(context, "_model_programs", None)
    if not reg:
        return 0
    with _lock:
        entries = list(reg.values())
    total = 0
    for _, program, _, committed in entries:
        if program is not None and committed:
            try:
                total += program.param_bytes
            except Exception:  # dsql: allow-broad-except — advisory
                # accounting must never fail a metrics scrape
                logger.debug("model byte accounting failed", exc_info=True)
    return total


def lowering_verdict(context, schema_name: str, name: str
                     ) -> Dict[str, str]:
    """SHOW MODELS / DESCRIBE MODEL verdict row for one registered model:
    serving tier, device param bytes, and the program's shape summary (or
    the decline reason).  Failure-isolated — unknown models report the
    host tier."""
    try:
        model, _cols = context.get_model(schema_name, name)
        program, reason = program_for(context, schema_name, name, model)
    except Exception:  # dsql: allow-broad-except — a broken model entry
        # must not sink catalog statements
        logger.debug("lowering verdict failed", exc_info=True)
        return {"tier": "host", "param_bytes": "", "shape": ""}
    if program is None:
        return {"tier": "host", "param_bytes": "", "shape": reason}
    return {"tier": "compiled",
            "param_bytes": str(program.param_bytes),
            "shape": program.describe()}


def predict_scratch_bytes(program: Optional[ModelProgram],
                          n_features: int) -> int:
    """Per-row device intermediate bytes of one fused PREDICT: the f64
    feature matrix plus, for tree programs, the (row, tree)-shaped
    navigation/leaf buffers.  The reference charges an int32 node and an
    f64 value a tree [+ f64 per class for probability leaves], an XLA
    fusion's footprint; the port's eager walk holds more at its peak
    (`programs.walk_bytes_per_row`), and the larger of the two is charged
    (ROADMAP.md, divergences).  The estimator multiplies by the padded row
    bucket to charge ``peak_bytes``."""
    per_row = 8 * max(int(n_features), 1)
    if program is None:
        return per_row
    trees = int(program.meta.get("trees", 0))
    if trees:
        per_row += trees * 12
        if program.kind in ("tree_classifier", "forest_classifier"):
            per_row += trees * 8 * int(program.meta.get("classes", 1))
        per_row = max(per_row, walk_bytes_per_row(program, n_features))
    return per_row
