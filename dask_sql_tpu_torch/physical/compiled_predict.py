"""Fused PREDICT: model inference inside the compiled select's programs.

Counterpart of `dask_sql_tpu/physical/compiled_predict.py`.  The host
tier (physical/rel/custom/ml.py PredictModelPlugin) runs the PREDICT
input, pulls the whole table to pandas, calls ``model.predict`` on numpy
and uploads the column again.  This module is the ``compiled_predict``
ladder rung that avoids it (arXiv:2306.08367, arXiv:2009.00524): the
PREDICT input's ``scan -> filter* -> project`` body runs as the compiled
select's two programs (`compiled_select.py`), and the registered model,
lowered to a tensor program by `dask_sql_tpu_torch.inference`, applies to
the gathered survivors' features inside the gather program
(`CompiledSelect._extra_pack_outputs`).  Two transfers: the survivor
count, then one packed matrix carrying the input columns AND the
prediction column.

The family discipline extends to models: filter and projection literals
lift into parameters exactly as in compiled_select, and the model's
weights, committed once to the device (inference/registry.py), enter as
runtime parameters appended after the family's.  The cache key holds the
model's *shape* (``ModelProgram.shape_key``: tree count, padded depth,
feature width), never its values, and a pipeline keeps no weights: a
second literal reuses the pipeline (``families.hit``), and a retrain or
``CREATE OR REPLACE MODEL`` of the same hyper-shape runs the cached
pipeline with the new weights.  The reference's family batcher stacks a
burst of PREDICTs into one launch; the port's compiled select has none,
so each member runs its own launch (ROADMAP.md, divergences).

Degradation: any failure inside the rung steps down to the host tier
through the ladder (its own (family, rung) breaker entity; the fault site
``predict`` proves the step down); a model that cannot lower declines
here and the host tier serves it.
"""
from __future__ import annotations

import dataclasses
import logging
from collections import OrderedDict
from typing import List, Optional, Tuple

import torch

from ..columnar.dtypes import STRING_TYPES
from ..columnar.table import Table
from ..planner import plan as p
from ..planner.expressions import ColumnRef
from ..resilience import faults
from .. import families
from .compiled import (
    PARAMS_SLOT,
    _Unsupported,
    _cache_lock,
    defer_rebuild,
    evict,
    pipeline_owner,
    remember_family,
    singleflight_get_or_build,
)
from .compiled_select import CompiledSelect, _extract, resolve_pipeline_inputs

logger = logging.getLogger(__name__)


def root_has_predict(root) -> bool:
    """Cheap pre-check for execute_root: the rung is only worth attempting
    when the ROOT is a PredictModelNode (optionally under the binder's
    identity output projection)."""
    if isinstance(root, p.PredictModelNode):
        return True
    return isinstance(root, p.Projection) \
        and isinstance(root.input, p.PredictModelNode)


def _extract_predict(root):
    """Match ``[Projection(pure refs)]? PredictModelNode <select chain>``;
    None otherwise.  The outer projection (the binder's ``SELECT *``
    rendering) applies host-side on the decoded result."""
    outer = None
    node = root
    if isinstance(node, p.Projection):
        if not all(isinstance(e, ColumnRef) and type(e) is ColumnRef
                   for e in node.exprs):
            return None
        outer = node
        node = node.input
    if not isinstance(node, p.PredictModelNode):
        return None
    inner = _extract(node.input)
    if inner is None:
        return None
    return outer, node, inner


class CompiledPredict(CompiledSelect):
    """One fused scan->filter->project->predict pipeline.

    Extends CompiledSelect through its ``_extra_pack_outputs`` seam: the
    gather program stacks the training-column expressions into the
    feature matrix and applies the model program's ``apply``.  Model
    params ride the tail of the runtime parameters (after the family's
    ParamRef slots).  The construction check runs the model over one row,
    so the params it is given are the committed device tensors; the
    pipeline keeps none of them."""

    def __init__(self, table: Table, upper_filters, scan_filters, proj,
                 proj_exprs, sort_keys, sort_fetch, limit, inner_limit,
                 family_params, program, feature_slots: List[int],
                 target_field):
        if program.output != "vector":
            raise _Unsupported(
                f"{program.kind} program emits a matrix, not a column")
        for i in feature_slots:
            if proj.schema[i].sql_type in STRING_TYPES:
                raise _Unsupported("string-typed model feature")
        # keep structure only: the program's `apply` closure and meta.
        # Holding the committed params here would pin one stale weight
        # copy in the pipeline cache per retrain (runs always pass the
        # CURRENT program's params through the runtime parameters).
        self._program = dataclasses.replace(program, params=())
        self._feature_exprs = [proj_exprs[i] for i in feature_slots]
        self._param_base = len(family_params)
        super().__init__(table, upper_filters, scan_filters, proj,
                         proj_exprs, sort_keys, sort_fetch, limit,
                         inner_limit,
                         tuple(family_params) + tuple(program.params))
        # the appended prediction column: decoded from the extra packed
        # rows the seam emits
        self.out_meta.append((target_field.name, target_field.sql_type,
                              None))

    def _extra_pack_outputs(self, ev, slots, bucket: int):
        def feature(e):
            d, v = ev.eval(e, slots)
            if v is not None:
                # a NULL-able feature must not silently feed the value
                # under the mask into the model: the host tier surfaces it
                # (NaN -> sklearn raises a structured error), so the fused
                # rung declines at construction and matches
                raise _Unsupported("nullable model feature")
            if d.dim() == 0:
                d = d.expand(bucket)
            return d.to(torch.float64)

        X = torch.stack([feature(e) for e in self._feature_exprs], dim=1)
        model_params = tuple(slots[PARAMS_SLOT][self._param_base:])
        pred = self._program.apply(model_params, X)
        return ((pred.to(torch.float64), None),)


#: LRU of fused PREDICT pipelines, keyed on (family identity, model
#: SHAPE), evicted with their Context (`compiled.pipeline_owner`) and by
#: DROP MODEL (`drop_model_pipelines`)
_CACHE_CAP = 16
_cache: "OrderedDict[Tuple, CompiledPredict]" = OrderedDict()


def drop_model_pipelines(context, schema_name: str, name: str) -> None:
    """Evict every cached pipeline of this Context built for a model (DROP
    MODEL and the pressure reclaim, via inference/registry.py).  Key
    layout: key[0] = the Context's owner token, key[4] = schema, key[5] =
    model."""
    token = pipeline_owner(context)
    with _cache_lock:
        for k in [k for k in _cache if k[0] == token
                  and k[4] == schema_name and k[5] == name]:
            del _cache[k]


def try_compiled_predict(root, executor) -> Optional[Table]:
    """Run a root PREDICT over a select chain on the fused rung; None
    steps down to the host tier (the eager PredictModelPlugin)."""
    config = executor.config
    if not config.get("sql.compile.predict", True) \
            or not config.get("sql.compile", True):
        return None
    got = _extract_predict(root)
    if got is None:
        return None
    outer, predict, inner = got
    scan, upper_filters, proj, sort_keys, sort_fetch, limit, inner_limit \
        = inner
    ctx = executor.context
    compiled = None
    try:
        schema_name, model_name = ctx._table_schema_name(predict.model_name)
        if model_name not in ctx.schema[schema_name].models:
            return None  # the host tier raises the structured not-found
        model, training_columns = ctx.get_model(schema_name, model_name)
        from .. import inference

        program, _reason = inference.program_for(ctx, schema_name,
                                                 model_name, model,
                                                 commit=True)
        if program is None or program.output != "vector":
            return None  # a decline verdict: the host tier serves
        if program.meta.get("features") not in (None,
                                                len(training_columns)):
            return None  # stale training columns: the host tier errors
        proj_names = [f.name for f in proj.schema]
        try:
            feature_slots = [proj_names.index(col)
                             for col in training_columns]
        except ValueError:
            return None  # a missing feature column: the host tier raises
        resolved = resolve_pipeline_inputs(scan, executor)
        if resolved is None:
            return None
        dc, table = resolved
        # literals in the PREDICT input lift into parameters, so every
        # literal variant, and every retrain of the same model shape,
        # shares ONE pipeline
        pz = families.pipeline_parameterizer(config)
        p_upper = [pz.rewrite(f) for f in upper_filters]
        p_scan_flts = [pz.rewrite(f) for f in scan.filters]
        p_exprs = [pz.rewrite(e) for e in proj.exprs]
        params = pz.params
        key = (
            "predict",
            dc.uid, ctx.table_epoch(scan.schema_name, scan.table_name),
            schema_name, model_name,
            program.shape_key,
            tuple(feature_slots),
            tuple(scan.projection or ()),
            tuple(str(f) for f in p_upper),
            tuple(str(f) for f in p_scan_flts),
            tuple(str(e) for e in p_exprs),
            tuple((f.name, f.sql_type) for f in proj.schema),
            tuple(str(k.expr) + str(k.ascending) + str(k.nulls_first)
                  for k in sort_keys) if sort_keys else None,
            sort_fetch,
            limit,
            inner_limit,
            table.num_rows,
        )
        target_field = predict.schema[-1]
        run_params = tuple(params) + tuple(program.params)

        def build():
            return CompiledPredict(table, p_upper, p_scan_flts, proj,
                                   p_exprs, sort_keys, sort_fetch, limit,
                                   inner_limit, params, program,
                                   feature_slots, target_field)

        def build_and_warm():
            obj = build()
            obj.run(table, run_params)
            return obj

        # the family is the key less the table's identity and rows: a
        # family seen before over a replaced or grown table rebuilds on
        # the background compiler, and this query is served on the host
        # tier once
        family = ("compiled_predict",) + key[3:-1]
        bucket = (key[1], key[2], key[-1])
        with _cache_lock:
            cached = ((pipeline_owner(ctx),) + key) in _cache
        if not cached and defer_rebuild(ctx, "compiled_predict", _cache,
                                        _CACHE_CAP, key, family, bucket,
                                        build_and_warm):
            return None
        compiled, built_here = singleflight_get_or_build(
            _cache, key, build, "compiled_predict", ctx, _CACHE_CAP)
        if built_here:
            remember_family(ctx, family, bucket)
        from ..observability import trace_event

        if not built_here and params:
            ctx.metrics.inc("families.hit")
            trace_event("family_hit", rung="compiled_predict",
                        params=len(params))
        if built_here and compiled.codespace_preds:
            ctx.metrics.inc("columnar.encoding.codespace_pred",
                            compiled.codespace_preds)
        faults.maybe_inject("oom", config)
        # the CURRENT program's params every run: a swapped model rides
        # the same pipeline with fresh (same-shaped) weights
        result = compiled.run(table, run_params)
        if compiled.has_encoded:
            ctx.metrics.inc("columnar.encoding.late_rows", result.num_rows)
        if outer is not None:
            result = _apply_outer_projection(outer, result)
        ctx.metrics.inc("inference.predict.compiled")
        trace_event("rung:compiled_predict", rung="compiled_predict",
                    model=f"{schema_name}.{model_name}",
                    model_kind=program.kind)
        return result
    except (_Unsupported, ValueError, TypeError, NotImplementedError) as e:
        # an expression or model the fused rung does not take must never
        # sink the query: the host tier answers it
        logger.info("compiled predict declined the plan: %s", e)
        evict(_cache, compiled)
        return None


def _apply_outer_projection(outer: p.Projection, result: Table) -> Table:
    """Host-side application of the binder's pure-ref output projection
    over the decoded fused result (column pick / rename only)."""
    from .rel.base import unique_names

    names = unique_names([f.name for f in outer.schema])
    inner_names = result.column_names
    cols = {}
    for uname, e in zip(names, outer.exprs):
        cols[uname] = result.columns[inner_names[e.index]]
    return Table(cols, result.num_rows, result.device)
