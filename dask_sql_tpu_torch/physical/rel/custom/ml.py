"""ML statement converters: CREATE MODEL / PREDICT / EXPERIMENT / EXPORT.

Role parity (reference physical/rel/custom/): create_model.py:23 (WITH
options: model_class, target_column, wrap_predict, wrap_fit, fit_kwargs),
predict_model.py:15 (PREDICT(MODEL m, <select>) appends a `target` column),
create_experiment.py:22 (GridSearchCV-style tuning), export_model.py:15
(pickle/joblib/mlflow/onnx), describe_model.py, drop_model.py.

Counterpart of `dask_sql_tpu/physical/rel/custom/ml.py`.  CREATE MODEL
trains the engine's own models (ml/torch_models.py) on the Context's
device; PREDICT here is the host tier of the ``compiled_predict`` rung
(physical/compiled_predict.py): the input pulled to pandas, the model's
``predict`` on numpy, the column uploaded to the input's device.
"""
from __future__ import annotations

import numpy as np

from ....columnar.column import Column
from ....columnar.table import Table
from ....planner import plan as p
from ....resilience.errors import (
    ModelError,
    ModelNotFoundError,
    QueryError,
    ResourceExhaustedError,
    classify,
)
from ..base import BaseRelPlugin, unique_names
from ...executor import Executor

_EMPTY = Table({}, 0, "cpu")


def _model_boundary(stage: str, fn):
    """Run one model-layer step under the structured error taxonomy: a
    failing fit/predict/class-resolution leaves here as a `ModelError`
    (USER_ERROR on the Presto wire) instead of a raw traceback that
    bypasses the QueryError code mapping."""
    try:
        return fn()
    except QueryError:
        raise
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as exc:
        # resource exhaustion (MemoryError on the pulled-to-host frame, a
        # card out-of-memory from an engine model) keeps its taxonomy class: the host tier is itself a degradation target and
        # USER_ERROR would tell the client their statement is wrong
        wrapped = classify(exc)
        if isinstance(wrapped, ResourceExhaustedError):
            raise wrapped
        raise ModelError(
            f"{stage} failed: {type(exc).__name__}: {exc}") from exc


def _split_xy(df, target_column):
    if target_column:
        X = df.drop(columns=[target_column])
        y = df[target_column]
    else:
        X, y = df, None
    return X, y


@Executor.add_plugin_class
class CreateModelPlugin(BaseRelPlugin):
    class_name = "CreateModelNode"

    def convert(self, rel: p.CreateModelNode, executor) -> Table:
        from ....ml import torch_models
        from ....ml.ml_classes import get_model_class
        from ....ml.wrappers import Incremental, ParallelPostFit

        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.name)
        if name in ctx.schema[schema_name].models:
            if rel.if_not_exists:
                return _EMPTY
            if not rel.or_replace:
                raise ModelError(
                    f"A model with the name {name} is already present.")
        kwargs = dict(rel.kwargs)
        model_class = kwargs.pop("model_class", None)
        if model_class is None:
            raise ModelError("CREATE MODEL requires a model_class parameter")
        if kwargs.pop("experiment_class", None) is not None:
            # historically popped and silently dropped — surface the
            # misdirected option instead of training something else
            raise ModelError(
                "experiment_class is a CREATE EXPERIMENT option; CREATE "
                "MODEL trains model_class directly — use CREATE "
                "EXPERIMENT for tuned fits")
        target_column = kwargs.pop("target_column", "")
        wrap_predict = _boolish(kwargs.pop("wrap_predict", False))
        wrap_fit = _boolish(kwargs.pop("wrap_fit", False))
        fit_kwargs = kwargs.pop("fit_kwargs", {}) or {}
        backend = kwargs.pop("backend", "tpu")
        kwargs.pop("gpu", None)

        training_table = executor.execute(rel.input)
        df = training_table.to_pandas(executor.config)
        X, y = _split_xy(df, target_column)

        ModelClass = _model_boundary(
            "model_class resolution",
            lambda: get_model_class(str(model_class), backend=str(backend)))
        if isinstance(ModelClass, type) \
                and issubclass(ModelClass, torch_models._TorchEstimator):
            # the engine's own models fit and predict on the card
            kwargs["device"] = ctx.device

        def fit():
            model = ModelClass(**kwargs)
            if wrap_fit:
                model = Incremental(model)
            if y is not None:
                model.fit(X.to_numpy(), y.to_numpy(), **fit_kwargs)
            else:
                model.fit(X.to_numpy(), **fit_kwargs)
            return model

        model = _model_boundary(f"CREATE MODEL {name} fit", fit)
        if wrap_predict and not isinstance(model, (ParallelPostFit, Incremental)):
            model = ParallelPostFit(model)
        ctx.register_model(name, model, list(X.columns), schema_name=schema_name)
        return _EMPTY


@Executor.add_plugin_class
class PredictModelPlugin(BaseRelPlugin):
    class_name = "PredictModelNode"

    def convert(self, rel: p.PredictModelNode, executor) -> Table:
        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.model_name)
        if name not in ctx.schema[schema_name].models:
            raise ModelNotFoundError(
                f"A model with the name {name} is not present.")
        model, training_columns = ctx.get_model(schema_name, name)
        inp = executor.execute(rel.input)
        df = inp.to_pandas(executor.config)
        # the host tier: pull to pandas, predict on numpy, re-upload —
        # where PREDICTs land when the fused compiled_predict rung
        # (physical/compiled_predict.py) declines or degrades
        ctx.metrics.inc("inference.predict.host")
        pred = _model_boundary(
            f"PREDICT(MODEL {name})",
            lambda: model.predict(df[training_columns].to_numpy()))
        names = unique_names([f.name for f in rel.schema])
        cols = dict(zip(names[:-1], [inp.columns[c] for c in inp.column_names]))
        cols[names[-1]] = Column.from_numpy(np.asarray(pred),
                                            device=inp.device, encode=False)
        return Table(cols, inp.num_rows, inp.device)


@Executor.add_plugin_class
class DropModelPlugin(BaseRelPlugin):
    class_name = "DropModelNode"

    def convert(self, rel: p.DropModelNode, executor) -> Table:
        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.name)
        if name not in ctx.schema[schema_name].models:
            if rel.if_exists:
                return _EMPTY
            raise ModelNotFoundError(
                f"A model with the name {name} is not present.")
        del ctx.schema[schema_name].models[name]
        from ....inference import invalidate

        invalidate(ctx, schema_name, name)  # ledger stops charging params
        return _EMPTY


@Executor.add_plugin_class
class DescribeModelPlugin(BaseRelPlugin):
    class_name = "DescribeModelNode"

    def convert(self, rel: p.DescribeModelNode, executor) -> Table:
        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.name)
        if name not in ctx.schema[schema_name].models:
            raise ModelNotFoundError(
                f"A model with the name {name} is not present.")
        model, training_columns = ctx.get_model(schema_name, name)
        params = model.get_params() if hasattr(model, "get_params") else {}
        params["training_columns"] = training_columns
        # the lowering verdict (inference/): does this model serve on the
        # compiled tier, how many device param bytes, what shape
        from ....inference import lowering_verdict

        verdict = lowering_verdict(ctx, schema_name, name)
        params["lowering.tier"] = verdict["tier"]
        params["lowering.param_bytes"] = verdict["param_bytes"]
        params["lowering.shape"] = verdict["shape"]
        keys = np.array([str(k) for k in params.keys()], dtype=object)
        vals = np.array([str(v) for v in params.values()], dtype=object)
        return Table({"Params": Column.from_numpy(keys),
                      "Value": Column.from_numpy(vals)}, len(keys))


@Executor.add_plugin_class
class ExportModelPlugin(BaseRelPlugin):
    class_name = "ExportModelNode"

    def convert(self, rel: p.ExportModelNode, executor) -> Table:
        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.name)
        model, training_columns = ctx.get_model(schema_name, name)
        kwargs = dict(rel.kwargs)
        fmt = str(kwargs.pop("format", "pickle")).lower()
        location = kwargs.pop("location", "tmp.pkl")
        if fmt in ("pickle", "pkl"):
            import pickle

            with open(location, "wb") as f:
                pickle.dump(model, f, **kwargs)
        elif fmt == "joblib":
            import joblib

            joblib.dump(model, location, **kwargs)
        elif fmt == "mlflow":
            try:
                import mlflow
            except ImportError as e:  # pragma: no cover
                raise RuntimeError("mlflow is not installed") from e
            mlflow.sklearn.save_model(model, location, **kwargs)
        elif fmt == "onnx":
            raise ModelError(
                "ONNX export requires skl2onnx, which is not installed here")
        else:
            raise ModelError(f"EXPORT MODEL format {fmt!r} is not supported")
        return _EMPTY


@Executor.add_plugin_class
class CreateExperimentPlugin(BaseRelPlugin):
    class_name = "CreateExperimentNode"

    def convert(self, rel: p.CreateExperimentNode, executor) -> Table:
        from ....ml.ml_classes import get_model_class

        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.name)
        if name in ctx.schema[schema_name].experiments:
            if rel.if_not_exists:
                return _EMPTY
            if not rel.or_replace:
                raise RuntimeError(f"An experiment with the name {name} is already present.")
        kwargs = dict(rel.kwargs)
        model_class = kwargs.pop("model_class", None)
        experiment_class = kwargs.pop("experiment_class", "sklearn.model_selection.GridSearchCV")
        tune_parameters = kwargs.pop("tune_parameters", {}) or {}
        target_column = kwargs.pop("target_column", "")
        automl_class = kwargs.pop("automl_class", None)
        experiment_kwargs = kwargs.pop("experiment_kwargs", {}) or {}
        kwargs.pop("gpu", None)

        training_table = executor.execute(rel.input)
        df = training_table.to_pandas(executor.config)
        X, y = _split_xy(df, target_column)

        if automl_class:
            raise NotImplementedError(
                "AutoML (TPOT-style) experiments need the automl package installed")
        if model_class is None:
            raise ModelError("CREATE EXPERIMENT requires a model_class")
        ModelClass = get_model_class(str(model_class), backend="cpu")
        base = ModelClass()
        ExperimentClass = get_model_class(str(experiment_class), backend="cpu")
        tuner = ExperimentClass(base, {k: list(v) if isinstance(v, (list, tuple)) else [v]
                                       for k, v in tune_parameters.items()},
                                **experiment_kwargs)
        tuner.fit(X.to_numpy(), y.to_numpy() if y is not None else None)
        import pandas as pd

        results = pd.DataFrame(tuner.cv_results_)
        ctx.schema[schema_name].experiments[name] = results
        ctx.register_model(name, tuner.best_estimator_, list(X.columns),
                           schema_name=schema_name)
        out = Table.from_pandas(results.astype(str))
        return out


def _boolish(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")
