"""The statements: DDL, SHOW, INSERT INTO and ANALYZE TABLE.

Counterpart of `dask_sql_tpu/physical/rel/custom/ddl.py`.  Each plugin
changes the Context's catalog (`context.py`) or reads it, and returns a
small host table of strings (SHOW, DESCRIBE, ANALYZE, the row count of an
INSERT) or no columns at all.  CREATE TABLE AS runs its query and
registers the result on the context's device; CREATE VIEW keeps the plan,
which runs where the view is read; INSERT INTO runs its query and appends
the rows in place (`Context.append_rows`).

CREATE TABLE ... WITH (location = ..., format = ..., persist = ...)
registers files or a published dataset through `Context.create_table`.

SHOW METRICS reads the Context's metrics registry (`serving/metrics.py`)
and SHOW PROFILES its profile store (`observability/profiles.py`).

SHOW MATERIALIZED reads the semantic-reuse state (`Context.materialize`,
materialize/), and SHOW MODELS the model registry with each model's
lowering verdict (inference/).

SHOW REPLICAS, whose subsystem the port does not have yet, raises
`NotImplementedError`, naming it and its item in ROADMAP.md's Queue 1
(item 10b).
"""
from __future__ import annotations

import numpy as np

from ....columnar.column import Column
from ....columnar.table import Table
from ....planner import plan as p
from ...executor import Executor
from ..base import BaseRelPlugin


def _string_table(cols: dict) -> Table:
    """A host table of string columns."""
    n = len(next(iter(cols.values()))) if cols else 0
    return Table({k: Column.from_numpy(np.array(v, dtype=object),
                                       encode=False)
                  for k, v in cols.items()}, n, "cpu")


_EMPTY = Table({}, 0, "cpu")


def _not_ported(statement: str, needs: str):
    def convert(self, rel, executor) -> Table:
        raise NotImplementedError(
            f"{statement} needs {needs}, not in the port yet")

    return convert


@Executor.add_plugin_class
class CreateTablePlugin(BaseRelPlugin):
    """CREATE TABLE ... WITH (location = ..., format = ..., persist = ...):
    a table read from files or a published dataset; the other WITH options
    go to the reader."""

    class_name = "CreateTableNode"

    def convert(self, rel: p.CreateTableNode, executor) -> Table:
        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.name)
        if name in ctx.schema[schema_name].tables:
            if rel.if_not_exists:
                return _EMPTY
            if not rel.or_replace:
                raise RuntimeError(
                    f"A table with the name {name} is already present.")
        kwargs = dict(rel.kwargs or {})
        location = kwargs.pop("location", None)
        fmt = kwargs.pop("format", None)
        persist = kwargs.pop("persist", False)
        kwargs.pop("gpu", None)
        kwargs.pop("backend", None)
        ctx.create_table(name, location, format=fmt, persist=persist,
                         schema_name=schema_name, **kwargs)
        return _EMPTY


@Executor.add_plugin_class
class CreateMemoryTablePlugin(BaseRelPlugin):
    """CREATE TABLE ... AS runs the query and registers its result; CREATE
    VIEW ... AS keeps the plan."""

    class_name = "CreateMemoryTableNode"

    def convert(self, rel: p.CreateMemoryTableNode, executor) -> Table:
        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.name)
        if name in ctx.schema[schema_name].tables:
            if rel.if_not_exists:
                return _EMPTY
            if not rel.or_replace:
                raise RuntimeError(
                    f"A table with the name {name} is already present.")
        if rel.persist:
            # an aggregate's group table lives on the host; a result over
            # a sharded table registers as its global rows
            table = executor.execute(rel.input).to(ctx.device).unsharded()
            ctx.create_table(name, table, schema_name=schema_name)
        else:
            ctx._register_view(name, rel.input, schema_name)
        return _EMPTY


@Executor.add_plugin_class
class DropTablePlugin(BaseRelPlugin):
    class_name = "DropTableNode"

    def convert(self, rel: p.DropTableNode, executor) -> Table:
        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.name)
        if name not in ctx.schema[schema_name].tables \
                and name not in ctx._views.get(schema_name, {}):
            if rel.if_exists:
                return _EMPTY
            raise RuntimeError(f"A table with the name {name} is not present.")
        ctx.drop_table(name, schema_name=schema_name)
        return _EMPTY


@Executor.add_plugin_class
class CreateSchemaPlugin(BaseRelPlugin):
    class_name = "CreateSchemaNode"

    def convert(self, rel: p.CreateSchemaNode, executor) -> Table:
        ctx = executor.context
        if rel.schema_name in ctx.schema:
            if rel.if_not_exists:
                return _EMPTY
            if not rel.or_replace:
                raise RuntimeError(
                    f"A schema with the name {rel.schema_name} is already "
                    f"present.")
        ctx.create_schema(rel.schema_name)
        return _EMPTY


@Executor.add_plugin_class
class DropSchemaPlugin(BaseRelPlugin):
    class_name = "DropSchemaNode"

    def convert(self, rel: p.DropSchemaNode, executor) -> Table:
        ctx = executor.context
        if rel.schema_name not in ctx.schema:
            if rel.if_exists:
                return _EMPTY
            raise RuntimeError(
                f"A schema with the name {rel.schema_name} is not present.")
        ctx.drop_schema(rel.schema_name)
        return _EMPTY


@Executor.add_plugin_class
class UseSchemaPlugin(BaseRelPlugin):
    class_name = "UseSchemaNode"

    def convert(self, rel: p.UseSchemaNode, executor) -> Table:
        ctx = executor.context
        if rel.schema_name not in ctx.schema:
            raise RuntimeError(
                f"A schema with the name {rel.schema_name} is not present.")
        ctx.schema_name = rel.schema_name
        return _EMPTY


@Executor.add_plugin_class
class AlterSchemaPlugin(BaseRelPlugin):
    class_name = "AlterSchemaNode"

    def convert(self, rel: p.AlterSchemaNode, executor) -> Table:
        executor.context.alter_schema(rel.old_name, rel.new_name)
        return _EMPTY


@Executor.add_plugin_class
class AlterTablePlugin(BaseRelPlugin):
    class_name = "AlterTableNode"

    def convert(self, rel: p.AlterTableNode, executor) -> Table:
        ctx = executor.context
        schema_name, old = ctx._table_schema_name(rel.old_name)
        if old not in ctx.schema[schema_name].tables:
            if rel.if_exists:
                return _EMPTY
            raise RuntimeError(f"A table with the name {old} is not present.")
        ctx.alter_table(old, rel.new_name, schema_name=schema_name)
        return _EMPTY


@Executor.add_plugin_class
class ShowSchemasPlugin(BaseRelPlugin):
    class_name = "ShowSchemasNode"

    def convert(self, rel: p.ShowSchemasNode, executor) -> Table:
        names = list(executor.context.schema.keys())
        if rel.like:
            names = [n for n in names if rel.like in n]
        return _string_table({"Schema": names})


@Executor.add_plugin_class
class ShowTablesPlugin(BaseRelPlugin):
    class_name = "ShowTablesNode"

    def convert(self, rel: p.ShowTablesNode, executor) -> Table:
        ctx = executor.context
        schema = rel.schema_name or ctx.schema_name
        if schema not in ctx.schema:
            raise RuntimeError(
                f"A schema with the name {schema} is not present.")
        names = list(ctx.schema[schema].tables.keys()) \
            + list(ctx._views.get(schema, {}).keys())
        return _string_table({"Table": names})


@Executor.add_plugin_class
class ShowColumnsPlugin(BaseRelPlugin):
    """SHOW COLUMNS FROM t and DESCRIBE t."""

    class_name = "ShowColumnsNode"

    def convert(self, rel: p.ShowColumnsNode, executor) -> Table:
        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.table)
        fields = ctx._table_fields(schema_name, name)
        return _string_table({
            "Column": [f.name for f in fields],
            "Type": [str(f.sql_type).lower() for f in fields],
            "Extra": ["" for _ in fields],
            "Comment": ["" for _ in fields],
        })


@Executor.add_plugin_class
class InsertIntoPlugin(BaseRelPlugin):
    """INSERT INTO t VALUES (...) and INSERT INTO t SELECT ...: the query
    runs, its columns bind to the table's by position, and the rows append
    in place (`Context.append_rows`).  One row reports the count."""

    class_name = "InsertIntoNode"

    def convert(self, rel: p.InsertIntoNode, executor) -> Table:
        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.name)
        dc = ctx.schema[schema_name].tables.get(name)
        if dc is None:
            raise RuntimeError(f"A table with the name {name} is not present.")
        delta = executor.execute(rel.input).to(ctx.device)
        target_names = list(dc.table.columns)
        if len(delta.columns) != len(target_names):
            raise RuntimeError(
                f"INSERT INTO {name} expects {len(target_names)} columns "
                f"({', '.join(target_names)}), got {len(delta.columns)}")
        renamed = Table(dict(zip(target_names, delta.columns.values())),
                        delta.num_rows, delta.device)
        n = ctx.append_rows(name, renamed, schema_name=schema_name)
        return _string_table({"Inserted": [str(n)]})


@Executor.add_plugin_class
class AnalyzeTablePlugin(BaseRelPlugin):
    """ANALYZE TABLE t COMPUTE STATISTICS [FOR ALL COLUMNS | FOR COLUMNS
    ...]: the pandas description of the numeric columns, and each column's
    dtype, as a result (the optimizer does not read it)."""

    class_name = "AnalyzeTableNode"

    def convert(self, rel: p.AnalyzeTableNode, executor) -> Table:
        import pandas as pd

        ctx = executor.context
        schema_name, name = ctx._table_schema_name(rel.table)
        df = ctx.get_table_data(schema_name, name).to_pandas()
        if rel.columns:
            df = df[rel.columns]
        num = df.select_dtypes("number")
        stats = num.describe() if len(num.columns) else pd.DataFrame()
        stats = stats.rename(index={"25%": "percentile_25",
                                    "50%": "percentile_50",
                                    "75%": "percentile_75"})
        combined = {"col_name": list(stats.index) + ["data_type", "col_name"]}
        for col in df.columns:
            vals = [str(stats[col][stat]) if col in stats.columns else ""
                    for stat in stats.index]
            combined[col] = vals + [str(df[col].dtype), col]
        return _string_table(combined)


def _like_match(pattern: str, name: str) -> bool:
    """SQL LIKE semantics when the pattern has a % wildcard (then _ is the
    single-character wildcard too); substring containment otherwise, since
    metric names hold literal underscores.  Copied from the reference's
    `ddl.py`."""
    if "%" in pattern:
        import re

        from ....ops.strings import like_to_regex

        return re.match(like_to_regex(pattern), name) is not None
    return pattern in name


def _flatten_metrics(prefix: str, value) -> list:
    """Nested snapshot dicts -> sorted (dotted-name, str) rows."""
    if isinstance(value, dict):
        out = []
        for k in sorted(value):
            out.extend(_flatten_metrics(f"{prefix}.{k}", value[k]))
        return out
    return [(prefix, "" if value is None else str(value))]


@Executor.add_plugin_class
class ShowMetricsPlugin(BaseRelPlugin):
    """SHOW METRICS [LIKE 'pat']: the Context's metrics registry as rows of
    (Metric, Value): counters, gauges (the card-byte ledger's refreshed
    first), histograms (count, avg, p50, p95, p99, max), the result
    cache's occupancy, the plan cache's entries, the circuit breaker's
    snapshot and, with a serving runtime attached, its queues."""

    class_name = "ShowMetricsNode"

    def convert(self, rel: p.ShowMetricsNode, executor) -> Table:
        ctx = executor.context
        ctx.ledger.publish(ctx.metrics)
        rows = list(ctx.metrics.rows())
        rows.extend(_flatten_metrics("result_cache",
                                     ctx._result_cache.snapshot()))
        rows.append(("plan_cache.entries", str(len(ctx._plan_cache))))
        rows.extend(_flatten_metrics("resilience.breaker",
                                     ctx.breaker.snapshot()))
        if ctx.serving is not None:
            rows.extend(_flatten_metrics("serving.runtime",
                                         ctx.serving.snapshot()))
        if rel.like:
            rows = [r for r in rows if _like_match(rel.like, r[0])]
        rows.sort()
        return _string_table({"Metric": [r[0] for r in rows],
                              "Value": [r[1] for r in rows]})


@Executor.add_plugin_class
class ShowProfilesPlugin(BaseRelPlugin):
    """SHOW PROFILES [LIKE 'pat']: the per-fingerprint profile store as
    rows of (Fingerprint, Family, Metric, Value): hits, rolling exec wall
    times, result bytes, rows, the rungs that answered and the per-rung
    compile (pipeline build) times.  LIKE filters on the fingerprint, the
    family or the metric name."""

    class_name = "ShowProfilesNode"

    def convert(self, rel: p.ShowProfilesNode, executor) -> Table:
        rows = executor.context.profiles.rows()
        if rel.like:
            rows = [r for r in rows
                    if _like_match(rel.like, r[0])
                    or _like_match(rel.like, r[1])
                    or _like_match(rel.like, r[2])]
        return _string_table({"Fingerprint": [r[0] for r in rows],
                              "Family": [r[1] for r in rows],
                              "Metric": [r[2] for r in rows],
                              "Value": [r[3] for r in rows]})


@Executor.add_plugin_class
class ShowQueriesPlugin(BaseRelPlugin):
    """SHOW QUERIES [LIKE 'pat']: the in-flight query table
    (observability/live.py) as (Qid, Field, Value) rows, one a populated
    live fact (state, class, stage, rung, family, batch role, reserved and
    measured bytes, deadline remaining), live queries first and a bounded
    tail of finished ones after, then the card-byte ledger under the
    ``(ledger)`` pseudo-qid.  LIKE filters on the qid or the field."""

    class_name = "ShowQueriesNode"

    def convert(self, rel: p.ShowQueriesNode, executor) -> Table:
        ctx = executor.context
        rows = list(ctx.live_queries.rows())
        rows.extend(ctx.ledger.rows())
        if rel.like:
            rows = [r for r in rows
                    if _like_match(rel.like, r[0])
                    or _like_match(rel.like, r[1])]
        return _string_table({"Qid": [r[0] for r in rows],
                              "Field": [r[1] for r in rows],
                              "Value": [r[2] for r in rows]})


@Executor.add_plugin_class
class CancelQueryPlugin(BaseRelPlugin):
    """CANCEL QUERY '<qid>': cooperative cancellation through the live
    table's `QueryTicket` (`Context.cancel_query`): the executor raises at
    its next checkpoint, and a queued query is skipped by the worker that
    pops it.  One row: whether a live, cancellable query was found."""

    class_name = "CancelQueryNode"

    def convert(self, rel: p.CancelQueryNode, executor) -> Table:
        ok = executor.context.cancel_query(rel.qid)
        return _string_table({"Qid": [rel.qid],
                              "Cancelled": [str(bool(ok)).lower()]})


@Executor.add_plugin_class
class ShowMaterializedPlugin(BaseRelPlugin):
    """SHOW MATERIALIZED [LIKE 'pat']: the semantic-reuse state
    (materialize/) as a result set, one row per pinned sub-plan stem
    (rows and bytes on the device, rewrite hits, the base table's delta
    epoch it was last refreshed to) and per incrementally maintained
    aggregate state.  LIKE filters on the kind, the fingerprint or the
    table name."""

    class_name = "ShowMaterializedNode"

    def convert(self, rel: p.ShowMaterializedNode, executor) -> Table:
        rows = executor.context.materialize.rows()
        if rel.like:
            rows = [r for r in rows
                    if _like_match(rel.like, r[0])
                    or _like_match(rel.like, r[1])
                    or _like_match(rel.like, r[2])]
        return _string_table({"Kind": [r[0] for r in rows],
                              "Fingerprint": [r[1] for r in rows],
                              "Table": [r[2] for r in rows],
                              "Rows": [str(r[3]) for r in rows],
                              "Bytes": [str(r[4]) for r in rows],
                              "Hits": [str(r[5]) for r in rows],
                              "Epoch": [str(r[6]) for r in rows]})


@Executor.add_plugin_class
class ShowModelsPlugin(BaseRelPlugin):
    class_name = "ShowModelsNode"

    def convert(self, rel: p.ShowModelsNode, executor) -> Table:
        from ....inference import lowering_verdict

        ctx = executor.context
        schema = rel.schema_name or ctx.schema_name
        names = list(ctx.schema[schema].models.keys())
        # the lowering verdict per model (inference/): which models serve
        # on the fused compiled_predict tier and which on the host tier,
        # their device param bytes, and the program shape
        verdicts = [lowering_verdict(ctx, schema, n) for n in names]
        return _string_table({
            "Model": names,
            "Tier": [v["tier"] for v in verdicts],
            "ParamBytes": [v["param_bytes"] for v in verdicts],
            "Shape": [v["shape"] for v in verdicts],
        })


@Executor.add_plugin_class
class ShowReplicasPlugin(BaseRelPlugin):
    class_name = "ShowReplicasNode"
    convert = _not_ported(
        "SHOW REPLICAS",
        "the fleet router (fleet/, ROADMAP.md Queue 1 item 10b)")
