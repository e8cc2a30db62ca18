"""Session checkpoint and restore: a Context's state across a restart.

A copy of `dask_sql_tpu/checkpoint.py` on the port's columns.  A snapshot
is the catalog written as parquet with a manifest, a layout that does not
depend on the engine: a snapshot the reference saves loads into a port
Context, and one the port saves loads into the reference's.

- Column-exact: every column keeps its SQL type, storage dtype and
  validity (the arrow arrays are written with their masks, so numeric
  NULLs never become NaN values).  Columns go down to the host to be
  written, decoded from their compressed encodings; they come back to the
  Context's device when loaded, their encodings chosen again as at
  registration (``columnar.encoding*``), so the card holds the same bytes
  after a load as before the save.
- Atomic: each save writes a new ``snap-NNNNNN/`` directory, then points
  the ``CURRENT`` file at it with an atomic rename; a crash mid-save (the
  ``checkpoint`` fault site, between the two) leaves the previous snapshot
  live.  Older snapshots are pruned after the repoint.
- A sharded table writes its global rows and its mesh's width; the load
  shards it again over the loading Context's default mesh.
- The table delta epochs, the per-fingerprint profiles (the warm-up's
  input, serving/warmup.py) and the breaker's open verdicts (restored
  within ``resilience.breaker.persist_ttl_s``) ride along.

- Registered models ride along, each pickled with its training columns
  (a port model's fitted tensors on the host, so a snapshot taken on the
  card loads on a CPU Context); the load registers them again on the
  loading Context's device.  A reference snapshot's models are not loaded
  (unpickling them imports the JAX package): the load warns and skips
  them.

Not captured, listed in the manifest's ``not_restored`` (re-issue their
DDL after a load): views and registered functions, as in the reference.

Layout under ``location/``:
    CURRENT                              name of the live snapshot dir
    snap-NNNNNN/manifest.json            inventories and column specs
    snap-NNNNNN/tables/<schema>/<table>.parquet
    snap-NNNNNN/models/<schema>/<model>.pkl
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
from typing import TYPE_CHECKING
from urllib.parse import quote

import numpy as np

from .ml import torch_models

if TYPE_CHECKING:  # pragma: no cover
    from .context import Context

logger = logging.getLogger(__name__)

#: the ``engine`` tag of a model entry the port saved (its pickle imports
#: only the port, torch and the model's own library)
_ENGINE = "torch"


def _q(name: str) -> str:
    return quote(name, safe="")


# ----------------------------------------------------------------- columns
def _write_table(table, path: str) -> list:
    """Write a Table as parquet with explicit validity masks; returns the
    per-column specs of the manifest (SQL type and storage dtype: arrow
    alone cannot tell a TIMESTAMP stored as int64 ns, or CHAR from
    VARCHAR)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from .columnar.dtypes import STRING_TYPES
    from .utils import count_d2h

    arrays, names, specs = [], [], []
    for name, col in table.columns.items():
        col = col.decode()
        if col.sql_type in STRING_TYPES:
            arrays.append(pa.array(col.to_numpy(), type=pa.string()))
            specs.append({"name": name, "sql_type": col.sql_type.value,
                          "storage": "string"})
        else:
            if col.device.type != "cpu":
                count_d2h()
            raw = col.data.cpu().numpy()
            mask = None if col.validity is None \
                else ~col.validity.cpu().numpy()
            arrays.append(pa.array(raw, mask=mask))
            specs.append({"name": name, "sql_type": col.sql_type.value,
                          "storage": str(raw.dtype)})
        names.append(name)
    pq.write_table(pa.table(arrays, names=names), path)
    return specs


def _read_table(path: str, specs: list, num_rows: int, device, config):
    """Inverse of `_write_table`, onto ``device``, each column's encoding
    chosen again under ``config`` as at registration."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from .columnar.column import Column
    from .columnar.dtypes import SqlType
    from .columnar.encodings import load_scope, maybe_encode
    from .columnar.table import Table

    at = pq.read_table(path)
    cols = {}
    with load_scope(config):
        for spec in specs:
            name = spec["name"]
            sql_type = SqlType(spec["sql_type"])
            arr = at.column(name).combine_chunks()
            if spec["storage"] == "string":
                col = _string_column(arr, sql_type, device)
            else:
                dt = np.dtype(spec["storage"])
                nulls = arr.is_null().to_numpy(zero_copy_only=False)
                fill = False if pa.types.is_boolean(arr.type) else 0
                vals = np.ascontiguousarray(arr.fill_null(fill).to_numpy(
                    zero_copy_only=False).astype(dt))
                valid = None if not nulls.any() else ~nulls
                col = maybe_encode(vals, valid, sql_type, device=device)
                if col is None:
                    col = Column.from_parts(vals, valid, None, sql_type,
                                            device)
            cols[name] = col
    return Table(cols, num_rows, device)


def _string_column(arr, sql_type, device):
    """A string column as registration builds it (`Column._encode_strings`:
    codes into the sorted distinct values, a NULL coded as the empty
    string) from an Arrow array, through Arrow's hash encoding: only the
    distinct values are sorted in Python."""
    import pyarrow.compute as pc

    from .columnar.column import Column

    nulls = arr.is_null().to_numpy(zero_copy_only=False)
    if nulls.any():
        arr = pc.fill_null(arr, "")
    enc = arr.dictionary_encode()
    values = np.asarray(enc.dictionary.to_pylist(), dtype=object)
    order = np.argsort(values, kind="stable")
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    codes = rank[enc.indices.to_numpy(zero_copy_only=False)]
    return Column.from_parts(codes, ~nulls if nulls.any() else None,
                             values[order], sql_type, device)


# ------------------------------------------------------------------- save
def save_state(context: "Context", location: str) -> dict:
    """Write a restartable snapshot of every schema; returns the manifest."""
    from .datacontainer import LazyParquetContainer

    os.makedirs(location, exist_ok=True)
    existing = sorted(d for d in os.listdir(location) if d.startswith("snap-"))
    snap = f"snap-{(int(existing[-1][5:]) + 1) if existing else 1:06d}"
    snap_dir = os.path.join(location, snap)

    manifest = {"version": 2, "current_schema": context.schema_name,
                "schemas": {}, "not_restored": {}}
    for schema_name, container in context.schema.items():
        os.makedirs(os.path.join(snap_dir, "tables", _q(schema_name)),
                    exist_ok=True)
        os.makedirs(os.path.join(snap_dir, "models", _q(schema_name)),
                    exist_ok=True)
        entry = {"tables": {}, "models": [], "statistics": {}}
        for tname, dc in container.tables.items():
            if isinstance(dc, LazyParquetContainer):
                entry["tables"][tname] = {"kind": "parquet",
                                          "path": dc.location}
                continue
            rel = os.path.join("tables", _q(schema_name),
                               _q(tname) + ".parquet")
            # a sharded table writes its global rows (its blocks hold no
            # padding); the load shards them again
            specs = _write_table(dc.table, os.path.join(snap_dir, rel))
            entry["tables"][tname] = {"kind": "materialized", "file": rel,
                                      "columns": specs,
                                      "num_rows": dc.table.num_rows}
            if dc.table.sharding is not None:
                entry["tables"][tname]["shards"] = dc.table.sharding.mesh.size
        for mname, (model, train_cols) in container.models.items():
            rel = os.path.join("models", _q(schema_name), _q(mname) + ".pkl")
            with open(os.path.join(snap_dir, rel), "wb") as f:
                pickle.dump((model, train_cols), f)
            # the engine tag tells the port's load its own pickles apart
            entry["models"].append({"name": mname, "file": rel,
                                    "engine": _ENGINE})
        for tname, stats in container.statistics.items():
            if stats is not None and stats.row_count is not None:
                entry["statistics"][tname] = float(stats.row_count)
        manifest["schemas"][schema_name] = entry
        dropped = {}
        if container.function_lists:
            dropped["functions"] = sorted(container.function_lists)
        if container.experiments:
            dropped["experiments"] = sorted(container.experiments)
        views = context._views.get(schema_name)
        if views:
            dropped["views"] = sorted(views)
        if dropped:
            manifest["not_restored"][schema_name] = dropped
            logger.warning(
                "save_state: schema %r has live objects a snapshot cannot "
                "carry (%s); re-issue their DDL after load_state",
                schema_name, ", ".join(sorted(dropped)))

    epochs: dict = {}
    for (s, t), e in context._table_epochs.items():
        if e:
            epochs.setdefault(s, {})[t] = e
    if epochs:
        manifest["table_epochs"] = epochs

    if len(context.profiles):
        with open(os.path.join(snap_dir, "profiles.json"), "w") as f:
            json.dump(context.profiles.snapshot(), f)
        manifest["profiles"] = "profiles.json"

    bsnap = context.breaker.snapshot_state()
    if bsnap["open"]:
        with open(os.path.join(snap_dir, "breaker.json"), "w") as f:
            json.dump(bsnap, f)
        manifest["breaker"] = "breaker.json"

    with open(os.path.join(snap_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    # the fault site: a crash here, with the snapshot written and CURRENT
    # not yet repointed, leaves the previous snapshot live
    from .resilience import faults

    faults.maybe_inject("checkpoint", context.config)
    tmp = os.path.join(location, f".CURRENT.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(snap)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(location, "CURRENT"))
    for old in existing:
        shutil.rmtree(os.path.join(location, old), ignore_errors=True)
    return manifest


# ------------------------------------------------------------------- load
def load_state(context: "Context", location: str) -> dict:
    """Load the live snapshot under ``location`` into ``context``."""
    from .datacontainer import DataContainer, Statistics

    with open(os.path.join(location, "CURRENT")) as f:
        snap_dir = os.path.join(location, f.read().strip())
    with open(os.path.join(snap_dir, "manifest.json")) as f:
        manifest = json.load(f)

    changed = set()
    for schema_name, entry in manifest["schemas"].items():
        if schema_name not in context.schema:
            context.create_schema(schema_name)
        container = context.schema[schema_name]
        for tname, spec in entry["tables"].items():
            if spec["kind"] == "parquet":
                context.create_table(tname, spec["path"],
                                     schema_name=schema_name)
                continue
            table = _read_table(os.path.join(snap_dir, spec["file"]),
                                spec["columns"], spec["num_rows"],
                                context.device, context.config)
            if spec.get("shards", 1) > 1:
                # a table saved sharded shards over the loading Context's
                # default mesh, as create_table(distributed=True) does
                from .parallel.distribute import shard_table
                from .parallel.mesh import default_mesh

                table = shard_table(table, default_mesh(context.device.type))
            container.tables[tname] = DataContainer(table)
            context._views.get(schema_name, {}).pop(tname, None)
            changed.add((schema_name, tname))
        foreign = [m["name"] for m in entry.get("models", [])
                   if m.get("engine") != _ENGINE]
        if foreign:
            logger.warning(
                "load_state: schema %r has models another engine saved "
                "(%s); unpickling them would import that engine, so they "
                "are not loaded", schema_name, ", ".join(foreign))
        for m in entry.get("models", []):
            if m.get("engine") != _ENGINE:
                continue
            with open(os.path.join(snap_dir, m["file"]), "rb") as f:
                model, train_cols = pickle.load(f)
            if isinstance(model, torch_models._TorchEstimator):
                model.to(context.device)
            context.register_model(m["name"], model, train_cols,
                                   schema_name=schema_name)
        for tname, rows in entry.get("statistics", {}).items():
            container.statistics[tname] = Statistics(rows)
    context.schema_name = manifest.get("current_schema", context.schema_name)
    for schema_name, tables in manifest.get("table_epochs", {}).items():
        for tname, epoch in tables.items():
            key = (schema_name, tname)
            # never rewind an epoch a live context already passed
            context._table_epochs[key] = max(
                context._table_epochs.get(key, 0), int(epoch))
    if changed:
        context._on_catalog_change(tables=changed)
    profiles_rel = manifest.get("profiles")
    if profiles_rel:
        path = os.path.join(snap_dir, profiles_rel)
        if os.path.exists(path):
            with open(path) as f:
                restored = context.profiles.load(json.load(f))
            logger.info("load_state: restored %d query profiles", restored)
    breaker_rel = manifest.get("breaker")
    if breaker_rel:
        ttl = float(context.config.get(
            "resilience.breaker.persist_ttl_s", 300.0) or 0.0)
        path = os.path.join(snap_dir, breaker_rel)
        if ttl > 0 and os.path.exists(path):
            with open(path) as f:
                n = context.breaker.load_state(json.load(f), ttl_s=ttl)
            if n:
                context.metrics.inc("resilience.breaker.restored", n)
                logger.info("load_state: restored %d open breaker verdicts "
                            "(ttl %.0fs)", n, ttl)
    return manifest
