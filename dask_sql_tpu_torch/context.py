"""The Context of the PyTorch port: register frames, run SQL, get pandas back.

Counterpart of `dask_sql_tpu/context.py`, lean: `create_table`, `sql` and a
lazy frame whose `compute()` returns pandas.  Tables live on the context's
device, which is the CUDA card unless the caller asks for the CPU.  Plans
come from the Python parser and binder, then the optimizer (the structural
rule loop, join reordering and dynamic partition pruning), as the
reference plans with its native planner off; a plan cache keyed by the SQL
text, the catalog's table uids and the config lets a repeated query skip
all of that.  The serving, result-cache, admission and observability tiers
of the reference are not ported yet.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch

from .columnar.dtypes import SqlType
from .columnar.table import Table, normalize_device
from .config import Config
from .datacontainer import SchemaContainer
from .planner import plan as plan_nodes
from .planner.binder import Binder
from .planner.catalog import Catalog, CatalogTable, Statistics
from .planner.expressions import Field
from .planner.parser import parse_sql
from .utils import Metrics

logger = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """The device of a Context: ``None`` means the CUDA card, which must be
    present; the CPU only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dask_sql_tpu_torch runs on a CUDA device, and none is available; "
            "pass device='cpu' to run on the CPU")
    return normalize_device(dev)


class TorchFrame:
    """Lazy query result: holds the plan; executes on `.compute()`
    (counterpart of the reference's `TpuFrame`)."""

    def __init__(self, context: "Context", plan, field_names: List[str],
                 config_options: Optional[Dict[str, Any]] = None):
        self._context = context
        self._plan = plan
        self._field_names = field_names
        self._result: Optional[Table] = None
        self._config_options = dict(config_options or {})

    @property
    def columns(self) -> List[str]:
        return list(self._field_names)

    def execute(self) -> Table:
        """Run the plan to a Table (cached)."""
        if self._result is None:
            from .physical.executor import Executor

            with self._context.config.set(self._config_options):
                self._result = Executor(self._context).execute_root(self._plan)
        return self._result

    def compute(self):
        """Materialize to a pandas DataFrame with the SQL output names."""
        df = self.execute().to_pandas()
        df.columns = self._disambiguated_names()
        return df

    def _disambiguated_names(self) -> List[str]:
        seen: Dict[str, int] = {}
        out = []
        for n in self._field_names:
            if n in seen:
                seen[n] += 1
                out.append(f"{n}{seen[n]}")
            else:
                seen[n] = 0
                out.append(n)
        return out


class Context:
    DEFAULT_SCHEMA_NAME = "root"
    _PLAN_CACHE_CAP = 128

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.schema_name = self.DEFAULT_SCHEMA_NAME
        self.schema: Dict[str, SchemaContainer] = {
            self.DEFAULT_SCHEMA_NAME: SchemaContainer(self.DEFAULT_SCHEMA_NAME)
        }
        self.config = Config()
        self.metrics = Metrics()
        #: plan-cache key -> optimized plan (LRU, `_PLAN_CACHE_CAP` entries)
        self._plan_cache: "OrderedDict[Tuple, Any]" = OrderedDict()

    def create_table(self, table_name: str, input_table: Any,
                     schema_name: Optional[str] = None) -> None:
        """Register a pandas frame, an Arrow table, a dict of columns or a
        port Table on this device (`input_utils`).  Loading picks each
        column's compressed encoding (``columnar.encoding*`` keys); the
        encoded columns are counted in
        ``metrics["columnar.encoding.encoded_columns"]`` and the resident
        bytes, encoded and as they would be decoded, recorded under
        ``columnar.encoding.encoded_bytes`` / ``decoded_bytes``."""
        from .input_utils import InputUtil

        schema_name = schema_name or self.schema_name
        if schema_name not in self.schema:
            raise KeyError(f"Schema {schema_name} not found")
        dc = InputUtil.to_dc(input_table, table_name, self.device,
                             config=self.config)
        self.schema[schema_name].tables[table_name] = dc
        table = dc.table
        if table.has_encoded_columns():
            from .columnar.encodings import Encoding, scan_bytes

            n_enc = sum(1 for c in table.columns.values()
                        if c.encoding is not Encoding.PLAIN)
            enc_b, dec_b = scan_bytes(table)
            self.metrics.inc("columnar.encoding.encoded_columns", n_enc)
            self.metrics.observe("columnar.encoding.encoded_bytes", enc_b)
            self.metrics.observe("columnar.encoding.decoded_bytes", dec_b)

    def sql(self, sql: str, return_futures: bool = True,
            config_options: Optional[Dict[str, Any]] = None):
        """Plan a SQL query (or take its plan from the plan cache); run it
        lazily (`.compute()`) or, with ``return_futures=False``, now to
        pandas."""
        if not isinstance(sql, str):
            raise ValueError("sql must be a string")
        with self.config.set(config_options):
            key = self._plan_cache_key(sql, config_options)
            plan = None if key is None else self._plan_cache.get(key)
            if plan is not None:
                self._plan_cache.move_to_end(key)
                self.metrics.inc("query.plan_cache.hit")
            else:
                self.metrics.inc("query.plan_cache.miss")
                statements = parse_sql(sql)
                if len(statements) != 1:
                    raise NotImplementedError("one statement per call in the port")
                plan = self._get_ral(statements[0])
                if isinstance(plan, plan_nodes.CustomNode):
                    raise NotImplementedError(
                        f"{type(plan).__name__} statements are not in the port yet")
                if key is not None:
                    self._plan_cache[key] = plan
                    while len(self._plan_cache) > self._PLAN_CACHE_CAP:
                        self._plan_cache.popitem(last=False)
        frame = TorchFrame(self, plan, [f.name for f in plan.schema],
                           config_options)
        return frame if return_futures else frame.compute()

    def _plan_cache_key(self, sql: str, config_options) -> Optional[Tuple]:
        """Cache key of a SQL text against the current catalog and config,
        or None when a config value is unhashable.  DPP reads the dimension
        side at plan time, so its inputs are pinned by the table uids."""
        try:
            parts: List[Any] = [sql, self.schema_name]
            parts.extend(self._catalog_signature())
            parts.append(self.config.effective_items())
            if config_options:
                parts.append(tuple(sorted(config_options.items())))
            key = tuple(parts)
            hash(key)
            return key
        except TypeError:
            return None

    def _catalog_signature(self) -> List[Any]:
        """Versioned identity of the catalog: per schema, its tables' uids
        (registering a table again gives it a new uid, and so a new
        signature)."""
        parts: List[Any] = []
        for schema_name in sorted(self.schema):
            parts.append(schema_name)
            parts.append(tuple(sorted(
                (name, dc.uid)
                for name, dc in self.schema[schema_name].tables.items())))
        return parts

    def _get_ral(self, stmt):
        """AST -> bound plan -> optimized plan, as the reference's
        `_get_ral` with its native planner off.  An optimizer failure falls
        back to the unoptimized plan, counted in
        ``metrics["planner.optimize.fallback"]``."""
        catalog = self._prepare_catalog()
        case_sensitive = bool(self.config.get("sql.identifier.case_sensitive", True))
        catalog.case_sensitive = case_sensitive
        plan = Binder(catalog, case_sensitive=case_sensitive).bind_statement(stmt)
        if self.config.get("sql.optimize", True):
            from .planner.optimizer.driver import optimize_core, optimize_post
            from .resilience.errors import QueryError

            try:
                plan = optimize_core(plan, self.config, catalog)
                plan = optimize_post(plan, self.config, catalog, context=self)
            except QueryError:
                raise
            except Exception:
                self.metrics.inc("planner.optimize.fallback")
                logger.warning("Optimization failed; using unoptimized plan",
                               exc_info=True)
        return plan

    def _prepare_catalog(self) -> Catalog:
        catalog = Catalog(self.schema_name)
        catalog.current_schema = self.schema_name
        for schema_name, container in self.schema.items():
            catalog.add_schema(schema_name)
            cschema = catalog.schemas[schema_name]
            for table_name, dc in container.tables.items():
                table = dc.table
                fields = [
                    Field(name, col.sql_type, col.validity is not None or
                          col.sql_type in (SqlType.FLOAT, SqlType.DOUBLE))
                    for name, col in table.columns.items()
                ]
                cschema.tables[table_name] = CatalogTable(
                    table_name, schema_name, fields,
                    Statistics(float(table.num_rows)))
        return catalog

    def get_table_data(self, schema_name: str, table_name: str) -> Table:
        dc = self.schema[schema_name].tables.get(table_name)
        if dc is None:
            raise KeyError(f"Table {schema_name}.{table_name} not found")
        return dc.table
