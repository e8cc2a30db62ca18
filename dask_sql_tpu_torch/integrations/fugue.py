"""FugueSQL execution-engine adapter of the port.

Counterpart of `dask_sql_tpu/integrations/fugue.py`: a SqlEngine that
routes FugueSQL SELECT statements through a `Context` (on the CUDA card),
an ExecutionEngine with that SQL engine pre-configured, and registration
of that engine under the name ``"torch"``.  Gated on the optional `fugue`
dependency, as in the reference.
"""
from __future__ import annotations

#: the engine name under which `register_engines` registers the port (the
#: reference registers ``"tpu"``)
ENGINE_NAME = "torch"

try:
    import fugue
    from fugue import SqlEngine

    _HAS_FUGUE = True
except ImportError:
    _HAS_FUGUE = False


if _HAS_FUGUE:

    class TorchSQLEngine(SqlEngine):
        """Fugue SqlEngine backed by a dask_sql_tpu_torch Context."""

        @property
        def is_distributed(self) -> bool:
            return True

        def select(self, dfs, statement):
            from ..context import Context

            context = Context()
            for name, df in dfs.items():
                context.create_table(name, df.as_pandas())
            result = context.sql(
                statement if isinstance(statement, str) else statement.construct())
            return fugue.dataframe.PandasDataFrame(result.compute())

    try:
        from fugue import NativeExecutionEngine

        class TorchSQLExecutionEngine(NativeExecutionEngine):
            """ExecutionEngine with the port's SQL engine pre-configured."""

            def create_default_sql_engine(self) -> SqlEngine:
                return TorchSQLEngine(self)

    except ImportError:
        TorchSQLExecutionEngine = None  # type: ignore[assignment]

    def register_engines() -> None:
        """Register (overwrite) the ``"torch"`` engine of fugue, which routes
        SQL through this port."""
        from fugue import register_execution_engine

        if TorchSQLExecutionEngine is not None:
            register_execution_engine(
                ENGINE_NAME,
                lambda conf, **kwargs: TorchSQLExecutionEngine(conf=conf),
                on_dup="overwrite",
            )

    try:  # registered at import, as the reference's
        register_engines()
    except Exception:  # dsql: allow-broad-except — registration best-effort
        pass

else:

    class TorchSQLEngine:  # type: ignore[no-redef]
        def __init__(self, *args, **kwargs):
            raise ImportError(
                "fugue is not installed; `pip install fugue` to use the adapter")

    class TorchSQLExecutionEngine:  # type: ignore[no-redef]
        def __init__(self, *args, **kwargs):
            raise ImportError(
                "fugue is not installed; `pip install fugue` to use the adapter")

    def register_engines() -> None:
        raise ImportError(
            "fugue is not installed; `pip install fugue` to use the adapter")
