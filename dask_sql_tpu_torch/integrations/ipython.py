"""IPython %%sql magic: registers a sql line and cell magic bound to a
Context; with auto_include, the pandas frames of the calling namespace are
registered first.  Copied from `dask_sql_tpu/integrations/ipython.py`.
The magic answers through `Context.sql`, so on the Context's device."""
from __future__ import annotations


def ipython_integration(context, auto_include: bool = False,
                        disable_highlighting: bool = True) -> None:
    try:
        from IPython.core.magic import needs_local_scope, register_line_cell_magic
    except ImportError as e:
        raise ImportError("IPython is required for the %%sql magic") from e

    @needs_local_scope
    def sql(line, cell=None, local_ns=None):
        sql_statement = cell if cell is not None else line
        if auto_include and local_ns:
            import pandas as pd

            for name, value in list(local_ns.items()):
                if isinstance(value, pd.DataFrame) and not name.startswith("_"):
                    context.create_table(name, value)
        result = context.sql(sql_statement)
        return result.compute() if result is not None else None

    register_line_cell_magic(sql)

    if not disable_highlighting:
        # best-effort SQL syntax highlighting of %%sql cells in classic
        # notebooks (parity: the reference's codemirror magic_spec injection)
        try:
            from IPython.display import Javascript, display

            display(Javascript(
                "if (window.IPython && IPython.CodeCell) {"
                "IPython.CodeCell.options_default.highlight_modes"
                "['magic_text/x-sql'] = {'reg': [/^%%sql/]};}"))
        except Exception:  # dsql: allow-broad-except — notebook JS
            # injection is cosmetic; failing it must not break the magic
            pass
