"""Interactive REPL CLI.

Copied from `dask_sql_tpu/cmd.py`: a REPL (prompt_toolkit when it is
installed, ``input()`` otherwise) with psql-style meta commands (\\l \\dt
\\df \\dm \\de \\dss \\dsc \\conf \\q).  Statements run on the Context's
device, the CUDA card unless ``--device`` names another one.  Models and
experiments are the ML port's (ROADMAP.md Queue 1 item 9): until then
\\dm and \\de list none.  Run ``python -m dask_sql_tpu_torch.cmd``.
"""
from __future__ import annotations

import sys
from typing import Optional


META_COMMANDS_HELP = """
\\l             list schemas
\\dt            list tables in the current schema
\\df            list user-defined functions
\\dm            list models
\\de            list experiments
\\dss <schema>  switch schema
\\dsc <schema>  show tables of a schema
\\conf [key]    show configuration
\\q             quit
"""


def _handle_meta(context, text: str) -> bool:
    """Handle a psql-style meta command; returns True when handled."""
    import pandas as pd

    cmd, _, arg = text.strip().partition(" ")
    arg = arg.strip()
    schema = context.schema[context.schema_name]
    if cmd == "\\l":
        print(pd.DataFrame({"Schema": list(context.schema.keys())}))
    elif cmd == "\\dt":
        print(pd.DataFrame({"Table": list(schema.tables.keys())}))
    elif cmd == "\\df":
        print(pd.DataFrame({"Function": list(schema.function_lists.keys())}))
    elif cmd == "\\dm":
        print(pd.DataFrame({"Model": list(getattr(schema, "models", {}))}))
    elif cmd == "\\de":
        print(pd.DataFrame({"Experiment": list(getattr(schema, "experiments",
                                                       {}))}))
    elif cmd == "\\dss":
        if arg in context.schema:
            context.schema_name = arg
            print(f"Schema switched to {arg}")
        else:
            print(f"Schema {arg!r} not found")
    elif cmd == "\\dsc":
        if arg in context.schema:
            print(pd.DataFrame({"Table": list(context.schema[arg].tables.keys())}))
        else:
            print(f"Schema {arg!r} not found")
    elif cmd == "\\conf":
        from .config import DEFAULTS

        items = {k: context.config.get(k) for k in DEFAULTS
                 if not arg or arg in k}
        print(pd.DataFrame({"Key": list(items.keys()), "Value": [str(v) for v in items.values()]}))
    elif cmd in ("\\q", "quit", "exit"):
        raise EOFError
    elif cmd in ("\\?", "help"):
        print(META_COMMANDS_HELP)
    else:
        return False
    return True


def _run_query(context, sql: str):
    import time

    t0 = time.perf_counter()
    try:
        result = context.sql(sql)
        if result is not None:
            print(result.compute())
        elapsed = time.perf_counter() - t0
        print(f"({elapsed:.3f}s)")
    except Exception as e:  # dsql: allow-broad-except — REPL surfaces all errors
        print(f"ERROR: {e}", file=sys.stderr)


def cmd_loop(context=None, client=None, startup: bool = False,
             log_level=None):  # pragma: no cover - interactive
    """Read statements and meta commands until EOF or \\q; ``context`` is
    a new Context on the CUDA card when None."""
    from .context import Context

    context = context if context is not None else Context()
    print(f"dask-sql-tpu (torch, {context.device}). "
          "Type \\? for help, \\q to quit.")
    try:
        from prompt_toolkit import PromptSession
        from prompt_toolkit.history import InMemoryHistory

        session = PromptSession(history=InMemoryHistory())
        read = lambda: session.prompt("(torch-sql) > ")
    except ImportError:
        read = lambda: input("(torch-sql) > ")

    while True:
        try:
            text = read()
        except (EOFError, KeyboardInterrupt):
            break
        if not text.strip():
            continue
        try:
            if text.strip().startswith("\\") or text.strip() in ("quit", "exit", "help"):
                if _handle_meta(context, text):
                    continue
            _run_query(context, text)
        except EOFError:
            break


def main(argv=None):  # pragma: no cover - console entrypoint
    import argparse

    from .context import Context

    parser = argparse.ArgumentParser(description="SQL REPL on a torch device")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the tables and queries "
                             "(default: the CUDA card)")
    args = parser.parse_args(argv)
    cmd_loop(Context(device=args.device))


if __name__ == "__main__":  # pragma: no cover
    main()
