"""CLI: ``python -m dask_sql_tpu_torch.analysis --self`` (the port's
self-lint) or ``python -m dask_sql_tpu_torch.analysis path.py ...`` (lint
specific files).  Counterpart of `dask_sql_tpu/analysis/__main__.py`.

Exit code 0 = clean, 1 = findings, 2 = bad invocation.
``tests/test_torch_selflint.py`` and ``chip_smoke.py`` run ``--self``.

``--rule DSQLnnn`` (repeatable) restricts the report to specific rules so
a pre-commit hook can gate on e.g. the concurrency rules alone;
``--format json`` emits a machine-readable report (one object with
``findings`` / ``files`` / ``rules``) so CI can diff findings across
runs; ``--format sarif`` emits a minimal SARIF 2.1.0 log so code-scanning
UIs (GitHub, VS Code SARIF viewers) can render findings in place.
"""
from __future__ import annotations

import argparse
import json
import sys

from .selflint import RULES, lint_paths, package_files, self_lint


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dask_sql_tpu_torch.analysis",
        description="Static self-lint for the dask_sql_tpu_torch engine")
    parser.add_argument("--self", dest="self_mode", action="store_true",
                        help="lint the installed engine package")
    parser.add_argument("--rules", action="store_true",
                        help="list rule ids and exit")
    parser.add_argument("--rule", action="append", default=[],
                        metavar="DSQLnnn",
                        help="report only this rule id (repeatable)")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default="text",
                        help="output format (default: text)")
    parser.add_argument("paths", nargs="*", help="python files to lint")
    args = parser.parse_args(argv)

    if args.rules:
        for rule, doc in sorted(RULES.items()):
            print(f"{rule}: {doc}")
        return 0
    if not args.self_mode and not args.paths:
        parser.print_usage(sys.stderr)
        return 2
    unknown = [r for r in args.rule if r not in RULES and r != "DSQL000"]
    if unknown:
        print(f"unknown rule id(s): {', '.join(unknown)} "
              f"(--rules lists them)", file=sys.stderr)
        return 2

    if args.self_mode:
        findings = self_lint()
        n_files = len(package_files())
    else:
        findings = lint_paths(args.paths)
        n_files = len(args.paths)
    if args.rule:
        wanted = set(args.rule)
        findings = [f for f in findings if f.rule in wanted]

    if args.format == "sarif":
        print(json.dumps(_sarif(findings), indent=2))
    elif args.format == "json":
        print(json.dumps({
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "message": f.message}
                for f in findings
            ],
            "files": n_files,
            "rules": sorted(args.rule) if args.rule else sorted(RULES),
        }, indent=2))
    else:
        for f in findings:
            print(f.format())
        print(f"self-lint: {len(findings)} finding(s) in "
              f"{n_files} file(s)")
    return 1 if findings else 0


def _sarif(findings) -> dict:
    """Minimal SARIF 2.1.0 log: one run, the full rule catalog in the
    driver, one ``result`` per finding with a physical location."""
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "dask-sql-tpu-torch-selflint",
                "informationUri":
                    "https://github.com/dask-contrib/dask-sql",
                "rules": [
                    {"id": rule,
                     "shortDescription": {"text": doc}}
                    for rule, doc in sorted(RULES.items())
                ],
            }},
            "results": [
                {"ruleId": f.rule,
                 "level": "error",
                 "message": {"text": f.message},
                 "locations": [{"physicalLocation": {
                     "artifactLocation": {"uri": f.path},
                     "region": {"startLine": max(f.line, 1)},
                 }}]}
                for f in findings
            ],
        }],
    }


if __name__ == "__main__":
    sys.exit(main())
