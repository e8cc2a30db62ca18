"""The port's self-lint (`dask_sql_tpu_torch/analysis/`: selflint.py,
concurrency.py, dataflow.py, effects.py, configkeys.py, the CLI) against
the reference's.

Every lint test of the reference (`tests/unit/test_analysis.py`,
`test_concurrency.py`, `test_effects.py`) runs once more with its linter
entry points standing in for both linters: each snippet goes through the
reference's and the port's, and their findings must be the same
``(rule, line)`` pairs.  A snippet built on a JAX name (``jax.jit``,
``jnp.asarray``, ``jax.device_put``, ``block_until_ready``) reaches the port
as its twin with the port's name (`TWINS`) and must give the reference
snippet's findings.  The dead-key pass anchors its findings in each
engine's own config.py, so those compare by key, over the keys both
registries hold.  `test_dataflow.py`'s cases run against the port's
dataflow module, and must find the same paths.

Then the port's own: DSQL301 on a compiled pipeline's run path, DSQL602's
port names, the CLI's exit codes and its JSON and SARIF output, the
config-key registry and ``analysis.strict_config`` (held against
`tests/unit/test_config.py`), and ``self_lint()`` of the port equal to
``[]``.
"""
import inspect
import itertools
import json
import logging
import os

import pytest

import dask_sql_tpu.config as ref_config
from dask_sql_tpu.analysis import configkeys as ref_configkeys
from dask_sql_tpu.analysis import concurrency as ref_concurrency
from dask_sql_tpu.analysis import effects as ref_effects
from dask_sql_tpu.analysis import selflint as ref_selflint
from dask_sql_tpu_torch import config as port_config
from dask_sql_tpu_torch.analysis import configkeys, concurrency, dataflow, \
    effects, selflint
from dask_sql_tpu_torch.analysis.__main__ import main
from tests.unit import test_analysis, test_concurrency, test_dataflow, \
    test_effects

#: JAX names of the reference's snippets -> the port's name for the same
#: hazard, applied in order
TWINS = (
    ("jax.jit(fn)(x)", '_build.library("segsum").dsql_segsum_typed(x)'),
    ("jax.device_put(x)", "x.to(device)"),
    ("jnp.asarray(x)", "torch.as_tensor(x)"),
    ("x.block_until_ready()", "torch.cuda.synchronize()"),
    ("jax.jit(", "torch.compile("),
    ("import jax\n", "import torch\n"),
)
_JAX_NAMES = ("jax", "jnp", "pallas_call", "block_until_ready")


def twin(src: str) -> str:
    for old, new in TWINS:
        src = src.replace(old, new)
    assert not any(n in src for n in _JAX_NAMES), src
    return src


_REF_CONFIG_PATH = os.path.join("dask_sql_tpu", "config.py")
_PORT_CONFIG_PATH = os.path.join("dask_sql_tpu_torch", "config.py")
_REF_CONFIG_SRC = inspect.getsource(ref_config)
_PORT_CONFIG_SRC = inspect.getsource(port_config)
_COMMON_KEYS = set(ref_config.DOCUMENTED_KEYS) & set(
    port_config.DOCUMENTED_KEYS)


def _port_sources(sources):
    out = {}
    for path, src in sources.items():
        if path == _REF_CONFIG_PATH:
            path = _PORT_CONFIG_PATH
            src = _PORT_CONFIG_SRC if src == _REF_CONFIG_SRC else src
        out[path] = twin(src)
    return out


def _key(finding):
    """(rule, line); a dead-key finding anchors in its engine's config.py,
    so it compares by the key it names."""
    if finding.path.endswith("config.py") and finding.rule == "DSQL703":
        key = finding.message.split("'")[1]
        return (finding.rule, key) if key in _COMMON_KEYS else None
    return (finding.rule, finding.line)


def _keys(findings):
    return sorted(k for k in map(_key, findings) if k is not None)


class _Both:
    """Stand-ins for the reference test modules' linter entry points: run
    both linters, record the two finding lists, answer the reference's."""

    def __init__(self):
        self.pairs = []

    def _record(self, what, ref, port):
        self.pairs.append((what, _keys(ref), _keys(port)))
        return ref

    def lint_source(self, src, path):
        return self._record(
            (src, path), ref_selflint.lint_source(src, path),
            selflint.lint_source(twin(src), path))

    def lock_order_findings(self, sources):
        return self._record(
            sources, ref_concurrency.lock_order_findings(sources),
            concurrency.lock_order_findings(_port_sources(sources)))

    def boundary_exception_findings(self, sources):
        return self._record(
            sources, ref_effects.boundary_exception_findings(sources),
            effects.boundary_exception_findings(_port_sources(sources)))

    def dead_config_key_findings(self, sources):
        return self._record(
            sources, ref_configkeys.dead_config_key_findings(sources),
            configkeys.dead_config_key_findings(_port_sources(sources)))


_ENTRIES = ("lint_source", "lock_order_findings",
            "boundary_exception_findings", "dead_config_key_findings")


def _param_sets(fn):
    """Each kwargs dict a reference test's parametrize marks expand to."""
    axes = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        rows = []
        for v in values:
            v = v.values if hasattr(v, "values") else v
            v = v if len(names) > 1 else (v,)
            rows.append(dict(zip(names, v)))
        axes.append(rows)
    for combo in itertools.product(*axes):
        out = {}
        for part in combo:
            out.update(part)
        yield out


def _lint_cases():
    cases = []
    for mod in (test_analysis, test_concurrency, test_effects):
        for name, fn in sorted(vars(mod).items()):
            if not (name.startswith("test_") and inspect.isfunction(fn)):
                continue
            src = inspect.getsource(fn)
            if not any(e in src for e in _ENTRIES + ("_findings(",)):
                continue
            if "main(" in src or "self_lint()" in src:
                continue  # the CLI and the reference's own self-lint
            for kwargs in _param_sets(fn):
                extra = set(inspect.signature(fn).parameters) - set(kwargs)
                assert not extra, (name, extra)
                label = "-".join(str(v)[:24] for v in kwargs.values())
                cases.append(pytest.param(
                    mod, fn, kwargs,
                    id=f"{mod.__name__.rsplit('.', 1)[1]}::{name}"
                       + (f"[{label}]" if label else "")))
    return cases


@pytest.mark.parametrize("mod,fn,kwargs", _lint_cases())
def test_reference_snippets_give_the_same_findings(mod, fn, kwargs,
                                                   monkeypatch):
    both = _Both()
    for entry in _ENTRIES:
        if hasattr(mod, entry):
            monkeypatch.setattr(mod, entry, getattr(both, entry))
    fn(**kwargs)
    assert both.pairs, "the test linted nothing"
    for what, ref, port in both.pairs:
        assert port == ref, (what, ref, port)


def test_every_lint_snippet_is_covered():
    """The collection above reaches every reference lint test but the CLI's
    and the reference's self-lint, which have port tests of their own."""
    names = {p.id.split("[")[0] for p in _lint_cases()}
    assert len(names) >= 35, sorted(names)
    assert "test_concurrency::test_blocking_under_lock_catalog" in names
    assert "test_effects::test_dead_registry_key_reported_at_its_registry_line" \
        in names


def _dataflow_cases():
    return [pytest.param(fn, id=name)
            for name, fn in sorted(vars(test_dataflow).items())
            if name.startswith("test_") and inspect.isfunction(fn)]


@pytest.mark.parametrize("fn", _dataflow_cases())
def test_dataflow_cases_find_the_same_paths_in_the_port(fn, monkeypatch):
    for name in ("ForwardAnalysis", "build_cfg", "find_path",
                 "format_witness", "path_lines"):
        monkeypatch.setattr(test_dataflow, name, getattr(dataflow, name))
    monkeypatch.setattr(test_dataflow, "_Reaches", type(
        "_Reaches", (dataflow.ForwardAnalysis,),
        {"transfer": test_dataflow._Reaches.transfer}))
    fn()


def test_the_rules_and_tokens_are_the_references():
    assert selflint.RULES.keys() == ref_selflint.RULES.keys()
    assert selflint._SUPPRESS == ref_selflint._SUPPRESS
    assert [p.name for p in effects.EFFECT_PAIRS] == \
        [p.name for p in ref_effects.EFFECT_PAIRS]


# ------------------------------------------------------- the port's names
_RUN_PATH = os.path.join("dask_sql_tpu_torch", "physical", "compiled.py")

HOST_SYNC_SRC = """\
import numpy as np
import torch

class CompiledThing:
    def _plan(self, t):
        return t.tolist()

    def run(self, table):
        out = self._step(table)
        return out

def _step_helper(x):
    return x

class Other:
    def _step(self, table):
        return _pull(table)

def _pull(t):
    return t.{call}
"""


@pytest.mark.parametrize("call,method", [
    ("cpu()", ".cpu()"), ("item()", ".item()"), ("tolist()", ".tolist()"),
    ("numpy()", ".numpy()"), ('to("cpu")', '.to("cpu")'),
    ('to(device="cpu")', '.to("cpu")'),
    ('to(torch.device("cpu"))', '.to("cpu")'),
])
def test_host_sync_on_a_run_path(call, method):
    src = HOST_SYNC_SRC.format(call=call)
    found = [f for f in selflint.lint_source(src, _RUN_PATH)
             if f.rule == "DSQL301"]
    # run -> _step (any class of the module, by name) -> _pull; `_plan`
    # is not reached from a run method
    assert [(f.line, f.message.split(" ")[0]) for f in found] == \
        [(20, method)]
    # a module that runs no compiled pipeline makes no claim
    assert selflint.lint_source(src, "dask_sql_tpu_torch/ops/x.py") == []
    # a device-local move is no pull
    moved = src.replace(f"t.{call}", "t.to(torch.float64)")
    assert not [f for f in selflint.lint_source(moved, _RUN_PATH)
                if f.rule == "DSQL301"]
    # the packed transfer is annotated at its site
    ok = src.replace(f"t.{call}",
                     f"t.{call}  # dsql: allow-host-sync — the packed pull")
    assert selflint.lint_source(ok, _RUN_PATH) == []


def test_host_sync_calls_and_captured_functions():
    src = HOST_SYNC_SRC.format(call="cpu()") + (
        "\ndef runner(x):\n"
        "    return np.asarray(x)\n"
        "\ndef waits(x):\n"
        "    torch.cuda.synchronize()\n"
        "    return x\n")
    found = [(f.line, f.rule) for f in selflint.lint_source(src, _RUN_PATH)]
    assert found == [(20, "DSQL301")]   # neither helper is on a run path
    for capture in ("torch.compile", "torch.jit.script",
                    "torch.cuda.make_graphed_callables"):
        captured = src + f"\ng = {capture}(runner)\nh = {capture}(waits)\n"
        assert [(f.line, f.rule)
                for f in selflint.lint_source(captured, "x.py")] == \
            [(23, "DSQL301"), (26, "DSQL301")], capture


BLOCKING_SRC = """\
import threading

import torch

from .. import _build

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def f(self, x, device):
        with self._lock:
            return {call}
"""


@pytest.mark.parametrize("call,expect", [
    ('_build.library("segsum")', True),
    ("_build.build()", True),
    ('_build.library("segsum").dsql_segsum_typed(x)', True),
    ("lib.dsql_segsum_plan(x)", True),
    ("torch.cuda.synchronize()", True),
    ("event.synchronize()", True),
    ("x.cpu()", True),
    ("x.to(device)", True),
    ("x.tolist()", True),
    ("x.numpy()", True),
    ("x.item()", True),
    ("torch.as_tensor(x)", True),
    ("torch.empty(4, device=device)", False),
    ("x + 1", False),
    ("build(x)", False),   # a bare `build` outside _build.py
])
def test_blocking_under_lock_port_names(call, expect):
    src = BLOCKING_SRC.format(call=call)
    found = [f for f in selflint.lint_source(src, "serving/x.py")
             if f.rule == "DSQL602"]
    assert bool(found) == expect, (call, found)
    if expect:
        assert found[0].line == 13


def test_the_build_modules_own_entry_points_block():
    src = BLOCKING_SRC.format(call="library(x)")
    found = [f for f in selflint.lint_source(src, "pkg/_build.py")
             if f.rule == "DSQL602"]
    assert [f.line for f in found] == [13]


def test_singleflight_pair_matches_the_ports_helpers():
    """The compiled caches' build claim is the reference's pair: dropping
    the finally that settles it is a DSQL701 leak."""
    src = ("def get(cache, key, build):\n"
           "    pending = singleflight_begin(key)\n"
           "    compiled = build()\n"
           "    singleflight_done(key, pending)\n"
           "    return compiled\n")
    found = selflint.lint_source(src, "x.py")
    assert [(f.rule, f.line) for f in found] == [("DSQL701", 2)]
    assert "compile-singleflight" in found[0].message
    fixed = ("def get(cache, key, build):\n"
             "    pending = singleflight_begin(key)\n"
             "    try:\n"
             "        return build()\n"
             "    finally:\n"
             "        singleflight_done(key, pending)\n")
    assert selflint.lint_source(fixed, "x.py") == []


def test_the_serving_boundary_is_torchframe_execute():
    src = ("class TorchFrame:\n"
           "    def execute(self):\n"
           "        return self._go()\n"
           "    def _go(self):\n"
           "        raise ValueError('x')\n")
    path = os.path.join("dask_sql_tpu_torch", "context.py")
    found = effects.boundary_exception_findings({path: src})
    assert [(f.rule, f.line) for f in found] == [("DSQL702", 5)]
    assert "TorchFrame.execute" in found[0].message


# ------------------------------------------------------------- the CLI
BAD = test_concurrency.CYCLE_SRC.format(mark="") \
    + "\ntry:\n    x = 1\nexcept Exception:\n    pass\n"


def test_cli_exit_codes_json_and_sarif(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD)
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")

    assert main(["--rules"]) == 0
    assert "DSQL703" in capsys.readouterr().out
    assert main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "DSQL601" in out and "DSQL101" in out
    assert out.strip().endswith("finding(s) in 1 file(s)")
    assert main(["--rule", "DSQL101", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "DSQL101" in out and "DSQL601" not in out

    assert main(["--format", "json", "--rule", "DSQL601", str(bad)]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["rules"] == ["DSQL601"] and payload["files"] == 1
    assert [f["rule"] for f in payload["findings"]] == ["DSQL601"]
    assert payload["findings"][0]["path"] == str(bad)

    assert main(["--format", "sarif", str(bad)]) == 1
    sarif = json.loads(capsys.readouterr().out)
    run = sarif["runs"][0]
    assert sarif["version"] == "2.1.0"
    assert run["tool"]["driver"]["name"] == "dask-sql-tpu-torch-selflint"
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == \
        set(selflint.RULES)
    assert sorted(r["ruleId"] for r in run["results"]) == \
        ["DSQL101", "DSQL601"]
    loc = run["results"][0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == str(bad)
    assert loc["region"]["startLine"] >= 1

    assert main(["--format", "json", str(ok)]) == 0
    assert json.loads(capsys.readouterr().out)["findings"] == []
    assert main([]) == 2                           # nothing to lint
    assert main(["--rule", "DSQL999", str(ok)]) == 2
    capsys.readouterr()


@pytest.fixture(scope="module")
def port_findings():
    """One self-lint of `dask_sql_tpu_torch/` for the module."""
    return selflint.self_lint()


def test_self_lint_of_the_port_is_clean(port_findings):
    assert port_findings == [], "\n".join(f.format() for f in port_findings)
    files = selflint.package_files()
    assert all(f.startswith(os.path.dirname(port_config.__file__))
               for f in files)
    assert any(f.endswith(os.path.join("resilience", "chaos.py"))
               for f in files)


def test_cli_self_mode_json(port_findings, monkeypatch, capsys):
    from dask_sql_tpu_torch.analysis import __main__ as cli

    monkeypatch.setattr(cli, "self_lint", lambda: port_findings)
    assert main(["--self", "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == []
    assert payload["files"] == len(selflint.package_files())


def test_the_dead_key_pass_sees_the_ports_registry():
    src = {_PORT_CONFIG_PATH: _PORT_CONFIG_SRC, "a.py": "x = 1\n"}
    dead = {f.message.split("'")[1]
            for f in configkeys.dead_config_key_findings(src)}
    # every key but the one read in config.py itself (and the reserved
    # parity key its registry row keeps alive) is dead here
    assert dead == set(port_config.DOCUMENTED_KEYS) - {
        "analysis.strict_config", "sql.shuffle.num_buckets"}


def test_an_unregistered_read_of_the_port_is_found():
    """The port read ``sql.compile.select`` without registering it: the
    streaming modules' reads are literal, so DSQL703 sees them."""
    src = ("def f(config):\n"
           "    return config.get('sql.compile.select', True)\n")
    assert selflint.lint_source(src, "streaming/plan.py") == []
    try:
        spec = port_config.DOCUMENTED_KEYS.pop("sql.compile.select")
        found = selflint.lint_source(src, "streaming/plan.py")
    finally:
        port_config.DOCUMENTED_KEYS["sql.compile.select"] = spec
    assert [(f.rule, f.line) for f in found] == [("DSQL703", 2)]


# --------------------------------------------- the config-key registry
def test_documented_keys_registry_covers_defaults():
    from dask_sql_tpu_torch.config import (DEFAULTS, DOCUMENTED_KEYS,
                                           KeySpec, is_documented_key)

    assert set(DOCUMENTED_KEYS) == set(DEFAULTS)
    spec = DOCUMENTED_KEYS["sql.optimize"]
    assert isinstance(spec, KeySpec)
    assert spec.default is True and bool in spec.types
    assert DOCUMENTED_KEYS["serving.deadline_s"].types == \
        ref_config.DOCUMENTED_KEYS["serving.deadline_s"].types
    for key in _COMMON_KEYS:
        assert DOCUMENTED_KEYS[key] == ref_config.DOCUMENTED_KEYS[key], key
    assert is_documented_key("sql.optimize")
    assert not is_documented_key("sql.not-a-key")


def _strict_warnings(get, set_strict, caplog, logger_name, suffix):
    with caplog.at_level(logging.WARNING, logger=logger_name):
        assert get(f"strictcfg.{suffix}.off", 7) == 7
    assert not caplog.records
    with set_strict():
        with caplog.at_level(logging.WARNING, logger=logger_name):
            assert get(f"strictcfg.{suffix}.on", 7) == 7
            assert get(f"strictcfg.{suffix}.on", 7) == 7  # second: silent
            assert get("sql.optimize") is True   # registered: silent
    return [r.getMessage() for r in caplog.records]


def test_strict_config_warns_once_per_unregistered_key(caplog):
    """The port's per-Context config warns as the reference's process
    config does (`tests/unit/test_config.py`)."""
    from dask_sql_tpu import config as rconfig

    ref = _strict_warnings(
        rconfig.get, lambda: rconfig.set({"analysis.strict_config": True}),
        caplog, "dask_sql_tpu.config", "ref")
    caplog.clear()
    cfg = port_config.Config()
    port = _strict_warnings(
        cfg.get, lambda: cfg.set({"analysis.strict_config": True}),
        caplog, "dask_sql_tpu_torch.config", "port")
    assert [m.replace("strictcfg.ref", "strictcfg.port") for m in ref] \
        == port
    assert len(port) == 1 and "DOCUMENTED_KEYS" in port[0]
