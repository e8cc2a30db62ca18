"""Engine self-lint of the PyTorch port: AST rules for the hazards of the
serving path.

Counterpart of `dask_sql_tpu/analysis/selflint.py`.  Every rule keeps the
reference's id, meaning and suppression comment; the rules that named JAX
calls match the port's counterparts instead (DSQL301 here, DSQL602 in
concurrency.py), and DSQL401/501/703 read the port's own registries.

The serving runtime made the engine multi-threaded and the resilience
layer made exception *types* load-bearing — a swallowed taxonomy error or
an off-lock mutation is a correctness bug, not a style issue.  These rules
encode the hazard families as static checks (``python -m
dask_sql_tpu_torch.analysis --self`` and tests/test_torch_selflint.py):

DSQL101  broad-except
    ``except Exception`` / ``except BaseException`` / bare ``except:``
    can swallow taxonomy ``QueryError``s (deadline expiry, cancellation,
    resource exhaustion) that policy layers upstream must see.  A handler
    passes if an earlier clause of the same ``try`` re-raises the
    taxonomy (``except QueryError: raise``), if the broad handler itself
    unconditionally re-raises, or if the site carries a
    ``# dsql: allow-broad-except`` suppression with its reason.

DSQL201  lock-coverage
    In a class that owns a ``threading.Lock``/``RLock``/``Condition``,
    an attribute mutated under ``with self.<lock>:`` somewhere must be
    mutated under it *everywhere* (outside ``__init__``): one unguarded
    site re-introduces the race the lock exists to prevent.  Methods
    named ``*_locked`` are exempt by convention (the caller holds the
    lock); suppress any other deliberate site with
    ``# dsql: allow-unlocked``.

DSQL301  host-sync
    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``.to("cpu")`` / ``torch.cuda.synchronize`` / ``np.asarray`` /
    ``np.array`` inside the code that runs a compiled pipeline on the
    card waits for the device there: one undocumented pull per call.
    The port traces nothing, so its "traced" scope is (a) the run path
    of the compiled pipelines — every function of `physical/compiled.py`,
    `compiled_join.py`, `compiled_select.py`, `compiled_predict.py`,
    `physical/streaming.py` or `inference/programs.py` reachable from a
    ``run`` / ``run_batched`` method, the predict seam
    ``_extra_pack_outputs`` or a model program's ``apply`` through calls
    by name within the module — and (b) functions handed to or decorated
    with a capturing entry point (``torch.compile``, ``torch.jit.script``
    / ``trace``, ``torch.cuda.make_graphed_callables``), where a host sync
    breaks the graph or the capture.  Suppress a deliberate pull (the
    packed transfer) with ``# dsql: allow-host-sync`` and the reason.

DSQL401  metric-registry coverage
    Every string-literal metric name passed to ``metrics.inc`` /
    ``metrics.observe`` / ``metrics.gauge`` (and the cache's ``self._mark``
    forwarder) must appear in the documented registry
    (``serving/metrics.py DOCUMENTED_METRICS`` /
    ``DOCUMENTED_METRIC_PREFIXES`` for f-string families) — a typo'd name
    silently splits a time series and dashboards go dark.  Dynamic names
    (plain variables) make no claim; suppress deliberate one-offs with
    ``# dsql: allow-metric-name``.

DSQL501  flight-recorder event vocabulary
    Every string-literal event name passed to ``flight.record(...)``
    (observability/flight.py) must be in the registered event vocabulary
    (``EVENT_NAMES`` / ``EVENT_NAME_PREFIXES``) — the flight recorder is
    the engine's postmortem timeline, and a typo'd event name silently
    splits it exactly like an unregistered metric splits a time series.
    Same literal/prefix machinery as DSQL401; suppress deliberate
    one-offs with ``# dsql: allow-flight-event``.

DSQL601  lock-order cycle (whole-repo; analysis/concurrency.py)
    A cycle in the repo-wide lock-acquisition graph (every ``with
    self.<lock>`` / ``.acquire()`` site, one interprocedural level
    through same-class/same-module helpers) is a potential deadlock;
    the finding carries both witness paths.  Suppress a deliberate
    edge with ``# dsql: allow-lock-order``.

DSQL602  blocking call under a held lock (analysis/concurrency.py)
    kernel and planner builds (``_build.*``), the ctypes kernel calls,
    ``torch.cuda.synchronize``, h2d/d2h transfers, ``time.sleep``,
    socket/HTTP and ``subprocess`` calls inside a lock-guarded region
    convoy every other thread behind one slow call.  Suppress a
    justified site with ``# dsql: allow-blocking-under-lock``.

DSQL603  ``_locked``-suffix convention (analysis/concurrency.py)
    Bidirectional: a ``*_locked`` function acquiring its own lock
    breaks the contract its name states; a non-``_locked`` callee of a
    locked region that mutates guarded attributes off-lock should be
    renamed to carry the contract.  Suppress with
    ``# dsql: allow-locked-naming``.

DSQL701  paired-effect release (analysis/effects.py + dataflow.py)
    Every acquire in the declarative effect-pair table (scheduler
    reservations, admission tickets, LiveQuery rows, ledger charges,
    batch groups, compile singleflight, breaker half-open trials) must
    reach its release on *every* CFG path out of the function —
    including exception edges — or return the handle to its caller
    (ownership transfer).  The finding carries a file:line witness per
    edge of the leaking path.  Suppress a cross-thread/callback handoff
    with ``# dsql: allow-unpaired-effect`` naming the custodian.

DSQL702  serving-boundary exception flow (analysis/effects.py)
    Bare ``ValueError``/``RuntimeError``/``KeyError`` raise sites whose
    exception can propagate (over the DSQL601-style call graph, minus
    types absorbed by enclosing handlers) to ``TorchFrame.execute``, a
    Presto ``do_*`` handler, or a public ``Router`` method bypass the
    taxonomy that retry/degrade/HTTP classification dispatch on.  Also
    flags catch sites dispatching a taxonomy class against its declared
    ``retryable``/``degradable`` flags.  Suppress with
    ``# dsql: allow-boundary-raise``.

DSQL703  config-key registry coverage (analysis/configkeys.py)
    Every literal key at a ``config.get("...")`` site must be in
    ``config.py DOCUMENTED_KEYS`` (the DSQL401 design applied to
    config); registered keys no source file mentions are reported dead.
    Suppress with ``# dsql: allow-config-key``.

The runtime counterpart of DSQL601 is the lock sanitizer
(runtime/locks.py): NamedLock ranks + the dynamic order graph verify
the same invariant over executed schedules, wired into the chaos
campaigns.  The runtime counterpart of DSQL703 is
``analysis.strict_config`` (config.py): dynamic key reads warn once per
unregistered key.

Suppression comments live on the offending line or the line above it, so
``git blame`` keeps the reason next to the decision.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "DSQL101": "broad exception handler can swallow taxonomy QueryErrors",
    "DSQL201": "lock-guarded attribute mutated outside its lock",
    "DSQL301": "host-sync call inside a compiled pipeline's run path",
    "DSQL401": "metric name not in the documented metric registry",
    "DSQL501": "flight-recorder event not in the registered vocabulary",
    "DSQL601": "lock-order cycle across the repo lock graph",
    "DSQL602": "blocking or device call under a held lock",
    "DSQL603": "_locked-suffix convention violated",
    "DSQL701": "paired effect acquired without a release on every CFG path",
    "DSQL702": "bare exception can escape to a serving boundary unwrapped",
    "DSQL703": "config key not in the documented registry (or dead)",
}

_SUPPRESS = {
    "DSQL101": "dsql: allow-broad-except",
    "DSQL201": "dsql: allow-unlocked",
    "DSQL301": "dsql: allow-host-sync",
    "DSQL401": "dsql: allow-metric-name",
    "DSQL501": "dsql: allow-flight-event",
    "DSQL601": "dsql: allow-lock-order",
    "DSQL602": "dsql: allow-blocking-under-lock",
    "DSQL603": "dsql: allow-locked-naming",
    "DSQL701": "dsql: allow-unpaired-effect",
    "DSQL702": "dsql: allow-boundary-raise",
    "DSQL703": "dsql: allow-config-key",
}

#: the compiled pipelines of the port: a function of one of these modules
#: reachable from a pipeline's run method is on the run path (DSQL301)
_RUN_PATH_SUFFIXES = (
    os.path.join("physical", "compiled.py"),
    os.path.join("physical", "compiled_join.py"),
    os.path.join("physical", "compiled_select.py"),
    os.path.join("physical", "compiled_predict.py"),
    os.path.join("physical", "streaming.py"),
    os.path.join("inference", "programs.py"),
)
_RUN_ROOTS = {"run", "run_batched", "_extra_pack_outputs", "apply"}
#: entry points that capture a function for the device (graph capture or
#: compilation): a host sync inside one breaks the graph or the capture
_CAPTURE_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.cuda.make_graphed_callables"}
_MUTATOR_METHODS = {
    "append", "appendleft", "add", "extend", "insert", "remove", "discard",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
    "move_to_end", "rotate",
}
#: exception class names that mean "taxonomy error" in a re-raise clause
#: (resilience/errors.py roots + the planner exceptions rebased under them)
_TAXONOMY_NAMES = {"QueryError", "ParseError", "ParsingException", "LexError",
                   "BindError", "BindingError", "PlanError"}


@dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _suppressed(lines: Sequence[str], lineno: int, rule: str) -> bool:
    token = _SUPPRESS[rule]
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and token in lines[ln - 1]:
            return True
    return False


def _name_of(node: ast.expr) -> Optional[str]:
    """Dotted name of an expression, e.g. ``torch.compile`` ->
    "torch.compile"."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _name_of(node.value)
        return f"{base}.{node.attr}" if base else None
    if isinstance(node, ast.Call):
        # functools.partial(torch.compile, ...) — look through to the
        # target
        return _name_of(node.func)
    return None


def _is_capture(name: Optional[str]) -> bool:
    return name in _CAPTURE_CALLS


def _self_attr(node: ast.expr) -> Optional[str]:
    """'x' for expressions rooted at ``self.x`` (any depth), else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


# ---------------------------------------------------------------------------
# DSQL101 — broad-except
# ---------------------------------------------------------------------------
def _broad_names(h: ast.ExceptHandler) -> bool:
    if h.type is None:
        return True
    exprs = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    for e in exprs:
        name = _name_of(e)
        if name and name.split(".")[-1] in ("Exception", "BaseException"):
            return True
    return False


def _reraises_taxonomy(try_node: ast.Try, handler: ast.ExceptHandler) -> bool:
    """True when the broad handler cannot swallow a taxonomy error: an
    earlier clause catches QueryError and re-raises, or the broad handler
    body itself ends in a taxonomy-preserving ``raise`` — bare, a taxonomy
    class, or ``classify(...)`` (the idempotent taxonomy wrapper).  A
    ``raise SomeOtherError(...)`` does NOT pass: re-wrapping strips the
    error's code/retryable/degradable semantics, which is the hazard."""
    for h in try_node.handlers:
        if h is handler:
            break
        exprs = (h.type.elts if isinstance(h.type, ast.Tuple)
                 else [h.type] if h.type is not None else [])
        for e in exprs:
            name = _name_of(e)
            if name and name.split(".")[-1] in _TAXONOMY_NAMES:
                if any(isinstance(s, ast.Raise) for s in h.body):
                    return True
    last = handler.body[-1] if handler.body else None
    if not isinstance(last, ast.Raise):
        return False
    if last.exc is None:
        return True  # bare re-raise
    name = _name_of(last.exc)  # looks through Call to its target
    return name is not None and name.split(".")[-1] in (
        _TAXONOMY_NAMES | {"classify"})


def _check_broad_except(tree: ast.AST, path: str,
                        lines: Sequence[str]) -> List[LintFinding]:
    out: List[LintFinding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for h in node.handlers:
            if not _broad_names(h):
                continue
            if _reraises_taxonomy(node, h):
                continue
            if _suppressed(lines, h.lineno, "DSQL101"):
                continue
            caught = ("bare except" if h.type is None
                      else f"except {_name_of(h.type) or '...'}")
            out.append(LintFinding(
                "DSQL101", path, h.lineno,
                f"{caught} can swallow taxonomy QueryErrors; re-raise "
                f"them first (`except QueryError: raise`) or annotate "
                f"`# {_SUPPRESS['DSQL101']}` with the reason"))
    return out


# ---------------------------------------------------------------------------
# DSQL201 — lock coverage
# ---------------------------------------------------------------------------
def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes assigned a threading lock anywhere in the class."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        name = _name_of(node.value.func) if isinstance(
            node.value, ast.Call) else None
        if name is None or name.split(".")[-1] not in (
                "Lock", "RLock", "Condition"):
            continue
        for t in node.targets:
            attr = _self_attr(t)
            if attr is not None:
                locks.add(attr)
    return locks


def _mutations(fn: ast.AST, locks: Set[str]):
    """Yield (attr, lineno, guarded) for every ``self.<attr>`` mutation in
    one function body, tracking enclosing ``with self.<lock>:`` blocks.
    Nested defs are skipped — a closure runs on its own schedule and is
    judged where it mutates, not where it is defined."""

    def visit(node: ast.AST, guarded: bool):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return
        if isinstance(node, ast.With):
            has_lock = any(
                _self_attr(item.context_expr) in locks
                for item in node.items)
            for child in node.body:
                visit(child, guarded or has_lock)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    attr = _self_attr(t)
                    if attr is not None and attr not in locks:
                        yield_list.append((attr, node.lineno, guarded))
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and f.attr in _MUTATOR_METHODS):
                attr = _self_attr(f.value)
                if attr is not None and attr not in locks:
                    yield_list.append((attr, node.lineno, guarded))
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    yield_list: List[Tuple[str, int, bool]] = []
    for stmt in getattr(fn, "body", []):
        visit(stmt, False)
    return yield_list


def _check_lock_coverage(tree: ast.AST, path: str,
                         lines: Sequence[str]) -> List[LintFinding]:
    out: List[LintFinding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if not locks:
            continue
        per_method: List[Tuple[str, List[Tuple[str, int, bool]]]] = []
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                per_method.append((item.name, _mutations(item, locks)))
        guarded_attrs = {
            attr
            for name, muts in per_method if name != "__init__"
            for attr, _, guarded in muts if guarded
        }
        for name, muts in per_method:
            if name == "__init__" or name.endswith("_locked"):
                continue
            for attr, lineno, guarded in muts:
                if guarded or attr not in guarded_attrs:
                    continue
                if _suppressed(lines, lineno, "DSQL201"):
                    continue
                out.append(LintFinding(
                    "DSQL201", path, lineno,
                    f"self.{attr} is mutated under a lock elsewhere in "
                    f"{cls.name} but off-lock here; guard it or annotate "
                    f"`# {_SUPPRESS['DSQL201']}` (e.g. caller holds the "
                    f"lock)"))
    return out


# ---------------------------------------------------------------------------
# DSQL301 — host sync on a compiled pipeline's run path
# ---------------------------------------------------------------------------
def _callee_name(call: ast.Call) -> Optional[str]:
    """The last segment of a call's target: ``f`` for ``f()``,
    ``self.f()``, ``ev.f()`` and ``g().f()``."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _traced_functions(tree: ast.AST, path: str) -> List[ast.AST]:
    """Functions whose bodies run on the card's behalf: the run path of a
    compiled pipeline module, and functions handed to a capturing entry
    point."""
    capture_targets: Set[str] = set()
    funcs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_capture(_name_of(node.func)):
            for arg in node.args[:1]:
                name = _name_of(arg)
                if name and "." not in name:
                    capture_targets.add(name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.setdefault(node.name, []).append(node)
    traced: List[ast.AST] = []
    seen: Set[int] = set()

    def take(node: ast.AST) -> None:
        if id(node) not in seen:
            seen.add(id(node))
            traced.append(node)

    for nodes in funcs.values():
        for node in nodes:
            if node.name in capture_targets or any(
                    _is_capture(_name_of(d)) for d in node.decorator_list):
                take(node)
    if path.endswith(_RUN_PATH_SUFFIXES):
        # the run path: the run methods, then every function of the module
        # they reach through calls by name (over-approximate on purpose:
        # a same-named helper is charged too)
        frontier = [n for name in _RUN_ROOTS for n in funcs.get(name, ())]
        reached: Set[int] = set()
        while frontier:
            node = frontier.pop()
            if id(node) in reached:
                continue
            reached.add(id(node))
            take(node)
            for call in ast.walk(node):
                if isinstance(call, ast.Call):
                    frontier.extend(funcs.get(_callee_name(call), ()))
    return traced


_HOST_SYNC_CALLS = {"np.asarray", "numpy.asarray", "np.array",
                    "numpy.array", "torch.cuda.synchronize"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}


def _to_host(call: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")``, ``x.to(torch.device("cpu"))``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    args = list(call.args) + [k.value for k in call.keywords
                              if k.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and _name_of(a.func) == "torch.device" \
                and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


def _check_host_sync(tree: ast.AST, path: str,
                     lines: Sequence[str]) -> List[LintFinding]:
    out: List[LintFinding] = []
    seen: Set[int] = set()
    for fn in _traced_functions(tree, path):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            name = _name_of(node.func)
            hit = None
            if name in _HOST_SYNC_CALLS:
                hit = name
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _HOST_SYNC_METHODS
                  and not node.args):
                hit = f".{node.func.attr}()"
            elif _to_host(node):
                hit = '.to("cpu")'
            if hit is None:
                continue
            seen.add(id(node))
            if _suppressed(lines, node.lineno, "DSQL301"):
                continue
            out.append(LintFinding(
                "DSQL301", path, node.lineno,
                f"{hit} forces a host sync on a compiled pipeline's run "
                f"path; hoist it to plan/build time or annotate "
                f"`# {_SUPPRESS['DSQL301']}` with the reason"))
    return out


# ---------------------------------------------------------------------------
# DSQL401 — metric-name registry coverage
# ---------------------------------------------------------------------------
#: receiver attribute names that mean "a MetricsRegistry" at a call site
#: (``metrics.inc(...)``, ``self.metrics.observe(...)``,
#: ``executor.context.metrics.inc(...)``, the cache's ``self._mark(...)``)
_METRIC_RECEIVERS = {"metrics", "_metrics"}
_METRIC_METHODS = {"inc", "observe", "gauge"}
_METRIC_WRAPPERS = {"_mark"}  # helpers that forward a name to metrics.inc


def _metric_name_of(arg: ast.expr) -> Tuple[Optional[str], bool]:
    """``(name, is_prefix)`` of a call's first argument: the full literal
    for str constants (is_prefix False), the leading literal run for
    f-strings (is_prefix True — the dynamic tail is unknown), ``(None,
    False)`` (no claim) for anything dynamic."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.JoinedStr):
        prefix = []
        for part in arg.values:
            if isinstance(part, ast.Constant) and isinstance(part.value, str):
                prefix.append(part.value)
            else:
                break
        return ("".join(prefix), True) if prefix else (None, False)
    return None, False


def _check_metric_names(tree: ast.AST, path: str,
                        lines: Sequence[str]) -> List[LintFinding]:
    from ..serving.metrics import is_documented_metric

    out: List[LintFinding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        if f.attr in _METRIC_METHODS:
            recv = _name_of(f.value)
            if recv is None or recv.split(".")[-1] not in _METRIC_RECEIVERS:
                continue
        elif not (f.attr in _METRIC_WRAPPERS
                  and isinstance(f.value, ast.Name)
                  and f.value.id == "self"):
            continue
        name, is_prefix = _metric_name_of(node.args[0])
        if name is None or is_documented_metric(name, prefix_only=is_prefix):
            continue
        if _suppressed(lines, node.lineno, "DSQL401"):
            continue
        out.append(LintFinding(
            "DSQL401", path, node.lineno,
            f"metric name {name!r} is not in the documented registry "
            f"(serving/metrics.py DOCUMENTED_METRICS); a typo here "
            f"silently splits a time series — register the name or "
            f"annotate `# {_SUPPRESS['DSQL401']}`"))
    return out


# ---------------------------------------------------------------------------
# DSQL501 — flight-recorder event vocabulary coverage
# ---------------------------------------------------------------------------
#: receiver names that mean "the flight recorder" at a call site:
#: ``flight.record(...)`` with the module imported as ``flight``, the
#: process recorder ``RECORDER.record(...)``, and flight.py's own bare
#: module-level ``record(...)`` calls (matched as a plain Name)
_FLIGHT_RECEIVERS = {"flight", "RECORDER"}


def _check_flight_events(tree: ast.AST, path: str,
                         lines: Sequence[str]) -> List[LintFinding]:
    from ..observability.flight import is_registered_event

    out: List[LintFinding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "record":
            recv = _name_of(f.value)
            if recv is None or recv.split(".")[-1] not in _FLIGHT_RECEIVERS:
                continue
        elif not (isinstance(f, ast.Name) and f.id == "record"):
            continue
        name, is_prefix = _metric_name_of(node.args[0])
        if name is None or is_registered_event(name, prefix_only=is_prefix):
            continue
        if _suppressed(lines, node.lineno, "DSQL501"):
            continue
        out.append(LintFinding(
            "DSQL501", path, node.lineno,
            f"flight event {name!r} is not in the registered vocabulary "
            f"(observability/flight.py EVENT_NAMES); a typo here silently "
            f"splits the postmortem timeline — register the name or "
            f"annotate `# {_SUPPRESS['DSQL501']}`"))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
def lint_source(source: str, path: str) -> List[LintFinding]:
    """Every per-file rule over one source text.  DSQL601 is repo-wide
    (a cycle's halves usually live in different files) and runs in
    `lint_paths` / `concurrency.lock_order_findings` instead, as do
    DSQL702 (boundary escape needs the repo call graph) and DSQL703's
    dead-key half."""
    from .concurrency import check_blocking_under_lock, check_locked_naming
    from .configkeys import config_key_findings
    from .effects import paired_effect_findings

    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [LintFinding("DSQL000", path, e.lineno or 0,
                            f"syntax error: {e.msg}")]
    lines = source.splitlines()
    out: List[LintFinding] = []
    out += _check_broad_except(tree, path, lines)
    out += _check_lock_coverage(tree, path, lines)
    out += _check_host_sync(tree, path, lines)
    out += _check_metric_names(tree, path, lines)
    out += _check_flight_events(tree, path, lines)
    out += check_blocking_under_lock(tree, path, lines)
    out += check_locked_naming(tree, path, lines)
    out += paired_effect_findings(tree, path, lines)
    out += config_key_findings(tree, path, lines)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths: Iterable[str]) -> List[LintFinding]:
    from .concurrency import lock_order_findings
    from .configkeys import dead_config_key_findings
    from .effects import boundary_exception_findings

    sources: Dict[str, str] = {}
    findings: List[LintFinding] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            sources[path] = f.read()
        findings.extend(lint_source(sources[path], path))
    findings.extend(lock_order_findings(sources))
    findings.extend(boundary_exception_findings(sources))
    findings.extend(dead_config_key_findings(sources))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def package_files(root: Optional[str] = None) -> List[str]:
    """Every .py file of the port's package, `dask_sql_tpu_torch/` (the
    --self target)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def self_lint(root: Optional[str] = None) -> List[LintFinding]:
    """Lint the engine's own source tree; [] means CI-clean."""
    return lint_paths(package_files(root))
