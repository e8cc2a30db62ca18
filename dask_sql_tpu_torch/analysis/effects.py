"""DSQL701/DSQL702 — effect-lifecycle rules over the dataflow framework.

Counterpart of `dask_sql_tpu/analysis/effects.py`, with the port's
serving boundary (``TorchFrame.execute``).  The effect-pair table is the
reference's: the port's compiled-pipeline caches claim and settle a build
through the same `singleflight_begin` / `singleflight_done` pair, and the
inference registry's `_commit` / `_uncommit` charges match nothing until
the port has that registry.

DSQL701 (paired-effect release)
-------------------------------
The serving stack is full of acquire/release pairs whose imbalance is a
slow leak the chaos campaigns can only *sample*: a scheduler byte
reservation never released strangles admission, an unfinished LiveQuery
row pins the in-flight table, an unsettled singleflight event hangs
every waiter of a compile family.  `EFFECT_PAIRS` declares those pairs;
for every acquire site the rule builds the function's CFG
(analysis/dataflow.py) and proves a matching release is reached on every
path to either exit — normal *and* exceptional — reporting the first
counterexample path with a ``file:line`` witness per edge.

Ownership transfer is recognised like Rust's move semantics: a function
that *returns* the acquired handle (``return self.scheduler.pop_locked(...)``
or ``item = ...pop_locked(...); ...; return item``) hands the obligation
to its caller and is exempt on that path.  One interprocedural level
through same-class/same-module helpers is resolved exactly like DSQL601:
a call to a helper whose body contains an unbalanced acquire (release)
counts as an acquire (release) at the call site.

Deliberate handoffs that live across threads or callbacks (an ExitStack
hook, a policy-driven eviction) cannot be proven intraprocedurally:
annotate the acquire with ``# dsql: allow-unpaired-effect`` and the
reason, which is itself the documentation of the invariant's custodian.

DSQL702 (serving-boundary exception flow)
-----------------------------------------
The resilience layer made exception *types* load-bearing: retry,
degradation and HTTP classification all dispatch on the taxonomy
(resilience/errors.py).  A bare ``ValueError``/``RuntimeError``/
``KeyError`` escaping to a serving boundary bypasses all three.  The
rule computes, per function, the set of bare exception types its body
can raise, propagates them over the DSQL601-style call graph
(``self.method()`` within a class, bare ``f()`` within a module),
subtracts types absorbed by enclosing ``try`` handlers along each hop,
and reports any bare type that reaches ``TorchFrame.execute``, a Presto
``do_*`` handler, or a public ``Router`` method — with the full call
chain as witness.  It also cross-checks catch sites against the
taxonomy: a handler that dispatches a class to a retry/degrade path the
class's declared ``retryable``/``degradable`` flags forbid is flagged.
Suppress with ``# dsql: allow-boundary-raise``.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from .dataflow import (CFG, ForwardAnalysis, Node, build_cfg, calls_in,
                       find_path, format_witness, node_calls)
from .selflint import LintFinding, _SUPPRESS, _name_of, _suppressed


# ---------------------------------------------------------------------------
# the effect-pair table
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class EffectPair:
    """One acquire/release obligation.  `acquire`/`release` are dotted
    call-name suffixes (``done.set`` matches ``group.done.set()``);
    `receivers` restricts acquire matches to calls whose receiver segment
    (the dotted name right before the match) is listed — '' means a bare
    call like ``singleflight_begin(...)``."""
    name: str
    acquire: Tuple[str, ...]
    release: Tuple[str, ...]
    receivers: Tuple[str, ...] = ()
    why: str = ""


EFFECT_PAIRS: Tuple[EffectPair, ...] = (
    EffectPair(
        "scheduler-reservation",
        acquire=("pop_locked",), release=("release_locked",),
        receivers=("scheduler",),
        why="a ticket popped from the packing scheduler carries a byte "
            "reservation; an unreleased ticket strangles admission"),
    EffectPair(
        "admission-ticket",
        acquire=("admit",), release=("on_finish",),
        receivers=("admission",),
        why="admit() counts the query against queue depth and estimated "
            "bytes; a lost ticket leaks both until restart"),
    EffectPair(
        "live-query",
        acquire=("begin",), release=("finish", "discard"),
        receivers=("live_queries",),
        why="a LiveQuery row without a terminal state pins the in-flight "
            "table and lies to SHOW LIVE QUERIES forever"),
    EffectPair(
        "ledger-charge",
        acquire=("_pin", "_commit"), release=("_evict_locked", "_uncommit"),
        receivers=("self", ""),
        why="pinned stems and committed model params are HBM ledger "
            "charges; a charge with no eviction path is a phantom "
            "reservation the pressure ladder can never reclaim"),
    EffectPair(
        "batch-group",
        acquire=("_Group",), release=("done.set",),
        receivers=("",),
        why="a flight batch group that never settles `done` hangs every "
            "follower for the full rendezvous timeout"),
    EffectPair(
        "compile-singleflight",
        acquire=("singleflight_begin",), release=("singleflight_done",),
        receivers=("",),
        why="the builder token of a compiled-cache miss; if the builder "
            "never settles, every same-family waiter blocks 300s"),
    EffectPair(
        "breaker-half-open",
        acquire=("allow",), release=("record_success", "record_failure"),
        receivers=("breaker",),
        why="a half-open breaker grants one trial; a trial that never "
            "settles leaves the rung's health unknown"),
)


def _match_effect(call: ast.Call, patterns: Sequence[str],
                  receivers: Sequence[str]) -> bool:
    name = _name_of(call.func)
    if name is None:
        return False
    for pat in patterns:
        if name == pat:
            recv = ""
        elif name.endswith("." + pat):
            head = name[: -len(pat) - 1]
            recv = head.split(".")[-1]
        else:
            continue
        if not receivers or recv in receivers:
            return True
    return False


# ---------------------------------------------------------------------------
# function collection (shared by both rules)
# ---------------------------------------------------------------------------
@dataclass
class _Fn:
    qual: str
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    cls: Optional[str]             # nearest enclosing class name


def _collect_functions(tree: ast.AST) -> List[_Fn]:
    out: List[_Fn] = []

    def visit(node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{cls}.{child.name}" if cls else child.name
                out.append(_Fn(qual, child, cls))
                visit(child, None)

    visit(tree, None)
    return out


def _class_methods(fns: Sequence[_Fn]) -> Dict[str, Dict[str, _Fn]]:
    by_cls: Dict[str, Dict[str, _Fn]] = {}
    for fn in fns:
        if fn.cls is not None:
            by_cls.setdefault(fn.cls, {})[fn.node.name] = fn
    return by_cls


def _module_funcs(tree: ast.AST, fns: Sequence[_Fn]) -> Dict[str, _Fn]:
    top = {s.name for s in tree.body
           if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return {fn.qual: fn for fn in fns if fn.cls is None and fn.qual in top}


def _own_calls(fn: ast.AST) -> Iterable[ast.Call]:
    """Every call in a function body, excluding nested def/class bodies."""
    stack: List[ast.AST] = list(fn.body)
    while stack:
        nd = stack.pop()
        if isinstance(nd, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(nd, ast.Call):
            yield nd
        stack.extend(ast.iter_child_nodes(nd))


# ---------------------------------------------------------------------------
# DSQL701 — paired-effect release on all paths
# ---------------------------------------------------------------------------
def _direct_effects(fn: ast.AST,
                    lines: Sequence[str]) -> Tuple[Set[str], Set[str]]:
    """(pairs acquired, pairs released) by calls directly in `fn`.  An
    acquire annotated ``allow-unpaired-effect`` is excluded: the
    annotation names an external custodian, so callers of the helper
    must not inherit the obligation either."""
    acq: Set[str] = set()
    rel: Set[str] = set()
    for call in _own_calls(fn):
        for pair in EFFECT_PAIRS:
            if _match_effect(call, pair.acquire, pair.receivers) \
                    and not _suppressed(lines, call.lineno, "DSQL701"):
                acq.add(pair.name)
            if _match_effect(call, pair.release, ()):
                rel.add(pair.name)
    return acq, rel


def _resolve_helper(call: ast.Call, cls_methods: Dict[str, _Fn],
                    mod_funcs: Dict[str, _Fn],
                    current: _Fn) -> Optional[_Fn]:
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "self":
        helper = cls_methods.get(f.attr)
    elif isinstance(f, ast.Name):
        helper = mod_funcs.get(f.id)
    else:
        helper = None
    if helper is None or helper.node is current.node:
        return None
    return helper


_Token = Tuple[str, int, FrozenSet[str]]   # (pair, acquire line, bound names)


class _EffectAnalysis(ForwardAnalysis):
    """Fact = frozenset of outstanding acquire tokens (union at joins: a
    token outstanding on ANY path into a node is outstanding there)."""

    def __init__(self, gens: Dict[int, List[_Token]],
                 kills: Dict[int, Set[str]],
                 return_names: Dict[int, FrozenSet[str]]):
        self._gens = gens
        self._kills = kills
        self._returns = return_names

    def transfer(self, node: Node, fact):
        out = set(fact)
        kills = self._kills.get(node.nid)
        if kills:
            out = {t for t in out if t[0] not in kills}
        rn = self._returns.get(node.nid)
        if rn:
            out = {t for t in out if not (t[2] & rn)}
        out |= set(self._gens.get(node.nid, ()))
        return frozenset(out)

    def transfer_except(self, node: Node, fact):
        # releases settle even on the raising edge (requiring a release
        # of the release would be unsatisfiable); acquires and handoff
        # returns stay pre-state — if they raised, nothing happened
        kills = self._kills.get(node.nid)
        if kills:
            return frozenset(t for t in fact if t[0] not in kills)
        return fact


def _binding_names(stmt: ast.stmt) -> FrozenSet[str]:
    """Names an assignment statement binds (for handoff tracking)."""
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items
                   if i.optional_vars is not None]
    names = set()
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                names.add(sub.id)
    return frozenset(names)


def paired_effect_findings(tree: ast.AST, path: str,
                           lines: Sequence[str]) -> List[LintFinding]:
    fns = _collect_functions(tree)
    if not fns:
        return []
    by_cls = _class_methods(fns)
    mod_funcs = _module_funcs(tree, fns)
    direct = {id(fn.node): _direct_effects(fn.node, lines) for fn in fns}

    pair_by_name = {p.name: p for p in EFFECT_PAIRS}
    out: List[LintFinding] = []
    for fn in fns:
        cls_methods = by_cls.get(fn.cls, {}) if fn.cls else {}

        def effects_of(call: ast.Call) -> Tuple[Set[str], Set[str]]:
            acq: Set[str] = set()
            rel: Set[str] = set()
            for pair in EFFECT_PAIRS:
                if _match_effect(call, pair.acquire, pair.receivers) \
                        and not _suppressed(lines, call.lineno, "DSQL701"):
                    acq.add(pair.name)
                if _match_effect(call, pair.release, ()):
                    rel.add(pair.name)
            helper = _resolve_helper(call, cls_methods, mod_funcs, fn)
            if helper is not None:
                h_acq, h_rel = direct[id(helper.node)]
                # one interprocedural level, DSQL601-style: only an
                # UNbalanced helper transfers its effect to the call site
                acq |= h_acq - h_rel
                rel |= h_rel - h_acq
            return acq, rel

        # cheap pre-scan: skip the CFG entirely when nothing acquires
        has_acquire = False
        for call in _own_calls(fn.node):
            a, _ = effects_of(call)
            if a:
                has_acquire = True
                break
        if not has_acquire:
            continue

        cfg = build_cfg(fn.node)
        gens: Dict[int, List[_Token]] = {}
        kills: Dict[int, Set[str]] = {}
        return_names: Dict[int, FrozenSet[str]] = {}
        token_node: Dict[_Token, int] = {}
        for node in cfg.stmt_nodes():
            stmt = node.stmt
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                rn = frozenset(n.id for n in ast.walk(stmt.value)
                               if isinstance(n, ast.Name))
                if rn:
                    return_names[node.nid] = rn
            bound = _binding_names(stmt)
            for call in node_calls(node):
                acq, rel = effects_of(call)
                if rel:
                    kills.setdefault(node.nid, set()).update(rel)
                if acq and isinstance(stmt, ast.Return):
                    continue  # `return acquire()` — direct ownership handoff
                for pname in acq:
                    token = (pname, node.line, bound)
                    gens.setdefault(node.nid, []).append(token)
                    token_node.setdefault(token, node.nid)

        if not gens:
            continue
        fact_in, _ = _EffectAnalysis(gens, kills, return_names).run(cfg)
        outstanding: Set[_Token] = set()
        for exit_nid in (cfg.exit, cfg.raise_exit):
            fact = fact_in.get(exit_nid)
            if fact:
                outstanding |= set(fact)
        for token in sorted(outstanding, key=lambda t: (t[1], t[0])):
            pname, line, names = token
            if _suppressed(lines, line, "DSQL701"):
                continue
            pair = pair_by_name[pname]

            def blocks(n: Node, _pname=pname, _names=names):
                if _pname in kills.get(n.nid, ()):
                    return "all"
                rn = return_names.get(n.nid)
                if rn and (_names & rn):
                    return "normal"
                return False

            witness = find_path(cfg, token_node[token],
                                {cfg.exit, cfg.raise_exit}, blocks)
            detail = format_witness(cfg, witness) if witness else "<no path>"
            out.append(LintFinding(
                "DSQL701", path, line,
                f"effect '{pname}' acquired here can leave "
                f"{fn.qual}() without {'/'.join(pair.release)} "
                f"(path {detail}) — {pair.why}; release on every path, "
                f"return the handle, or annotate "
                f"`# {_SUPPRESS['DSQL701']}` with the custodian"))
    return out


# ---------------------------------------------------------------------------
# DSQL702 — serving-boundary exception flow
# ---------------------------------------------------------------------------
_BARE_TYPES = {"ValueError", "RuntimeError", "KeyError"}

#: (path suffix, kind, spec) — kind "exact" matches the full qualname,
#: "method-prefix" any method whose own name starts with the spec,
#: "class-public" every non-underscore method of the named class
BOUNDARY_SPECS: Tuple[Tuple[str, str, str], ...] = (
    (os.path.join("dask_sql_tpu_torch", "context.py"), "exact",
     "TorchFrame.execute"),
    (os.path.join("server", "app.py"), "method-prefix", "do_"),
    (os.path.join("fleet", "router.py"), "class-public", "Router"),
)


def _is_boundary(path: str, fn: _Fn) -> bool:
    for suffix, kind, spec in BOUNDARY_SPECS:
        if not path.endswith(suffix):
            continue
        if kind == "exact" and fn.qual == spec:
            return True
        if kind == "method-prefix" and fn.node.name.startswith(spec):
            return True
        if kind == "class-public" and fn.cls == spec \
                and not fn.node.name.startswith("_"):
            return True
    return False


def _raise_type(stmt: ast.Raise) -> Optional[str]:
    exc = stmt.exc
    if isinstance(exc, ast.Call):
        exc = exc.func
    if isinstance(exc, ast.Name):
        return exc.id
    if isinstance(exc, ast.Attribute):
        return exc.attr
    return None


def _absorbs(caught: Sequence[FrozenSet[str]], exc_type: str) -> bool:
    for frame in caught:
        if exc_type in frame or "*" in frame \
                or "Exception" in frame or "BaseException" in frame:
            return True
    return False


def _handler_type_names(h: ast.ExceptHandler) -> FrozenSet[str]:
    if h.type is None:
        return frozenset(["*"])
    types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    names = set()
    for t in types:
        if isinstance(t, ast.Name):
            names.add(t.id)
        elif isinstance(t, ast.Attribute):
            names.add(t.attr)
    return frozenset(names)


@dataclass
class _FnFlow:
    key: Tuple[str, str]                       # (path, qual)
    raises: List[Tuple[str, int]] = field(default_factory=list)
    calls: List[Tuple[Tuple[str, str], int, FrozenSet[str]]] = \
        field(default_factory=list)            # (callee key, line, caught)


def _scan_flow(path: str, fn: _Fn, cls_methods: Dict[str, _Fn],
               mod_funcs: Dict[str, _Fn]) -> _FnFlow:
    flow = _FnFlow((path, fn.qual))

    def record_calls(node: ast.AST, caught: Tuple[FrozenSet[str], ...]):
        for call in calls_in(node):
            helper = _resolve_helper(call, cls_methods, mod_funcs, fn)
            if helper is not None:
                flat = frozenset().union(*caught) if caught else frozenset()
                flow.calls.append(((path, helper.qual),
                                   getattr(call, "lineno", 0), flat))

    def scan(stmts: Sequence[ast.stmt],
             caught: Tuple[FrozenSet[str], ...]) -> None:
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(s, ast.Try):
                handled = frozenset().union(
                    *[_handler_type_names(h) for h in s.handlers]) \
                    if s.handlers else frozenset()
                scan(s.body, caught + (handled,))
                scan(s.orelse, caught)
                for h in s.handlers:
                    scan(h.body, caught)
                scan(s.finalbody, caught)
                continue
            if isinstance(s, ast.Raise):
                t = _raise_type(s)
                if t in _BARE_TYPES and not _absorbs(caught, t):
                    flow.raises.append((t, s.lineno))
                if s.exc is not None:
                    record_calls(s.exc, caught)
                continue
            # immediate expressions + nested suites
            if isinstance(s, (ast.If, ast.While)):
                record_calls(s.test, caught)
                scan(s.body, caught)
                scan(s.orelse, caught)
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                record_calls(s.iter, caught)
                scan(s.body, caught)
                scan(s.orelse, caught)
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                for item in s.items:
                    record_calls(item.context_expr, caught)
                scan(s.body, caught)
            elif hasattr(ast, "Match") and isinstance(s, ast.Match):
                record_calls(s.subject, caught)
                for case in s.cases:
                    scan(case.body, caught)
            else:
                record_calls(s, caught)

    scan(fn.node.body, ())
    return flow


def boundary_exception_findings(
        sources: Dict[str, str]) -> List[LintFinding]:
    flows: Dict[Tuple[str, str], _FnFlow] = {}
    roots: List[Tuple[str, str]] = []
    line_cache: Dict[str, List[str]] = {}
    for path, source in sorted(sources.items()):
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue  # DSQL000 already reported by lint_source
        line_cache[path] = source.splitlines()
        fns = _collect_functions(tree)
        by_cls = _class_methods(fns)
        mod_funcs = _module_funcs(tree, fns)
        for fn in fns:
            cls_methods = by_cls.get(fn.cls, {}) if fn.cls else {}
            flow = _scan_flow(path, fn, cls_methods, mod_funcs)
            flows[flow.key] = flow
            if _is_boundary(path, fn):
                roots.append(flow.key)

    # reverse call edges
    callers: Dict[Tuple[str, str],
                  List[Tuple[Tuple[str, str], int, FrozenSet[str]]]] = {}
    for key, flow in flows.items():
        for callee, line, caught in flow.calls:
            if callee in flows:
                callers.setdefault(callee, []).append((key, line, caught))

    # escape sets: origin = (exc type, origin path, origin line);
    # parent[(fn key, origin)] = (callee key, call line) for witnesses
    Origin = Tuple[str, str, int]
    escapes: Dict[Tuple[str, str], Set[Origin]] = {}
    parent: Dict[Tuple[Tuple[str, str], Origin],
                 Tuple[Tuple[str, str], int]] = {}
    work: List[Tuple[Tuple[str, str], Origin]] = []
    for key, flow in flows.items():
        for exc_type, line in flow.raises:
            origin = (exc_type, key[0], line)
            escapes.setdefault(key, set()).add(origin)
            work.append((key, origin))
    while work:
        key, origin = work.pop()
        for caller, line, caught in callers.get(key, ()):
            if _absorbs([caught], origin[0]):
                continue
            if origin in escapes.setdefault(caller, set()):
                continue
            escapes[caller].add(origin)
            parent[(caller, origin)] = (key, line)
            work.append((caller, origin))

    out: List[LintFinding] = []
    reported: Set[Origin] = set()
    for root in sorted(roots):
        for origin in sorted(escapes.get(root, ()),
                             key=lambda o: (o[1], o[2])):
            if origin in reported:
                continue
            exc_type, opath, oline = origin
            if _suppressed(line_cache.get(opath, []), oline, "DSQL702"):
                reported.add(origin)
                continue
            chain: List[str] = [flows[root].key[1]]
            cursor: Tuple[str, str] = root
            while (cursor, origin) in parent:
                callee, call_line = parent[(cursor, origin)]
                chain.append(f"{callee[1]} (called at "
                             f"{os.path.basename(cursor[0])}:{call_line})")
                cursor = callee
            out.append(LintFinding(
                "DSQL702", opath, oline,
                f"bare {exc_type} raised here can escape to serving "
                f"boundary {flows[root].key[1]}() via "
                f"{' -> '.join(chain)} without a taxonomy wrapper — "
                f"raise a resilience/errors.py subclass, classify() it, "
                f"or annotate `# {_SUPPRESS['DSQL702']}`"))
            reported.add(origin)

    out.extend(_taxonomy_dispatch_findings(sources, line_cache))
    return out


# -- taxonomy catch-site flag cross-check -----------------------------------
_TAXONOMY_ROOTS = {"QueryError"}
_RETRY_HINTS = ("retry",)
_DEGRADE_HINTS = ("degrade", "step_down")


def _taxonomy_flags(sources: Dict[str, str]) -> Dict[str, Dict[str, bool]]:
    """name -> {retryable, degradable} for every class reachable (by base
    name) from the taxonomy root, resolved repo-wide to a fixpoint so
    definition order across files does not matter."""
    classes: Dict[str, Tuple[List[str], Dict[str, bool]]] = {}
    for source in sources.values():
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases = [b.id if isinstance(b, ast.Name) else b.attr
                     for b in node.bases
                     if isinstance(b, (ast.Name, ast.Attribute))]
            own: Dict[str, bool] = {}
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) \
                        and isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, bool):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name) \
                                and t.id in ("retryable", "degradable"):
                            own[t.id] = stmt.value.value
            classes[node.name] = (bases, own)

    flags: Dict[str, Dict[str, bool]] = {
        root: {"retryable": False, "degradable": False}
        for root in _TAXONOMY_ROOTS}
    changed = True
    while changed:
        changed = False
        for name, (bases, own) in classes.items():
            inherited = next((flags[b] for b in bases if b in flags), None)
            if inherited is None:
                continue
            resolved = dict(inherited)
            resolved.update(own)
            if flags.get(name) != resolved:
                flags[name] = resolved
                changed = True
    return flags


def _taxonomy_dispatch_findings(
        sources: Dict[str, str],
        line_cache: Dict[str, List[str]]) -> List[LintFinding]:
    flags = _taxonomy_flags(sources)
    out: List[LintFinding] = []
    for path, source in sorted(sources.items()):
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        lines = line_cache.get(path) or source.splitlines()
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler) or node.type is None:
                continue
            caught = [n for n in _handler_type_names(node)
                      if n in flags and n not in _TAXONOMY_ROOTS]
            if not caught:
                continue
            # a handler that reads the flag attribute dispatches correctly
            # by construction — only hard-coded dispatch can disagree
            reads_flags = any(
                isinstance(sub, ast.Attribute)
                and sub.attr in ("retryable", "degradable")
                for s in node.body for sub in ast.walk(s))
            if reads_flags:
                continue
            called = {(_name_of(c.func) or "").lower()
                      for s in node.body for c in calls_in(s)}
            for cls in sorted(caught):
                for flag, hints in (("retryable", _RETRY_HINTS),
                                    ("degradable", _DEGRADE_HINTS)):
                    if flags[cls][flag]:
                        continue
                    hit = next(
                        (name for name in called
                         if any(h in name.split(".")[-1] for h in hints)),
                        None)
                    if hit is None:
                        continue
                    if _suppressed(lines, node.lineno, "DSQL702"):
                        continue
                    out.append(LintFinding(
                        "DSQL702", path, node.lineno,
                        f"catch site dispatches {cls} to '{hit}' but "
                        f"{cls}.{flag} is False in the taxonomy "
                        f"(resilience/errors.py) — fix the dispatch, the "
                        f"flag, or annotate `# {_SUPPRESS['DSQL702']}`"))
    return out
