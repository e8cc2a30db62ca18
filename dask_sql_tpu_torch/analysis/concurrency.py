"""Static concurrency rules DSQL601-603 of the port's self-lint.

Counterpart of `dask_sql_tpu/analysis/concurrency.py`: DSQL601 and DSQL603
are copied; DSQL602 matches the port's blocking calls (kernel and planner
builds, the ctypes kernel calls, the card's synchronize, torch transfers)
where the reference matched jit and pallas_call.

The self-lint layer (selflint.py, DSQL101-501) proves registries and
lock *coverage*; these rules prove lock *ordering* and lock *hygiene*
over the AST:

DSQL601  lock-order cycle (whole-repo)
    Builds a lock-acquisition graph across every linted file.  A lock's
    identity is its NAME, not its instance — ``ClassName.attr`` for
    ``self.<attr>`` locks, ``file.py:name`` for module-level locks —
    and an edge A -> B is recorded wherever B is acquired (``with`` or
    ``.acquire()``) while A is held, including one interprocedural level
    through same-class ``self.m()`` / same-module ``f()`` calls (the
    ``*_locked`` helper convention).  Any cycle is a potential deadlock;
    the finding reports BOTH witness paths (every edge's file:line).
    Suppress a deliberate edge with ``# dsql: allow-lock-order`` on the
    inner acquisition line.

DSQL602  blocking call under a held lock
    Inside a lock-guarded region (a ``with self.<lock>:`` body, a
    ``with <module lock>:`` body, or the body of a ``*_locked``
    function, whose caller holds a lock by convention), flags calls
    that block or do expensive device work: kernel and planner library
    builds (``_build.build`` / ``library`` / ``native_library``: an
    ``nvcc`` or ``g++`` run), the ctypes kernel entry points
    (``lib.dsql_*``), ``torch.cuda.synchronize`` / ``.synchronize()``,
    h2d/d2h transfers (``torch.as_tensor``/``np.asarray``/``.cpu()``/
    ``.to(...)``/``.tolist()``/``.numpy()``/``.item()``),
    ``.compute()``/``.result()``, ``time.sleep``, socket/HTTP, and
    ``subprocess``.  Holding a hot lock across any of these turns one
    slow query into a convoy.  Suppress a justified site with
    ``# dsql: allow-blocking-under-lock`` and the reason.

DSQL603  ``_locked``-suffix convention, both directions
    (a) a ``*_locked`` function that itself acquires a lock of its own
    class/module breaks the contract its name states (the caller
    already holds the lock — re-acquiring a plain Lock self-deadlocks);
    (b) a non-``_locked`` method called inside a locked region whose
    body mutates lock-guarded attributes off-lock should be named
    ``*_locked`` so every future caller knows the contract.  Suppress
    with ``# dsql: allow-locked-naming``.

DSQL602/603 are per-file checks wired into ``lint_source``; DSQL601 is
a repo-wide pass run by ``lint_paths``/``self_lint`` (and directly via
`lock_order_findings` for tests) because a cycle's two halves usually
live in different files.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .selflint import (LintFinding, _SUPPRESS, _lock_attrs, _name_of,
                       _self_attr, _suppressed)

# ---------------------------------------------------------------------------
# shared: lock discovery
# ---------------------------------------------------------------------------


def _module_locks(tree: ast.AST) -> Set[str]:
    """Names assigned a threading lock at module top level."""
    locks: Set[str] = set()
    for node in getattr(tree, "body", []):
        if not isinstance(node, ast.Assign):
            continue
        name = _name_of(node.value.func) if isinstance(
            node.value, ast.Call) else None
        if name is None or name.split(".")[-1] not in (
                "Lock", "RLock", "Condition"):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                locks.add(t.id)
    return locks


def _named_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """`_lock_attrs` plus attributes assigned a sanitized NamedLock /
    named_lock / named_condition (runtime/locks.py) — migrated sites
    must stay visible to the static rules."""
    locks = set(_lock_attrs(cls))
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        name = _name_of(node.value.func) if isinstance(
            node.value, ast.Call) else None
        if name is None or name.split(".")[-1] not in (
                "NamedLock", "named_lock", "named_condition"):
            continue
        for t in node.targets:
            attr = _self_attr(t)
            if attr is not None:
                locks.add(attr)
    return locks


def _named_module_locks(tree: ast.AST) -> Set[str]:
    locks = set(_module_locks(tree))
    for node in getattr(tree, "body", []):
        if not isinstance(node, ast.Assign):
            continue
        name = _name_of(node.value.func) if isinstance(
            node.value, ast.Call) else None
        if name is None or name.split(".")[-1] not in (
                "NamedLock", "named_lock", "named_condition"):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                locks.add(t.id)
    return locks


def _lock_of(expr: ast.expr, self_locks: Set[str],
             mod_locks: Set[str]) -> Optional[Tuple[str, str]]:
    """(kind, name) when ``expr`` denotes a known lock: ("self", attr)
    for ``self.<attr>`` / ``self.<attr>.acquire``-style roots, ("mod",
    name) for a module-level lock name."""
    attr = _self_attr(expr)
    if attr is not None and attr in self_locks:
        return ("self", attr)
    if isinstance(expr, ast.Name) and expr.id in mod_locks:
        return ("mod", expr.id)
    return None


# ---------------------------------------------------------------------------
# DSQL601 — whole-repo lock-order graph
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LockEdge:
    """One observed nesting: ``outer`` held while ``inner`` acquired."""
    outer: str
    inner: str
    path: str
    line: int          # the inner acquisition site (suppression anchor)
    via: Optional[str]  # callee name for interprocedural edges


def _fn_acquisitions(fn: ast.AST, self_locks: Set[str],
                     mod_locks: Set[str], lock_id) -> List[Tuple[str, int]]:
    """Top-level (not nested-under-another-lock) acquisitions inside one
    function body: every ``with <lock>`` and ``<lock>.acquire()``."""
    out: List[Tuple[str, int]] = []

    def visit(node: ast.AST):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return
        if isinstance(node, ast.With):
            for item in node.items:
                lk = _lock_of(item.context_expr, self_locks, mod_locks)
                if lk is not None:
                    out.append((lock_id(lk), item.context_expr.lineno))
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "acquire":
            lk = _lock_of(node.func.value, self_locks, mod_locks)
            if lk is not None:
                out.append((lock_id(lk), node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in getattr(fn, "body", []):
        visit(stmt)
    return out


def collect_lock_edges(tree: ast.AST, path: str,
                       lines: Sequence[str]) -> List[LockEdge]:
    """All lock-nesting edges in one file, suppression already applied.

    Scopes scanned: every function/method.  Within a ``with <lockA>:``
    body, an edge A -> B is emitted for each directly acquired lock B
    and — one interprocedural level — for each lock acquired by a
    same-class ``self.m()`` / same-module ``f()`` callee.  Same-name
    self-edges (``with self._lock`` twice through a helper on the same
    attr) ARE emitted: statically those are the same instance, a real
    self-deadlock for a plain Lock."""
    mod_locks = _named_module_locks(tree)
    base = os.path.basename(path)

    mod_funcs: Dict[str, ast.AST] = {
        n.name: n for n in getattr(tree, "body", [])
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    edges: List[LockEdge] = []

    def scan_scope(fn, cls: Optional[ast.ClassDef],
                   self_locks: Set[str]) -> None:
        def lock_id(lk: Tuple[str, str]) -> str:
            kind, name = lk
            if kind == "self":
                return f"{cls.name}.{name}" if cls is not None else name
            return f"{base}:{name}"

        methods: Dict[str, ast.AST] = {}
        if cls is not None:
            methods = {
                n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

        def callee_edges(node: ast.Call, held: str) -> None:
            """One interprocedural level: locks the callee acquires."""
            target = None
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self" and f.attr in methods):
                target = methods[f.attr]
            elif isinstance(f, ast.Name) and f.id in mod_funcs:
                target = mod_funcs[f.id]
            if target is None or target is fn:
                return
            for acquired, _ in _fn_acquisitions(
                    target, self_locks, mod_locks, lock_id):
                if not _suppressed(lines, node.lineno, "DSQL601"):
                    edges.append(LockEdge(
                        held, acquired, path, node.lineno,
                        via=getattr(target, "name", None)))

        def visit(node: ast.AST, held: Optional[str]):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return
            if isinstance(node, ast.With):
                inner_held = held
                for item in node.items:
                    lk = _lock_of(item.context_expr, self_locks, mod_locks)
                    if lk is None:
                        continue
                    acquired = lock_id(lk)
                    if inner_held is not None and not _suppressed(
                            lines, item.context_expr.lineno, "DSQL601"):
                        edges.append(LockEdge(
                            inner_held, acquired, path,
                            item.context_expr.lineno, via=None))
                    inner_held = acquired
                for child in node.body:
                    visit(child, inner_held)
                return
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "acquire":
                    lk = _lock_of(node.func.value, self_locks, mod_locks)
                    if lk is not None and held is not None \
                            and not _suppressed(
                                lines, node.lineno, "DSQL601"):
                        edges.append(LockEdge(
                            held, lock_id(lk), path, node.lineno,
                            via=None))
                elif held is not None:
                    callee_edges(node, held)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in getattr(fn, "body", []):
            visit(stmt, None)

    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            self_locks = _named_lock_attrs(node)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan_scope(item, node, self_locks)
        elif isinstance(node, ast.Module):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan_scope(item, None, set())


    return edges


def check_lock_order(edges: Iterable[LockEdge]) -> List[LintFinding]:
    """Cycle detection over the merged edge set.  Each cycle is reported
    ONCE, anchored at its lexicographically-first edge, with every
    edge's witness site in the message (for the common 2-cycle that is
    exactly 'both witness paths')."""
    graph: Dict[str, Dict[str, LockEdge]] = {}
    for e in edges:
        graph.setdefault(e.outer, {}).setdefault(e.inner, e)

    findings: List[LintFinding] = []
    reported: Set[Tuple[str, ...]] = set()

    def path_to(src: str, dst: str) -> List[LockEdge]:
        parent: Dict[str, Tuple[str, LockEdge]] = {}
        frontier, seen = [src], {src}
        while frontier:
            node = frontier.pop(0)
            if node == dst:
                out: List[LockEdge] = []
                while node != src:
                    prev, edge = parent[node]
                    out.append(edge)
                    node = prev
                out.reverse()
                return out
            for nxt, edge in graph.get(node, {}).items():
                if nxt not in seen:
                    seen.add(nxt)
                    parent[nxt] = (node, edge)
                    frontier.append(nxt)
        return []

    for outer, inners in sorted(graph.items()):
        for inner, edge in sorted(inners.items()):
            if outer == inner:
                key = (outer,)
                if key in reported:
                    continue
                reported.add(key)
                via = f" via {edge.via}()" if edge.via else ""
                findings.append(LintFinding(
                    "DSQL601", edge.path, edge.line,
                    f"lock {outer!r} is re-acquired while already held"
                    f"{via} — a plain Lock self-deadlocks here; annotate "
                    f"`# {_SUPPRESS['DSQL601']}` only if the lock is "
                    f"reentrant by construction"))
                continue
            back = path_to(inner, outer)
            if not back:
                continue
            cycle_nodes = tuple(sorted({outer, inner}
                                       | {e.outer for e in back}
                                       | {e.inner for e in back}))
            if cycle_nodes in reported:
                continue
            reported.add(cycle_nodes)

            def fmt(e: LockEdge) -> str:
                via = f" via {e.via}()" if e.via else ""
                return (f"{e.outer} -> {e.inner} at {e.path}:{e.line}"
                        f"{via}")

            witness = "; ".join([fmt(edge)] + [fmt(e) for e in back])
            findings.append(LintFinding(
                "DSQL601", edge.path, edge.line,
                f"lock-order cycle between {outer!r} and {inner!r} — "
                f"potential deadlock; witness paths: {witness}.  Fix "
                f"one direction or annotate the deliberate edge with "
                f"`# {_SUPPRESS['DSQL601']}`"))
    return findings


def lock_order_findings(sources: Dict[str, str]) -> List[LintFinding]:
    """The repo-wide DSQL601 pass over {path: source} (the entry point
    `lint_paths` and the unit tests share)."""
    edges: List[LockEdge] = []
    for path, src in sources.items():
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue  # lint_source already reports DSQL000 for this file
        edges.extend(collect_lock_edges(tree, path, src.splitlines()))
    return check_lock_order(edges)


# ---------------------------------------------------------------------------
# DSQL602 — blocking call under a held lock
# ---------------------------------------------------------------------------
#: dotted-name LAST segments that block or do device work when called
_BLOCKING_LAST = {
    # the card's synchronize (``torch.cuda.synchronize``)
    "synchronize",
    # h2d/d2h transfers
    "as_tensor", "asarray", "array",
    # time / network
    "sleep", "urlopen",
    # subprocess constructors
    "Popen", "check_call", "check_output", "call",
}
#: dotted-name FIRST segments whose whole API surface is blocking I/O, or
#: (``_build``) a kernel or planner library build under its own lock
_BLOCKING_FIRST = {"requests", "socket", "httpx", "urllib", "subprocess",
                   "_build"}
#: ctypes entry points of the hand-written kernels and the native planner
#: (``lib.dsql_segsum_typed``)
_KERNEL_ENTRY_PREFIX = "dsql_"
#: the build module's own entry points, called by bare name inside it
_BUILD_MODULE = "_build.py"
_BUILD_ENTRIES = {"build", "library", "native_library"}
#: zero-dotted receiver methods that synchronize with the card or an
#: executor (``x.cpu()``, ``x.to(device)``, ``fut.result(timeout)``, ...)
_BLOCKING_METHODS = {"item", "compute", "result", "cpu", "to", "tolist",
                     "numpy", "synchronize"}
#: `asarray`/`array`/`as_tensor` only count for these namespaces (a local
#: helper named `array` is not a transfer)
_TRANSFER_NAMESPACES = {"np", "numpy", "torch"}


def _blocking_hit(node: ast.Call, path: str = "") -> Optional[str]:
    name = _name_of(node.func)
    if name is not None:
        parts = name.split(".")
        if parts[0] in _BLOCKING_FIRST:
            return name
        if name in _BUILD_ENTRIES \
                and os.path.basename(path) == _BUILD_MODULE:
            return name
        last = parts[-1]
        if last in ("asarray", "array", "as_tensor"):
            return name if (len(parts) > 1
                            and parts[-2] in _TRANSFER_NAMESPACES) else None
        if last.startswith(_KERNEL_ENTRY_PREFIX):
            return name
        if last in _BLOCKING_LAST and last != "call":
            return name
        if last == "call" and len(parts) > 1 \
                and parts[-2] == "subprocess":
            return name
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _BLOCKING_METHODS:
        return f".{node.func.attr}()"
    return None


def check_blocking_under_lock(tree: ast.AST, path: str,
                              lines: Sequence[str]) -> List[LintFinding]:
    mod_locks = _named_module_locks(tree)
    out: List[LintFinding] = []
    seen: Set[int] = set()

    def scan_region(body, holder: str, fn) -> None:
        def visit(node: ast.AST):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return  # closures run on their own schedule
            if isinstance(node, ast.Call) and id(node) not in seen:
                hit = _blocking_hit(node, path)
                if hit is not None:
                    seen.add(id(node))
                    if not _suppressed(lines, node.lineno, "DSQL602"):
                        out.append(LintFinding(
                            "DSQL602", path, node.lineno,
                            f"{hit} blocks while {holder} is held — a "
                            f"slow call under a hot lock convoys every "
                            f"other thread; move it outside the lock or "
                            f"annotate "
                            f"`# {_SUPPRESS['DSQL602']}` with the "
                            f"justification"))
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in body:
            visit(stmt)

    def scan_fn(fn, self_locks: Set[str]) -> None:
        if fn.name.endswith("_locked"):
            scan_region(fn.body, f"the caller's lock ({fn.name})", fn)
            return

        def visit(node: ast.AST):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return
            if isinstance(node, ast.With):
                for item in node.items:
                    lk = _lock_of(item.context_expr, self_locks, mod_locks)
                    if lk is not None:
                        label = (f"self.{lk[1]}" if lk[0] == "self"
                                 else lk[1])
                        scan_region(node.body, label, fn)
                        break
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.body:
            visit(stmt)

    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            self_locks = _named_lock_attrs(node)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan_fn(item, self_locks)
        elif isinstance(node, ast.Module):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan_fn(item, set())
    return out


# ---------------------------------------------------------------------------
# DSQL603 — `_locked` naming convention, both directions
# ---------------------------------------------------------------------------
def check_locked_naming(tree: ast.AST, path: str,
                        lines: Sequence[str]) -> List[LintFinding]:
    from .selflint import _mutations

    mod_locks = _named_module_locks(tree)
    out: List[LintFinding] = []

    # (a) a *_locked function that acquires a lock of its own scope
    def check_reacquire(fn, self_locks: Set[str]) -> None:
        if not fn.name.endswith("_locked"):
            return

        def lock_id(lk):
            return f"self.{lk[1]}" if lk[0] == "self" else lk[1]

        for node in ast.walk(fn):
            lk = None
            if isinstance(node, ast.With):
                for item in node.items:
                    lk = _lock_of(item.context_expr, self_locks, mod_locks)
                    if lk is not None:
                        break
            elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) \
                    and node.func.attr == "acquire":
                lk = _lock_of(node.func.value, self_locks, mod_locks)
            if lk is None:
                continue
            if _suppressed(lines, node.lineno, "DSQL603"):
                continue
            out.append(LintFinding(
                "DSQL603", path, node.lineno,
                f"{fn.name}() promises its caller already holds the "
                f"lock (`_locked` suffix) but acquires {lock_id(lk)} "
                f"itself — a plain Lock self-deadlocks; drop the "
                f"acquire, rename the function, or annotate "
                f"`# {_SUPPRESS['DSQL603']}`"))

    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            self_locks = _named_lock_attrs(node)
            methods = {
                n.name: n for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            for fn in methods.values():
                check_reacquire(fn, self_locks)
            if not self_locks:
                continue

            # (b) non-_locked callee of a locked region mutating guarded
            # attrs off-lock: it should carry the _locked name
            per_method = {name: _mutations(m, self_locks)
                          for name, m in methods.items()}
            guarded_attrs = {
                attr for name, muts in per_method.items()
                if name != "__init__"
                for attr, _, guarded in muts if guarded}
            if not guarded_attrs:
                continue
            offenders = {
                name for name, muts in per_method.items()
                if not name.endswith("_locked") and name != "__init__"
                and any(attr in guarded_attrs and not guarded
                        for attr, _, guarded in muts)}

            for fn in methods.values():
                for sub in ast.walk(fn):
                    if not isinstance(sub, ast.With):
                        continue
                    if not any(_lock_of(i.context_expr, self_locks,
                                        mod_locks)
                               for i in sub.items):
                        continue
                    for call in ast.walk(sub):
                        if not isinstance(call, ast.Call):
                            continue
                        f = call.func
                        if not (isinstance(f, ast.Attribute)
                                and isinstance(f.value, ast.Name)
                                and f.value.id == "self"
                                and f.attr in offenders):
                            continue
                        if _suppressed(lines, call.lineno, "DSQL603"):
                            continue
                        out.append(LintFinding(
                            "DSQL603", path, call.lineno,
                            f"self.{f.attr}() is called under "
                            f"{node.name}'s lock and mutates "
                            f"lock-guarded attributes off-lock — name "
                            f"it {f.attr}_locked so the contract is in "
                            f"the signature, or annotate "
                            f"`# {_SUPPRESS['DSQL603']}`"))
        elif isinstance(node, ast.Module):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    check_reacquire(item, set())
    return out
