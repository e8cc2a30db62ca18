"""Intraprocedural CFG + forward dataflow framework for the self-lint.

Copied from `dask_sql_tpu/analysis/dataflow.py` (no backend code).

The concurrency rules (DSQL601-603) match AST patterns, which alone
cannot prove *path* properties: "this reservation is released on
every way out of the function" is a statement about control flow, not
about any single call site.  This module supplies the missing layer — a
control-flow graph built from a function's AST and a small worklist
engine for forward dataflow over it — so rules like DSQL701
(paired-effect release) can produce genuine all-paths proofs with a
``file:line`` witness for every edge of a counterexample path.

Graph shape
-----------
One node per *statement* (plus a handful of synthetic nodes: entry, the
two exits, branch joins, except-dispatch and finally anchors).  Statement
granularity keeps witness paths readable — every node on a reported path
is a real source line — and functions are small enough that the extra
nodes cost nothing measurable.

Two distinct exits model the two ways control leaves a function:

* ``exit``        — normal completion (``return`` or falling off the end)
* ``raise_exit``  — an exception escaping the function

Exception edges are *approximate by design*: any statement whose
immediately-executed expressions contain a call (or an explicit
``raise`` / ``assert``) gets an edge to the innermost enclosing handler
dispatch / ``finally`` anchor, or to ``raise_exit``.  Pure
name/constant moves get none.  This over-approximates raising (most
calls never throw) and that is the conservative direction for a
release-on-all-paths proof: extra paths can only make the proof
stricter, never hide a leak.  Calls deferred inside a ``lambda`` are
excluded — they do not run at the statement's site.

``try``/``finally`` uses the standard conflation: the ``finally`` suite
is built once, every continuation that enters it (normal fall, return,
exception, break, continue) is recorded, and the suite's end fans back
out to each recorded continuation.  Paths that pair one entry kind with
another's continuation are spurious but, again, only over-approximate.

``while True:`` (constant test) gets no test-false edge — the loop exits
only via ``break``/``return``/``raise``.  Without this the serving
worker's dispatch loop would appear to fall through to the function exit
on a path that cannot execute.

Dataflow
--------
`ForwardAnalysis` is a generic forward engine over a user-supplied
lattice: subclass and provide ``initial()`` / ``transfer(node, fact)`` /
``join(facts)``.  The one CFG-specific rule the engine owns: a value
propagated along an ``except`` edge is ``transfer_except(node,
pre_state)`` — by default the source node's *pre*-state, because if the
statement itself blew up, its effect did not happen.  Clients may
override asymmetrically (DSQL701 counts reaching a *release* statement
as settlement even when the release raises, while an acquire that raised
stays un-acquired).

`find_path` extracts counterexample witnesses: a concrete entry-to-exit
path avoiding "blocking" nodes; the blocker callback distinguishes
nodes that settle on every outgoing edge ("all": release sites) from
ones crossable via their own ``except`` edge ("normal": a handoff
``return`` that raised before returning).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "CFG", "Node", "Edge", "build_cfg", "ForwardAnalysis",
    "enumerate_paths", "path_lines", "find_path", "format_witness",
    "calls_in", "node_calls", "may_raise",
]


# ---------------------------------------------------------------------------
# graph
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Edge:
    src: int
    dst: int
    kind: str   # "step" | "branch" | "back" | "except" | "return" |
                # "break" | "continue" | "handler"
    line: int


@dataclass
class Node:
    nid: int
    label: str  # "entry" | "exit" | "raise_exit" | "stmt" | "join" |
                # "dispatch" | "handler" | "finally"
    line: int = 0
    stmt: Optional[ast.stmt] = None


class CFG:
    """Control-flow graph of one function body."""

    def __init__(self) -> None:
        self.nodes: Dict[int, Node] = {}
        self.succ: Dict[int, List[Edge]] = {}
        self.pred: Dict[int, List[Edge]] = {}
        self.entry = -1
        self.exit = -1
        self.raise_exit = -1
        self._next = 0

    def add_node(self, label: str, line: int = 0,
                 stmt: Optional[ast.stmt] = None) -> int:
        nid = self._next
        self._next += 1
        self.nodes[nid] = Node(nid, label, line, stmt)
        return nid

    def add_edge(self, src: int, dst: int, kind: str, line: int) -> None:
        e = Edge(src, dst, kind, line)
        self.succ.setdefault(src, []).append(e)
        self.pred.setdefault(dst, []).append(e)

    def stmt_nodes(self) -> Iterable[Node]:
        return (n for n in self.nodes.values() if n.stmt is not None)


# ---------------------------------------------------------------------------
# expression helpers
# ---------------------------------------------------------------------------
def calls_in(node: ast.AST) -> Iterable[ast.Call]:
    """Calls executed *at* this node, skipping deferred lambda bodies."""
    stack: List[ast.AST] = [node]
    while stack:
        nd = stack.pop()
        if isinstance(nd, ast.Lambda):
            continue
        if isinstance(nd, ast.Call):
            yield nd
        stack.extend(ast.iter_child_nodes(nd))


def _immediate_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The expressions a compound statement evaluates *itself* (its suites
    are separate nodes); a simple statement evaluates all of itself."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, ast.Try):
        return []
    if hasattr(ast, "Match") and isinstance(stmt, ast.Match):
        return [stmt.subject]
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []  # a def/class statement itself does not call its body
    return [stmt]


def node_calls(node: Node) -> List[ast.Call]:
    """Calls a CFG node executes itself (compound statements evaluate only
    their immediate expressions; suites are separate nodes)."""
    if node.stmt is None:
        return []
    out: List[ast.Call] = []
    for expr in _immediate_exprs(node.stmt):
        out.extend(calls_in(expr))
    return out


def may_raise(stmt: ast.stmt) -> bool:
    """Could executing this statement's own expressions raise?  Calls,
    explicit raises and asserts; not pure data movement."""
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    for expr in _immediate_exprs(stmt):
        for _ in calls_in(expr):
            return True
    return False


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------
@dataclass
class _Frame:
    kind: str                 # "except" | "finally" | "loop"
    dispatch: int = -1        # except: dispatch node
    anchor: int = -1          # finally: suite entry anchor
    head: int = -1            # loop: header node
    after: int = -1           # loop: join after the loop
    pending: Set[str] = field(default_factory=set)   # finally continuations


_CATCH_ALL = {"Exception", "BaseException"}


def _handler_names(h: ast.ExceptHandler) -> List[str]:
    if h.type is None:
        return ["*"]
    types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    out = []
    for t in types:
        if isinstance(t, ast.Attribute):
            out.append(t.attr)
        elif isinstance(t, ast.Name):
            out.append(t.id)
    return out


class _Builder:
    def __init__(self) -> None:
        self.cfg = CFG()
        self._frames: List[_Frame] = []

    def build(self, fn: ast.AST) -> CFG:
        cfg = self.cfg
        cfg.entry = cfg.add_node("entry", getattr(fn, "lineno", 0))
        cfg.exit = cfg.add_node("exit")
        cfg.raise_exit = cfg.add_node("raise_exit")
        end = self._body(fn.body, cfg.entry)
        if end is not None:
            cfg.add_edge(end, cfg.exit, "return", cfg.nodes[end].line)
        return cfg

    # -- continuation routing -------------------------------------------
    def _route(self, src: int, kind: str, line: int) -> None:
        """Route a non-local continuation ("except" / "return" / "break" /
        "continue") from `src` through enclosing finally frames."""
        for fr in reversed(self._frames):
            if fr.kind == "finally":
                self.cfg.add_edge(src, fr.anchor, kind, line)
                fr.pending.add(kind)
                return
            if fr.kind == "except" and kind == "except":
                self.cfg.add_edge(src, fr.dispatch, "except", line)
                return
            if fr.kind == "loop" and kind in ("break", "continue"):
                dst = fr.after if kind == "break" else fr.head
                self.cfg.add_edge(src, dst, kind, line)
                return
        if kind == "return":
            self.cfg.add_edge(src, self.cfg.exit, "return", line)
        elif kind == "except":
            self.cfg.add_edge(src, self.cfg.raise_exit, "except", line)
        # break/continue outside any loop is a syntax error upstream

    # -- construction ----------------------------------------------------
    def _node(self, stmt: ast.stmt, cur: int, kind: str = "step") -> int:
        n = self.cfg.add_node("stmt", stmt.lineno, stmt)
        self.cfg.add_edge(cur, n, kind, stmt.lineno)
        return n

    def _join(self) -> int:
        return self.cfg.add_node("join")

    def _body(self, stmts: Sequence[ast.stmt],
              cur: Optional[int]) -> Optional[int]:
        for stmt in stmts:
            if cur is None:
                break  # unreachable tail
            cur = self._stmt(stmt, cur)
        return cur

    def _stmt(self, s: ast.stmt, cur: int) -> Optional[int]:
        if isinstance(s, ast.If):
            return self._if(s, cur)
        if isinstance(s, (ast.While,)):
            return self._while(s, cur)
        if isinstance(s, (ast.For, ast.AsyncFor)):
            return self._for(s, cur)
        if isinstance(s, (ast.With, ast.AsyncWith)):
            return self._with(s, cur)
        if isinstance(s, ast.Try):
            return self._try(s, cur)
        if hasattr(ast, "Match") and isinstance(s, ast.Match):
            return self._match(s, cur)

        n = self._node(s, cur)
        if isinstance(s, ast.Return):
            if s.value is not None and any(True for _ in calls_in(s.value)):
                self._route(n, "except", s.lineno)
            self._route(n, "return", s.lineno)
            return None
        if isinstance(s, ast.Raise):
            self._route(n, "except", s.lineno)
            return None
        if isinstance(s, ast.Break):
            self._route(n, "break", s.lineno)
            return None
        if isinstance(s, ast.Continue):
            self._route(n, "continue", s.lineno)
            return None
        if may_raise(s):
            self._route(n, "except", s.lineno)
        return n

    def _if(self, s: ast.If, cur: int) -> Optional[int]:
        test = self._node(s, cur)
        if may_raise(s):
            self._route(test, "except", s.lineno)
        t_end = self._body(s.body, test)
        f_end = self._body(s.orelse, test) if s.orelse else test
        ends = [e for e in (t_end, f_end) if e is not None]
        if not ends:
            return None
        if len(ends) == 1:
            return ends[0]
        join = self._join()
        for e in ends:
            self.cfg.add_edge(e, join, "step", self.cfg.nodes[e].line)
        return join

    @staticmethod
    def _const_true(test: ast.expr) -> bool:
        return isinstance(test, ast.Constant) and bool(test.value) \
            and test.value is not None

    def _while(self, s: ast.While, cur: int) -> Optional[int]:
        head = self._node(s, cur)
        if may_raise(s):
            self._route(head, "except", s.lineno)
        after = self._join()
        self._frames.append(_Frame("loop", head=head, after=after))
        b_end = self._body(s.body, head)
        self._frames.pop()
        if b_end is not None:
            self.cfg.add_edge(b_end, head, "back", self.cfg.nodes[b_end].line)
        if not self._const_true(s.test):
            # test-false: run the else suite (if any), then fall out
            e_end = self._body(s.orelse, head) if s.orelse else head
            if e_end is not None:
                self.cfg.add_edge(e_end, after, "step", s.lineno)
        return after if self.cfg.pred.get(after) else None

    def _for(self, s, cur: int) -> Optional[int]:
        head = self._node(s, cur)
        if may_raise(s):
            self._route(head, "except", s.lineno)
        after = self._join()
        self._frames.append(_Frame("loop", head=head, after=after))
        b_end = self._body(s.body, head)
        self._frames.pop()
        if b_end is not None:
            self.cfg.add_edge(b_end, head, "back", self.cfg.nodes[b_end].line)
        e_end = self._body(s.orelse, head) if s.orelse else head
        if e_end is not None:
            self.cfg.add_edge(e_end, after, "step", s.lineno)
        return after if self.cfg.pred.get(after) else None

    def _with(self, s, cur: int) -> Optional[int]:
        n = self._node(s, cur)
        if may_raise(s):
            self._route(n, "except", s.lineno)
        return self._body(s.body, n)

    def _match(self, s, cur: int) -> Optional[int]:
        subj = self._node(s, cur)
        if may_raise(s):
            self._route(subj, "except", s.lineno)
        join = self._join()
        for case in s.cases:
            c_end = self._body(case.body, subj)
            if c_end is not None:
                self.cfg.add_edge(c_end, join, "step",
                                  self.cfg.nodes[c_end].line)
        # no case may match
        self.cfg.add_edge(subj, join, "branch", s.lineno)
        return join

    def _try(self, s: ast.Try, cur: int) -> Optional[int]:
        fin: Optional[_Frame] = None
        if s.finalbody:
            anchor = self.cfg.add_node("finally", s.finalbody[0].lineno)
            fin = _Frame("finally", anchor=anchor)
            self._frames.append(fin)
        disp = -1
        if s.handlers:
            disp = self.cfg.add_node("dispatch", s.lineno)
            self._frames.append(_Frame("except", dispatch=disp))

        body_end = self._body(s.body, cur)
        if s.handlers:
            self._frames.pop()  # handlers/else run outside the except frame
        if body_end is not None and s.orelse:
            body_end = self._body(s.orelse, body_end)

        h_ends: List[int] = []
        if s.handlers and self.cfg.pred.get(disp):
            catch_all = False
            for h in s.handlers:
                names = _handler_names(h)
                if "*" in names or any(n in _CATCH_ALL for n in names):
                    catch_all = True
                hn = self.cfg.add_node("handler", h.lineno)
                self.cfg.add_edge(disp, hn, "handler", h.lineno)
                h_end = self._body(h.body, hn)
                if h_end is not None:
                    h_ends.append(h_end)
            if not catch_all:
                # typed handlers may not match: the exception continues out
                self._route(disp, "except", s.lineno)

        if fin is not None:
            self._frames.pop()
            if body_end is not None:
                self.cfg.add_edge(body_end, fin.anchor, "step",
                                  self.cfg.nodes[body_end].line)
                fin.pending.add("fall")
            for he in h_ends:
                self.cfg.add_edge(he, fin.anchor, "step",
                                  self.cfg.nodes[he].line)
                fin.pending.add("fall")
            if not self.cfg.pred.get(fin.anchor):
                return None
            fin_end = self._body(s.finalbody, fin.anchor)
            if fin_end is None:
                return None  # the finally suite itself diverges
            after: Optional[int] = None
            line = s.finalbody[-1].lineno
            for kind in sorted(fin.pending):
                if kind == "fall":
                    after = self._join()
                    self.cfg.add_edge(fin_end, after, "step", line)
                else:
                    self._route(fin_end, kind, line)
            return after

        ends = ([body_end] if body_end is not None else []) + h_ends
        if not ends:
            return None
        if len(ends) == 1:
            return ends[0]
        join = self._join()
        for e in ends:
            self.cfg.add_edge(e, join, "step", self.cfg.nodes[e].line)
        return join


def build_cfg(fn: ast.AST) -> CFG:
    """CFG of one ``FunctionDef`` / ``AsyncFunctionDef`` body.  Nested
    function/class definitions are single statement nodes (their bodies
    are separate CFGs)."""
    return _Builder().build(fn)


# ---------------------------------------------------------------------------
# forward dataflow engine
# ---------------------------------------------------------------------------
class ForwardAnalysis:
    """Generic forward worklist dataflow.  Subclass with a lattice:

    * ``initial()``            -- fact at function entry
    * ``transfer(node, fact)`` -- fact after executing `node`
    * ``join(facts)``          -- merge at control-flow confluences

    Facts must be hashable/comparable values (frozensets work well).
    ``except`` edges propagate ``transfer_except(node, pre_state)``; the
    default is the source's *pre*-state unchanged — if the statement
    raised, its own effect did not take place.  A client may override it
    asymmetrically (DSQL701 applies *releases* even on the except edge —
    demanding a release-of-the-release would be unsatisfiable — while
    acquires stay pre-state).
    """

    def initial(self):
        return frozenset()

    def transfer(self, node: Node, fact):
        return fact

    def transfer_except(self, node: Node, fact):
        return fact

    def join(self, facts):
        merged = set()
        for f in facts:
            merged |= f
        return frozenset(merged)

    def run(self, cfg: CFG) -> Tuple[Dict[int, object], Dict[int, object]]:
        """Fixpoint; returns (fact_in, fact_out) per node id.  Unreached
        nodes are absent from both maps."""
        fact_in: Dict[int, object] = {cfg.entry: self.initial()}
        fact_out: Dict[int, object] = {}
        work = [cfg.entry]
        while work:
            nid = work.pop()
            fi = fact_in[nid]
            fo = self.transfer(cfg.nodes[nid], fi)
            fact_out[nid] = fo
            for e in cfg.succ.get(nid, []):
                val = self.transfer_except(cfg.nodes[nid], fi) \
                    if e.kind == "except" else fo
                old = fact_in.get(e.dst)
                new = val if old is None else self.join([old, val])
                if new != old:
                    fact_in[e.dst] = new
                    work.append(e.dst)
        return fact_in, fact_out


# ---------------------------------------------------------------------------
# path extraction
# ---------------------------------------------------------------------------
def enumerate_paths(cfg: CFG, limit: int = 2000) -> List[List[Edge]]:
    """All simple entry-to-exit paths (each node at most once, so loop
    bodies appear at most one iteration).  For tests and witnesses, not
    for analysis — the dataflow engine handles cycles by fixpoint."""
    out: List[List[Edge]] = []
    targets = {cfg.exit, cfg.raise_exit}

    def dfs(nid: int, path: List[Edge], on_path: Set[int]) -> None:
        if len(out) >= limit:
            return
        if nid in targets:
            out.append(list(path))
            return
        for e in cfg.succ.get(nid, []):
            if e.dst in on_path:
                continue
            path.append(e)
            on_path.add(e.dst)
            dfs(e.dst, path, on_path)
            on_path.discard(e.dst)
            path.pop()

    dfs(cfg.entry, [], {cfg.entry})
    return out


def path_lines(cfg: CFG, limit: int = 2000) -> Set[Tuple]:
    """Each simple path as a tuple of visited statement lines plus a
    terminal marker ("exit" or "raise"), for exact-shape assertions."""
    shapes: Set[Tuple] = set()
    for path in enumerate_paths(cfg, limit):
        lines: List[object] = []
        for e in path:
            node = cfg.nodes[e.dst]
            if node.stmt is not None:
                lines.append(node.line)
        terminal = "raise" if path and path[-1].dst == cfg.raise_exit \
            else "exit"
        shapes.add(tuple(lines) + (terminal,))
    return shapes


def find_path(cfg: CFG, start: int, targets: Set[int],
              blocks: Callable[[Node], object]) -> Optional[List[Edge]]:
    """Shortest path from `start` to any target on which no intermediate
    node "blocks".  ``blocks(node)`` returns ``"all"`` (the node settles
    the effect even on its own except edge — a release statement),
    ``"normal"`` (crossable only via its own except edge — a handoff
    ``return`` that raised before returning), or a falsy value.  `start`'s
    own ``except`` edges are excluded: if the acquire raised, no effect
    took place."""
    from collections import deque

    parent: Dict[int, Edge] = {}
    seen = {start}
    q = deque([start])
    while q:
        nid = q.popleft()
        node = cfg.nodes[nid]
        verdict = None if nid == start else blocks(node)
        if verdict == "all":
            continue
        for e in cfg.succ.get(nid, []):
            if nid == start and e.kind == "except":
                continue
            if verdict and e.kind != "except":
                continue
            if e.dst in seen:
                continue
            seen.add(e.dst)
            parent[e.dst] = e
            if e.dst in targets:
                path = [e]
                while path[0].src != start:
                    path.insert(0, parent[path[0].src])
                return path
            q.append(e.dst)
    return None


def format_witness(cfg: CFG, path: List[Edge]) -> str:
    """`10 -> 12 -> except 14 -> raise-exit` — one hop per edge, statement
    lines only; exceptional hops are labelled."""
    if not path:
        return "<empty>"
    parts: List[str] = [str(cfg.nodes[path[0].src].line)]
    for e in path:
        node = cfg.nodes[e.dst]
        if node.nid == cfg.exit:
            label = "exit"
        elif node.nid == cfg.raise_exit:
            label = "raise-exit"
        elif node.stmt is None:
            continue  # synthetic join/dispatch/finally anchor
        else:
            label = str(node.line)
        if e.kind in ("except", "return", "back", "break", "continue"):
            label = f"{e.kind} {label}"
        parts.append(label)
    return " -> ".join(parts)
