"""lock-discipline: what may not happen inside a ``with lock:`` body, plus a
global lock-acquisition-order cycle check.

The Go reference gets `-race` and deadlock-on-timeout panics for free; here
17 modules take locks across the informer/workqueue/apiserver/kubelet/probe
paths with nothing watching. Two checkers share one lexical model:

`LockDisciplineChecker` (per-module):
- no `time.sleep` under a lock (a sleeping holder stalls every contender —
  the classic tail-latency multiplier),
- no network/blocking I/O calls under a lock (`urlopen`, `http_get`,
  `_get_json`, sockets, subprocess),
- no callback/handler dispatch under a lock (a handler is arbitrary foreign
  code: it can try to take another lock and close an inversion cycle),
- no re-entrant acquisition of a non-reentrant lock: a nested `with` on the
  same lock, or a call to a same-class method that takes the lock the
  caller already holds (threading.Lock self-deadlocks; only RLock and
  Condition are re-entrant).

`LockOrderChecker` (whole-package): builds the static acquisition graph —
an edge A -> B for every `with A:` body that lexically nests `with B:` or
calls a same-class method that takes B — and reports every cycle. A cycle
is a potential ABBA deadlock even if chaos runs have never hit it; the
runtime twin (utils/racecheck.py) checks the same property on the ACTUAL
acquisition order under RACECHECK=1.

Lock identity is `ClassName.attr` for `self.X` locks and `module.name` for
globals — instances of the same class share a node, so hierarchical
same-class locking shows up as a self-edge (ignored: that is re-entrancy,
the discipline checker's job, not ordering's).

`Condition.wait()` is exempt everywhere: wait releases the lock.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..framework import Checker, Finding, ModuleInfo
from ._util import dotted_name, is_lock_expr, terminal_name

SLEEP_RE = re.compile(r"^(time\.)?sleep$")
# dotted-name fragments that mean "this call leaves the process"
NETWORK_FRAGMENTS = (
    "urlopen", "urlretrieve", "http_get", "_get_json", "getresponse",
    "create_connection", "subprocess.", "requests.", "socket.socket",
)
HANDLER_CALL_RE = re.compile(r"(^|_)(handler|callback|cb|hook)s?$")
HANDLER_ITER_RE = re.compile(r"(^|_)(handlers|callbacks|listeners|subscribers|hooks)$")
# threading factory -> reentrancy. Condition's default inner lock is an
# RLock; racecheck factories mirror the same split.
LOCK_FACTORIES = {
    "Lock": "Lock",
    "RLock": "RLock",
    "Condition": "Condition",
    "make_lock": "Lock",
    "make_rlock": "RLock",
}


def _lock_factory_kind(value: ast.AST) -> Optional[str]:
    """`threading.Lock()` -> "Lock", `racecheck.make_rlock(...)` -> "RLock"."""
    if not isinstance(value, ast.Call):
        return None
    name = terminal_name(value.func)
    return LOCK_FACTORIES.get(name or "")


class _ClassInfo:
    def __init__(self, name: str):
        self.name = name
        # lock attr ("self._lock" dotted) -> "Lock" | "RLock" | "Condition"
        self.lock_kinds: Dict[str, str] = {}
        # method name -> set of lock dotted names it acquires lexically
        self.method_locks: Dict[str, Set[str]] = {}
        # method name -> True if it dispatches a callback/handler anywhere in
        # its body (so a call to it under a lock is transitively dispatch)
        self.method_dispatches: Dict[str, bool] = {}


def _scan_classes(tree: ast.AST) -> Dict[str, _ClassInfo]:
    classes: Dict[str, _ClassInfo] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = _ClassInfo(node.name)
        classes[node.name] = info
        for method in node.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            acquired: Set[str] = set()
            dispatches = False
            for sub in ast.walk(method):
                if isinstance(sub, ast.Assign):
                    kind = _lock_factory_kind(sub.value)
                    if kind:
                        for target in sub.targets:
                            dn = dotted_name(target)
                            if dn and dn.startswith("self."):
                                info.lock_kinds[dn] = kind
                if isinstance(sub, ast.With):
                    for item in sub.items:
                        dn = dotted_name(item.context_expr)
                        if dn and dn.startswith("self.") and is_lock_expr(item.context_expr):
                            acquired.add(dn)
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and HANDLER_CALL_RE.search(sub.func.attr)
                ):
                    dispatches = True
            info.method_locks[method.name] = acquired
            info.method_dispatches[method.name] = dispatches
    return classes


def _module_label(path: str) -> str:
    return Path(path).stem


class _WalkContext:
    """Lexical walk of one function: tracks the stack of held locks and the
    enclosing class, emitting discipline findings and order-graph edges."""

    def __init__(
        self,
        path: str,
        cls: Optional[_ClassInfo],
        classes: Dict[str, _ClassInfo],
        edges: Dict[Tuple[str, str], Tuple[str, int]],
        findings: List[Finding],
    ):
        self.path = path
        self.cls = cls
        self.classes = classes
        self.edges = edges
        self.findings = findings
        self.held: List[Tuple[str, str]] = []  # (dotted expr, graph node id)

    def _flag(self, line: int, message: str) -> None:
        self.findings.append(
            Finding(check="lock-discipline", path=self.path, line=line, message=message)
        )

    def _node_id(self, dotted: str) -> str:
        if dotted.startswith("self.") and self.cls is not None:
            return f"{self.cls.name}.{dotted[len('self.'):]}"
        return f"{_module_label(self.path)}.{dotted}"

    def _lock_kind(self, dotted: str) -> Optional[str]:
        if dotted.startswith("self.") and self.cls is not None:
            return self.cls.lock_kinds.get(dotted)
        return None

    def _add_edge(self, outer: str, inner: str, line: int) -> None:
        if outer == inner:
            return  # re-entrancy, not ordering
        self.edges.setdefault((outer, inner), (self.path, line))

    def walk_stmts(self, stmts: Iterable[ast.stmt]) -> None:
        for stmt in stmts:
            self.walk(stmt)

    def walk(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            return  # does not run under the enclosing lock
        if isinstance(node, ast.With):
            lock_items = [
                (item, dotted_name(item.context_expr))
                for item in node.items
                if is_lock_expr(item.context_expr)
            ]
            entered = 0
            for item, dotted in lock_items:
                if dotted is None:
                    continue
                node_id = self._node_id(dotted)
                kind = self._lock_kind(dotted)
                for held_dotted, held_id in self.held:
                    if held_dotted == dotted:
                        if kind in ("RLock", "Condition"):
                            continue
                        self._flag(
                            node.lineno,
                            f"re-entrant acquisition of non-reentrant lock "
                            f"{dotted} (already held; threading.Lock "
                            f"self-deadlocks here)",
                        )
                    else:
                        self._add_edge(held_id, node_id, node.lineno)
                self.held.append((dotted, node_id))
                entered += 1
            for item in node.items:  # context expressions evaluate pre-lock
                if not is_lock_expr(item.context_expr):
                    self.walk(item.context_expr)
            self.walk_stmts(node.body)
            if entered:
                del self.held[len(self.held) - entered:]
            return
        if isinstance(node, ast.Call) and self.held:
            self._check_call(node)
        if isinstance(node, ast.For) and self.held:
            iter_name = terminal_name(node.iter) or ""
            iter_call_recv = (
                terminal_name(node.iter.func.value)
                if isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Attribute)
                and isinstance(node.iter.func.value, (ast.Name, ast.Attribute))
                else None
            )
            handlerish = HANDLER_ITER_RE.search(iter_name) or (
                iter_call_recv and HANDLER_ITER_RE.search(iter_call_recv)
            )
            if handlerish and isinstance(node.target, ast.Name):
                target = node.target.id
                for sub in ast.walk(node):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id == target
                    ):
                        self._flag(
                            sub.lineno,
                            f"callback {target!r} (from {iter_name or iter_call_recv}) "
                            f"dispatched while holding {self.held[-1][0]} — foreign "
                            f"code under a lock can close a deadlock cycle",
                        )
        for child in ast.iter_child_nodes(node):
            self.walk(child)

    def _check_call(self, node: ast.Call) -> None:
        dotted = dotted_name(node.func) or ""
        short = terminal_name(node.func) or ""
        held_expr = self.held[-1][0]
        if short in ("wait", "wait_for"):
            return  # Condition.wait releases the lock
        if SLEEP_RE.match(dotted) or SLEEP_RE.match(short):
            self._flag(
                node.lineno,
                f"time.sleep while holding {held_expr} — every contender "
                f"stalls for the full sleep",
            )
            return
        for fragment in NETWORK_FRAGMENTS:
            if fragment in dotted:
                self._flag(
                    node.lineno,
                    f"blocking I/O call {dotted}() while holding {held_expr}",
                )
                return
        if HANDLER_CALL_RE.search(short):
            # `wh.handler(req)` or a bare `handler(...)` — either way foreign
            # code is running with our lock held
            self._flag(
                node.lineno,
                f"callback dispatch {dotted}() while holding {held_expr}",
            )
        # same-class method call that re-acquires a held non-reentrant lock,
        # and order edges for the locks it does acquire
        if (
            isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
            and self.cls is not None
        ):
            if self.cls.method_dispatches.get(node.func.attr):
                self._flag(
                    node.lineno,
                    f"call to self.{node.func.attr}() while holding "
                    f"{held_expr} — the callee dispatches callbacks, so "
                    f"foreign code runs under this lock",
                )
            callee_locks = self.cls.method_locks.get(node.func.attr, set())
            for callee_lock in callee_locks:
                kind = self.cls.lock_kinds.get(callee_lock)
                for held_dotted, held_id in self.held:
                    if held_dotted == callee_lock:
                        if kind in ("RLock", "Condition"):
                            continue
                        self._flag(
                            node.lineno,
                            f"call to self.{node.func.attr}() re-acquires "
                            f"non-reentrant lock {callee_lock} already held here",
                        )
                    else:
                        self._add_edge(
                            held_id, self._node_id(callee_lock), node.lineno
                        )


class LockDisciplineChecker(Checker):
    name = "lock-discipline"

    def __init__(self) -> None:
        # acquisition-order edges harvested during the SAME walk that finds
        # discipline violations; a paired LockOrderChecker consumes them so
        # the package is walked once, not twice
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        self._walk_module(module, self.edges, findings)
        return findings

    @staticmethod
    def _walk_module(
        module: ModuleInfo,
        edges: Dict[Tuple[str, str], Tuple[str, int]],
        findings: List[Finding],
    ) -> None:
        classes = _scan_classes(module.tree)

        def visit_scope(body: Iterable[ast.stmt], cls: Optional[_ClassInfo]) -> None:
            for stmt in body:
                if isinstance(stmt, ast.ClassDef):
                    visit_scope(stmt.body, classes.get(stmt.name))
                elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ctx = _WalkContext(module.path, cls, classes, edges, findings)
                    ctx.walk_stmts(stmt.body)
                    # nested defs: fresh context (no lock held at def time)
                    for sub in ast.walk(stmt):
                        if isinstance(
                            sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ) and sub is not stmt:
                            inner = _WalkContext(
                                module.path, cls, classes, edges, findings
                            )
                            inner.walk_stmts(sub.body)
                else:
                    ctx = _WalkContext(module.path, cls, classes, edges, findings)
                    ctx.walk(stmt)

        assert isinstance(module.tree, ast.Module)
        visit_scope(module.tree.body, None)


class LockOrderChecker(Checker):
    """Whole-package static lock-order graph; cycles reported in finish().

    Pass `shared` (the run's LockDisciplineChecker) to reuse the edges its
    walk already harvested; standalone (tests, --check lock-order) it walks
    the modules itself."""

    name = "lock-order"

    def __init__(self, shared: Optional[LockDisciplineChecker] = None) -> None:
        self._shared = shared
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = (
            shared.edges if shared is not None else {}
        )

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        if self._shared is None:
            findings: List[Finding] = []  # discipline findings discarded here
            LockDisciplineChecker._walk_module(module, self.edges, findings)
        return ()

    def finish(self) -> Iterable[Finding]:
        graph: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, []).append(b)
        findings: List[Finding] = []
        reported: Set[frozenset] = set()
        for start in sorted(graph):
            cycle = self._find_cycle(graph, start)
            if not cycle:
                continue
            key = frozenset(cycle)
            if key in reported:
                continue
            reported.add(key)
            first_edge = (cycle[0], cycle[1 % len(cycle)])
            path, line = self.edges.get(first_edge, ("<unknown>", 0))
            findings.append(
                Finding(
                    check="lock-order",
                    path=path,
                    line=line,
                    message=(
                        "lock acquisition order cycle: "
                        + " -> ".join(cycle + [cycle[0]])
                        + " (potential ABBA deadlock)"
                    ),
                )
            )
        return findings

    @staticmethod
    def _find_cycle(graph: Dict[str, List[str]], start: str) -> Optional[List[str]]:
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        seen: Set[str] = set()
        while stack:
            node, path = stack.pop()
            for nxt in graph.get(node, []):
                if nxt == start:
                    return path
                if nxt in seen:
                    continue
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
        return None
