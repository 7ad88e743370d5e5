"""no-cache-mutation: objects read from an informer cache (or any read memo)
must be deep-copied before any in-place write.

This is the classic controller-runtime bug class: a reconciler mutates the
object the informer's lister handed out, silently corrupting the shared
cache for every other reader — no error, just a cluster view that drifts
from etcd until the next relist. The Go ecosystem catches it with
deep-copy-gen conventions and runtime mutation detectors
(`client-go`'s `mutation_detector.go`, `-race`); statically we approximate
with a per-function taint pass:

- SEEDS: calls `<recv>.get(...)` / `<recv>.list(...)` / `<recv>.values()` /
  `<recv>.items()` and subscripts `<recv>[key]` where the receiver's
  terminal name looks cache-ish (`_cache`, `cache`, `inf`, `informer`,
  `*_memo`). Iterating a seed taints the loop target.
- LAUNDER: `copy.deepcopy(x)`, `x.deepcopy()`, or rebinding the name.
- FLAG: any in-place write through a tainted name — subscript/attribute
  assignment, `del`, augmented assignment, or a mutating method call
  (`update`, `pop`, `setdefault`, `append`, ...), including through
  subscript chains (`obj["metadata"]["labels"][k] = v`).

The cache CONTAINER itself is exempt: `self._cache[key] = obj` is the
informer (the owner) managing its own storage, which is legal; the invariant
protects objects handed OUT of it. The runtime twin of this checker is the
RACECHECK=1 write barrier in utils/racecheck.py, which catches the dynamic
escapes (handler callbacks, cross-module flows) this lexical pass cannot.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List

from ..framework import Checker, Finding, ModuleInfo
from ._util import base_name, terminal_name

CACHE_RECV_RE = re.compile(r"(^|_)(cache|caches|memo|memos|inf|informer)$|_memo$|_cache$")
READ_METHODS = {"get", "list", "values", "items"}
MUTATORS = {
    "update", "pop", "popitem", "setdefault", "clear",
    "append", "extend", "insert", "remove", "sort", "reverse",
}
LAUNDER_CALLS = {"deepcopy"}  # copy.deepcopy(x) / x.deepcopy()


def _is_cache_read(node: ast.AST) -> bool:
    """`self._cache.get(k)`, `inf.list(...)`, `self._cache[k]` ..."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in READ_METHODS:
            recv = terminal_name(node.func.value)
            return bool(recv and CACHE_RECV_RE.search(recv))
    if isinstance(node, ast.Subscript):
        recv = terminal_name(node.value)
        return bool(recv and CACHE_RECV_RE.search(recv))
    return False


def _is_launder(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        name = None
        if isinstance(node.func, ast.Attribute):
            name = node.func.attr
        elif isinstance(node.func, ast.Name):
            name = node.func.id
        return name in LAUNDER_CALLS
    return False


class _FunctionTaint(ast.NodeVisitor):
    """Single forward pass over one function body, in textual order. Taint is
    a name -> seed-line map; joins are ignored (any path that taints, taints
    — conservative in the flagging direction, permissive on rebinds)."""

    def __init__(self, path: str):
        self.path = path
        self.taint: Dict[str, int] = {}
        self.findings: List[Finding] = []

    # -- taint sources / kills --

    def _names_of_target(self, target: ast.AST) -> List[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            out: List[str] = []
            for elt in target.elts:
                out.extend(self._names_of_target(elt))
            return out
        return []

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)  # flags mutations on the RHS/targets first
        value = node.value
        tainted_value = _is_cache_read(value) or (
            isinstance(value, ast.Name) and value.id in self.taint
        )
        for target in node.targets:
            self._check_mutation(target, node.lineno)
            for name in self._names_of_target(target):
                if _is_launder(value):
                    self.taint.pop(name, None)
                elif tainted_value:
                    self.taint[name] = node.lineno
                else:
                    self.taint.pop(name, None)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is None:
            return
        if isinstance(node.target, ast.Name):
            if _is_cache_read(node.value):
                self.taint[node.target.id] = node.lineno
            else:
                self.taint.pop(node.target.id, None)

    def visit_For(self, node: ast.For) -> None:
        iter_tainted = _is_cache_read(node.iter) or (
            isinstance(node.iter, ast.Name) and node.iter.id in self.taint
        )
        if iter_tainted:
            for name in self._names_of_target(node.target):
                self.taint[name] = node.lineno
        self.generic_visit(node)

    # -- mutation sinks --

    def _check_mutation(self, target: ast.AST, lineno: int) -> None:
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            base = base_name(target.value)
            if base in self.taint:
                self.findings.append(
                    Finding(
                        check="cache-mutation",
                        path=self.path,
                        line=lineno,
                        message=(
                            f"in-place write through {base!r} (read from a cache "
                            f"at line {self.taint[base]}) without copy.deepcopy()"
                        ),
                    )
                )

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_mutation(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            self._check_mutation(target, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and node.func.attr in MUTATORS:
            base = base_name(node.func.value)
            if base in self.taint:
                self.findings.append(
                    Finding(
                        check="cache-mutation",
                        path=self.path,
                        line=node.lineno,
                        message=(
                            f"mutating call .{node.func.attr}() through {base!r} "
                            f"(read from a cache at line {self.taint[base]}) "
                            f"without copy.deepcopy()"
                        ),
                    )
                )
        self.generic_visit(node)

    # nested defs get their own fresh pass (run by the checker); don't let
    # this one descend into them with the enclosing scope's taint
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass


class CacheMutationChecker(Checker):
    name = "cache-mutation"

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visitor = _FunctionTaint(module.path)
                for stmt in node.body:
                    visitor.visit(stmt)
                findings.extend(visitor.findings)
        return findings
