"""Shared AST helpers for the checkers."""
from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

# terminal attribute/variable names that denote a lock-like object. `cond`
# covers threading.Condition (it IS a lock for discipline purposes).
LOCK_NAME_RE = re.compile(r"(^|_)(lock|cond|mutex)$")


def dotted_name(node: ast.AST) -> Optional[str]:
    """`self._cache.get` -> "self._cache.get"; None for non-name chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last identifier of a name chain: `self._lock` -> "_lock"."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def is_lock_expr(node: ast.AST) -> bool:
    """Heuristic: a with-item (or call receiver) is a lock if its terminal
    name looks lock-ish. Covers every lock in this codebase (`_lock`,
    `_cond`, `_serve_lock`, `_roots_lock`, ...) without type inference."""
    name = terminal_name(node)
    return bool(name and LOCK_NAME_RE.search(name))


def walk_body(stmts: Iterable[ast.stmt]) -> Iterable[ast.AST]:
    """Walk statements without descending into nested function/class defs —
    a `def` inside a `with lock:` body does not RUN under the lock."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
            ):
                continue
            stack.append(child)


def base_name(node: ast.AST) -> Optional[str]:
    """The root variable of a subscript/attribute chain:
    `obj["metadata"]["labels"]` -> "obj"; `self.x[0]` -> "self.x"."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if isinstance(node, ast.Attribute):
            # stop at `self.<attr>`: return the dotted prefix
            dn = dotted_name(node)
            if dn is not None:
                return dn
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None
