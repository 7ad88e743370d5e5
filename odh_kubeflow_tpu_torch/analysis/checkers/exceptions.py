"""swallowed-exception: no bare/blind except in reconcile, webhook or probe
paths.

A reconciler that swallows an exception converts a retryable failure into
silent state drift: the workqueue never backs off, the status never reports
the error, and the operator looks healthy while doing nothing. Two shapes
are flagged, scoped to the control-plane paths where they are dangerous
(controllers/, probe/, webhook modules — plus any function named
reconcile*):

- bare ``except:`` — catches SystemExit/KeyboardInterrupt too; always wrong,
- blind ``except Exception:`` whose body is only ``pass``/``continue``/``...``
  — no log, no fallback value, no re-raise; the error evaporates.

A handler that assigns a fallback (``terminals = []``) or logs is NOT
flagged: degrading with a recorded decision is the pattern the reference
uses, and the point is to force the decision to be visible.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

from ..framework import Checker, Finding, ModuleInfo

SCOPED_DIRS = {"controllers", "probe"}


def _in_scope(path: str) -> bool:
    if path == "<fixture>":
        return True
    parts = Path(path).parts
    if SCOPED_DIRS & set(parts):
        return True
    return "webhook" in Path(path).name


def _is_blind_body(body: List[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / `...`
        return False
    return True


def _catches_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for sub in types:
        if isinstance(sub, ast.Name) and sub.id in ("Exception", "BaseException"):
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in ("Exception", "BaseException"):
            return True
    return False


def _reconcile_handlers(tree: ast.AST) -> List[ast.ExceptHandler]:
    """Except handlers lexically inside any reconcile* function — reconcile
    paths are in scope wherever the module lives (runtime/, cluster/, ...)."""
    out: List[ast.ExceptHandler] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            node.name.startswith("reconcile") or node.name.startswith("_reconcile")
        ):
            out.extend(
                sub for sub in ast.walk(node) if isinstance(sub, ast.ExceptHandler)
            )
    return out


class SwallowedExceptionChecker(Checker):
    name = "swallowed-exception"

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        if _in_scope(module.path):
            handlers: List[ast.ExceptHandler] = [
                node
                for node in ast.walk(module.tree)
                if isinstance(node, ast.ExceptHandler)
            ]
        else:
            handlers = _reconcile_handlers(module.tree)
        findings: List[Finding] = []
        for node in handlers:
            if node.type is None:
                findings.append(
                    Finding(
                        check=self.name,
                        path=module.path,
                        line=node.lineno,
                        message="bare `except:` in a control-plane path "
                        "(catches SystemExit/KeyboardInterrupt too) — name "
                        "the exception and handle or log it",
                    )
                )
            elif _catches_broad(node) and _is_blind_body(node.body):
                findings.append(
                    Finding(
                        check=self.name,
                        path=module.path,
                        line=node.lineno,
                        message="blind `except Exception: pass` in a "
                        "control-plane path — the error evaporates; log it, "
                        "assign a fallback, or re-raise",
                    )
                )
        return findings
