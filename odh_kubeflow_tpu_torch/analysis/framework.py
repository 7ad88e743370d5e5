"""Checker framework of the port's lint: module loading, pragma
suppression, finding report.

One `ast.parse` per module, shared by every checker; checkers are small
classes with a per-module `check()` and an optional cross-module `finish()`
(the lock-order graph needs the whole package before it can report cycles).

Suppression is comment-driven so exceptions live next to the code they
excuse:

    self._handlers.append(handler)  # lint: disable=lock-discipline

- ``# lint: disable=<check>[,<check>...]`` suppresses those checks on that
  physical line (the line a finding is reported at).
- ``# lint: disable-file=<check>`` anywhere in the file suppresses the check
  for the whole module (used for fixture files that exist to be ugly).
- ``all`` matches every check.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

_PRAGMA_RE = re.compile(r"#\s*lint:\s*disable(?P<scope>-file)?\s*=\s*(?P<checks>[A-Za-z0-9_,\- ]+)")


@dataclass(frozen=True)
class Finding:
    check: str
    path: str  # repo-relative where possible (stable in CI output)
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


@dataclass
class ModuleInfo:
    path: str
    source: str
    tree: ast.AST
    # physical line -> set of check names disabled on that line
    line_pragmas: Dict[int, Set[str]] = field(default_factory=dict)
    file_pragmas: Set[str] = field(default_factory=set)

    @classmethod
    def parse(cls, path: str, source: Optional[str] = None) -> "ModuleInfo":
        if source is None:
            source = Path(path).read_text()
        tree = ast.parse(source, filename=path)
        info = cls(path=path, source=source, tree=tree)
        # pragmas come from real COMMENT tokens only — a regex over raw lines
        # would arm suppressions written inside string literals/docstrings
        # (e.g. a fixture or log template containing the pragma text)
        try:
            tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
        except (tokenize.TokenError, IndentationError):  # pragma: no cover
            tokens = []  # ast.parse succeeded, so this is near-unreachable
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            checks = {c.strip() for c in m.group("checks").split(",") if c.strip()}
            if m.group("scope"):
                info.file_pragmas |= checks
            else:
                info.line_pragmas.setdefault(tok.start[0], set()).update(checks)
        return info

    def suppressed(self, finding: Finding) -> bool:
        if {"all", finding.check} & self.file_pragmas:
            return True
        on_line = self.line_pragmas.get(finding.line, set())
        return bool({"all", finding.check} & on_line)


class Checker:
    """Base checker: subclass, set `name`, implement `check(module)`."""

    name = "checker"

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        raise NotImplementedError

    def finish(self) -> Iterable[Finding]:
        """Cross-module findings, after every module has been checked."""
        return ()


def all_checkers() -> List[Checker]:
    """Fresh instances of every registered checker (stateful finish() passes
    must not leak graph state between runs)."""
    from .checkers import make_checkers

    return make_checkers()


def _iter_py_files(root: Path) -> Iterable[Path]:
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts or "_native" in path.parts:
            continue
        yield path


def _iter_modules(paths: Sequence[str]) -> Iterator[ModuleInfo]:
    """Parse every .py under `paths` (files or directories), cwd-relative
    where possible — the one iteration both the analysis pass and the
    pragma budget share, so they can never scan different trees."""
    for p in paths:
        root = Path(p)
        files = [root] if root.is_file() else list(_iter_py_files(root))
        for f in files:
            try:
                rel = str(f.relative_to(Path.cwd()))
            except ValueError:
                rel = str(f)
            yield ModuleInfo.parse(rel)


def run_analysis(
    paths: Sequence[str],
    checkers: Optional[Sequence[Checker]] = None,
    include_suppressed: bool = False,
) -> List[Finding]:
    """Run checkers over every .py under `paths` (files or directories).

    Returns unsuppressed findings sorted by (path, line). Pass
    `include_suppressed=True` to audit what the pragmas are hiding."""
    checkers = list(checkers) if checkers is not None else all_checkers()
    findings: List[Finding] = []
    modules: List[ModuleInfo] = list(_iter_modules(paths))
    if not modules:
        # a mistyped path (or a runner invoked from the wrong cwd) must not
        # turn the lint gate into a vacuous green
        raise FileNotFoundError(
            f"analysis found no Python modules under {list(paths)!r} "
            f"(cwd: {Path.cwd()})"
        )
    for module in modules:
        for checker in checkers:
            for finding in checker.check(module):
                if include_suppressed or not module.suppressed(finding):
                    findings.append(finding)
    by_path = {m.path: m for m in modules}
    for checker in checkers:
        for finding in checker.finish():
            module = by_path.get(finding.path)
            if include_suppressed or module is None or not module.suppressed(finding):
                findings.append(finding)
    return sorted(findings, key=lambda f: (f.path, f.line, f.check))


def collect_pragmas(paths: Sequence[str]) -> Dict[Tuple[str, str], int]:
    """(path, check) -> pragma count over every module under `paths` — the
    pragma BUDGET the `--pragma-gate` holds against the committed allowlist
    (analysis/pragma_allowlist.txt). Counts are per-line-occurrence (a file
    pragma counts once): adding an unreviewed `# lint: disable` anywhere
    fails the gate even when the file already had one for the same check."""
    out: Dict[Tuple[str, str], int] = {}
    for info in _iter_modules(paths):
        for checks in info.line_pragmas.values():
            for check in checks:
                out[(info.path, check)] = out.get((info.path, check), 0) + 1
        for check in info.file_pragmas:
            out[(info.path, check)] = out.get((info.path, check), 0) + 1
    return out


def render_pragma_allowlist(budget: Dict[Tuple[str, str], int]) -> str:
    lines = [
        "# Reviewed `# lint: disable` pragma budget of the port (--pragma-gate).",
        "# Regenerate after a REVIEWED change with:",
        "#   python -m odh_kubeflow_tpu_torch.analysis --pragma-update "
        "odh_kubeflow_tpu_torch/analysis/pragma_allowlist.txt",
        "# format: path<TAB>check<TAB>count",
    ]
    for (path, check), count in sorted(budget.items()):
        lines.append(f"{path}\t{check}\t{count}")
    return "\n".join(lines) + "\n"


def parse_pragma_allowlist(text: str) -> Dict[Tuple[str, str], int]:
    out: Dict[Tuple[str, str], int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        if len(parts) != 3:
            raise ValueError(f"malformed allowlist line: {line!r}")
        out[(parts[0], parts[1])] = int(parts[2])
    return out


def pragma_budget_violations(
    budget: Dict[Tuple[str, str], int],
    allowlist: Dict[Tuple[str, str], int],
) -> List[str]:
    """New/expanded pragmas fail; shrinkage only nags (an overly-generous
    allowlist is stale, not dangerous)."""
    problems = []
    for (path, check), count in sorted(budget.items()):
        allowed = allowlist.get((path, check), 0)
        if count > allowed:
            problems.append(
                f"{path}: {count} `# lint: disable={check}` pragma(s), "
                f"allowlist permits {allowed} — a new suppression needs "
                "review (then --pragma-update)"
            )
    return problems


def run_on_source(
    source: str, checkers: Sequence[Checker], path: str = "<fixture>"
) -> List[Finding]:
    """Run checkers over an in-memory snippet — the test-fixture entry point."""
    module = ModuleInfo.parse(path, source=source)
    findings: List[Finding] = []
    for checker in checkers:
        for finding in checker.check(module):
            if not module.suppressed(finding):
                findings.append(finding)
    for checker in checkers:
        for finding in checker.finish():
            if not module.suppressed(finding):
                findings.append(finding)
    return sorted(findings, key=lambda f: (f.path, f.line, f.check))
