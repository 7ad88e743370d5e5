"""metric-convention / annotation-convention: names are contracts.

Metric families and annotation keys outlive any one release — dashboards,
alerts, and users' CRs bind to them. Two checkers keep them centralized and
well-formed:

`MetricConventionChecker`: every `registry.counter/gauge/histogram(...)`
registration site must use a literal name that passes the shared Prometheus
rules in analysis/metric_rules.py (valid charset, counters end in `_total`,
non-empty help, valid label names, no reserved `le`). Literal-only is itself
a rule: a computed metric name cannot be grepped, alerted on, or linted.

`AnnotationConventionChecker`: the operator's own annotation/label keys
(`notebooks.kubeflow.org/...`, `notebooks.opendatahub.io/...`,
`opendatahub.io/...`, `kubeflow-resource-stopped`) may only be spelled out
in controllers/constants.py (and utils/tracing.py, the traceparent key's
canonical home). Everywhere else must import the constant — the reference
keeps these byte-identical to upstream, and a typo'd inline key silently
breaks the stop/culling state machine rather than failing loudly.

The checker's `finish()` pass additionally flags DEAD `*_ANNOTATION`
constants: a key defined in constants.py that no other module reads is
either a leftover from a removed feature (delete it) or — worse — a
contract someone believes is honored while nothing writes or reads it
(the reference's first catch: TPU_IDLE_ANNOTATION, which nothing ever
consumed — the culler reads last_busy from the probe JSON).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from ..framework import Checker, Finding, ModuleInfo
from ..metric_rules import check_metric
from ._util import terminal_name

REGISTRY_RECV_RE = re.compile(r"(^|_)(registry|metrics)$")
REGISTRATION_METHODS = {"counter", "gauge", "histogram"}

# the operator's own key namespaces (external contract keys like
# cert-manager.io/* are other controllers' constants, not ours)
ANNOTATION_KEY_RE = re.compile(
    r"^(notebooks\.(kubeflow\.org|opendatahub\.io|tpu\.kubeflow\.org)"
    r"|opendatahub\.io)/[A-Za-z0-9_.\-]+$"
    r"|^kubeflow-resource-stopped$"
)
ANNOTATION_HOMES = ("constants.py", "tracing.py")


def _literal_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class MetricConventionChecker(Checker):
    name = "metric-convention"

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in REGISTRATION_METHODS
            ):
                continue
            recv = terminal_name(node.func.value) or ""
            if not REGISTRY_RECV_RE.search(recv):
                continue
            name = _literal_str(node.args[0] if node.args else None)
            if name is None:
                findings.append(
                    Finding(
                        check=self.name,
                        path=module.path,
                        line=node.lineno,
                        message=f"metric name passed to .{node.func.attr}() "
                        "must be a string literal (computed names cannot be "
                        "grepped, alerted on, or linted)",
                    )
                )
                continue
            help_node = node.args[1] if len(node.args) > 1 else None
            for kw in node.keywords:
                if kw.arg == "help_":
                    help_node = kw.value
            help_text = _literal_str(help_node)
            if help_node is None:
                help_text = ""  # registration default: empty help
            # labels: third positional (Registry.counter(name, help_, labels))
            # or the `labels=` keyword — both spellings are live in-tree
            labels_node = node.args[2] if len(node.args) > 2 else None
            for kw in node.keywords:
                if kw.arg == "labels":
                    labels_node = kw.value
            labels: List[str] = []
            if isinstance(labels_node, (ast.Tuple, ast.List)):
                labels = [
                    v for v in (_literal_str(e) for e in labels_node.elts)
                    if v is not None
                ]
            for violation in check_metric(
                name, node.func.attr, help_text, labels
            ):
                findings.append(
                    Finding(
                        check=self.name,
                        path=module.path,
                        line=node.lineno,
                        message=violation,
                    )
                )
        return findings


class AnnotationConventionChecker(Checker):
    name = "annotation-convention"

    def __init__(self) -> None:
        # constants.py `*_ANNOTATION` definitions and the names read
        # anywhere else, for the dead-constant finish() pass. Only armed
        # when the real constants module is in the scan set, so fixture
        # runs on a lone snippet stay silent.
        self._defined: Dict[str, Tuple[str, int]] = {}
        self._read: set = set()

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        basename = Path(module.path).name
        if basename == "constants.py" and "controllers" in Path(module.path).parts:
            for node in ast.iter_child_nodes(module.tree):
                if not isinstance(node, ast.Assign):
                    continue
                for target in node.targets:
                    if isinstance(target, ast.Name) and \
                            target.id.endswith("_ANNOTATION"):
                        self._defined[target.id] = (module.path, node.lineno)
        else:
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Attribute):
                    self._read.add(node.attr)
                elif isinstance(node, ast.Name):
                    self._read.add(node.id)
        if basename in ANNOTATION_HOMES:
            return []
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
                continue
            if ANNOTATION_KEY_RE.match(node.value):
                findings.append(
                    Finding(
                        check=self.name,
                        path=module.path,
                        line=node.lineno,
                        message=f"operator annotation/label key {node.value!r} "
                        "spelled inline — import it from "
                        "controllers/constants.py (one typo here silently "
                        "breaks the culling/stop state machine)",
                    )
                )
        return findings

    def finish(self) -> Iterable[Finding]:
        if not self._read:
            # constants.py scanned alone (a single-file --check run): with
            # no reader module in the scan set, "nothing reads it" would be
            # vacuously true for every constant — stay silent
            return
        for name, (path, line) in sorted(self._defined.items()):
            if name not in self._read:
                yield Finding(
                    check=self.name,
                    path=path,
                    line=line,
                    message=f"dead annotation constant {name}: no module "
                    "reads it — delete it, or the feature that honored "
                    "this contract is gone while the key suggests "
                    "otherwise",
                )
