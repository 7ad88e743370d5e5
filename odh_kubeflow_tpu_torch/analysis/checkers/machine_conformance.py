"""machine-conformance: state-machine writes must match analysis/machines.py.

The three annotation-durable machines (suspend, slice-repair, culling/stop)
are declared as data in `analysis/machines.py`. This checker AST-extracts
every WRITE of a machine's state annotation from the scanned modules —

    {C.TPU_SUSPEND_STATE_ANNOTATION: STATE_SUSPENDED}      # patch dict
    updates[C.STOP_ANNOTATION] = now_rfc3339()             # subscript store
    annotations.setdefault(C.STOP_ANNOTATION, C.RECON...)  # setdefault

— and flags:

- writes from a module with no declared transition for that machine
  (non-owning writer: a fourth controller quietly joining a two-writer
  contract is exactly how lifecycle races are born),
- writes whose target state is not declared, or whose (function, target)
  pair matches no declared transition (a drifted transition),
- declared transitions whose implementing function no longer writes that
  state (spec drift the other way), checked only when the owning module is
  actually in the scan set,
- spec-level dead ends: unreachable declared states, terminal states with
  neither a self-heal path nor an incident bundle, and — for transitions
  entering a terminal `incident` state — a `via` function that never calls
  `recorder.snapshot(...)`.

A `finish()` pass also asserts the REPAIR_OWNED_CONDITIONS drift contract:
the tuple in controllers/conditions.py must cover EXACTLY the condition
types the repair/suspend/SLO machines pass to `write_condition` — a
condition written but not mirror-preserved gets stomped by the pod-condition
mirror; a preserved-but-never-written type is a dead entry.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..framework import Checker, Finding, ModuleInfo
from ..machines import MACHINES, MachineSpec, machine_for_annotation, spec_errors

# where the machine specs live, for spec-level findings
_SPEC_PATH = "odh_kubeflow_tpu_torch/analysis/machines.py"

# constants.py values resolved lazily (Attribute writes like
# C.RECONCILIATION_LOCK_VALUE need the literal value to classify the state)
_CONST_VALUES: Optional[Dict[str, str]] = None


def _const_values() -> Dict[str, str]:
    global _CONST_VALUES
    if _CONST_VALUES is None:
        from ...controllers import constants as C

        _CONST_VALUES = {
            name: value
            for name, value in vars(C).items()
            if isinstance(value, str) and not name.startswith("_")
        }
    return _CONST_VALUES


def _annotation_const(node: ast.AST) -> Optional[str]:
    """The constants.py NAME a key expression references (C.X / constants.X
    / bare X from `from .constants import X`)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


class _Write:
    __slots__ = ("spec", "module", "function", "value", "dynamic", "line")

    def __init__(self, spec: MachineSpec, module: str, function: str,
                 value: Optional[str], dynamic: bool, line: int):
        self.spec = spec
        self.module = module
        self.function = function
        self.value = value
        self.dynamic = dynamic
        self.line = line


class MachineConformanceChecker(Checker):
    name = "machine-conformance"

    def __init__(self) -> None:
        # (machine name, via) pairs implemented somewhere in the scan set,
        # and which owner modules were actually scanned — drift checks only
        # fire for machines whose owners are present (fixture runs on a
        # single snippet must not report the whole real tree as missing)
        self._implemented: Set[Tuple[str, str, str]] = set()
        self._scanned_modules: Set[str] = set()
        self._condition_writes: Dict[str, Tuple[str, int]] = {}
        self._owned_conditions: Optional[List[Tuple[str, int]]] = None
        self._conditions_path: Optional[str] = None

    # ---------- per-module ----------

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        basename = Path(module.path).name
        self._scanned_modules.add(basename)
        findings: List[Finding] = []
        consts = self._module_string_constants(module.tree)

        for func_name, node, key_node, value_node in self._write_sites(module.tree):
            const_name = _annotation_const(key_node)
            if const_name is None:
                continue
            spec = machine_for_annotation(const_name)
            if spec is None:
                continue
            write = self._classify(
                spec, basename, func_name, value_node, consts, node.lineno
            )
            findings.extend(self._judge(module, write))
        if basename == "conditions.py":
            self._harvest_owned_conditions(module)
        self._harvest_condition_writes(module)
        return findings

    def _write_sites(self, tree: ast.AST):
        """Yield (enclosing function, node, key expr, value expr) for every
        annotation-write shape in the module."""
        func_of: Dict[ast.AST, str] = {}

        def walk(node: ast.AST, func: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and func == "<module>":
                # nested defs (retry closures like `attempt`) attribute to
                # the named method that owns them — the transition's `via`
                func = node.name
            func_of[node] = func
            for child in ast.iter_child_nodes(node):
                walk(child, func)

        walk(tree, "<module>")
        for node in ast.walk(tree):
            func = func_of.get(node, "<module>")
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if k is not None:
                        yield func, node, k, v
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Subscript):
                        yield func, node, target.slice, node.value
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "setdefault"
                and len(node.args) >= 2
            ):
                yield func, node, node.args[0], node.args[1]

    @staticmethod
    def _module_string_constants(tree: ast.AST) -> Dict[str, str]:
        """Module-level NAME = "literal" assignments (STATE_* values)."""
        out: Dict[str, str] = {}
        for node in ast.iter_child_nodes(tree):
            if not isinstance(node, ast.Assign):
                continue
            if not (isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                continue
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = node.value.value
        return out

    def _classify(
        self,
        spec: MachineSpec,
        module: str,
        func: str,
        value_node: ast.AST,
        consts: Dict[str, str],
        line: int,
    ) -> _Write:
        value: Optional[str] = None
        dynamic = False
        if isinstance(value_node, ast.Constant):
            if value_node.value is None:
                value = ""
            elif isinstance(value_node.value, str):
                value = value_node.value
            else:
                dynamic = True
        elif isinstance(value_node, ast.Name) and value_node.id in consts:
            value = consts[value_node.id]
        elif isinstance(value_node, ast.Attribute) \
                and value_node.attr in _const_values():
            value = _const_values()[value_node.attr]
        else:
            dynamic = True
        return _Write(spec, module, func, value, dynamic, line)

    def _judge(self, module: ModuleInfo, w: _Write) -> Iterable[Finding]:
        spec = w.spec
        via = f"{w.module}:{w.function}"
        state = spec.classify_value(w.value, dynamic=w.dynamic)
        if state is None:
            if w.dynamic:
                msg = (
                    f"{spec.name} machine: computed value written to "
                    f"{spec.annotation} in {via} — states must be literal "
                    "(a computed state cannot be checked against the spec)"
                )
            else:
                msg = (
                    f"{spec.name} machine: {via} writes undeclared state "
                    f"{w.value!r} (declared: "
                    f"{sorted(s.name or '(absent)' for s in spec.states)}; "
                    "declare it in analysis/machines.py or fix the write)"
                )
            yield Finding(self.name, module.path, w.line, msg)
            return
        declared_vias = {t.via for t in spec.transitions if t.via}
        if all(not v.startswith(w.module + ":") for v in declared_vias):
            yield Finding(
                self.name, module.path, w.line,
                f"{spec.name} machine: {w.module} writes {spec.annotation} "
                f"but is not a declared writer (owners: "
                f"{', '.join(spec.writer_modules())}) — declare the "
                "transition in analysis/machines.py or route the write "
                "through the owning controller",
            )
            return
        matching = [
            t for t in spec.transitions if t.via == via and t.dst == state
        ]
        if not matching:
            yield Finding(
                self.name, module.path, w.line,
                f"{spec.name} machine: transition to "
                f"{state or '(cleared)'!r} in {via} is not declared in "
                "analysis/machines.py — a drifted transition (declare it, "
                "with its legal source states, or fix the write)",
            )
            return
        self._implemented.add((spec.name, via, state))
        # incident contract: a transition into a terminal incident state
        # must snapshot a flight-recorder bundle from its via function
        st = spec.state(state)
        if st is not None and st.terminal and st.incident:
            if not self._function_snapshots(module.tree, w.function):
                yield Finding(
                    self.name, module.path, w.line,
                    f"{spec.name} machine: {via} enters terminal state "
                    f"{state!r} without a recorder.snapshot(...) incident "
                    "bundle — a dead end with no evidence trail",
                )

    @staticmethod
    def _function_snapshots(tree: ast.AST, func_name: str) -> bool:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == func_name:
                for sub in ast.walk(node):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "snapshot"
                    ):
                        return True
        return False

    # ---------- REPAIR_OWNED_CONDITIONS drift ----------

    def _harvest_owned_conditions(self, module: ModuleInfo) -> None:
        self._conditions_path = module.path
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == "REPAIR_OWNED_CONDITIONS"
                for t in node.targets
            ):
                continue
            if isinstance(node.value, (ast.Tuple, ast.List)):
                self._owned_conditions = [
                    (name, node.lineno)
                    for name in (
                        _annotation_const(e) for e in node.value.elts
                    )
                    if name is not None
                ]

    def _harvest_condition_writes(self, module: ModuleInfo) -> None:
        """Condition-type constants passed to write_condition(...) — the
        mirror-preservation contract's write side."""
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if name != "write_condition" or len(node.args) < 4:
                continue
            ctype = _annotation_const(node.args[3])
            if ctype and ctype.isupper():
                self._condition_writes.setdefault(
                    ctype, (module.path, node.lineno)
                )

    # ---------- cross-module ----------

    def finish(self) -> Iterable[Finding]:
        findings: List[Finding] = []
        for spec in MACHINES:
            for err in spec_errors(spec):
                findings.append(Finding(self.name, _SPEC_PATH, 1, err))
            # drift the other way: a declared transition nobody implements.
            # Only judged when the via module itself was scanned — a
            # single-fixture run must not report the whole tree missing.
            for t in spec.transitions:
                if t.via is None:
                    continue
                via_module = t.via.split(":", 1)[0]
                if via_module not in self._scanned_modules:
                    continue
                if (spec.name, t.via, t.dst) not in self._implemented:
                    findings.append(Finding(
                        self.name, _SPEC_PATH, 1,
                        f"{spec.name} machine: declared transition "
                        f"{t.src or 'rest'!r}->{t.dst or 'rest'!r} via "
                        f"{t.via} has no matching write in {via_module} — "
                        "the spec drifted from the code",
                    ))
        # conditions drift (only when conditions.py was in the scan set AND
        # the writing modules were too — the package-level pass)
        if self._owned_conditions is not None and \
                "slice_repair.py" in self._scanned_modules:
            owned = {name for name, _ in self._owned_conditions}
            written = set(self._condition_writes)
            path = self._conditions_path or "controllers/conditions.py"
            line = self._owned_conditions[0][1] if self._owned_conditions else 1
            for name in sorted(written - owned):
                wpath, wline = self._condition_writes[name]
                findings.append(Finding(
                    self.name, wpath, wline,
                    f"condition {name} is written via write_condition but "
                    "missing from REPAIR_OWNED_CONDITIONS — the pod-"
                    "condition mirror will stomp it on the next rebuild",
                ))
            for name in sorted(owned - written):
                findings.append(Finding(
                    self.name, path, line,
                    f"REPAIR_OWNED_CONDITIONS entry {name} is never passed "
                    "to write_condition — a dead preservation entry (remove "
                    "it, or the machine that owned it lost its write)",
                ))
        return findings
