"""torchlint: the data-plane discipline checkers of the port, counterparts
of the reference's jaxlint (odh_kubeflow_tpu/analysis/checkers/jaxlint.py)
under the reference's check names.

- ``host-transfer``  device->host copies (``.item()``, ``.cpu()``,
                     ``.tolist()``, ``.numpy()``, ``torchguard.to_host``,
                     ``.to("cpu")``, ``np.array/asarray``, ``float/int/bool``
                     over a tensor, branching on a tensor) inside a declared
                     hot region (`utils/hotregions.py`) or any same-module
                     function it reaches. A copy waits for every kernel
                     queued before it: in the decode loop that is the
                     per-token round trip continuous batching exists to
                     amortize.
- ``psum-axis``      axis-name literals given to the mesh's axis methods
                     (`group`, `size`, `index`, `ranks`, `live`), to its
                     `sizes[...]`, and to
                     ``axis_name=`` / ``seq_axis=`` must be axes some scanned
                     module declares (`parallel/mesh.py`'s ``AXES`` and
                     ``GROUP_AXES``): a cross-module finish() pass.

Without types, a tensor is told from a host (numpy) value by how it was
made: a call into ``torch.``, a tensor-only method (``.to``, ``.long()``,
a ``dim=`` argument, ...), a same-module function that returns one, or a
name or ``self`` attribute bound to one of those. Values made by ``np.``
calls or returned by ``to_host`` are host values, and so are a tensor's
``.shape``, ``.dtype`` and ``.device``. `ServingEngine._lengths` is a numpy
array, so ``int(self._lengths.max())`` is no transfer.

The reference's ``retrace-hazard`` and ``donation-discipline`` have no
counterpart yet: the port has no ``torch.compile`` and no CUDA-graph
capture, whose static inputs bring both hazards back.

The runtime twin is `utils/torchguard.py`; the two share the hot-region
table in `utils/hotregions.py`.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from ...utils import hotregions
from ..framework import Checker, Finding, ModuleInfo
from ._util import dotted_name, terminal_name

_NP_TRANSFER = {"np.array", "np.asarray", "numpy.array", "numpy.asarray"}
# torch.* calls that give host values (or no value), not tensors
_TORCH_HOST_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.compiler.",
    "torch.is_", "torch.get_", "torch.are_", "torch.set_", "torch.device",
    "torch.dtype", "torch.Size", "torch.finfo", "torch.iinfo",
    "torch.inference_mode", "torch.no_grad", "torch.enable_grad",
    "torch.manual_seed", "torch.Generator",
)
# methods only a tensor has: a call of one marks its receiver a tensor
_TENSOR_METHODS = {
    "to", "cuda", "long", "int", "float", "half", "bfloat16", "bool",
    "contiguous", "clone", "detach", "pin_memory", "unsqueeze", "masked_fill",
    "index_select", "clamp", "clamp_", "softmax", "log_softmax",
}
# methods and attributes of a tensor that give host values
_HOST_METHODS = {
    "size", "dim", "numel", "stride", "element_size", "data_ptr",
    "is_contiguous", "get_device", "item", "tolist", "cpu", "numpy",
    "to_host",
}
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout", "type"}


def _is_cpu(node: ast.AST) -> bool:
    """`"cpu"` or `torch.device("cpu")`."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (
        isinstance(node, ast.Call)
        and dotted_name(node.func) == "torch.device"
        and bool(node.args)
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "cpu"
    )


class _Values:
    """Which expressions of one module hold tensors and which hold host
    values: names per function, `self` attributes per module, and the
    module's functions that return a tensor."""

    def __init__(self, funcs: Dict[str, ast.AST]):
        self.funcs = funcs
        self.local_device: Dict[str, Set[str]] = {q: set() for q in funcs}
        self.local_host: Dict[str, Set[str]] = {q: set() for q in funcs}
        self.attr_device: Set[str] = set()
        self.attr_host: Set[str] = set()
        self.returns_device: Set[str] = set()  # terminal names
        for _ in range(4):
            if not self._pass():
                break

    # ---------- judging one expression ----------

    def device(self, node: ast.AST, q: str) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.local_device[q]
        if isinstance(node, ast.Attribute):
            dn = dotted_name(node)
            if dn is not None and dn.startswith("self.") and dn.count(".") == 1:
                return dn in self.attr_device and dn not in self.attr_host
            if node.attr in _HOST_ATTRS:
                return False
            return self.device(node.value, q)
        if isinstance(node, ast.Subscript):
            return self.device(node.value, q)
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func) or ""
            tn = terminal_name(node.func) or ""
            if dn.startswith("torch."):
                return not dn.startswith(_TORCH_HOST_PREFIXES)
            if isinstance(node.func, ast.Attribute):
                if tn in _HOST_METHODS:
                    return False
                if tn in _TENSOR_METHODS or any(kw.arg == "dim" for kw in node.keywords):
                    return True
                if tn in self.returns_device and dotted_name(node.func.value) == "self":
                    return True
                return self.device(node.func.value, q)
            return tn in self.returns_device
        if isinstance(node, ast.BinOp):
            return self.device(node.left, q) or self.device(node.right, q)
        if isinstance(node, ast.UnaryOp):
            return self.device(node.operand, q)
        if isinstance(node, ast.BoolOp):
            return any(self.device(v, q) for v in node.values)
        if isinstance(node, ast.Compare):
            return any(self.device(v, q) for v in [node.left, *node.comparators])
        if isinstance(node, ast.IfExp):
            return self.device(node.body, q) or self.device(node.orelse, q)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.device(e, q) for e in node.elts)
        return False

    def host(self, node: ast.AST, q: str) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.local_host[q] and node.id not in self.local_device[q]
        if isinstance(node, ast.Attribute):
            dn = dotted_name(node)
            if dn is not None and dn.startswith("self.") and dn.count(".") == 1:
                return dn in self.attr_host and dn not in self.attr_device
            return self.host(node.value, q)
        if isinstance(node, ast.Subscript):
            return self.host(node.value, q)
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func) or ""
            if dn.startswith(("np.", "numpy.")) or terminal_name(node.func) == "to_host":
                return True
            if isinstance(node.func, ast.Attribute):
                return self.host(node.func.value, q)
        return False

    # ---------- binding ----------

    def _bind(self, target: ast.AST, value: ast.AST, q: str) -> bool:
        if isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(target.elts):
                return any([self._bind(t, v, q) for t, v in zip(target.elts, value.elts)])
            return any([self._bind(t, value, q) for t in target.elts])
        if isinstance(target, ast.Starred):
            return self._bind(target.value, value, q)
        is_device, is_host = self.device(value, q), self.host(value, q)
        if isinstance(target, ast.Name):
            names = self.local_device[q] if is_device else self.local_host[q] if is_host else None
            if names is not None and target.id not in names:
                names.add(target.id)
                return True
        elif isinstance(target, ast.Attribute):
            dn = dotted_name(target)
            if dn is not None and dn.startswith("self.") and dn.count(".") == 1:
                attrs = self.attr_device if is_device else self.attr_host if is_host else None
                if attrs is not None and dn not in attrs:
                    attrs.add(dn)
                    return True
        return False

    def _pass(self) -> bool:
        changed = False
        for q, fndef in self.funcs.items():
            # nested defs included: a closure such as generate's pick runs in its region
            for node in ast.walk(fndef):
                if isinstance(node, ast.Assign):
                    for target in node.targets:
                        changed |= self._bind(target, node.value, q)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    changed |= self._bind(node.target, node.value, q)
                elif isinstance(node, ast.Return) and node.value is not None:
                    name = q.rsplit(".", 1)[-1]
                    if name not in self.returns_device and self.device(node.value, q):
                        self.returns_device.add(name)
                        changed = True
        return changed


class HostTransferChecker(Checker):
    """Device->host copies inside a declared hot region or any same-module
    function it reaches."""

    name = "host-transfer"

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        roots = hotregions.hot_functions_for(module.path)
        if not roots:
            return ()
        funcs = self._module_functions(module.tree)
        reach = self._reachable(roots, funcs)
        values = _Values(funcs)
        findings: List[Finding] = []
        seen_lines: Set[int] = set()

        def flag(line: int, message: str) -> None:
            if line in seen_lines:
                return
            seen_lines.add(line)
            findings.append(Finding(self.name, module.path, line, message))

        for qualname in sorted(reach):
            origin = reach[qualname]
            where = (
                f"hot region {origin.name!r}"
                if qualname in roots
                else f"reached from hot region {origin.name!r}"
            )
            for node in ast.walk(funcs[qualname]):
                if isinstance(node, ast.Call):
                    self._judge_call(node, qualname, where, values, flag)
                elif isinstance(node, (ast.If, ast.While)):
                    if values.device(node.test, qualname):
                        flag(node.test.lineno,
                             f"branching on a tensor in {where} — implicit "
                             "bool() is a blocking copy; fold the predicate "
                             "into the device work (torch.where) or read it "
                             "in the batched drain")
        return findings

    @staticmethod
    def _judge_call(node: ast.Call, q: str, where: str, values: _Values, flag) -> None:
        dn = dotted_name(node.func) or ""
        tn = terminal_name(node.func) or ""
        method = isinstance(node.func, ast.Attribute)
        if method and tn in ("item", "tolist") and not values.host(node.func.value, q):
            flag(node.lineno,
                 f".{tn}() in {where} — a blocking device->host copy per "
                 "call; batch the copy after the region")
        elif method and tn in ("cpu", "numpy"):
            flag(node.lineno,
                 f".{tn}() in {where} — a blocking device->host copy; keep "
                 "the value on the device or batch the copy after the region")
        elif tn == "to_host":
            flag(node.lineno,
                 f"torchguard.to_host in {where} — a blocking host sync; "
                 "batch into ONE post-region drain (or pragma the "
                 "intentional one)")
        elif method and tn == "to" and (
            any(_is_cpu(a) for a in node.args[:1])
            or any(kw.arg == "device" and _is_cpu(kw.value) for kw in node.keywords)
        ):
            flag(node.lineno,
                 f'.to("cpu") in {where} — a blocking device->host copy; '
                 "keep the value on the device")
        elif dn in _NP_TRANSFER and any(values.device(a, q) for a in node.args[:1]):
            flag(node.lineno,
                 f"{dn} over a tensor in {where} — copies the device value "
                 "to the host; keep it on the device")
        elif tn in ("float", "int", "bool") and not method and any(
            values.device(a, q) for a in node.args
        ):
            flag(node.lineno,
                 f"{tn}() over a tensor in {where} — an implicit blocking "
                 "copy")

    @staticmethod
    def _module_functions(tree: ast.AST) -> Dict[str, ast.AST]:
        """Qualname (`Class.method` / bare fn) -> def node, one level of
        class nesting (all this codebase has)."""
        out: Dict[str, ast.AST] = {}
        for node in ast.iter_child_nodes(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[node.name] = node
            elif isinstance(node, ast.ClassDef):
                for sub in ast.iter_child_nodes(node):
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out[f"{node.name}.{sub.name}"] = sub
        return out

    @staticmethod
    def _reachable(
        roots: Dict[str, "hotregions.HotRegion"],
        funcs: Dict[str, ast.AST],
    ) -> Dict[str, "hotregions.HotRegion"]:
        """Roots plus same-module callees reachable from them (edges by
        terminal call name: `self._emit(...)` reaches `Cls._emit`)."""
        by_terminal: Dict[str, List[str]] = {}
        for qualname in funcs:
            by_terminal.setdefault(qualname.rsplit(".", 1)[-1], []).append(qualname)
        out: Dict[str, hotregions.HotRegion] = {}
        work = [
            (qualname, region)
            for qualname, region in roots.items()
            if qualname in funcs
        ]
        while work:
            qualname, region = work.pop()
            if qualname in out:
                continue
            out[qualname] = region
            for node in ast.walk(funcs[qualname]):
                if isinstance(node, ast.Call):
                    tn = terminal_name(node.func)
                    for callee in by_terminal.get(tn or "", []):
                        if callee not in out:
                            work.append((callee, region))
        return out


# ---------------------------------------------------------------------------
# psum-axis
# ---------------------------------------------------------------------------

# the mesh's methods that take axis names (parallel/mesh.py)
_MESH_AXIS_METHODS = {"group", "size", "index", "ranks", "live"}
_AXIS_KEYWORDS = {"axis_name", "axis_names", "seq_axis"}
_AXES_ASSIGN_NAMES = {"AXES", "GROUP_AXES", "MESH_AXES", "axis_names"}


def _axis_literals(node: ast.AST) -> List[Tuple[int, str]]:
    """(line, name) of every non-empty string constant in `node` (a name, a
    tuple of names, or a tuple of such tuples). The empty string means "no
    axis" (`seq_axis=""`)."""
    return [
        (sub.lineno, sub.value)
        for sub in ast.walk(node)
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) and sub.value
    ]


def _is_mesh(node: ast.AST) -> bool:
    """A receiver that names a mesh: `mesh`, `self.mesh`, `stage_mesh`."""
    name = terminal_name(node) or ""
    return name == "mesh" or name.endswith("_mesh")


class PsumAxisChecker(Checker):
    """Axis-name literals must be axes some scanned module declares (the
    mesh's AXES / GROUP_AXES tuples). Cross-module: uses are collected per
    module and judged once at finish() against the union of declared axes —
    `ring_attention`'s "sp" default is legal because `parallel/mesh.py`
    declares it."""

    name = "psum-axis"

    def __init__(self) -> None:
        self.declared: Set[str] = set()
        self.uses: List[Tuple[str, int, str]] = []  # (path, line, axis)

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                if node.value is not None and any(
                    isinstance(t, ast.Name) and t.id in _AXES_ASSIGN_NAMES for t in targets
                ):
                    self.declared.update(a for _, a in _axis_literals(node.value))
            elif isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in _MESH_AXIS_METHODS
                    and _is_mesh(func.value)
                ):
                    for arg in node.args[:1]:
                        self._use(module, arg)
                for kw in node.keywords:
                    if kw.arg in _AXIS_KEYWORDS:
                        self._use(module, kw.value)
            elif (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "sizes"
                and _is_mesh(node.value.value)
            ):
                self._use(module, node.slice)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                positional = args.posonlyargs + args.args
                pairs = list(zip(positional[len(positional) - len(args.defaults):], args.defaults))
                pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults) if d is not None]
                for param, default in pairs:
                    if param.arg in _AXIS_KEYWORDS:
                        self._use(module, default)
        return ()

    def _use(self, module: ModuleInfo, node: ast.AST) -> None:
        if isinstance(node, (ast.Constant, ast.Tuple, ast.List)):
            for line, axis in _axis_literals(node):
                self.uses.append((module.path, line, axis))

    def finish(self) -> Iterable[Finding]:
        if not self.declared:
            # nothing in the scanned tree declares mesh axes (fixture runs
            # over non-parallel modules): no basis to judge uses
            return ()
        findings = []
        for path, line, axis in self.uses:
            if axis not in self.declared:
                findings.append(Finding(
                    self.name, path, line,
                    f"collective axis {axis!r} is not a declared mesh axis "
                    f"(declared: {sorted(self.declared)}) — the collective "
                    "would fail (or silently no-op under a 1-sized rename) "
                    "at the call site's mesh",
                ))
        return findings
