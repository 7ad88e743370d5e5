"""deploylint: the deployment-surface conformance family of the port.

Four checkers proving the port's committed deploy tree and its code agree,
all reading the ONE contract in analysis/deploysurface.py (whose runtime
twin is utils/deployguard.py):

- rbac-coverage       every client verb×kind the manager issues is granted
                      by deploy/manifests.py cluster_role(), and no granted
                      rule is exercised by nothing (stale RBAC);
- crd-schema-drift    the CRDs deploy/crdgen.py derives from the api/
                      dataclasses match the committed deploy/tree/base/
                      manifests.yaml byte-for-structure;
- env-contract        every os.environ read package-wide resolves to a
                      declared knob in controllers/config.py ENV_CONTRACT
                      (a key is a literal, or a module-level string
                      constant of its module or imported by name from a
                      module of the package); dead knobs and manifest-knob
                      drift are findings;
- flow-schema-coverage  every flow name the code enters classifies onto a
                      non-default PriorityLevel, declared flows are
                      entered, and served webhook paths match the
                      generated registration.

Attribution (rbac-coverage): only deploysurface.is_manager_module() paths
count — the sim-cluster actors (kubelet/scheduler/statefulset) model other
identities. Kinds are resolved through local bindings (assignments, loop
targets, parameter annotations, intra-module helper returns); calls whose
kind stays dynamic are recorded per-verb and left to DEPLOYGUARD, which
sees the live (flow, verb, kind) stream.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .. import deploysurface as ds
from ..framework import Checker, Finding, ModuleInfo

_CLIENT_RECEIVERS = ("client", "api_reader")


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _receiver_name(func: ast.Attribute) -> str:
    node = func.value
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_client_receiver(name: str) -> bool:
    return name in _CLIENT_RECEIVERS or name.endswith("_client")


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _scope_split(body: Sequence[ast.stmt]) -> Tuple[List[ast.AST], List[ast.AST]]:
    """Walk a scope's statements, NOT descending into nested def/async def
    (those are their own scopes, returned separately). Lambdas stay in the
    enclosing scope — `retry_on_conflict(lambda: client.update(nb))` must
    resolve against the enclosing bindings."""
    nodes: List[ast.AST] = []
    nested: List[ast.AST] = []
    stack: List[ast.AST] = list(body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested.append(n)
            continue
        nodes.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return nodes, nested


class RbacCoverageChecker(Checker):
    """Manager client traffic ⊆ declared RBAC, and declared RBAC ⊆ traffic."""

    name = "rbac-coverage"

    def __init__(self) -> None:
        # (group, resource, verb) -> first (path, line) exercising it
        self._usage: Dict[Tuple[str, str, str], Tuple[str, int]] = {}
        # verbs issued at call sites whose kind stayed dynamic
        self._dynamic_verbs: Set[str] = set()
        # (group, resource) -> (path, line) of the generator rule literal
        self._rule_sites: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._manifests_scanned = False
        self._reported: Set[Tuple[str, str, str, str]] = set()
        # test hooks: a surface artifact (set of 4-tuples, DEPLOYGUARD's dump), a
        # synthetic RBAC table, and a gate override for fixture runs
        self.surface: Optional[Set[Tuple[str, str, str, str]]] = None
        self.rbac_override: Optional[Dict[Tuple[str, str], Any]] = None
        self.force_stale = False

    def _granted(self) -> Dict[Tuple[str, str], Any]:
        if self.rbac_override is not None:
            return self.rbac_override
        return ds.declared_rbac()

    # -- generator harvest (stale findings anchor at the rule literal) --

    def _harvest_rules(self, module: ModuleInfo) -> None:
        self._manifests_scanned = True
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Dict):
                continue
            keys = {_str_const(k) for k in node.keys}
            if not {"apiGroups", "resources", "verbs"} <= keys:
                continue
            try:
                rule = ast.literal_eval(node)
            except (ValueError, SyntaxError):
                continue
            for group in rule.get("apiGroups", []):
                for resource in rule.get("resources", []):
                    self._rule_sites.setdefault(
                        (group, resource), (module.path, node.lineno)
                    )

    # -- kind resolution --

    @staticmethod
    def _method_returns(tree: ast.AST) -> Dict[str, Set[str]]:
        """helper name -> kinds it returns via `return Cls(...)` — resolves
        the extension.py `self._create(self._rolebinding(...))` idiom."""
        out: Dict[str, Set[str]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Return) and isinstance(sub.value, ast.Call)):
                    continue
                f = sub.value.func
                if isinstance(f, ast.Name) and f.id in ds.KIND_RESOURCES:
                    out.setdefault(node.name, set()).add(f.id)
        return out

    def _wrapper_methods(self, tree: ast.AST) -> Dict[str, List[Tuple[str, int]]]:
        """helper name -> [(client method, param index)] for helpers that
        forward a parameter straight into a client call (`def _create(self,
        obj): ... self.client.create(obj)`) — the call SITE carries the kind."""
        out: Dict[str, List[Tuple[str, int]]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in node.args.args if a.arg != "self"]
            if not params:
                continue
            for sub in ast.walk(node):
                if not (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in ds.CLIENT_VERBS
                    and _is_client_receiver(_receiver_name(sub.func))
                    and sub.args
                    and isinstance(sub.args[0], ast.Name)
                    and sub.args[0].id in params
                ):
                    continue
                out.setdefault(node.name, []).append(
                    (sub.func.attr, params.index(sub.args[0].id))
                )
        return out

    def _expr_kinds(
        self,
        node: ast.AST,
        env: Dict[str, Set[str]],
        returns: Dict[str, Set[str]],
    ) -> Set[str]:
        if isinstance(node, ast.Name):
            if node.id in ds.KIND_RESOURCES:
                return {node.id}
            return set(env.get(node.id, ()))
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                if f.id in ds.KIND_RESOURCES:
                    return {f.id}
                if f.id in returns:
                    return set(returns[f.id])
            if isinstance(f, ast.Attribute):
                if f.attr == "deepcopy" and node.args:
                    return self._expr_kinds(node.args[0], env, returns)
                if (
                    f.attr in ("get", "list")
                    and _is_client_receiver(_receiver_name(f))
                    and node.args
                ):
                    return self._expr_kinds(node.args[0], env, returns)
                if f.attr in returns:
                    return set(returns[f.attr])
        return set()

    def _bindings(
        self,
        nodes: Iterable[ast.AST],
        env: Dict[str, Set[str]],
        returns: Dict[str, Set[str]],
    ) -> None:
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                t = n.targets[0]
                if isinstance(t, ast.Name):
                    kinds = self._expr_kinds(n.value, env, returns)
                    if kinds:
                        env.setdefault(t.id, set()).update(kinds)
            elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
                if (
                    isinstance(n.annotation, ast.Name)
                    and n.annotation.id in ds.KIND_RESOURCES
                ):
                    env.setdefault(n.target.id, set()).add(n.annotation.id)
            elif isinstance(n, ast.For):
                if isinstance(n.target, ast.Name):
                    kinds = self._expr_kinds(n.iter, env, returns)
                    if kinds:
                        env.setdefault(n.target.id, set()).update(kinds)
                elif isinstance(n.target, ast.Tuple) and isinstance(
                    n.iter, (ast.Tuple, ast.List)
                ):
                    # `for cls, ns, name in ((Service, ...), (ConfigMap, ...))`
                    for j, elt in enumerate(n.target.elts):
                        if not isinstance(elt, ast.Name):
                            continue
                        for row in n.iter.elts:
                            if isinstance(row, (ast.Tuple, ast.List)) and j < len(
                                row.elts
                            ):
                                cell = row.elts[j]
                                if (
                                    isinstance(cell, ast.Name)
                                    and cell.id in ds.KIND_RESOURCES
                                ):
                                    env.setdefault(elt.id, set()).add(cell.id)

    # -- per-module pass --

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        path = _norm(module.path)
        if path.endswith("deploy/manifests.py"):
            self._harvest_rules(module)
        if not ds.is_manager_module(path):
            return []
        findings: List[Finding] = []
        returns = self._method_returns(module.tree)
        wrappers = self._wrapper_methods(module.tree)
        self._scope(
            module.tree.body, {}, module, returns, wrappers, set(), findings
        )
        return findings

    def _scope(
        self,
        body: Sequence[ast.stmt],
        env: Dict[str, Set[str]],
        module: ModuleInfo,
        returns: Dict[str, Set[str]],
        wrappers: Dict[str, List[Tuple[str, int]]],
        wrapper_params: Set[str],
        findings: List[Finding],
    ) -> None:
        nodes, nested = _scope_split(body)
        self._bindings(nodes, env, returns)
        for n in nodes:
            if isinstance(n, ast.Call):
                self._handle_call(
                    n, env, module, returns, wrappers, wrapper_params, findings
                )
        for fn in nested:
            assert isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            fenv = dict(env)
            params = {a.arg for a in fn.args.args if a.arg != "self"}
            for a in fn.args.args:
                if (
                    a.annotation is not None
                    and isinstance(a.annotation, ast.Name)
                    and a.annotation.id in ds.KIND_RESOURCES
                ):
                    fenv.setdefault(a.arg, set()).add(a.annotation.id)
            fw = params if fn.name in wrappers else set()
            self._scope(fn.body, fenv, module, returns, wrappers, fw, findings)

    def _handle_call(
        self,
        call: ast.Call,
        env: Dict[str, Set[str]],
        module: ModuleInfo,
        returns: Dict[str, Set[str]],
        wrappers: Dict[str, List[Tuple[str, int]]],
        wrapper_params: Set[str],
        findings: List[Finding],
    ) -> None:
        f = call.func
        if not isinstance(f, ast.Attribute):
            if (  # module-level wrapper called by bare name
                isinstance(f, ast.Name) and f.id in wrappers
            ):
                for method, pidx in wrappers[f.id]:
                    arg = call.args[pidx] if pidx < len(call.args) else None
                    kinds = (
                        self._expr_kinds(arg, env, returns) if arg is not None else set()
                    )
                    self._record(method, kinds, module, call.lineno, findings)
            return
        # informer registration: .for_/.owns/.watches(Cls) = get+list+watch
        if f.attr in ds.WATCH_METHODS and call.args:
            kinds = self._expr_kinds(call.args[0], env, returns)
            for verb in ds.WATCH_VERBS:
                self._record(verb, kinds, module, call.lineno, findings)
            return
        if f.attr in wrappers and not _is_client_receiver(_receiver_name(f)):
            for method, pidx in wrappers[f.attr]:
                arg = call.args[pidx] if pidx < len(call.args) else None
                kinds = (
                    self._expr_kinds(arg, env, returns) if arg is not None else set()
                )
                self._record(method, kinds, module, call.lineno, findings)
            return
        if f.attr not in ds.CLIENT_VERBS:
            return
        if not _is_client_receiver(_receiver_name(f)):
            return
        if not call.args:
            return
        arg = call.args[0]
        if isinstance(arg, ast.Name) and arg.id in wrapper_params:
            # this IS a wrapper body's forwarding call; its sites carry the kind
            return
        kinds = self._expr_kinds(arg, env, returns)
        self._record(f.attr, kinds, module, call.lineno, findings)

    def _record(
        self,
        method: str,
        kinds: Set[str],
        module: ModuleInfo,
        line: int,
        findings: List[Finding],
    ) -> None:
        verb_sub = ds.CLIENT_VERBS.get(method)
        verb = verb_sub[0] if verb_sub else method
        if not kinds:
            self._dynamic_verbs.add(verb)
            return
        granted = self._granted()
        for kind in sorted(kinds):
            req = ds.required_rbac(method if verb_sub else "get", kind)
            if verb_sub is None:
                req = (ds.KIND_RESOURCES[kind][0], ds.KIND_RESOURCES[kind][1], verb)
            if req is None:
                continue
            group, resource, v = req
            self._usage.setdefault((group, resource, v), (module.path, line))
            if v in granted.get((group, resource), ()):
                continue
            key = (module.path, group, resource, v)
            if key in self._reported:
                continue
            self._reported.add(key)
            findings.append(
                Finding(
                    self.name,
                    module.path,
                    line,
                    f"issues {method} {kind} but verb {v!r} on "
                    f"{group or 'core'}/{resource} is not granted to the "
                    "manager ServiceAccount (deploy/manifests.py "
                    "cluster_role()) — grant it or move the call off the "
                    "manager's identity",
                )
            )

    # -- stale direction --

    def finish(self) -> Iterable[Finding]:
        if not (self._manifests_scanned or self.force_stale):
            return []
        findings: List[Finding] = []
        surface_resources = (
            ds.exercised_resources_from_surface(self.surface)
            if self.surface is not None
            else None
        )
        for (group, resource), verbs in sorted(self._granted().items()):
            if (group, resource) in ds.RBAC_EXEMPTIONS:
                continue
            if any((group, resource, v) in self._usage for v in verbs):
                continue
            if surface_resources is not None and (group, resource) in surface_resources:
                continue
            dyn = set(verbs) & self._dynamic_verbs
            if dyn and surface_resources is None:
                # a dynamic-kind call could exercise it; only a runtime
                # surface artifact (DEPLOYGUARD's dump) can settle that
                continue
            path, line = self._rule_sites.get(
                (group, resource), ("odh_kubeflow_tpu_torch/deploy/manifests.py", 1)
            )
            confidence = (
                " (runtime surface artifact confirms: never exercised)"
                if surface_resources is not None
                else ""
            )
            findings.append(
                Finding(
                    self.name,
                    path,
                    line,
                    f"stale RBAC: rule grants {sorted(verbs)} on "
                    f"{group or 'core'}/{resource} but no manager code "
                    f"exercises it{confidence} — drop the rule or add a "
                    "reviewed exemption in analysis/deploysurface.py",
                )
            )
        return findings


class CrdSchemaDriftChecker(Checker):
    """deploy/crdgen.py output == committed deploy/base/manifests.yaml CRDs."""

    name = "crd-schema-drift"
    MAX_PATHS_PER_CRD = 12

    def __init__(self) -> None:
        self._crdgen_path: Optional[str] = None
        # test hook: point at a doctored committed tree
        self.manifests_path: Optional[str] = None

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        if _norm(module.path).endswith("deploy/crdgen.py"):
            self._crdgen_path = module.path
        return []

    @classmethod
    def _diff(cls, want: Any, got: Any, prefix: str, out: List[str]) -> None:
        if len(out) >= cls.MAX_PATHS_PER_CRD:
            return
        if isinstance(want, dict) and isinstance(got, dict):
            for key in sorted(set(want) | set(got)):
                p = f"{prefix}.{key}" if prefix else str(key)
                if key not in got:
                    out.append(f"{p}: missing from committed manifest")
                elif key not in want:
                    out.append(f"{p}: only in committed manifest")
                else:
                    cls._diff(want[key], got[key], p, out)
                if len(out) >= cls.MAX_PATHS_PER_CRD:
                    return
        elif isinstance(want, list) and isinstance(got, list):
            if len(want) != len(got):
                out.append(f"{prefix}: {len(want)} generated vs {len(got)} committed entries")
                return
            for i, (w, g) in enumerate(zip(want, got)):
                cls._diff(w, g, f"{prefix}[{i}]", out)
                if len(out) >= cls.MAX_PATHS_PER_CRD:
                    return
        elif want != got:
            out.append(f"{prefix}: generated {want!r} vs committed {got!r}")

    def finish(self) -> Iterable[Finding]:
        if self._crdgen_path is None:
            return []
        try:
            import yaml

            load_all = yaml.safe_load_all
        except ImportError:
            # no PyYAML, which the port does not need: the committed tree is
            # in the form `render_yaml` writes, which the port reads back
            from ...deploy.overlay import load_yaml as load_all

        from ...deploy.__main__ import TREE
        from ...deploy.crdgen import (
            inference_endpoint_crd,
            notebook_crd,
            tpu_job_crd,
        )

        # the port's committed tree lives inside its package (deploy/tree/),
        # where `python -m odh_kubeflow_tpu_torch.deploy generate` writes it
        manifests = Path(
            self.manifests_path or Path(TREE) / "base" / "manifests.yaml"
        )
        findings: List[Finding] = []
        anchor = self._crdgen_path
        if not manifests.exists():
            return [
                Finding(
                    self.name,
                    anchor,
                    1,
                    f"committed manifest tree missing: {manifests} — run "
                    "python -m odh_kubeflow_tpu_torch.deploy generate",
                )
            ]
        committed = {
            doc["metadata"]["name"]: doc
            for doc in load_all(manifests.read_text())
            if isinstance(doc, dict)
            and doc.get("kind") == "CustomResourceDefinition"
        }
        generated = {
            crd["metadata"]["name"]: crd
            for crd in (notebook_crd(), inference_endpoint_crd(), tpu_job_crd())
        }
        for name in sorted(set(generated) | set(committed)):
            if name not in committed:
                findings.append(
                    Finding(
                        self.name,
                        anchor,
                        1,
                        f"CRD {name} is generated by crdgen but absent from "
                        f"{manifests} — regenerate the deploy tree",
                    )
                )
                continue
            if name not in generated:
                findings.append(
                    Finding(
                        self.name,
                        anchor,
                        1,
                        f"CRD {name} is committed in {manifests} but no "
                        "crdgen function produces it",
                    )
                )
                continue
            diffs: List[str] = []
            self._diff(generated[name], committed[name], "", diffs)
            for d in diffs:
                findings.append(
                    Finding(
                        self.name,
                        anchor,
                        1,
                        f"CRD {name} drifted from the api/ dataclasses: {d} "
                        "— regenerate with python -m "
                        "odh_kubeflow_tpu_torch.deploy generate",
                    )
                )
        return findings


class EnvContractChecker(Checker):
    """Every os.environ read resolves to a declared ENV_CONTRACT knob."""

    name = "env-contract"

    def __init__(self) -> None:
        self._reads: Dict[str, Tuple[str, int]] = {}  # name -> first site
        self._config_path: Optional[str] = None
        self._knob_lines: Dict[str, int] = {}
        self._constants_of: Dict[str, Dict[str, str]] = {}  # file -> constants
        # test hooks
        self.declared_override: Optional[Dict[str, Any]] = None
        self.manifest_names_override: Optional[Set[str]] = None
        self.force_finish = False

    def _declared(self) -> Dict[str, Any]:
        if self.declared_override is not None:
            return self.declared_override
        return ds.declared_env()

    def _manifest_names(self) -> Set[str]:
        if self.manifest_names_override is not None:
            return set(self.manifest_names_override)
        return set(ds.manifest_env_names())

    # -- env-read extraction --

    @staticmethod
    def _is_os_environ(node: ast.AST) -> bool:
        return (
            isinstance(node, ast.Attribute)
            and node.attr == "environ"
            and isinstance(node.value, ast.Name)
            and node.value.id == "os"
        )

    @classmethod
    def _aliases_environ(cls, node: ast.AST) -> bool:
        """Is this assignment VALUE the environ mapping itself (`os.environ`,
        `environ if ... else os.environ`, `environ or os.environ`)? A call
        RESULT like `os.environ.get(...)` is a plain string, not an alias."""
        if cls._is_os_environ(node):
            return True
        if isinstance(node, ast.IfExp):
            return cls._aliases_environ(node.body) or cls._aliases_environ(node.orelse)
        if isinstance(node, ast.BoolOp):
            return any(cls._aliases_environ(v) for v in node.values)
        return False

    @staticmethod
    def _string_constants(tree: ast.AST) -> Dict[str, str]:
        """A module's module-level `NAME = "literal"` bindings."""
        out: Dict[str, str] = {}
        for stmt in getattr(tree, "body", []):
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            literal = _str_const(value)
            for t in targets:
                if literal is not None and isinstance(t, ast.Name):
                    out[t.id] = literal
        return out

    def _constants(self, module: ModuleInfo) -> Dict[str, str]:
        """The string constants an env key may name in `module`: its own
        module-level ones, and those it imports by name from a module of its
        package (`from ..probe.behavior import CONTROL_DIR_ENV`), read from
        that module's file, so a reader and a writer share one constant."""
        consts = self._string_constants(module.tree)
        here = Path(module.path).parent
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.ImportFrom) and node.level):
                continue
            base = here
            for _ in range(node.level - 1):
                base = base.parent
            target = base.joinpath(*node.module.split(".")) if node.module else base
            source = target.with_suffix(".py")
            if not source.is_file():
                source = target / "__init__.py"
            key = str(source)
            if key not in self._constants_of:
                self._constants_of[key] = (
                    self._string_constants(ast.parse(source.read_text()))
                    if source.is_file()
                    else {}
                )
            theirs = self._constants_of[key]
            for alias in node.names:
                if alias.name in theirs:
                    consts[alias.asname or alias.name] = theirs[alias.name]
        return consts

    def _module_reads(self, module: ModuleInfo) -> List[Tuple[str, int]]:
        tree = module.tree
        consts = self._constants(module)
        aliases: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) and self._aliases_environ(node.value):
                    aliases.add(t.id)

        def env_receiver(node: ast.AST) -> bool:
            return self._is_os_environ(node) or (
                isinstance(node, ast.Name) and node.id in aliases
            )

        reads: List[Tuple[str, int]] = []
        # wrapper name -> param names whose value is the env key
        wrappers: Dict[str, Set[str]] = {}

        def key_exprs(node: ast.AST) -> Iterable[Tuple[ast.AST, int]]:
            """(key expression, line) of every env read under `node`."""
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    f = sub.func
                    if (
                        isinstance(f, ast.Attribute)
                        and f.attr in ("get", "setdefault")
                        and env_receiver(f.value)
                        and sub.args
                    ):
                        yield sub.args[0], sub.lineno
                    elif (
                        isinstance(f, ast.Attribute)
                        and f.attr == "getenv"
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "os"
                        and sub.args
                    ):
                        yield sub.args[0], sub.lineno
                elif isinstance(sub, ast.Subscript) and env_receiver(sub.value):
                    key = sub.slice
                    if isinstance(key, ast.Index):  # pragma: no cover (py<3.9)
                        key = key.value  # type: ignore[attr-defined]
                    yield key, sub.lineno
                elif (
                    isinstance(sub, ast.Compare)
                    and len(sub.ops) == 1
                    and isinstance(sub.ops[0], (ast.In, ast.NotIn))
                    and len(sub.comparators) == 1
                    and env_receiver(sub.comparators[0])
                ):
                    yield sub.left, sub.lineno

        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = {a.arg for a in node.args.args}
            for key, _line in key_exprs(node):
                if isinstance(key, ast.Name) and key.id in params:
                    wrappers.setdefault(node.name, set()).add(key.id)

        params = set().union(*wrappers.values()) if wrappers else set()

        def key_name(key: ast.AST) -> Optional[str]:
            name = _str_const(key)
            if name is None and isinstance(key, ast.Name) and key.id not in params:
                name = consts.get(key.id)
            return name

        for key, line in key_exprs(tree):
            name = key_name(key)
            if name is not None:
                reads.append((name, line))
            # other non-literal keys that aren't wrapper params are a
            # documented blind spot; DEPLOYGUARD has no env analog, so keep
            # them rare

        # literal call sites of env-key wrappers (_env_bool("DEV", ...))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)):
                continue
            wrapper = wrappers.get(node.func.id)
            if not wrapper or not node.args:
                continue
            name = key_name(node.args[0])
            if name is not None:
                reads.append((name, node.lineno))
        return reads

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        path = _norm(module.path)
        if path.endswith("controllers/config.py"):
            self._config_path = module.path
            for node in ast.walk(module.tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "EnvKnob"
                ):
                    name = None
                    if node.args:
                        name = _str_const(node.args[0])
                    for kw in node.keywords:
                        if kw.arg == "name":
                            name = _str_const(kw.value)
                    if name:
                        self._knob_lines[name] = node.lineno
        findings: List[Finding] = []
        declared = self._declared()
        seen_here: Set[str] = set()
        for name, line in self._module_reads(module):
            self._reads.setdefault(name, (module.path, line))
            if name in declared or name in seen_here:
                continue
            seen_here.add(name)
            findings.append(
                Finding(
                    self.name,
                    module.path,
                    line,
                    f"os.environ read of {name!r} is not declared in "
                    "ENV_CONTRACT (controllers/config.py) — declare the knob "
                    "(name, default, consumer, doc) or drop the read",
                )
            )
        return findings

    def finish(self) -> Iterable[Finding]:
        if self._config_path is None and not self.force_finish:
            return []
        findings: List[Finding] = []
        anchor = self._config_path or "odh_kubeflow_tpu_torch/controllers/config.py"
        declared = self._declared()
        manifest_names = self._manifest_names()
        for name, knob in sorted(declared.items()):
            line = self._knob_lines.get(name, 1)
            if name not in self._reads:
                findings.append(
                    Finding(
                        self.name,
                        anchor,
                        line,
                        f"dead knob: ENV_CONTRACT declares {name!r} but "
                        "nothing in the package reads it — drop the entry or "
                        "wire the consumer",
                    )
                )
            if getattr(knob, "manifest", False) and name not in manifest_names:
                findings.append(
                    Finding(
                        self.name,
                        anchor,
                        line,
                        f"knob {name!r} is declared manifest=True but the "
                        "generated Deployment env stanza / culler ConfigMap "
                        "(deploy/manifests.py) does not carry it",
                    )
                )
        for name in sorted(manifest_names - set(declared)):
            findings.append(
                Finding(
                    self.name,
                    anchor,
                    1,
                    f"generated manifests ship env {name!r} but ENV_CONTRACT "
                    "does not declare it — the deployed knob would be dead "
                    "on arrival",
                )
            )
        return findings


class FlowSchemaCoverageChecker(Checker):
    """Entered flows classify non-default; declared flows are entered;
    served webhook paths match the generated registration."""

    name = "flow-schema-coverage"

    def __init__(self) -> None:
        self._entered: Dict[str, Tuple[str, int]] = {}
        self._declared_flow_lines: Dict[str, int] = {}
        self._flowcontrol_path: Optional[str] = None
        self._main_scanned = False
        self._served_paths: Dict[str, Tuple[str, int]] = {}
        self._fc = None
        # test hooks
        self.webhook_paths_override: Optional[Set[str]] = None

    def _controller(self):
        if self._fc is None:
            from ...cluster.flowcontrol import FlowController

            self._fc = FlowController()
        return self._fc

    def _declared_webhook_paths(self) -> Set[str]:
        if self.webhook_paths_override is not None:
            return set(self.webhook_paths_override)
        return set(ds.declared_webhook_paths())

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        path = _norm(module.path)
        findings: List[Finding] = []
        if path.endswith("cluster/flowcontrol.py"):
            self._flowcontrol_path = module.path
            for node in ast.walk(module.tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "FlowSchema"
                ):
                    continue
                exprs: List[ast.AST] = []
                for kw in node.keywords:
                    if kw.arg == "flows":
                        exprs.append(kw.value)
                for e in exprs:
                    if isinstance(e, (ast.Tuple, ast.List)):
                        for elt in e.elts:
                            name = _str_const(elt)
                            if name:
                                self._declared_flow_lines.setdefault(
                                    name, elt.lineno
                                )
            return findings
        if path.endswith("odh_kubeflow_tpu_torch/main.py"):
            self._main_scanned = True
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and node.targets[0].attr == "flow"
                ):
                    # `elector_client.flow = LEADER_ELECTION_FLOW` — a
                    # per-client flow override is an entry point too
                    name = _str_const(node.value)
                    if name is None and isinstance(node.value, ast.Name):
                        if node.value.id == "LEADER_ELECTION_FLOW":
                            name = "leader-election"
                    if name:
                        self._entered.setdefault(name, (module.path, node.lineno))
                continue
            f = node.func
            flow_name: Optional[str] = None
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "builder"
                and node.args
            ):
                flow_name = _str_const(node.args[0])
            elif (
                (isinstance(f, ast.Name) and f.id == "flow_context")
                or (isinstance(f, ast.Attribute) and f.attr == "flow_context")
            ) and node.args:
                flow_name = _str_const(node.args[0])
            if flow_name:
                self._entered.setdefault(flow_name, (module.path, node.lineno))
                level = self._controller().classify(flow_name)
                if level.name == "default":
                    findings.append(
                        Finding(
                            self.name,
                            module.path,
                            node.lineno,
                            f"flow {flow_name!r} enters flow_context but "
                            "classifies onto the default PriorityLevel — add "
                            "it to a FlowSchema in cluster/flowcontrol.py so "
                            "overload sheds it deliberately",
                        )
                    )
                continue
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "register"
                and node.args
            ):
                served = _str_const(node.args[0])
                if served and served.startswith(("/mutate", "/validate")):
                    self._served_paths.setdefault(served, (module.path, node.lineno))
                    if served not in self._declared_webhook_paths():
                        findings.append(
                            Finding(
                                self.name,
                                module.path,
                                node.lineno,
                                f"webhook path {served!r} is served but absent "
                                "from the generated "
                                "MutatingWebhookConfiguration "
                                "(deploy/manifests.py) — the API server would "
                                "never call it",
                            )
                        )
        return findings

    def finish(self) -> Iterable[Finding]:
        findings: List[Finding] = []
        if self._flowcontrol_path is not None:
            for name, line in sorted(self._declared_flow_lines.items()):
                if name not in self._entered:
                    findings.append(
                        Finding(
                            self.name,
                            self._flowcontrol_path,
                            line,
                            f"FlowSchema names flow {name!r} but nothing "
                            "enters it (no builder/flow_context/client.flow "
                            "site) — stale schema or a controller missing "
                            "its flow identity",
                        )
                    )
        if self._main_scanned:
            for path in sorted(self._declared_webhook_paths() - set(self._served_paths)):
                findings.append(
                    Finding(
                        self.name,
                        "odh_kubeflow_tpu_torch/main.py",
                        1,
                        f"generated MutatingWebhookConfiguration points at "
                        f"{path!r} but no server.register() serves it — CR "
                        "writes would fail closed (failurePolicy: Fail)",
                    )
                )
        return findings


def make_deploylint_checkers() -> List[Checker]:
    return [
        RbacCoverageChecker(),
        CrdSchemaDriftChecker(),
        EnvContractChecker(),
        FlowSchemaCoverageChecker(),
    ]
