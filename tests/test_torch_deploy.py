"""The port's deploy layer (odh_kubeflow_tpu_torch/deploy/) and its env
contract (controllers/config.py ENV_CONTRACT) against the JAX package's, on
the CPU.

- The cases of tests/test_deploy.py, each run on both packages in one test
  (tests/torch_ported.py); on the port's side the committed tree is the
  package's own (`odh_kubeflow_tpu_torch/deploy/tree/`). Left out:
  `test_build_manifests_check_mode_catches_unregenerated_edit`, which runs
  ci/build_manifests.sh, the JAX tree's own drift script; the port's tree
  is held to its generator by the drift case here and by crd-schema-drift.
- The port's four overlay builds equal the JAX builds dict for dict, apart
  from `DIFFERENCES`, where each entry names the port's code that causes it.
- The port's YAML emitter (no PyYAML): its output read back by
  `yaml.safe_load_all` equals the built dicts, for every overlay and for
  strings YAML would read as another type; a process with `yaml` unimportable
  imports the port's deploy package, builds, renders and regenerates the
  committed tree byte for byte.
- `Config.from_env()` equals the JAX one field for field under one seeded
  environment; unset, only the prewarmer's shape differs (h100 1x4 against
  v5e 2x2). tests/test_coalesce.py's env knob case runs on both packages.
- Every env read in the port resolves to a knob of its ENV_CONTRACT, whose
  consumers are the port's files; rbac-coverage counts the port's
  controllers, runtime and main.py as the manager's modules; each deploylint
  checker flags a seeded bad copy of a port file in a temporary tree.
"""
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

import torch_ported

import odh_kubeflow_tpu.controllers.config as j_config
import odh_kubeflow_tpu.deploy as j_deploy
import odh_kubeflow_tpu_torch
import odh_kubeflow_tpu_torch.controllers.config as p_config
import odh_kubeflow_tpu_torch.deploy as p_deploy
from odh_kubeflow_tpu_torch.analysis import deploysurface as ds
from odh_kubeflow_tpu_torch.analysis import run_analysis
from odh_kubeflow_tpu_torch.analysis.checkers import (
    CrdSchemaDriftChecker,
    EnvContractChecker,
    FlowSchemaCoverageChecker,
    RbacCoverageChecker,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = pathlib.Path(odh_kubeflow_tpu_torch.__file__).resolve().parent
TREE = PKG / "deploy" / "tree"

LEFT_OUT = ("test_build_manifests_check_mode_catches_unregenerated_edit",)
RENAMES = (('committed = os.path.join(REPO, "deploy")',
            'committed = os.path.join(REPO, "odh_kubeflow_tpu_torch", "deploy", "tree")'),)
JAX = torch_ported.load("test_deploy", "jax")
PORT = torch_ported.load("test_deploy", "port", renames=RENAMES)

# (overlay, kind, name, path) of every place the port's build differs from
# the JAX one, each with the port's code that causes it. The port's api/
# dataclasses keep the reference's wire names, its ClusterRole is the
# reference's (rbac-coverage holds it to the port's code), and the GKE node
# selector's label (gpu.GKE_NODEPOOL_LABEL) is GKE's own: only the manager's
# image differs.
PORT_IMAGE = "ghcr.io/odh-kubeflow-tpu/controller-torch:latest"
DIFFERENCES = {
    (overlay, "Deployment", "tpu-notebook-controller-manager", ".spec.template.spec.containers[0].image"):
        "deploy/overlay.py DEFAULT_PARAMS: the port's manager image (Dockerfile.torch)"
    for overlay in ("base", "dev", "gke", "standalone")
}


@pytest.mark.parametrize("case", torch_ported.cases(JAX, skip=LEFT_OUT))
def test_deploy_case_against_the_reference(case, tmp_path):
    torch_ported.both(JAX, PORT, case, tmp_path, transcript=False)


def _diff(port, jax, path, out):
    if isinstance(port, dict) and isinstance(jax, dict):
        for k in sorted(set(port) | set(jax)):
            _diff(port.get(k), jax.get(k), f"{path}.{k}", out)
    elif isinstance(port, list) and isinstance(jax, list) and len(port) == len(jax):
        for i, (a, b) in enumerate(zip(port, jax)):
            _diff(a, b, f"{path}[{i}]", out)
    elif port != jax:
        out.append(path)


@pytest.mark.parametrize("overlay", sorted(j_deploy.OVERLAYS))
def test_overlay_equals_the_jax_build(overlay):
    assert sorted(p_deploy.OVERLAYS) == sorted(j_deploy.OVERLAYS)
    port, jax = p_deploy.build(overlay), j_deploy.build(overlay)
    assert [(m["kind"], m["metadata"]["name"]) for m in port] == [(m["kind"], m["metadata"]["name"]) for m in jax]
    found = {}
    for p, j in zip(port, jax):
        paths = []
        _diff(p, j, "", paths)
        for path in paths:
            found[(overlay, p["kind"], p["metadata"]["name"], path)] = None
    listed = {k: v for k, v in DIFFERENCES.items() if k[0] == overlay}
    assert set(found) == set(listed), sorted(set(found) ^ set(listed))


@pytest.mark.parametrize("overlay", sorted(p_deploy.OVERLAYS))
def test_emitter_reads_back_as_the_build(overlay):
    built = p_deploy.build(overlay)
    text = p_deploy.render_yaml(built)
    assert text.startswith("---\n") and text.count("\n---\n") == len(built) - 1
    assert list(yaml.safe_load_all(text)) == built


def test_emitter_quotes_what_yaml_reads_as_another_type():
    tricky = ["", "true", "False", "yes", "no", "on", "OFF", "y", "n", "null", "~", "1", "0x1f", "1_000", "0.5",
              ".5", "1e3", ".inf", "-.inf", ".nan", "1:20", "2001-12-14", "a: b", "a #b", "#x", "-x", "- x", "*x",
              "&x", "!x", "%x", "@x", "`x", "'x", '"x"', "[x]", "{x}", "x:", " x", "x ", "a\nb", "tab\tx", "é",
              "ghcr.io/odh-kubeflow-tpu/controller:latest", "500m", "4Gi", "/healthz", "x-kubernetes-foo"]
    doc = {"strings": tricky, "keys": {s: i for i, s in enumerate(tricky) if s},
           "numbers": [0, -3, 10**12, 0.05, 1e-06, 3.0, -2.5e20, float("inf"), float("-inf")],
           "flags": [True, False, None], "empty": {"d": {}, "l": []},
           "nested": [[1, [2, {}]], {"a": [{"b": []}], "c": {"d": [[]]}}, []]}
    (back,) = yaml.safe_load_all(p_deploy.render_yaml([doc]))
    assert back == doc


def test_the_deploy_package_builds_and_renders_without_yaml(tmp_path):
    """A process in which `import yaml` fails imports the port's deploy
    package, builds every overlay, renders it, and regenerates the committed
    tree byte for byte (the card's machine has no PyYAML)."""
    script = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import odh_kubeflow_tpu_torch.deploy as d\n"
        "from odh_kubeflow_tpu_torch.deploy.__main__ import generate_tree\n"
        "print(sorted((n, len(d.render_yaml(d.build(n)))) for n in d.OVERLAYS))\n"
        f"generate_tree({str(tmp_path)!r}, {str(TREE / 'params.env')!r})\n"
        "try:\n"
        "    import yaml\n"
        "except ImportError:\n"
        "    print('no yaml')\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("no yaml"), out.stdout
    for rel in ["base/manifests.yaml"] + [f"overlays/{n}/manifests.yaml" for n in p_deploy.OVERLAYS if n != "base"]:
        assert (tmp_path / rel).read_bytes() == (TREE / rel).read_bytes(), rel


def test_committed_params_env_is_the_generators(tmp_path):
    from odh_kubeflow_tpu_torch.deploy.__main__ import generate_tree

    generate_tree(str(tmp_path))
    assert (tmp_path / "params.env").read_text() == (TREE / "params.env").read_text()
    port = p_deploy.load_params((TREE / "params.env").read_text())
    jax = j_deploy.load_params((REPO / "deploy" / "params.env").read_text())
    image = "odh-notebook-controller-image"
    assert port[image] == PORT_IMAGE != jax[image]
    assert {k: v for k, v in port.items() if k != image} == {k: v for k, v in jax.items() if k != image}


def test_the_port_image_runs_the_ports_manager():
    """The image the port's manifests pin is built from the port's package
    and starts the port's manager, not the reference's."""
    dockerfile = (REPO / "Dockerfile.torch").read_text()
    assert f"-t {PORT_IMAGE} ." in dockerfile
    assert "COPY odh_kubeflow_tpu_torch ./odh_kubeflow_tpu_torch" in dockerfile
    assert 'ENTRYPOINT ["python", "-m", "odh_kubeflow_tpu_torch.main"]' in dockerfile
    assert "COPY odh_kubeflow_tpu " not in dockerfile and "odh_kubeflow_tpu.main" not in dockerfile
    for name in p_deploy.OVERLAYS:
        (deployment,) = [m for m in p_deploy.build(name) if m["kind"] == "Deployment"]
        assert deployment["spec"]["template"]["spec"]["containers"][0]["image"] == PORT_IMAGE, name
    main = (PKG / "main.py").read_text()
    assert 'if __name__ == "__main__":\n    main()' in main


# ---------------------------------------------------------------------------
# the env contract
# ---------------------------------------------------------------------------


def _config_knobs(module):
    return {k.name: k for k in module.ENV_CONTRACT if k.consumer == "controllers/config.py"}


def _seeded_env(seed=23):
    """A value for every knob Config.from_env reads, of its default's type."""
    rng = np.random.default_rng(seed)
    env = {}
    for name, knob in sorted(_config_knobs(j_config).items()):
        d = knob.default
        if d in ("true", "false"):
            env[name] = str(bool(rng.integers(2))).lower()
        elif d.isdigit():
            env[name] = str(int(rng.integers(1, 500)))
        elif d.replace(".", "", 1).isdigit():
            env[name] = f"{rng.uniform(0.01, 50):.4f}"
        else:
            env[name] = "v" + "".join(rng.choice(list("abcdefgh"), 6))
    return env


# the reference's Config fields (and their env knobs) that nothing in the
# port reads: the token router's, which only the reference's load tiers
# read; they come back with a main.py that builds a router
NOT_PORTED = {"router_eject_failures": "ROUTER_EJECT_FAILURES", "router_hedge_after_s": "ROUTER_HEDGE_AFTER_S"}


def _ported(config):
    return {k: v for k, v in dataclasses.asdict(config).items() if k not in NOT_PORTED}


def test_config_from_env_equals_the_references(monkeypatch):
    assert _config_knobs(p_config).keys() == _config_knobs(j_config).keys() - set(NOT_PORTED.values())
    port_fields = {f.name for f in dataclasses.fields(p_config.Config)}
    assert port_fields == {f.name for f in dataclasses.fields(j_config.Config)} - set(NOT_PORTED)
    for name in _config_knobs(j_config):
        monkeypatch.delenv(name, raising=False)
    unset_port, unset_jax = _ported(p_config.Config.from_env()), _ported(j_config.Config.from_env())
    differs = {k for k in unset_jax if unset_port[k] != unset_jax[k]}
    assert differs == {"pool_prewarm_accelerator", "pool_prewarm_topology"}
    assert (unset_port["pool_prewarm_accelerator"], unset_port["pool_prewarm_topology"]) == ("h100", "1x4")
    for name, value in _seeded_env().items():
        monkeypatch.setenv(name, value)
    assert _ported(p_config.Config.from_env()) == _ported(j_config.Config.from_env())
    # the knobs' defaults are the Config's, on both sides
    for name, knob in _config_knobs(p_config).items():
        if name.startswith("POOL_PREWARM_"):
            continue
        assert knob.default == _config_knobs(j_config)[name].default, name


COALESCE = (torch_ported.load("test_coalesce", "jax"), torch_ported.load("test_coalesce", "port"))


def test_the_coalescers_env_knob_against_the_reference(tmp_path):
    """tests/test_coalesce.py's env case (STATUS_COALESCE_WINDOW_S read
    and clamped by Config.from_env), on both packages."""
    torch_ported.both(*COALESCE, "test_status_coalesce_window_env_knob", tmp_path, transcript=False)


def test_every_env_read_of_the_port_is_a_declared_knob():
    checker = EnvContractChecker()
    findings = run_analysis([str(PKG)], checkers=[checker])
    assert findings == [], "\n".join(map(str, findings))
    declared = ds.declared_env()
    assert set(checker._reads) == set(declared)
    for name, knob in declared.items():
        assert (PKG / knob.consumer).is_file(), (name, knob.consumer)
    # the reference's knobs the port reads nowhere are not declared
    assert "JAXGUARD" not in declared
    assert {"RANK", "WORLD_SIZE", "LOCAL_RANK", "PET_NODE_RANK", "POD_IP", "SERVING_DEVICE",
            "TORCHGUARD", "DEPLOYGUARD"} <= set(declared)


def test_rbac_coverage_counts_the_ports_manager_modules():
    manager = [p for p in PKG.rglob("*.py") if ds.is_manager_module(str(p))]
    rel = {str(p.relative_to(PKG)) for p in manager}
    for d in ("controllers", "runtime"):
        assert {str(p.relative_to(PKG)) for p in (PKG / d).glob("*.py")} <= rel, d
    assert "main.py" in rel and "cluster/kubelet.py" not in rel
    assert not ds.is_manager_module("odh_kubeflow_tpu/controllers/notebook.py")
    checker = RbacCoverageChecker()
    assert run_analysis([str(PKG)], checkers=[checker]) == []
    users = {pathlib.Path(path).as_posix() for path, _ in checker._usage.values()}
    assert any(u.endswith("odh_kubeflow_tpu_torch/controllers/notebook.py") for u in users), users
    assert checker._manifests_scanned


# ---------------------------------------------------------------------------
# each checker flags a seeded bad copy
# ---------------------------------------------------------------------------


def _bad_copy(tmp_path, rel, extra):
    """A copy of the port's file `rel` under tmp_path/odh_kubeflow_tpu_torch,
    with `extra` appended; returns the tree's root."""
    dst = tmp_path / "odh_kubeflow_tpu_torch" / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text((PKG / rel).read_text() + "\n\n" + extra)
    return str(tmp_path / "odh_kubeflow_tpu_torch")


def test_rbac_coverage_flags_a_bad_copy(tmp_path):
    root = _bad_copy(tmp_path, "controllers/culling.py",
                     'def _evict(client):\n    node = client.get(Node, "", "n")\n    client.delete(node)\n')
    findings = run_analysis([root], checkers=[RbacCoverageChecker()])
    assert [(f.check, "delete Node" in f.message) for f in findings] == [("rbac-coverage", True)]


def test_env_contract_flags_a_bad_copy(tmp_path):
    root = _bad_copy(tmp_path, "serving/__main__.py", 'SEEDED = os.environ.get("SEEDED_UNDECLARED_KNOB", "")\n')
    findings = run_analysis([root], checkers=[EnvContractChecker()])
    assert [(f.check, "SEEDED_UNDECLARED_KNOB" in f.message) for f in findings] == [("env-contract", True)]


def test_env_contract_resolves_string_constants(tmp_path):
    """A key named by a module-level constant, of its own module or imported
    by name from a module of the package, is read under the constant's
    value: undeclared it is flagged at each reader, declared it is clean."""
    pkg = tmp_path / "pkg"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "sub" / "__init__.py").write_text("")
    (pkg / "names.py").write_text('import os\nKNOB_ENV = "SEEDED_CONST_KNOB"\nOTHER: str = "SEEDED_ANNOTATED"\n'
                                  "def read():\n    return os.environ.get(KNOB_ENV, '') + os.environ[OTHER]\n")
    (pkg / "sub" / "reader.py").write_text("import os\n\ndef read():\n    from ..names import KNOB_ENV as K\n"
                                           "    return K in os.environ\n")
    checker = EnvContractChecker()
    checker.declared_override = {}
    findings = run_analysis([str(pkg)], checkers=[checker])
    got = sorted((pathlib.Path(f.path).name, f.message.split("'")[1]) for f in findings)
    assert got == [("names.py", "SEEDED_ANNOTATED"), ("names.py", "SEEDED_CONST_KNOB"),
                   ("reader.py", "SEEDED_CONST_KNOB")], got
    checker = EnvContractChecker()
    checker.declared_override = {"SEEDED_CONST_KNOB": None, "SEEDED_ANNOTATED": None}
    assert run_analysis([str(pkg)], checkers=[checker]) == []
    # the port's own shared constants resolve: the serving process reads the
    # control directory under the constant its agent writes
    checker = EnvContractChecker()
    run_analysis([str(PKG)], checkers=[checker])
    assert checker._reads["SERVING_CONTROL_DIR"][0].endswith("serving/__main__.py")
    assert checker._reads["JAX_COORDINATOR_ADDRESS"][0].endswith("parallel/distributed.py")


def test_flow_schema_coverage_flags_a_bad_copy(tmp_path):
    root = _bad_copy(tmp_path, "runtime/prober.py",
                     'def _rogue(client):\n    with flow_context("seeded-rogue-flow"):\n        client.list(Pod)\n')
    findings = run_analysis([root], checkers=[FlowSchemaCoverageChecker()])
    assert [(f.check, "seeded-rogue-flow" in f.message) for f in findings] == [("flow-schema-coverage", True)]


def test_crd_schema_drift_flags_a_bad_copy_of_the_committed_tree(tmp_path):
    shutil.copytree(TREE, tmp_path / "tree")
    base = tmp_path / "tree" / "base" / "manifests.yaml"
    docs = list(yaml.safe_load_all(base.read_text()))
    for doc in docs:
        if doc["kind"] == "CustomResourceDefinition" and doc["metadata"]["name"].startswith("tpujobs."):
            del doc["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"]["properties"]["steps"]
    base.write_text(p_deploy.render_yaml(docs))
    checker = CrdSchemaDriftChecker()
    checker.manifests_path = str(base)
    root = _bad_copy(tmp_path, "deploy/crdgen.py", "")
    findings = run_analysis([root], checkers=[checker])
    assert findings and all(f.check == "crd-schema-drift" for f in findings)
    assert any("tpujobs.kubeflow.org" in f.message and ".steps: missing from committed" in f.message
               for f in findings), [f.message for f in findings]
    # the unaltered committed tree is clean
    assert run_analysis([root], checkers=[CrdSchemaDriftChecker()]) == []
