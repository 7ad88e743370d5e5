"""The PyTorch/CUDA port stands alone: it imports neither jax nor anything of
the JAX package (odh_kubeflow_tpu), so a CUDA image without jax runs it; and
no module of it imports `cryptography` when it is loaded (the card's machine
has none: `utils.certs` imports it inside `generate_cert_dir`).

The import check runs in a subprocess, because this test process already
holds jax (tests/conftest.py imports it). Note the prefix: the port's name
starts with "odh_kubeflow_tpu", so a module belongs to the JAX package only
when it is "odh_kubeflow_tpu" itself or under "odh_kubeflow_tpu.".
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from odh_kubeflow_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "odh_kubeflow_tpu_torch"
# the port, the smoke (phase 14's and 15's torchrun worker script too), the helper its phases 14
# and 15 import from tests/, the phases' runners and the gate's node reading in tools/, and the
# operator flow's helpers that the card tests import
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tests" / "torch_dist.py",
                                        REPO / "tools" / "device_phase.py", REPO / "tools" / "operator_phase.py",
                                        REPO / "tools" / "gate_nodes.py",
                                        REPO / "tests" / "torch_operator_flow.py",
                                        REPO / "tests" / "torch_pod_worker.py"]


def _forbidden(module: str) -> bool:
    return (
        module == "jax" or module.startswith("jax.") or module.startswith("jaxlib")
        or module == "odh_kubeflow_tpu" or module.startswith("odh_kubeflow_tpu.")
    )


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_forbidden_prefix_rule():
    assert _forbidden("odh_kubeflow_tpu.ops") and _forbidden("jax.numpy")
    assert not _forbidden("odh_kubeflow_tpu_torch.ops")


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules() + ["chip_smoke"]
    assert "odh_kubeflow_tpu_torch.serving.__main__" in mods
    assert {"odh_kubeflow_tpu_torch.parallel", "odh_kubeflow_tpu_torch.parallel.mesh",
            "odh_kubeflow_tpu_torch.parallel.distributed", "odh_kubeflow_tpu_torch.parallel.comm",
            "odh_kubeflow_tpu_torch.ops.ring_attention", "odh_kubeflow_tpu_torch.parallel.pipeline",
            "odh_kubeflow_tpu_torch.parallel.interleaved_1f1b", "odh_kubeflow_tpu_torch.gpu",
            "odh_kubeflow_tpu_torch.gpu.topology", "odh_kubeflow_tpu_torch.gpu.env",
            "odh_kubeflow_tpu_torch.gpu.podspec", "odh_kubeflow_tpu_torch.apimachinery.errors",
            "odh_kubeflow_tpu_torch.cluster.store", "odh_kubeflow_tpu_torch.cluster.sim",
            "odh_kubeflow_tpu_torch.runtime.manager", "odh_kubeflow_tpu_torch.controllers.notebook",
            "odh_kubeflow_tpu_torch.controllers.probe_status", "odh_kubeflow_tpu_torch.controllers.culling",
            "odh_kubeflow_tpu_torch.probe.behavior", "odh_kubeflow_tpu_torch.utils.diff",
            "odh_kubeflow_tpu_torch.api.admission", "odh_kubeflow_tpu_torch.api.networking",
            "odh_kubeflow_tpu_torch.api.rbac", "odh_kubeflow_tpu_torch.api.gateway",
            "odh_kubeflow_tpu_torch.api.dspa", "odh_kubeflow_tpu_torch.controllers.webhook",
            "odh_kubeflow_tpu_torch.controllers.extension", "odh_kubeflow_tpu_torch.utils.certs",
            "odh_kubeflow_tpu_torch.runtime.webhook_server", "odh_kubeflow_tpu_torch.cluster.webhook_dispatch",
            "odh_kubeflow_tpu_torch.cluster.remote"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'odh_kubeflow_tpu' or m.startswith('odh_kubeflow_tpu.') or m.split('.')[0] == 'cryptography')\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_cryptography_at_module_level(path):
    """An import of `cryptography` sits inside a function body, never in a
    module's own statements (a class body or an `if`/`try` at module level
    counts as loading it)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            todo += list(ast.iter_child_nodes(node))
            continue
        bad = [n for n in names if n.split(".")[0] == "cryptography"]
        assert not bad, f"{path.name}:{node.lineno} imports {bad} when the module loads"


def test_the_cryptography_check_sees_module_level_imports(tmp_path):
    """The check above flags a module-level import, also one nested in a
    `try` or a class body, and passes one inside a function."""
    for source, flagged in (("import cryptography\n", True),
                            ("try:\n    from cryptography import x509\nexcept ImportError:\n    pass\n", True),
                            ("class A:\n    import cryptography.x509\n", True),
                            ("def f():\n    from cryptography import x509\n", False)):
        path = tmp_path / "mod.py"
        path.write_text(source)
        if flagged:
            with pytest.raises(AssertionError, match="cryptography"):
                test_sources_import_no_cryptography_at_module_level(path)
        else:
            test_sources_import_no_cryptography_at_module_level(path)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_CANDIDATES", (str(tmp_path / "no-nvcc"),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build_all()
    assert not (tmp_path / "build").exists()


def test_build_reports_compiler_output_on_failure(monkeypatch, tmp_path):
    """A refused source raises with the compiler's own output (here a stub
    compiler that prints and fails), and leaves no library behind."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'flash_fwd.cu(1): error: stub refusal'\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="stub refusal"):
        _build.build_all()
    assert list((tmp_path / "build").iterdir()) == []


def test_library_name_keys_on_the_source(monkeypatch, tmp_path):
    src = tmp_path / "flash_fwd.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("flash_fwd")
    src.write_text("// two\n")
    assert _build.library_path("flash_fwd") != first
    assert first.parent == _build.BUILD_DIR


def test_library_name_keys_on_the_shared_header(monkeypatch, tmp_path):
    (tmp_path / "flash_bwd.cu").write_text('#include "flash_common.cuh"\n')
    header = tmp_path / "flash_common.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("flash_bwd")
    header.write_text("// two\n")
    assert _build.library_path("flash_bwd") != first
