"""The port's torchlint pair (analysis/checkers/torchlint.py), the
counterparts of the reference's jaxlint host-transfer and psum-axis
(tests/test_analysis.py holds those over jax fixtures; their torch
fixtures are here).

host-transfer: each torch surface of a device->host copy is flagged inside
a hot region's root and inside a same-module function the root reaches;
host numpy values (the engine's `_lengths`, what `to_host` returned) stay
silent; a pragma'd copy and a function no root reaches stay silent; a
module that is no hot region is not scanned; every root of
`utils/hotregions.py` names a def of the port. psum-axis: an undeclared
axis is flagged, the declared ones (defaults included) pass, and without a
declaration nothing is judged. The port's tree is clean under the pair, and
a seeded bad copy of a port module is flagged.

Left out, as the reference has them: retrace-hazard and
donation-discipline, which have no counterpart in the port until it has a
`torch.compile` or a CUDA-graph capture.
"""
import pathlib
import shutil

import pytest

import odh_kubeflow_tpu_torch
from odh_kubeflow_tpu_torch.analysis import run_analysis, run_on_source
from odh_kubeflow_tpu_torch.analysis.checkers import make_checkers
from odh_kubeflow_tpu_torch.analysis.checkers.torchlint import HostTransferChecker, PsumAxisChecker
from odh_kubeflow_tpu_torch.utils import hotregions

PKG = pathlib.Path(odh_kubeflow_tpu_torch.__file__).parent
ENGINE_PATH = "odh_kubeflow_tpu_torch/serving/engine.py"

# (surface, the statement over a tensor `t`, a word of the message)
SURFACES = (
    ("item", "v = t.sum().item()", ".item()"),
    ("cpu", "v = t.cpu()", ".cpu()"),
    ("tolist", "v = t.tolist()", ".tolist()"),
    ("numpy", "v = t.numpy()", ".numpy()"),
    ("to_host", "v = torchguard.to_host(t)", "torchguard.to_host"),
    ("to-cpu", 'v = t.to("cpu")', '.to("cpu")'),
    ("to-device-cpu", 'v = t.to(device=torch.device("cpu"))', '.to("cpu")'),
    ("np.asarray", "v = np.asarray(t)", "np.asarray over a tensor"),
    ("np.array", "v = np.array(t + 1)", "np.array over a tensor"),
    ("float", "v = float(t.max())", "float() over a tensor"),
    ("int", "v = int(t.argmax(dim=-1)[0])", "int() over a tensor"),
    ("bool", "v = bool((t > 0).any())", "bool() over a tensor"),
    ("branch", "if t.sum() > 0:\n            v = 1", "branching on a tensor"),
)

FIXTURE = '''
import numpy as np
import torch

from ..utils import torchguard


class ServingEngine:
    def step(self):
        t = torch.ones(4)
        {root}
        return self._helper()

    def _helper(self):
        t = self._upload(np.zeros(4))
        {callee}

    def _upload(self, arr):
        return torch.from_numpy(arr).to(self.device, non_blocking=True)
'''


def _line_of(src, needle):
    return next(i for i, line in enumerate(src.splitlines(), 1) if needle in line)


@pytest.mark.parametrize("where", ["root", "callee"])
@pytest.mark.parametrize("surface,stmt,word", SURFACES, ids=[s[0] for s in SURFACES])
def test_host_transfer_flags_each_torch_surface(surface, stmt, word, where):
    src = FIXTURE.format(root=stmt if where == "root" else "pass",
                         callee=stmt if where == "callee" else "pass")
    findings = run_on_source(src, [HostTransferChecker()], path=ENGINE_PATH)
    assert len(findings) == 1, findings
    finding = findings[0]
    assert finding.check == "host-transfer" and word in finding.message
    assert finding.line == _line_of(src, stmt.splitlines()[0].strip())
    assert ("reached from hot region" in finding.message) == (where == "callee")


HOST_VALUES = '''
import numpy as np
import torch

from ..utils import torchguard


class ServingEngine:
    def __init__(self):
        self._lengths = np.zeros((8,), np.int64)
        self._queue = []

    def step(self):
        n_active = sum(1 for q in self._queue)
        if n_active == 0:
            return False
        extent = int(self._lengths.max()) + 4
        state = self._upload(np.concatenate([self._lengths, self._lengths]))
        packed = torch.cat([state, state])
        if packed.shape[0] > extent:
            pass
        host = torchguard.to_host(packed)  # lint: disable=host-transfer
        self._lengths = host[:8].copy()
        first = int(host[0])
        tokens = host.tolist()
        peak = float(self._lengths.max())
        prompt = np.asarray([[1, 2, 3]], np.int64)
        ok = bool(self._queue)
        if self._lengths[0] > 2 and len(tokens) > first:
            peak += self._lengths.sum().item()
        return ok, prompt, peak

    def _upload(self, arr):
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t
'''


def test_host_transfer_silent_on_host_numpy_values():
    assert run_on_source(HOST_VALUES, [HostTransferChecker()], path=ENGINE_PATH) == []


HOST_TRANSFER_CLEAN = '''
import torch
from ..utils import torchguard

class ServingEngine:
    def step(self):
        out = self._burst()
        drained = torchguard.to_host(out)  # lint: disable=host-transfer
        return drained

    def _burst(self):
        return self._fn(self._buf)

class Reporter:
    def outside_hot_region(self):
        return float(torchguard.to_host(self._x)[0]) + self._x.sum().item()
'''


def test_host_transfer_pragma_and_reachability_scope():
    # the pragma'd drain is suppressed; Reporter is reached from no root
    assert run_on_source(HOST_TRANSFER_CLEAN, [HostTransferChecker()], path=ENGINE_PATH) == []
    unpragmad = HOST_TRANSFER_CLEAN.replace("  # lint: disable=host-transfer", "")
    findings = run_on_source(unpragmad, [HostTransferChecker()], path=ENGINE_PATH)
    assert [f.line for f in findings] == [_line_of(unpragmad, "drained = ")]


def test_host_transfer_silent_outside_registered_modules():
    src = FIXTURE.format(root="v = t.sum().item()", callee="v = t.cpu()")
    assert run_on_source(src, [HostTransferChecker()], path="odh_kubeflow_tpu_torch/other.py") == []
    assert len(run_on_source(src, [HostTransferChecker()], path=ENGINE_PATH)) == 2


@pytest.mark.parametrize("region", [r for r in hotregions.REGIONS], ids=[r.name for r in hotregions.REGIONS])
def test_every_hot_region_root_names_a_def_of_the_port(region):
    path = PKG.parent / region.module
    assert path.is_file(), region.module
    assert hotregions.hot_functions_for(str(path)) == {
        fn: r for r in hotregions.REGIONS if r.module == region.module for fn in r.functions}
    import ast

    defs = HostTransferChecker._module_functions(ast.parse(path.read_text()))
    for fn in region.functions:
        assert fn in defs, f"{region.name}: {fn} is no def of {region.module}"


def test_the_serving_regions_reach_the_engine_drain_and_the_first_token():
    findings = run_analysis([str(PKG / "serving" / "engine.py")], checkers=[HostTransferChecker()],
                            include_suppressed=True)
    src = (PKG / "serving" / "engine.py").read_text()
    assert [f.line for f in findings] == [_line_of(src, "host = torchguard.to_host(packed)"),
                                         _line_of(src, "first = int(torchguard.to_host(")]
    assert "reached from hot region 'serving.decode_burst'" in findings[0].message
    assert "hot region 'serving.prefill'" in findings[1].message


PSUM_BAD = '''
AXES = ("dp", "tp")

def f(mesh, x):
    return comm.all_reduce(x, mesh.group("sp")[0])
'''

PSUM_CLEAN = '''
AXES = ("dp", "fsdp", "tp", "sp")
GROUP_AXES = (("sp",), ("dp", "fsdp"))

def f(mesh, x, seq_axis="sp"):
    n = mesh.size(("dp", "fsdp")) * mesh.sizes["tp"]
    return ring(x, mesh, axis_name="sp", seq_axis="") * n + mesh.index("tp")

def g(x, axis_name="tp", *, axis_names=("dp", "fsdp")):
    group, ranks = self.mesh.group(axis_name)
    return ("a", "b").index("b"), re_match.group("checks")
'''

PSUM_NO_DECLARATION = '''
def f(mesh, x):
    return mesh.group("anything")
'''


@pytest.mark.parametrize("use", ['mesh.group("sp")', 'mesh.size("sp")', 'mesh.index(("dp", "sp"))',
                                 'mesh.ranks("sp")', 'self.mesh.live("sp")', 'stage_mesh.sizes["sp"]',
                                 'ring(x, axis_name="sp")', 'layer(x, seq_axis="sp")'])
def test_psum_axis_flags_undeclared_axis(use):
    src = PSUM_BAD.replace('mesh.group("sp")[0]', use)
    findings = run_on_source(src, [PsumAxisChecker()])
    assert [f.check for f in findings] == ["psum-axis"]
    assert "'sp'" in findings[0].message and findings[0].line == _line_of(src, use)


def test_psum_axis_flags_an_undeclared_default():
    src = PSUM_BAD + '\ndef h(x, seq_axis="sq"):\n    return x\n'
    assert {("'sq'" in f.message) for f in run_on_source(src, [PsumAxisChecker()])} == {True, False}


def test_psum_axis_passes_declared_axes_including_defaults():
    assert run_on_source(PSUM_CLEAN, [PsumAxisChecker()]) == []


def test_psum_axis_silent_without_any_declaration():
    assert run_on_source(PSUM_NO_DECLARATION, [PsumAxisChecker()]) == []


def test_psum_axis_reads_the_port_mesh_declaration():
    checker = PsumAxisChecker()
    run_analysis([str(PKG / "parallel" / "mesh.py")], checkers=[checker])
    assert checker.declared == {"dp", "fsdp", "pp", "ep", "tp", "sp"}


def test_the_port_tree_is_clean_under_the_pair():
    assert run_analysis([str(PKG)], checkers=[HostTransferChecker(), PsumAxisChecker()]) == []


def test_the_pair_is_registered_and_jaxlints_other_two_are_not():
    names = [c.name for c in make_checkers()]
    assert "host-transfer" in names and "psum-axis" in names
    assert "retrace-hazard" not in names and "donation-discipline" not in names


def test_a_seeded_bad_copy_of_a_port_module_is_flagged(tmp_path):
    root = tmp_path / "odh_kubeflow_tpu_torch"
    (root / "serving").mkdir(parents=True)
    (root / "parallel").mkdir()
    src = (PKG / "serving" / "engine.py").read_text()
    anchor = "        handle.tokens.append(token)\n"
    assert anchor in src
    bad = src.replace(anchor, anchor + "        self._seen = self._caches[0][0].sum().item()\n")
    (root / "serving" / "engine.py").write_text(bad)
    shutil.copy(PKG / "parallel" / "mesh.py", root / "parallel" / "mesh.py")
    (root / "parallel" / "bad.py").write_text("def f(mesh):\n    return mesh.group('xp')\n")
    findings = run_analysis([str(root)], checkers=[HostTransferChecker(), PsumAxisChecker()])
    assert [(f.check, pathlib.Path(f.path).name, f.line) for f in findings] == [
        ("psum-axis", "bad.py", 2),
        ("host-transfer", "engine.py", _line_of(bad, "self._seen = ")),
    ]
    # the engine's _emit is reached from both serving roots, not a root itself
    assert "reached from hot region" in findings[1].message
