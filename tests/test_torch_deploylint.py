"""The port's deploylint family (analysis/checkers/deploylint.py over the
contract in analysis/deploysurface.py and the framework in
analysis/framework.py) against the JAX package's, on the CPU.

The deploylint cases of tests/test_analysis.py, each run on both packages in
one test (tests/torch_ported.py): each checker flags its fixture and passes
its clean twin, rbac-coverage attributes only the manager's modules (on the
port's side the fixtures' paths are the port's, `odh_kubeflow_tpu_torch/
controllers/...`) and a surface artifact clears a stale rule,
crd-schema-drift passes the committed tree, flags a doctored copy of it and
a missing one (on the port's side the tree inside its package,
`deploy/tree/base/manifests.yaml`, never the JAX one), env-contract's
undeclared reads, pragmas, dead knobs and manifest drift, flow-schema-
coverage's default classification, unentered schemas and webhook paths both
ways, and the whole family clean on the real package — the port's own on
its side. tests/test_torch_analysis.py runs the rest of tests/test_analysis.py
but for its jaxlint cases, whose jax fixtures the port's torchlint does not
read (their import is cut on both sides here).
"""
import pytest

import torch_ported

CUT = (
    "from odh_kubeflow_tpu.analysis.checkers.jaxlint import (\n    DonationDisciplineChecker,\n"
    "    HostTransferChecker,\n    PsumAxisChecker,\n    RetraceHazardChecker,\n)\n",
)
EDITS = tuple((line, "") for line in CUT)
RENAMES = (('pathlib.Path(odh_kubeflow_tpu_torch.__file__).parent.parent\n        / "deploy" / "base"',
            'pathlib.Path(odh_kubeflow_tpu_torch.__file__).parent\n        / "deploy" / "tree" / "base"'),)
JAX = torch_ported.load("test_analysis", "jax", edits=EDITS)
PORT = torch_ported.load("test_analysis", "port", renames=RENAMES, edits=EDITS)


def _deploylint(module):
    return [c for c in torch_ported.cases(module)
            if any(m.name == "deploylint" for m in getattr(getattr(module, c), "pytestmark", []))]


DEPLOYLINT = _deploylint(JAX)


def test_the_deploylint_cases_are_the_twelve_and_the_package_gate():
    assert len(DEPLOYLINT) == 13 and DEPLOYLINT[-1] == "test_deploylint_family_is_clean_on_the_real_package"
    assert _deploylint(PORT) == DEPLOYLINT


@pytest.mark.parametrize("case", DEPLOYLINT)
def test_deploylint_case_against_the_reference(case, tmp_path):
    torch_ported.both(JAX, PORT, case, tmp_path, transcript=False)
