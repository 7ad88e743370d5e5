"""The port's lint (odh_kubeflow_tpu_torch/analysis: the framework and its
pragma budget, metric_rules, and the cache-mutation, lock-discipline,
lock-order, swallowed-exception, metric- and annotation-convention and
machine-conformance checkers) against the JAX package's, on the CPU.

The cases of tests/test_analysis.py, each run on both packages in one test
(tests/torch_ported.py): every checker flags its fixture and passes its
clean twin, the pragma scopes and the pragma budget, the machine-conformance
drift checks both ways, the shared metric rules and the live registry, the
racecheck lock graph and cache write barrier, and the whole pass clean on
the real package — the port's own on its side, held to the port's allowlist
(`odh_kubeflow_tpu_torch/analysis/pragma_allowlist.txt`, renamed in below).

Left out: the 13 deploylint cases, which tests/test_torch_deploylint.py
runs, and the 14 jaxlint fixture cases (retrace-hazard, host-transfer,
donation-discipline, psum-axis): their fixtures are jax source, and the
port's counterparts (host-transfer and psum-axis over torch) are held in
tests/test_torch_torchlint.py. Their imports are cut on both sides.
"""
import pytest

import torch_ported
import torch_threads

torch_threads.cap()

EDITS = ((
    "from odh_kubeflow_tpu.analysis.checkers.jaxlint import (\n    DonationDisciplineChecker,\n"
    "    HostTransferChecker,\n    PsumAxisChecker,\n    RetraceHazardChecker,\n)\n", ""),)
RENAMES = (('allowlist = parse_pragma_allowlist(\n        (repo / "ci" / "pragma_allowlist.txt").read_text()\n    )',
            'allowlist = parse_pragma_allowlist(\n        (pkg / "analysis" / "pragma_allowlist.txt").read_text()\n    )'),)
JAX = torch_ported.load("test_analysis", "jax", edits=EDITS)
PORT = torch_ported.load("test_analysis", "port", renames=RENAMES, edits=EDITS)

JAXLINT_PREFIXES = ("test_retrace_hazard_", "test_host_transfer_", "test_donation_discipline_", "test_psum_axis_")


def _deploylint(module):
    return [c for c in torch_ported.cases(module)
            if any(m.name == "deploylint" for m in getattr(getattr(module, c), "pytestmark", []))]


LEFT_OUT = tuple(_deploylint(JAX)) + tuple(c for c in torch_ported.cases(JAX) if c.startswith(JAXLINT_PREFIXES))
CASES = torch_ported.cases(JAX, skip=LEFT_OUT)


def test_the_cases_are_the_forty_eight_left_by_deploylint_and_jaxlint():
    assert len(torch_ported.cases(JAX)) == 75 and len(LEFT_OUT) == 13 + 14
    assert len(CASES) == 48
    assert torch_ported.cases(PORT, skip=LEFT_OUT) == CASES


@pytest.mark.parametrize("case", CASES)
def test_analysis_case_against_the_reference(case, tmp_path):
    torch_ported.both(JAX, PORT, case, tmp_path, transcript=False)
