"""The port's RemoteStore against canned kube-apiserver exchanges: every
case of tests/test_wire_conformance.py (paths and envelopes, Status bodies,
merge patch and the status subresource, the watch stream's bookmarks and
410 relist, the client-side throttle), run on the JAX package and on the
port in one test, the two held to the same requests and answers
(tests/torch_ported.py). Also tests/test_overload.py's wire case: API
priority and fairness over the wire (the flow header, injected delay, 429
bursts retried within the client's bound)."""
import pytest

import torch_ported

JAX = torch_ported.load("test_wire_conformance", "jax")
PORT = torch_ported.load("test_wire_conformance", "port")
OVERLOAD_JAX = torch_ported.load("test_overload", "jax")
OVERLOAD_PORT = torch_ported.load("test_overload", "port", renames=(
    ("from odh_kubeflow_tpu_torch.probe import", "from odh_kubeflow_tpu_torch.probe.behavior import"),))


@pytest.mark.parametrize("case", torch_ported.cases(JAX))
def test_wire_conformance_case_against_the_reference(case, tmp_path):
    torch_ported.both(JAX, PORT, case, tmp_path)


def test_wire_overload_flow_header_delay_and_429_bursts_against_the_reference(tmp_path):
    torch_ported.both(OVERLOAD_JAX, OVERLOAD_PORT, "test_wire_overload_flow_header_delay_and_429_bursts", tmp_path)
