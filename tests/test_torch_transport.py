"""The wire on the port: every case of tests/test_transport.py (the
Kubernetes REST protocol between `ApiServer` and `RemoteStore` over real
sockets: CRUD, Status errors, selectors, the status subresource, both
patch types, watch streams with resourceVersion resume, 410 relist and
bookmarks, bearer token, TLS, kubeconfig and in-cluster bootstrap, the
wire fixture and the pooled transport's retry discipline), run on the JAX
package and on the port in one test, the two held to the same requests and
the same answers (tests/torch_ported.py)."""
import pytest

import torch_ported

JAX = torch_ported.load("test_transport", "jax")
PORT = torch_ported.load("test_transport", "port")


@pytest.mark.parametrize("case", torch_ported.cases(JAX))
def test_transport_case_against_the_reference(case, tmp_path):
    torch_ported.both(JAX, PORT, case, tmp_path)
