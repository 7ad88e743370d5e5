"""The port's manager debug mux (runtime/serving.py, `Manager.serve_endpoints`)
against the JAX package's, on the CPU: the cases of the JAX suite that
serve it, each run on both packages in one test (tests/torch_ported.py) —
/metrics and /healthz, /readyz on their two ports with real liveness and
readiness (tests/test_runtime.py), a dead controller thread failing
/healthz, /debug/traces' limit, notebook and name filters and its 400
(tests/test_slo.py), and /debug/flowcontrol's levels with the index's link
(tests/test_flowcontrol.py). tests/test_tracing.py's connected readiness
trace over /debug/traces runs in tests/test_torch_main.py (it goes through
`build_manager`), the seeded bad day's /debug/slo, /debug/incidents and
/debug/traces reads in tests/test_torch_slo.py, the /debug/accounting cases
in tests/test_torch_accounting.py and /debug/reconciles' in
tests/test_torch_cpprofile.py.

Also each route's bad arguments on the port's mux, against the JAX one's
answers on the same requests."""
import urllib.error
import urllib.request

import pytest

import torch_ported
import torch_threads

torch_threads.cap()

PORTED = {
    "test_runtime": ("test_serving_endpoints_metrics_and_health", "test_healthz_reports_dead_controller_thread"),
    "test_slo": ("test_debug_traces_limit_and_notebook_filters",),
    "test_flowcontrol": ("test_debug_flowcontrol_view",),
}
MODULES = {name: (torch_ported.load(name, "jax"), torch_ported.load(name, "port")) for name in PORTED}


@pytest.mark.parametrize("case", [(name, case) for name, cases in PORTED.items() for case in cases],
                         ids=lambda c: f"{c[0]}::{c[1]}")
def test_debug_mux_case_against_the_reference(case, tmp_path):
    name, case = case
    torch_ported.both(*MODULES[name], case, tmp_path)


QUERIES = ("/debug/traces?limit=x", "/debug/traces?limit=-1", "/debug/traces?limit=0",
           "/debug/profile?limit=x", "/debug/profile?limit=-1", "/debug/profile?region=no-such-region",
           "/debug/reconciles?limit=x", "/debug/reconciles?controller=no-such-controller",
           "/debug/incidents?id=no-such-incident", "/debug/nothing", "/debug/")


def test_every_route_answers_the_reference_status():
    """Each route of the mux, with good and bad arguments, answers the
    status the JAX package's answers, and a JSON body where it does."""
    from odh_kubeflow_tpu.cluster import Store as JStore
    from odh_kubeflow_tpu.runtime import Manager as JManager
    from odh_kubeflow_tpu_torch.cluster import Store as PStore
    from odh_kubeflow_tpu_torch.runtime import Manager as PManager

    def answers(manager_cls, store_cls):
        mgr = manager_cls(store_cls())
        ep = mgr.serve_endpoints(metrics_port=0, health_port=0, host="127.0.0.1")
        out = {}
        try:
            host, port = ep.metrics_address
            for query in QUERIES:
                try:
                    with urllib.request.urlopen(f"http://{host}:{port}{query}", timeout=5) as r:
                        status, kind = r.status, r.headers.get("Content-Type", "")
                except urllib.error.HTTPError as e:
                    status, kind = e.code, e.headers.get("Content-Type", "")
                out[query] = (status, kind.split(";")[0])
        finally:
            ep.stop()
        return out

    jax, port = answers(JManager, JStore), answers(PManager, PStore)
    assert port == jax
    assert {port[q][0] for q in QUERIES[:2] + QUERIES[3:8]} == {400}
    assert port["/debug/nothing"][0] == 404 and port["/debug/"] == (200, "text/html")
