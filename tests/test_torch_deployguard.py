"""The port's DEPLOYGUARD (utils/deployguard.py, its hook in
cluster/client.py) against the JAX package's, on the CPU.

- The cases of tests/test_deployguard.py, each run on both packages in one
  test (tests/torch_ported.py): a manager flow's ungranted call raises at
  the call, granted traffic is recorded, non-manager flows are record-only,
  the two flow-identity invariants (Lease traffic only on the elector's
  flow, and only Lease traffic there), the disarmed client, the env switch,
  the surface artifact and its merge across processes. Left out:
  `test_armed_observe_overhead_under_ten_percent`, a wall-clock ratio of
  two loops in one process, which load on the test machine breaks whatever
  the code does.
- `DEPLOYGUARD=1` arms the port's guard at import, and
  `DEPLOYGUARD_SURFACE_OUT` gets the artifact at the process's exit.
- The port's `build_manager` on a SimCluster runs a notebook to ready and
  through a cull under the armed guard: no drift, the manager's flows
  recorded, and the rbac-coverage checker over the port's package with that
  artifact finds no ungranted call (the CPU twin of the card's phase 15
  gate).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_ported
import torch_threads

torch_threads.cap()

REPO = Path(__file__).resolve().parent.parent
LEFT_OUT = ("test_armed_observe_overhead_under_ten_percent",)
JAX = torch_ported.load("test_deployguard", "jax")
PORT = torch_ported.load("test_deployguard", "port")


@pytest.mark.parametrize("case", torch_ported.cases(JAX, skip=LEFT_OUT))
def test_deployguard_case_against_the_reference(case, tmp_path):
    torch_ported.both(JAX, PORT, case, tmp_path, transcript=False)


def test_the_env_arms_the_guard_at_import_and_dumps_at_exit(tmp_path):
    out = tmp_path / "surface.json"
    script = (
        "from odh_kubeflow_tpu_torch.api.core import ConfigMap\n"
        "from odh_kubeflow_tpu_torch.cluster import Client, Store\n"
        "from odh_kubeflow_tpu_torch.cluster.flowcontrol import flow_context\n"
        "from odh_kubeflow_tpu_torch.utils import deployguard\n"
        "assert deployguard.ACTIVE is not None\n"
        "cm = ConfigMap()\n"
        "cm.metadata.namespace, cm.metadata.name = 'ns', 'cm'\n"
        "with flow_context('notebook'):\n"
        "    Client(Store()).create(cm)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), DEPLOYGUARD="1", DEPLOYGUARD_SURFACE_OUT=str(out))
    done = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
    assert ["notebook", "create", "ConfigMap", ""] in json.loads(out.read_text())["surface"]


def test_the_ports_operator_runs_inside_its_generated_rbac(tmp_path):
    """build_manager's controllers, armed, over one notebook's life: made
    ready on an h100 1x4 slice, culled, deleted."""
    import time

    from odh_kubeflow_tpu_torch.analysis import deploysurface as ds
    from odh_kubeflow_tpu_torch.analysis import run_analysis
    from odh_kubeflow_tpu_torch.analysis.checkers import RbacCoverageChecker
    from odh_kubeflow_tpu_torch.api.core import Container
    from odh_kubeflow_tpu_torch.api.notebook import Notebook, TPUSpec
    from odh_kubeflow_tpu_torch.cluster import SimCluster
    from odh_kubeflow_tpu_torch.controllers import Config
    from odh_kubeflow_tpu_torch.controllers import constants as C
    from odh_kubeflow_tpu_torch.main import build_manager
    from odh_kubeflow_tpu_torch.probe.behavior import sim_agent_behavior
    from odh_kubeflow_tpu_torch.utils import deployguard

    previous = deployguard.ACTIVE
    deployguard.disarm()
    guard = deployguard.arm()
    cluster = SimCluster().start()
    agents = {}
    mgr = None
    try:
        cluster.add_gpu_pool("h100", "h100", "1x4")
        cluster.add_pod_behavior(sim_agent_behavior(agents, duty=0.0, kernels_busy=False))
        config = Config(enable_culling=True, cull_idle_time_min=2.0 / 60.0, idleness_check_period_min=0.1 / 60.0,
                        readiness_probe_period_s=0.2, accounting_period_s=0.0)
        mgr = build_manager(cluster.store, config, http_get=cluster.http_get)
        mgr.start()
        nb = Notebook()
        nb.metadata.name, nb.metadata.namespace = "guarded", "user"
        nb.spec.template.spec.containers = [Container(name="guarded", image="torch:1")]
        nb.spec.tpu = TPUSpec(accelerator="h100", topology="1x4")
        cluster.client.create(nb)

        def status():
            return cluster.client.get(Notebook, "user", "guarded")

        def culled():
            # the CR is born with the webhook's reconciliation lock in the
            # same annotation; the culler's stop is a timestamp
            return status().metadata.annotations.get(C.STOP_ANNOTATION, C.RECONCILIATION_LOCK_VALUE) \
                != C.RECONCILIATION_LOCK_VALUE

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not culled():
            time.sleep(0.05)
        assert status().status.tpu.first_ready_time, "never mesh-ready"
        assert culled(), "never culled"
        cluster.client.delete(Notebook, "user", "guarded")
        time.sleep(0.5)
    finally:
        if mgr is not None:
            mgr.stop()
        cluster.stop()
        for a in set(agents.values()):
            a.close()
        deployguard.disarm()
        deployguard.ACTIVE = previous
    assert guard.drifts == 0
    flows = {t[0] for t in guard.surface if t[0] in ds.MANAGER_FLOWS}
    assert {"notebook", "culling", "probe-status"} <= flows, flows
    artifact = tmp_path / "surface.json"
    guard.dump(str(artifact))
    checker = RbacCoverageChecker()
    checker.surface = ds.surface_tuples_from_artifact(json.loads(artifact.read_text()))
    findings = run_analysis([str(REPO / "odh_kubeflow_tpu_torch")], checkers=[checker])
    assert [f for f in findings if "stale RBAC" not in f.message] == []
