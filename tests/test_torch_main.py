"""The port's composition root (odh_kubeflow_tpu_torch/main.py) against the
JAX package's, on the CPU.

`build_manager` on both sides over a SimCluster (the JAX side on v5e 2x2,
the port on h100 1x4): the same controllers, in the same order, and the
same services; one notebook created, made ready, culled and deleted, its
objects compared on `to_dict()` JSON with the device fields mapped
(tests/test_torch_operator.py's canonical forms). The cases of the JAX
suite that go through `build_manager` (tests/test_coalesce.py,
tests/test_probe_status.py's device-visibility gate on one host and on
four, tests/test_slo.py's canary round trip, tests/test_suspend.py's
reconciliation lock, tests/test_tracing.py's deleted root and connected
trace served over /debug/traces), each run on both packages in one test
(tests/torch_ported.py). The knobs only `main` reads (SLO_ENABLED,
CANARY_PERIOD_S) against the reference's Config.

`python -m odh_kubeflow_tpu_torch.main` as a process, in its three shapes:
the demo (an in-process SimCluster) on free ports answers /healthz,
/readyz, /metrics and /debug and exits 0 on SIGTERM; the remote shape,
with KUBECONFIG at a `build_remote_stack` fixture and WEBHOOK_CERT_DIR
holding tls.crt, admits a Notebook written over the wire through its own
HTTPS webhook and renders its StatefulSet, as the JAX package's `main`
does run the same way; the deployed shape (KUBERNETES_SERVICE_HOST) with
no certs exits non-zero.

tests/test_duty_cycle.py's case (a busy device keeps the notebook through
an aggressive culler, an idle one does not) runs through the port's
`build_manager` in tests/test_torch_probe.py, a scripted card's allocator
in place of the jax.numpy loop; tests/test_extension.py's sequence in
tests/test_torch_extension.py. Left out: tests/test_tracing.py's
`test_bench_phase_breakdown_reports_all_phases` (bench.py's breakdown
reads the JAX package's span buffer)."""
import base64
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import torch_ported
import torch_threads
from test_torch_operator import PORT as PORT_SIDE, SIDES, canon_service, canon_sts, canon_status, wait_for
from torch_sides import both as both_at_once

import odh_kubeflow_tpu.main as j_main
import odh_kubeflow_tpu_torch.main as p_main

torch_threads.cap()

REPO = Path(__file__).resolve().parent.parent
NS = "user"
MAINS = {"jax": j_main, "port": p_main}


# ---------------------------------------------------------------------------
# build_manager on both sides
# ---------------------------------------------------------------------------


def wiring(side, **cfg):
    """What `build_manager` wired on a side: its controllers' names in
    order, its services' classes, the judgement layer's attributes."""
    store = side.cluster.Store()
    mgr = MAINS[side.name].build_manager(store, side.ctrl.Config(**cfg))
    return {"controllers": [c.name for c in mgr.controllers],
            "services": [type(s).__name__ for s in mgr._services],
            "judgement": {a: type(getattr(mgr, a, None)).__name__
                          for a in ("slo_engine", "alert_manager", "flight_recorder", "prober", "autoscaler",
                                    "accountant", "status_coalescer")},
            "webhooks": len(getattr(store, "_admission", getattr(store, "_webhooks", [])) or [])}


@pytest.mark.parametrize("cfg", [
    {},
    {"slo_enabled": False},
    {"canary_period_s": 30.0, "autoscale_period_s": 1.0, "accounting_period_s": 0.0},
    {"pool_prewarm": 1},
])
def test_build_manager_wires_the_reference_controllers_and_services(cfg):
    """The same controllers in the same order, the same services (the
    status coalescer, the prewarmer with POOL_PREWARM, the SLO engine, the
    canary prober, the autoscaler, the accountant) and the same judgement
    attributes, for each Config; the port's autoscaler reads the pods'
    /stats (`PodStatsSignals`), the reference's its default signals."""
    jax, port = (wiring(side, **cfg) for side in SIDES)
    assert port == jax
    assert "notebook" in port["controllers"] and "StatusCoalescer" in port["services"]
    if cfg.get("autoscale_period_s"):
        store = PORT_SIDE.cluster.Store()
        mgr = p_main.build_manager(store, PORT_SIDE.ctrl.Config(**cfg))
        from odh_kubeflow_tpu_torch.runtime.autoscaler import PodStatsSignals, serving_address

        assert isinstance(mgr.autoscaler.signals_fn, PodStatsSignals)
        assert mgr.autoscaler.signals_fn.address_of is serving_address


def test_serving_address_reads_the_pods_ip_and_its_serving_port():
    """`serving_address` is a replica's URL from its pod object alone: the
    pod's IP and its `http-serving` container port; None without an IP or
    without that port."""
    from odh_kubeflow_tpu_torch.api.core import Container, ContainerPort, Pod
    from odh_kubeflow_tpu_torch.runtime.autoscaler import serving_address

    pod = Pod()
    pod.spec.containers = [Container(name="side", ports=[ContainerPort(name="metrics", container_port=9090)]),
                           Container(name="ep", ports=[ContainerPort(name="http-serving", container_port=8000)])]
    assert serving_address(pod) is None
    pod.status.pod_ip = "10.1.2.3"
    assert serving_address(pod) == "http://10.1.2.3:8000"
    pod.spec.containers = pod.spec.containers[:1]
    assert serving_address(pod) is None


class MainEnv:
    """One side's SimCluster with sim agents and the manager its
    `build_manager` builds (culling on, a 1 s idle threshold)."""

    def __init__(self, side):
        self.side = side
        self.cluster = side.cluster.SimCluster().start()
        self.agents = {}
        self.cluster.add_pod_behavior(side.behavior(self.agents))
        side.add_pool(self.cluster, "pool", *side.slices["one-host"])
        self.config = side.ctrl.Config(readiness_probe_period_s=0.1, enable_culling=True,
                                       cull_idle_time_min=1.0 / 60.0, idleness_check_period_min=0.1 / 60.0,
                                       slo_enabled=False)
        self.mgr = MAINS[side.name].build_manager(self.cluster.store, self.config, http_get=self.cluster.http_get)
        self.mgr.start()
        self.client = self.cluster.client

    def stop(self):
        try:
            self.mgr.stop()
        finally:
            self.cluster.stop()

    def get(self, cls, name):
        return self.client.get(cls, NS, name)


def settled(read, quiet_s=0.5, timeout=30.0):
    """`read()` once it has returned the same value for `quiet_s` (the
    status converges in several writes, and a loaded machine spreads them
    out)."""
    deadline = time.monotonic() + timeout
    last, since = read(), time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.05)
        now = read()
        if now != last:
            last, since = now, time.monotonic()
        elif time.monotonic() - since >= quiet_s:
            return now
    raise AssertionError(f"never settled: last {last!r}")


def test_a_notebook_created_ready_culled_and_deleted_through_build_manager():
    """The operator both `build_manager`s wire, one notebook on a one-host
    slice: admitted with the lock, unlocked by the extension, mesh-ready,
    culled once its kernels are idle, deleted. Compared at mesh-ready and
    after the cull: its StatefulSet, both Services and its status (device
    fields mapped), its annotations' keys, the events' reasons; and what is
    left of it once deleted."""
    def scenario(env):
        side, C = env.side, env.side.C
        nb_cls, sts_cls, svc_cls = side.nb.Notebook, side.apps.StatefulSet, side.core.Service
        shape = side.plan(*side.slices["one-host"])
        nb = nb_cls()
        nb.metadata.name, nb.metadata.namespace = "nb", NS
        nb.spec.template.spec.containers = [side.core.Container(name="nb", image="img:1")]
        nb.spec.tpu = side.nb.TPUSpec(*side.slices["one-host"])
        created = env.client.create(nb)
        out = {"admitted": sorted(created.metadata.annotations),
               "locked": created.metadata.annotations.get(C.STOP_ANNOTATION) == C.RECONCILIATION_LOCK_VALUE}

        def snapshot():
            sts = canon_sts(side, env.get(sts_cls, "nb").to_dict(), shape)
            template = sts["spec"]["template"]["metadata"]["annotations"]
            assert template[C.TRACEPARENT_ANNOTATION] == created.metadata.annotations[C.TRACEPARENT_ANNOTATION]
            template[C.TRACEPARENT_ANNOTATION] = "the notebook's"  # random per run
            return {"statefulset": sts,
                    "service": canon_service(env.get(svc_cls, "nb").to_dict()),
                    "hosts service": canon_service(env.get(svc_cls, "nb-hosts").to_dict()),
                    "status": canon_status(side, env.get(nb_cls, "nb").status.to_dict(), shape),
                    "events": sorted({(e.involved_object.kind, e.reason)
                                      for e in env.client.list(side.core.Event, namespace=NS)})}

        wait_for(lambda: (n := env.get(nb_cls, "nb")).status.tpu and n.status.tpu.mesh_ready
                 and n.status.ready_replicas == shape.hosts, msg="mesh-ready")
        out["ready"] = settled(snapshot)
        for agent in env.agents.values():
            agent.kernels.set_idle(time.time() - 3600)
            agent.monitor.duty = 0.0
        wait_for(lambda: env.get(nb_cls, "nb").metadata.annotations.get(C.STOP_ANNOTATION, C.RECONCILIATION_LOCK_VALUE)
                 != C.RECONCILIATION_LOCK_VALUE, msg="culled")
        wait_for(lambda: env.get(sts_cls, "nb").spec.replicas == 0
                 and not env.client.list(side.core.Pod, namespace=NS), msg="scaled to 0")
        # the status converges in several writes: the gate's Stopped after the scale-down
        wait_for(lambda: (n := env.get(nb_cls, "nb")).status.ready_replicas == 0 and any(
            c.reason == "Stopped" for c in n.status.conditions) and not n.status.tpu.mesh_ready, msg="status at 0")
        out["culled"] = settled(lambda: dict(snapshot(), annotations=sorted(env.get(nb_cls, "nb").metadata.annotations)))
        env.client.delete(nb_cls, NS, "nb")
        wait_for(lambda: not env.client.list(nb_cls, namespace=NS) and not env.client.list(sts_cls, namespace=NS),
                 msg="deleted")
        out["left"] = sorted(s.metadata.name for s in env.client.list(svc_cls, namespace=NS))
        return out

    got = both_at_once(scenario, MainEnv, lambda env: env.stop(), sides=SIDES)
    assert got["jax"] == got["port"], got
    assert got["port"]["locked"] and got["port"]["left"] == []


@pytest.mark.parametrize("env", [{}, {"SLO_ENABLED": "false", "CANARY_PERIOD_S": "15"},
                                 {"SLO_ENABLED": "0", "CANARY_PERIOD_S": "-5"}])
def test_the_knobs_only_main_reads_follow_the_reference_env(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jax, port = (side.ctrl.Config.from_env() for side in SIDES)
    assert (jax.slo_enabled, jax.canary_period_s) == (port.slo_enabled, port.canary_period_s)


# ---------------------------------------------------------------------------
# the JAX suite's build_manager cases, on both packages
# ---------------------------------------------------------------------------

PROBE_RENAME = ("from odh_kubeflow_tpu_torch.probe import sim_agent_behavior",
                "from odh_kubeflow_tpu_torch.probe.behavior import sim_agent_behavior")
ONE_HOST = (('add_tpu_pool("v5e", "v5e", "2x2"', 'add_gpu_pool("h100", "h100", "1x4"'),
            ('TPUSpec(accelerator="v5e", topology="2x2"', 'TPUSpec(accelerator="h100", topology="1x4"'))
PORTED = {
    "test_coalesce": ((), ("test_build_manager_wires_coalescer_from_config",)),
    "test_slo": ((), ("test_canary_probe_full_roundtrip_and_cleanup",)),
    "test_suspend": ((PROBE_RENAME, ("from odh_kubeflow_tpu_torch.tpu import", "from odh_kubeflow_tpu_torch.gpu import"),
                      *ONE_HOST), ("test_reconciliation_lock_does_not_trigger_suspend",)),
    "test_tracing": ((PROBE_RENAME, *ONE_HOST), ("test_notebook_delete_closes_open_root",
                                                 "test_connected_readiness_trace_and_debug_endpoint")),
    # v5e 2x2 (one host of 4) ~ h100 1x4; v5p 2x2x4 (4 hosts of 4) ~ h100 4x4
    "test_probe_status": ((PROBE_RENAME,
                           ('add_tpu_pool("v5e", "v5e", "2x2", slices=2)', 'add_gpu_pool("v5e", "h100", "1x4", slices=2)'),
                           ('add_tpu_pool("v5p", "v5p", "2x2x4", slices=1)', 'add_gpu_pool("v5p", "h100", "4x4", slices=1)'),
                           ('def mk_nb(name, topology="2x2", accelerator="v5e")',
                            'def mk_nb(name, topology="1x4", accelerator="h100")'),
                           ('topology="2x2x4", accelerator="v5p"', 'topology="4x4", accelerator="h100"')),
                          ("test_partial_chip_visibility_blocks_mesh_ready", "test_multihost_gate_requires_every_host",
                           "test_chip_loss_after_ready_revokes_gate_but_keeps_first_ready",
                           "test_unreachable_probe_keeps_gate_closed", "test_mesh_ready_downgrades_after_host_loss")),
}
MODULES = {name: (torch_ported.load(name, "jax"), torch_ported.load(name, "port", renames=renames))
           for name, (renames, _) in PORTED.items()}


@pytest.mark.parametrize("case", [(name, case) for name, (_, cases) in PORTED.items() for case in cases],
                         ids=lambda c: f"{c[0]}::{c[1]}")
def test_build_manager_case_against_the_reference(case, tmp_path):
    name, case = case
    torch_ported.both(*MODULES[name], case, tmp_path)


# ---------------------------------------------------------------------------
# python -m odh_kubeflow_tpu_torch.main, as a process
# ---------------------------------------------------------------------------

MAIN_LIMIT_S = 60.0  # a shape's start, and its exit after SIGTERM


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("KUBECONFIG", "KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT")}
    return {**env, "PYTHONPATH": str(REPO), "LOG_FORMAT": "text", "JAX_PLATFORMS": "cpu", **extra}


def http(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def until(fn, msg, proc, limit=MAIN_LIMIT_S):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        assert proc.poll() is None, f"{msg}: the process exited {proc.returncode}"
        try:
            out = fn()
        except OSError:
            out = None
        if out:
            return out
        time.sleep(0.1)
    raise AssertionError(f"{msg}: not within {limit} s")


def started(proc, health):
    """Waits until `main()` has returned from the manager's start: /readyz
    answers 200 once it has, and its SIGTERM handler is set right after
    (a SIGTERM before that ends the process with the signal)."""
    until(lambda: http(f"http://127.0.0.1:{health}/readyz")[0] == 200, "readyz", proc)
    time.sleep(0.5)


def stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(MAIN_LIMIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_the_demo_shape_serves_its_mux_and_exits_on_sigterm(tmp_path):
    """No KUBECONFIG, no KUBERNETES_SERVICE_HOST: the port's operator boots
    its own SimCluster, serves /metrics and /debug on METRICS_PORT and
    /healthz, /readyz on HEALTH_PORT, and exits 0 on SIGTERM."""
    metrics, health = free_port(), free_port()
    log = open(tmp_path / "main.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "odh_kubeflow_tpu_torch.main"], cwd=str(tmp_path),
                            env=main_env(METRICS_PORT=str(metrics), HEALTH_PORT=str(health)),
                            stdout=log, stderr=subprocess.STDOUT)
    try:
        started(proc, health)
        assert http(f"http://127.0.0.1:{health}/healthz") == (200, b"ok\n")
        status, body = http(f"http://127.0.0.1:{metrics}/metrics")
        assert status == 200 and b"# TYPE notebook_create_total counter" in body
        status, body = http(f"http://127.0.0.1:{metrics}/debug")
        assert status == 200 and b"/debug/reconciles" in body
        status, body = http(f"http://127.0.0.1:{metrics}/debug/slo")
        assert status == 200 and json.loads(body)["engine"]["slos"] is not None
        assert http(f"http://127.0.0.1:{metrics}/debug/traces?limit=x")[0] == 400
    finally:
        rc = stop(proc)
        log.close()
    assert rc == 0, (tmp_path / "main.log").read_text()[-3000:]


def remote_run(side, tmp_path):
    """`python -m <package>.main` in the remote shape: a store with one CPU
    node's worth of nothing (the manager only renders), a TLS ApiServer in
    front of it with a MutatingWebhookConfiguration pointing at the
    process's own HTTPS webhook, KUBECONFIG at it; a Notebook created over
    the wire. Returns the admitted notebook's annotation keys, whether it
    carries the lock, and its StatefulSet's spec as rendered."""
    from types import SimpleNamespace

    pkg = "odh_kubeflow_tpu" if side.name == "jax" else "odh_kubeflow_tpu_torch"
    cluster, admission, certs = (__import__(f"{pkg}.{m}", fromlist=["x"])
                                 for m in ("cluster", "api.admission", "utils.certs"))
    store = cluster.Store()
    pki = tmp_path / f"{side.name}-pki"
    ca, crt, key = certs.generate_cert_dir(str(pki))
    api = cluster.ApiServer(store, bearer_token="t", certfile=crt, keyfile=key,
                            admission=cluster.WebhookDispatcher(store)).start()
    port = free_port()
    cfg = admission.MutatingWebhookConfiguration()
    cfg.metadata.name = "notebook-mutator"
    cfg.webhooks = [admission.MutatingWebhook(
        name="notebooks.kubeflow.org", failure_policy="Fail",
        client_config=admission.WebhookClientConfig(url=f"https://127.0.0.1:{port}/mutate-notebook-v1",
                                                    ca_bundle=base64.b64encode(Path(ca).read_bytes()).decode()),
        rules=[admission.RuleWithOperations(operations=["CREATE", "UPDATE"], api_groups=["kubeflow.org"],
                                            api_versions=["*"], resources=["notebooks"])])]
    cluster.Client(store).create(cfg)
    kubeconfig = tmp_path / f"{side.name}-kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {"server": api.base_url, "certificate-authority": ca}}],
        "users": [{"name": "u", "user": {"token": "t"}}]}))
    log = open(tmp_path / f"{side.name}-main.log", "w")
    health = free_port()
    proc = subprocess.Popen([sys.executable, "-m", f"{pkg}.main"], cwd=str(tmp_path),
                            env=main_env(KUBECONFIG=str(kubeconfig), WEBHOOK_CERT_DIR=str(pki),
                                         WEBHOOK_PORT=str(port), METRICS_PORT=str(free_port()),
                                         HEALTH_PORT=str(health)),
                            stdout=log, stderr=subprocess.STDOUT)
    try:
        remote = cluster.RemoteStore(api.base_url, token="t", ca_file=ca, timeout=10, qps=0)
        client = cluster.Client(remote)
        until(lambda: socket.create_connection(("127.0.0.1", port), timeout=1).close() or True,
              "the process's webhook listening", proc)
        nb = side.nb.Notebook()
        nb.metadata.name, nb.metadata.namespace = "wired", NS
        nb.spec.template.spec.containers = [side.core.Container(name="wired", image="img:1")]
        created = client.create(nb)
        sts = until(lambda: next(iter(client.list(side.apps.StatefulSet, namespace=NS)), None),
                    "the StatefulSet rendered over the wire", proc)
        rendered = canon_sts(side, sts.to_dict(), None)
        # the pods carry the notebook's readiness traceparent (random per run)
        template = rendered["spec"]["template"]["metadata"].get("annotations", {})
        traceparent = side.C.TRACEPARENT_ANNOTATION
        assert template.get(traceparent) == created.metadata.annotations.get(traceparent), template
        template[traceparent] = "the notebook's"
        out = SimpleNamespace(annotations=sorted(created.metadata.annotations),
                              locked=created.metadata.annotations.get(side.C.STOP_ANNOTATION)
                              == side.C.RECONCILIATION_LOCK_VALUE, sts=rendered)
        started(proc, health)
    finally:
        rc = stop(proc)
        log.close()
        api.stop()
    assert rc == 0, (tmp_path / f"{side.name}-main.log").read_text()[-3000:]
    return out


def test_the_remote_shape_admits_over_https_and_renders_as_the_reference(tmp_path):
    """KUBECONFIG at a TLS ApiServer and WEBHOOK_CERT_DIR with tls.crt:
    the process serves its HTTPS webhook, the ApiServer calls it for a
    Notebook written over the wire (the lock stamped), and its manager,
    on a RemoteStore, renders the StatefulSet; the same as the JAX
    package's `main` run the same way, and both exit 0 on SIGTERM."""
    jax, port = (remote_run(side, tmp_path) for side in SIDES)
    assert port.locked and jax.locked
    assert port.annotations == jax.annotations
    assert port.sts == jax.sts


def test_the_deployed_shape_without_certs_fails(tmp_path):
    """KUBERNETES_SERVICE_HOST set (in a pod, its ServiceAccount's token and
    CA mounted) with no serving certs at WEBHOOK_CERT_DIR: the process
    exits non-zero, naming the missing certs, rather than run without its
    admission webhook."""
    sa = tmp_path / "sa"
    sa.mkdir()
    (sa / "token").write_text("t")
    from odh_kubeflow_tpu_torch.utils.certs import generate_cert_dir

    ca, _, _ = generate_cert_dir(str(tmp_path / "pki"))
    (sa / "ca.crt").write_bytes(Path(ca).read_bytes())
    boot = ("import odh_kubeflow_tpu_torch.cluster.remote as remote, odh_kubeflow_tpu_torch.main as main; "
            f"remote.RemoteStore.SERVICEACCOUNT_DIR = {str(sa)!r}; main.main()")
    proc = subprocess.run([sys.executable, "-c", boot], cwd=str(tmp_path),
                          env=main_env(KUBERNETES_SERVICE_HOST="127.0.0.1", KUBERNETES_SERVICE_PORT="1",
                                       WEBHOOK_CERT_DIR=str(tmp_path / "no-certs"),
                                       METRICS_PORT=str(free_port()), HEALTH_PORT=str(free_port())),
                          capture_output=True, text=True, timeout=MAIN_LIMIT_S)
    assert proc.returncode != 0 and "webhook serving certs missing" in proc.stderr, \
        proc.stdout[-2000:] + proc.stderr[-2000:]
