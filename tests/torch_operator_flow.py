"""The port's operator driving notebook pods that are real processes
(`probe.behavior.pod_process_behavior`): the one flow of
tests/test_torch_operator_process.py (the CPU), tests/test_torch_cuda.py and
chip_smoke.py's phase 15 (the card). Imports no jax.

One card: a SimCluster with one h100 1x1 node, its store's admission chain
running the port's NotebookWebhook (as the JAX `build_manager` registers it
for an in-process store) and the Manager running the workbench extension
beside the reconciler, the gate and the culler. First a Notebook whose slice
`gpu.plan_slice` cannot plan is denied at admission: nothing is stored and
no pod starts. The notebooks of a wave are created at once; admission
stamps each with the reconciliation lock and the traceparent of its
`notebook.ready` root; the extension makes its HTTPRoute and
NetworkPolicies and lifts the lock; one binds (the scheduler takes them in
no fixed order) and the others stay Pending, their FailedScheduling
mirrored onto the notebook. Each bound pod's `torchrun` runs the caller's
worker from the env the reconciler rendered; the readiness gate opens and
closes the root; once the worker has written its result, its kernel is
idle, the culler stops the notebook, the stop terminates the pod's
processes, the next notebook binds on the freed card, and the culled one is
deleted, its route and policies with it. The next wave starts once the last
of a wave is culled.
"""
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch_dist
from odh_kubeflow_tpu_torch.api.apps import StatefulSet
from odh_kubeflow_tpu_torch.api.core import Container, Event, Pod
from odh_kubeflow_tpu_torch.api.gateway import HTTPRoute
from odh_kubeflow_tpu_torch.api.networking import NetworkPolicy
from odh_kubeflow_tpu_torch.api.notebook import Notebook, TPUSpec
from odh_kubeflow_tpu_torch.apimachinery import AdmissionDeniedError, NotFoundError
from odh_kubeflow_tpu_torch.cluster import SimCluster
from odh_kubeflow_tpu_torch.controllers import (
    Config,
    CullingReconciler,
    EventMirrorController,
    NotebookReconciler,
    NotebookWebhook,
    ProbeStatusController,
    TPUWorkbenchReconciler,
    constants as C,
)
from odh_kubeflow_tpu_torch.controllers.extension import route_name
from odh_kubeflow_tpu_torch.gpu import GPU_RESOURCE
from odh_kubeflow_tpu_torch.probe.behavior import pod_process_behavior
from odh_kubeflow_tpu_torch.runtime import Manager
from odh_kubeflow_tpu_torch.utils import tracing
from odh_kubeflow_tpu_torch.utils.flightrecorder import recorder

REPO = Path(__file__).resolve().parent.parent
WORKER = str(REPO / "tests" / "torch_pod_worker.py")
NS = "user"
CFG = dict(readiness_probe_period_s=0.2, enable_culling=True,
           cull_idle_time_min=1.0 / 60.0,  # 1 s idle
           idleness_check_period_min=0.2 / 60.0)
DENIED = ("nb-denied", "h100", "3x5")  # a notebook whose slice the planner refuses: 5 cards a host


def pod_worker(device):
    """The container command of tests/torch_pod_worker.py on `device`."""
    return lambda out_dir: [sys.executable, "-m", "torch.distributed.run", WORKER, device, str(out_dir)]


def wait_for(fn, timeout, msg):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            out = fn()
            if out:
                return out
            last = out
        except AssertionError:
            raise
        except Exception as e:  # NotFound while the objects appear
            last = e
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg() if callable(msg) else msg}: last={last!r}")


def result(out_dir):
    """The worker's rank-0.json, once it is written."""
    path = Path(out_dir) / "rank-0.json"
    return json.loads(path.read_text()) if path.exists() else None


def compute_app_pids():
    """The pids nvidia-smi lists as holding a CUDA context on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return sorted(int(line) for line in out.split() if line.strip().isdigit())


def card_released():
    """A `released` for run(): nvidia-smi lists none of the pod's pids, and
    the card's compute apps are those from before this call."""
    before = compute_app_pids()

    def released(pids):
        apps = compute_app_pids()
        return not set(apps) & set(pids) and apps == before

    return released


def alive(pids):
    return [p for p in pids if Path(f"/proc/{p}").exists()
            and Path(f"/proc/{p}/stat").read_text().rsplit(")", 1)[-1].split()[0] != "Z"]


def run(tmp_path, command, monitor, waves=(("nb-0", "nb-1"),), cfg=CFG, env=None, grace_s=15.0, timeout=120.0,
        released=lambda pids: True, while_serving=lambda: None, card_state=lambda: None):
    """Drives the flow; returns what it saw.

    `command(out_dir) -> argv` is the container's command. Its worker writes
    out_dir/rank-0.json whole with "pid", "env", "world", "device" and
    "times": {"context": its CUDA context (or the CPU tensor), "done": its
    work finished, epoch seconds}; the notebook's kernel is busy until
    then. `monitor(pod, chips, processes)` builds the agents' device view.
    `env` is the pods' base env (torch_dist.clean_env() with one OMP
    thread by default). `released(pids)` is what else must hold, after a
    culled pod's processes are stopped, before its card counts as free;
    `while_serving()` is read once a worker has served; `card_state()` is
    read before and after the denied notebook's admission. Each wait lasts
    at most `timeout` seconds."""
    out_root, log_dir = Path(tmp_path) / "out", Path(tmp_path) / "logs"
    log_dir.mkdir(parents=True)
    if env is None:
        env = dict(torch_dist.clean_env(), OMP_NUM_THREADS="1")
    processes = {}

    def out_dir(name):
        d = out_root / name
        d.mkdir(parents=True, exist_ok=True)
        return d

    def idle_since(pod):
        got = result(out_dir(pod.metadata.labels[C.NOTEBOOK_NAME_LABEL]))
        return got["times"]["done"] if got else None

    cluster = SimCluster().start()
    config = Config(**cfg)
    mgr = Manager(cluster.store)
    timeline = None
    try:
        cluster.add_pod_behavior(pod_process_behavior(
            lambda pod: command(out_dir(pod.metadata.labels[C.NOTEBOOK_NAME_LABEL])), str(log_dir),
            env=env, cwd=str(REPO), monitor=monitor, idle_since=idle_since, grace_s=grace_s,
            processes=processes))
        cluster.add_gpu_pool("h100", "h100", "1x1")
        NotebookWebhook(mgr.client, config).register(cluster.store)
        NotebookReconciler(mgr, config).setup()
        EventMirrorController(mgr).setup()
        TPUWorkbenchReconciler(mgr, config).setup()
        ProbeStatusController(mgr, config, http_get=cluster.http_get).setup()
        CullingReconciler(mgr, config, http_get=cluster.http_get).setup()
        mgr.start()
        timeline = Timeline(cluster.store)

        def logs():
            return "\n".join(f"--- {p.name}\n{p.read_text()[-3000:]}" for p in sorted(log_dir.glob("*.log")))

        def wait(fn, msg):
            return wait_for(fn, timeout, lambda: f"{msg}\n{logs()}")

        def notebook(name):
            return cluster.client.get(Notebook, NS, name)

        def pod(name):
            return cluster.client.get(Pod, NS, f"{name}-0")

        def mirrored_failure(name):
            return next((e.message for e in cluster.client.list(Event, namespace=NS)
                         if e.involved_object.kind == "Notebook" and e.involved_object.name == name
                         and e.reason == "FailedScheduling"), None)

        def new_notebook(name, accelerator="h100", topology=""):
            nb = Notebook()
            nb.metadata.name, nb.metadata.namespace = name, NS
            nb.spec.template.spec.containers = [Container(name=name, image="workbench")]
            nb.spec.tpu = TPUSpec(accelerator=accelerator, topology=topology)
            return nb

        def owned_by(name):
            """What exists of a notebook, as kind/name: itself, its set, its
            pods, its policies and its route."""
            out = [f"{cls.__name__}/{name}" for cls in (Notebook, StatefulSet)
                   if any(o.metadata.name == name for o in cluster.client.list(cls, namespace=NS))]
            out += [f"Pod/{p.metadata.name}" for p in cluster.client.list(Pod, namespace=NS,
                                                                          labels={C.NOTEBOOK_NAME_LABEL: name})]
            out += [f"NetworkPolicy/{n.metadata.name}" for n in cluster.client.list(NetworkPolicy, namespace=NS)
                    if n.metadata.name.startswith(f"{name}-")]
            nb = Notebook()
            nb.metadata.name, nb.metadata.namespace = name, NS
            try:
                route = cluster.client.get(HTTPRoute, config.controller_namespace, route_name(nb))
                out.append(f"HTTPRoute/{route.metadata.name}")
            except NotFoundError:
                pass
            return out

        seen = {"turns": [], "gate period": config.readiness_probe_period_s}
        name, accelerator, topology = DENIED
        state = card_state()
        try:
            cluster.client.create(new_notebook(name, accelerator, topology))
            raise AssertionError(f"{name}'s slice {accelerator} {topology} was admitted")
        except AdmissionDeniedError as e:
            seen["denied"] = {"name": name, "error": str(e), "left": owned_by(name),
                              "card": (state, card_state())}
        for wave in waves:
            for name in wave:
                seen[name] = {"created": time.time()}
                created = cluster.client.create(new_notebook(name))
                seen[name]["admitted"] = dict(created.metadata.annotations)
            # the scheduler takes a wave's pods in no fixed order: the first bound holds the card
            first = wait(lambda: next((n for n in wave if pod(n).spec.node_name), None), f"a pod of {wave} bound")
            wave = (first,) + tuple(n for n in wave if n != first)
            seen["turns"] += wave
            for i, name in enumerate(wave):
                got = seen[name]
                wait(lambda: pod(name).spec.node_name, f"{name} bound")
                for other in wave[i + 1:]:  # Pending on the one card, its FailedScheduling mirrored
                    message = wait(lambda: mirrored_failure(other), f"{other}'s FailedScheduling on the notebook")
                    assert GPU_RESOURCE in message, message
                    seen[other].setdefault("pending", message)
                container = cluster.client.get(StatefulSet, NS, name).spec.template.spec.containers[0]
                got["set"] = {"requests": dict(container.resources.requests), "env": container.env_dict()}

                def served():
                    procs = processes.get(f"{name}-0")
                    done = result(out_dir(name))
                    assert done or procs is None or procs.running(), \
                        f"{name}'s torchrun exited {procs.proc.returncode}\n{logs()}"
                    return done

                got["result"] = wait(served, f"{name}'s worker")
                got["while running"] = owned_by(name)
                # the agent's readiness edges, as its device view saw them
                got["agent ready"] = [r["ready"] for r in recorder.records("probe-agent")
                                      if r.get("pod") == f"{NS}/{name}-0"]
                got["serving"] = while_serving()
                wait(lambda: notebook(name).metadata.annotations.get(C.STOP_ANNOTATION, C.RECONCILIATION_LOCK_VALUE)
                     != C.RECONCILIATION_LOCK_VALUE, f"{name} culled")
                wait(lambda: cluster.client.get(StatefulSet, NS, name).spec.replicas == 0, f"{name}'s set at 0")
                wait(lambda: not cluster.client.list(Pod, namespace=NS, labels={C.NOTEBOOK_NAME_LABEL: name}),
                     f"{name}'s pod deleted")
                procs = processes[f"{name}-0"]
                got["pids"] = sorted(set(procs.pids) | {got["result"]["pid"]})
                wait(lambda: procs.closed and not alive(got["pids"]) and released(got["pids"]),
                     f"{name}'s processes {got['pids']} gone and its card released")
                got["free"] = time.time()
                got["alive"] = alive(got["pids"])
                got["culls"] = [r for r in recorder.records("transition")
                                if r.get("machine") == "culling" and r.get("notebook") == f"{NS}/{name}"]
                for what in ("unlocked", "bound", "mesh-ready", "stopped"):
                    got[what] = wait(lambda: timeline.get(f"{name} {what}"), f"the watches to see {name} {what}")
                got["status"] = timeline.ready_status[name]
                trace_id = (tracing.parse_traceparent(got["admitted"].get(C.TRACEPARENT_ANNOTATION)) or ("",))[0]
                got["root"] = tracing.recent_spans(trace_id=trace_id, name="notebook.ready")
                cluster.client.delete(Notebook, NS, name)
                wait(lambda: not owned_by(name), f"{name} deleted, its route and policies with it")
        seen["denied"]["left at the end"] = owned_by(seen["denied"]["name"])
        return seen
    finally:
        if timeline is not None:
            timeline.stop()
        mgr.stop()
        cluster.stop()


class Timeline:
    """Store watches on Pods and Notebooks: when (this process's clock at
    the event's arrival) and at which resourceVersion (one counter for the
    whole store) each notebook's pod was first bound, and each notebook
    first went without its reconciliation lock, was first mesh-ready (and
    its status.tpu then) and first stopped."""

    def __init__(self, store):
        self._watches = [store.watch("v1", "Pod"), store.watch("kubeflow.org/v1beta1", "Notebook")]
        self._done = threading.Event()
        self._lock = threading.Lock()
        self.first = {}  # "<notebook> bound|mesh-ready|stopped" -> (time, rv)
        self.ready_status = {}  # notebook -> status.tpu's JSON when first mesh-ready
        self._threads = [threading.Thread(target=self._run, args=(w,), daemon=True) for w in self._watches]
        for t in self._threads:
            t.start()

    def _note(self, ev):
        obj, now = ev.object, time.time()
        meta = obj.get("metadata", {})
        keys, tpu = [], (obj.get("status") or {}).get("tpu") or {}
        if obj.get("kind") == "Pod" and obj.get("spec", {}).get("nodeName"):
            keys.append(f"{(meta.get('labels') or {}).get(C.NOTEBOOK_NAME_LABEL)} bound")
        if obj.get("kind") == "Notebook":
            if (meta.get("annotations") or {}).get(C.STOP_ANNOTATION) != C.RECONCILIATION_LOCK_VALUE:
                keys.append(f"{meta.get('name')} unlocked")
            if tpu.get("meshReady"):
                keys.append(f"{meta.get('name')} mesh-ready")
            if (meta.get("annotations") or {}).get(C.STOP_ANNOTATION, C.RECONCILIATION_LOCK_VALUE) \
                    != C.RECONCILIATION_LOCK_VALUE:  # the admission's lock is no stop
                keys.append(f"{meta.get('name')} stopped")
        with self._lock:
            for key in keys:
                self.first.setdefault(key, (now, int(meta.get("resourceVersion", 0))))
            if tpu.get("meshReady"):
                self.ready_status.setdefault(meta.get("name"), tpu)

    def _run(self, watch):
        for ev in watch.pending:
            self._note(ev)
        while not self._done.is_set():
            ev = watch.get(timeout=0.05)
            if ev is not None:
                self._note(ev)

    def get(self, key):
        with self._lock:
            return self.first.get(key)

    def stop(self):
        self._done.set()
        for t in self._threads:
            t.join()
        for w in self._watches:
            w.stop()


def root_lag(got):
    """The `notebook.ready` root's end (the gate's first mesh-ready) against
    the watch event that brought status.tpu meshReady, in seconds."""
    return got["mesh-ready"][0] - got["root"][0]["end_time"]


def check(seen, device, chips_expected=1, gate_waits=False):
    """The assertions every caller makes on run()'s result. `gate_waits`:
    each pod's agent first reported not ready, then ready (its device view
    follows the pod's processes, not this process), and no pod was
    mesh-ready before its worker's CUDA context, less one gate period."""
    period = seen["gate period"]
    denied = seen["denied"]
    assert denied["error"].startswith("spec.tpu invalid: "), denied
    assert denied["left"] == denied["left at the end"] == [], denied
    assert denied["card"][0] == denied["card"][1], denied
    turns = seen["turns"]
    for name in turns:
        got = seen[name]
        # admission: the lock and the readiness root's traceparent; the
        # extension lifted the lock before the pod was bound
        assert got["admitted"][C.STOP_ANNOTATION] == C.RECONCILIATION_LOCK_VALUE, got["admitted"]
        assert tracing.parse_traceparent(got["admitted"].get(C.TRACEPARENT_ANNOTATION)), got["admitted"]
        assert got["unlocked"][1] < got["bound"][1], (got["unlocked"], got["bound"])
        assert {f"NetworkPolicy/{name}-ctrl-np", f"HTTPRoute/nb-{NS}-{name}"} <= set(got["while running"]), \
            got["while running"]
        # the root opened at admission, closed by the gate at mesh-ready
        assert len(got["root"]) == 1 and got["root"][0]["start_time"] <= got["mesh-ready"][0], got["root"]
        assert 0 <= root_lag(got) <= period, (root_lag(got), got["root"])
        if gate_waits:
            assert got["mesh-ready"][0] >= got["result"]["times"]["context"] - period, \
                (name, got["mesh-ready"][0] - got["result"]["times"]["context"])
        assert got["set"]["requests"] == {GPU_RESOURCE: "1"}
        env = got["set"]["env"]
        assert env["PET_STANDALONE"] == "1" and env["PET_NPROC_PER_NODE"] == "1"
        run = got["result"]
        # the worker saw the env as the reconciler rendered it
        for key in ("PET_STANDALONE", "PET_NPROC_PER_NODE", "NB_TPU_CHIPS_EXPECTED"):
            assert run["env"][key] == env[key], (key, run["env"])
        assert run["env"]["NB_TPU_CHIPS_EXPECTED"] == str(chips_expected)
        assert run["world"] == [0, 1] and run["device"].startswith(device)
        status = got["status"]
        assert status.get("firstReadyTime") and status["chipsVisible"] == status["chipsExpected"] == chips_expected, \
            status
        assert got["culls"], f"{name}'s stop annotation did not come from the culler"
        if gate_waits:
            assert got["agent ready"][:1] == [False] and True in got["agent ready"], got["agent ready"]
        assert got["alive"] == [], got
    # each took the card in turn: bound, stopped, and only then the next bound
    order = [seen[n][k][1] for n in turns for k in ("bound", "stopped")]
    assert order == sorted(order), dict(zip([f"{n} {k}" for n in turns for k in ("bound", "stopped")], order))
