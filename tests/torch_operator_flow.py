"""The port's operator driving notebook pods that are real processes
(`probe.behavior.pod_process_behavior`): the one flow of
tests/test_torch_operator_process.py (the CPU), tests/test_torch_cuda.py and
chip_smoke.py's phase 15 (the card). Imports no jax.

One card: a SimCluster with one h100 1x1 node, a TLS ApiServer in front of
its store whose admission calls the port's NotebookWebhook over HTTPS (the
deployed shape), and the Manager the port's `main.build_manager` builds,
running the workbench extension beside the reconciler, the gate and the
culler, its debug mux served, its webhook in the store's admission chain.
First a Notebook whose slice `gpu.plan_slice` cannot plan is written over
the wire and denied at admission over HTTPS: nothing is stored and no pod
starts. The notebooks of a wave are created at once; admission
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

The manager also runs the SliceRepairController. With `repair` set to a
notebook, a second h100 1x1 node in a pool of its own joins before that
notebook's wave (both nodes stand for the one card, and the contention of
the earlier waves is kept), and once that notebook's worker has written its
first result, its node is preempted: the repair opens Degraded
(HostPreempted), drives the pod's /tpu/checkpoint (forwarded to the
worker, `probe.behavior.forward_checkpoint`), writes `checkpoint-saved`,
evicts the pod, whose processes stop before its object goes (the kubelet's
graceful deletion), and the replacement pod binds on the other pool's node,
restores the notebook's checkpoint and takes the next step. Each pod's
directory is <notebook>/<pod uid> under the run's directory (a replacement
pod keeps its predecessor's name); <notebook>/checkpoints is the notebook's
volume.

With `resume` (or `promotion`) as well, the repaired notebook's replacement
stays busy after its step, and the flow then suspends it through the
SuspendResumeController: suspend is enabled in that controller (off until
then, so the waves' culls tear down), the notebook is stopped with the
culler's stamp (the stop and checkpointing in one patch), the controller
drives the pod's
/tpu/checkpoint (forwarded to the worker, which saves the resumed step),
writes suspended with the save's step and checksum, and releases the pod's
pool warm at the notebook's priority; its pods and their processes go.

With `promotion`, the suspended notebook is then promoted into an
InferenceEndpoint: the endpoint is created with
`spec.notebookRef` naming it and serving its checkpoint directory, the
InferenceEndpointReconciler claims the released pool (a warm bind), the
endpoint's pod runs the serving process (`python -m
odh_kubeflow_tpu_torch.serving`, its control directory the pod's own),
whose agent is ready once it has restored the checkpoint and listens, the
restore is verified through the forwarded /tpu/restore, the requests are
served over HTTP, and the endpoint's stop drains it route first and
terminates it, its card free and its pool warm again.

With `job` (a `Job`), once the waves are done a TPUJob runs on the same
cluster: the TPUJobReconciler secures its gang's slice (a warm claim, or a
free slice parked and claimed), its learner pod's `torchrun` runs the
worker in its "job" mode (tests/torch_pod_worker.py `job_run`), Running
once the gate has the pod ready, the cadence checkpoints go through the
forwarded /tpu/checkpoint; after the first acked one the flow stamps
`preempt-requested: user`, the job checkpoints, parks Preempted with its
slice warm at its priority, requeues, claims the slice warm again, and the
new pod restores the acked step and trains on to `spec.steps`; the job
Succeeds, its set goes to 0 and its card is free.

With `resume` and `job`, the job runs right after the suspended notebook's
episodes (before the notebook is deleted), and instead of the user's stamp
the notebook's resume preempts it. The repair's preempted node stays
tainted, so once the job holds the other pool's node no h100 1x1 node is
free. The flow unstops the notebook: the resume's warm claim misses, its
pod sits unschedulable, and past `reclaim_pending_grace_s` the reclaimer
stamps the job, the lowest priority (`capacity-pressure:`, cause
`reclaim`); the job checkpoints and returns its slice to general capacity;
the notebook's pod binds there, its worker restores the suspended step,
reports it and answers the forwarded /tpu/restore, the gate opens, the
resume completes with the restore verified, and the worker takes the next
step. The flow then stops the notebook again: it suspends (the forwarded
save of that step) and releases its slice warm, which the requeued job
claims, restoring its acked step and running to Succeeded. With a cfg whose
`accounting_period_s` is above 0, a ChipAccountant built from the Config
runs in the manager over the whole flow (`runtime.accounting.set_current`
too, so incident bundles carry its ledger).

Over every flow the manager also runs the judgement layer (`Judgement`):
the SLO engine and the burn-rate alerts at the reference's bad-day window
scale, mirroring onto the notebooks, and a canary notebook probed on a CPU
node before the first wave and at the end. With a `Promotion` whose
`idle_s` is set and a cfg's `autoscale_period_s`, the endpoint is
parked to zero by the ReplicaAutoscaler once its requests are served, and
a TokenRouter over it with no live replica sheds the next requests and
fires its cold wake; the woken gang takes the parked slice back, its
serving process restores and is verified again, joins the router, and the
shed requests are served through it; then the stop (`park_and_wake`).
"""
import collections
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Sequence, Tuple

import torch_dist
import torch_pod_worker
import odh_kubeflow_tpu_torch.cluster.slicepool as slicepool
import odh_kubeflow_tpu_torch.runtime.accounting as accounting
import odh_kubeflow_tpu_torch.runtime.jobmetrics as jobmetrics
from odh_kubeflow_tpu_torch.api.apps import StatefulSet
from odh_kubeflow_tpu_torch.api.core import Container, EnvVar, Event, Node, Pod
from odh_kubeflow_tpu_torch.api.gateway import HTTPRoute
from odh_kubeflow_tpu_torch.api.inference import AutoscalingSpec, InferenceEndpoint, NotebookRef, ServingSpec
from odh_kubeflow_tpu_torch.api.job import TPUJob
from odh_kubeflow_tpu_torch.api.networking import NetworkPolicy
from odh_kubeflow_tpu_torch.api.notebook import Notebook, TPUSpec
import odh_kubeflow_tpu_torch.apimachinery as apimachinery
from odh_kubeflow_tpu_torch.apimachinery import AdmissionDeniedError, NotFoundError
from odh_kubeflow_tpu_torch.cluster import Client, SimCluster
from odh_kubeflow_tpu_torch.cluster.remote_fixture import build_remote_stack
from odh_kubeflow_tpu_torch import telemetry
from odh_kubeflow_tpu_torch.controllers import (
    Config,
    SliceRepairController,
    SuspendResumeController,
    constants as C,
)
from odh_kubeflow_tpu_torch.controllers.job import job_priority
from odh_kubeflow_tpu_torch.controllers.extension import route_name
from odh_kubeflow_tpu_torch.controllers.inference import endpoint_route_name
from odh_kubeflow_tpu_torch.gpu import GPU_RESOURCE
from odh_kubeflow_tpu_torch.gpu import GKE_NODEPOOL_LABEL
from odh_kubeflow_tpu_torch.utils import deployguard
from odh_kubeflow_tpu_torch.probe.behavior import (
    SERVING_EXIT,
    forward_checkpoint,
    forward_restore,
    pod_process_behavior,
    read_json,
    serving_ready,
)
from odh_kubeflow_tpu_torch.probe.agent import SimTPUMonitor
from odh_kubeflow_tpu_torch.cluster.kubelet import PodDecision
from odh_kubeflow_tpu_torch.runtime import metrics as runtime_metrics
from odh_kubeflow_tpu_torch.runtime.alerts import slo_alerts_inhibited_total
from odh_kubeflow_tpu_torch.main import build_manager
from odh_kubeflow_tpu_torch.runtime import cpprofile
from odh_kubeflow_tpu_torch.runtime.autoscaler import read_replica_stats, serving_address
from odh_kubeflow_tpu_torch.runtime.prober import canary_probes_total
from odh_kubeflow_tpu_torch.runtime.slo import default_slos, slo_evaluations_total
from odh_kubeflow_tpu_torch.serving import metrics as serving_metrics
from odh_kubeflow_tpu_torch.serving.engine import QueueFull, RequestHandle
from odh_kubeflow_tpu_torch.serving.router import TokenRouter
from odh_kubeflow_tpu_torch.utils import tracing
from odh_kubeflow_tpu_torch.runtime.flightrecorder import recorder

REPO = Path(__file__).resolve().parent.parent
WORKER = str(REPO / "tests" / "torch_pod_worker.py")
NS = "user"
CFG = dict(readiness_probe_period_s=0.2, enable_culling=True,
           cull_idle_time_min=1.0 / 60.0,  # 1 s idle
           idleness_check_period_min=0.2 / 60.0)
# the repair's knob under every cfg: a window the save fits in (the backoff
# and attempts are Config's defaults)
REPAIR_CFG = dict(checkpoint_window_s=30.0)
# the endpoint's knobs under every cfg: Loading's window holds the serving
# process's start, its restore and its bind; the drain window is short
PROMOTION_CFG = dict(serving_loading_window_s=120.0)
# the job's knobs under every cfg: a checkpoint window the card's save fits
# in (the reconciler's probe gives up after 2 s and re-probes, joining the
# save under way), and a short requeue backoff
JOB_CFG = dict(job_checkpoint_window_s=20.0, job_requeue_backoff_s=0.5)
# the accountant is off unless a cfg sets its period (Config's 0 = off)
ACCOUNTING_CFG = dict(accounting_period_s=0.0)
DENIED = ("nb-denied", "h100", "3x5")  # a notebook whose slice the planner refuses: 5 cards a host
OTHER_POOL = "h100-b"  # the repair's fallback pool
RESTORE_DEADLINE_S = 1.5  # the forwarded /tpu/restore's wait: under the reconciler's 2 s probe timeout
# the suspend's knobs under every cfg (suspend itself is enabled in its
# controller only for the suspend episode): a checkpoint window the card's
# save fits in with Config's retries, and a card budget that admits the
# resumed notebook and the job together and nothing more
RESUME_CFG = dict(suspend_checkpoint_window_s=15.0, chip_budget=2)
# the judgement layer's knob under every cfg: the reference's bad-day scale
# of the burn windows (5m -> 0.6 s, 1h -> 7.2 s, 6h -> 43.2 s); the
# replica autoscaler is off unless a cfg sets its period (Config's 0 = off)
# the prober's loop period: longer than any flow (the flow probes by hand)
JUDGEMENT_CFG = dict(slo_window_scale=0.002, canary_period_s=86400.0)
AVAILABILITY_PAGE = "notebook-availability-fast-burn"


@dataclass
class Promotion:
    """The promotion episode's inputs (run(promotion=...)): the endpoint's
    name, its serving process's model config (SERVING_MODEL_CONFIG's
    fields) and device, the requests it serves ((prompt, max_new) each, all
    at once), its engine's slots and max_seq, its drain window, and its
    container's command. With `idle_s`, the endpoint is created with
    `autoscaling {minReplicas 1, maxReplicas 1, scaleToZero true,
    scaleToZeroIdleS idle_s}` and, after its requests, parked to zero by
    the ReplicaAutoscaler (a cfg's `autoscale_period_s` above 0) and woken
    by a TokenRouter's cold wake (`park_and_wake`)."""

    model_config: dict
    device: str
    requests: List[Tuple[List[int], int]]
    slots: int = 8
    max_seq: int = 512
    drain_s: float = 1.0
    name: str = "ep-0"
    command: Sequence[str] = field(default_factory=lambda: [sys.executable, "-m", "odh_kubeflow_tpu_torch.serving"])
    idle_s: float = 0.0


class HttpReplica:
    """An engine-like backend of the TokenRouter (submit/stats/cancel) over
    a serving process's HTTP front: `submit` posts /generate from a thread
    and returns a RequestHandle that completes with the reply (its tokens,
    the engine's `ttft_s` and result; a 429 or 503 reply is not "ok", which
    the router retries), `stats` reads /stats."""

    def __init__(self, url, timeout):
        self.url, self.timeout = url, timeout
        self._ids = itertools.count()

    def stats(self):
        return read_replica_stats(self.url, self.timeout)

    def submit(self, prompt, max_new, traceparent=None):
        handle = RequestHandle(id=next(self._ids), prompt=list(prompt), max_new=max_new, submitted=time.time(),
                               traceparent=traceparent)

        def post():
            body = json.dumps({"prompt": list(prompt), "max_new": max_new}).encode()
            headers = {"Content-Type": "application/json", **({"traceparent": traceparent} if traceparent else {})}
            try:
                with urllib.request.urlopen(urllib.request.Request(f"{self.url}/generate", data=body, headers=headers),
                                            timeout=self.timeout) as r:
                    reply = json.loads(r.read())
                handle.tokens, handle.ttft_s, handle.result = reply["tokens"], reply["ttft_s"], reply["result"]
            except urllib.error.HTTPError as e:
                handle.result = json.loads(e.read() or b"{}").get("result") or f"http {e.code}"
            except Exception as e:
                handle.result = f"error {e!r}"
            handle.done.set()

        threading.Thread(target=post, daemon=True).start()
        return handle

    def cancel(self, handle):
        pass


@dataclass
class Job:
    """The job episode's inputs (run(job=...)): its step budget
    (`spec.steps`), its checkpoint cadence (`spec.checkpointPeriodS`) and
    the TPUJob's name; its learner gang is an h100 1x1 slice (the card)."""

    steps: int
    period_s: float
    name: str = "rl-0"


def model_config(cfg):
    """SERVING_MODEL_CONFIG's fields of a TransformerConfig, its dtype by name."""
    import dataclasses

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return fields


def pod_worker(device):
    """The container command of tests/torch_pod_worker.py on `device`, in
    the worker's mode (`role`): "serve", or "repair" / "promote" for the
    notebook the flow repairs (and promotes)."""
    return lambda out_dir, role: [sys.executable, "-m", "torch.distributed.run", WORKER, device, str(out_dir), role]


def stamp_monitor(tmp_path):
    """A CPU monitor factory for run(tmp_path, ...): a notebook's or job's pod
    has its devices (a SimTPUMonitor, duty 0) once its worker has written its
    context stamp (tests/torch_pod_worker.py CONTEXT_STAMP), as the card's
    CudaMonitor comes up at the worker's CUDA context; an endpoint's pod
    has them at once."""

    class Stamped(SimTPUMonitor):
        def __init__(self, chips, stamp):
            super().__init__(chips=chips, expected=chips, duty=0.0)
            self._stamp, self._up = stamp, False

        def came_up(self):
            self._up = self._up or self._stamp.exists()
            return self._up

        def chips_visible(self):
            return super().chips_visible() if self.came_up() else 0

    def make(pod, chips, procs):
        if C.INFERENCE_NAME_LABEL in pod.metadata.labels:
            return SimTPUMonitor(chips=chips, expected=chips, duty=0.0)
        return Stamped(chips, Path(tmp_path) / "out" / owner(pod) / pod.metadata.uid / torch_pod_worker.CONTEXT_STAMP)

    return make


def owner(pod):
    """The notebook, endpoint or job a pod runs."""
    labels = pod.metadata.labels
    return labels.get(C.NOTEBOOK_NAME_LABEL) or labels.get(C.INFERENCE_NAME_LABEL) or labels[C.JOB_NAME_LABEL]


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


def reconciler_of(mgr, cls):
    """The manager's reconciler of class `cls`, as `build_manager` set it
    up (a controller's reconciler is its bound `reconcile`)."""
    return next(c.reconciler.__self__ for c in mgr.controllers
                if isinstance(getattr(c.reconciler, "__self__", None), cls))


def debug_get(endpoints, path, port="metrics"):
    """One read of the manager's debug mux: (status, body, its bytes, its
    seconds); the body is JSON where the route answers JSON."""
    host, number = endpoints.metrics_address if port == "metrics" else endpoints.health_address
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://{host}:{number}{path}", timeout=30) as r:
            status, raw, kind = r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        status, raw, kind = e.code, e.read(), e.headers.get("Content-Type", "")
    took = time.perf_counter() - t0
    body = json.loads(raw) if kind.startswith("application/json") else raw.decode()
    return status, body, len(raw), took


# bad arguments the mux must answer with 400, one per route that takes them
DEBUG_BAD_ARGS = ("/debug/traces?limit=x", "/debug/traces?limit=-1", "/debug/profile?limit=x",
                  "/debug/profile?region=no-such-region", "/debug/reconciles?limit=-1",
                  "/debug/reconciles?controller=no-such-controller", "/debug/accounting?class=no-such-class",
                  "/debug/accounting?limit=x")


def read_debug_mux(endpoints):
    """The flow's reads of the manager's debug mux at its end: the health
    port's /healthz and /readyz, /metrics, /debug, /debug/slo,
    /debug/incidents (and each bundle), /debug/accounting,
    /debug/reconciles, /debug/flowcontrol, /debug/profile and
    /debug/traces?name=notebook.ready, then each of DEBUG_BAD_ARGS; each
    read as `debug_get` returns it."""
    out = {path: debug_get(endpoints, path, port="health") for path in ("/healthz", "/readyz")}
    for path in ("/metrics", "/debug", "/debug/slo", "/debug/incidents", "/debug/accounting", "/debug/reconciles",
                 "/debug/flowcontrol", "/debug/profile", "/debug/traces?name=notebook.ready"):
        out[path] = debug_get(endpoints, path)
    for incident in out["/debug/incidents"][1]["incidents"]:
        path = f"/debug/incidents?id={incident['id']}"
        out[path] = debug_get(endpoints, path)
    out["bad args"] = {path: debug_get(endpoints, path)[0] for path in DEBUG_BAD_ARGS}
    return out


def run(tmp_path, command, monitor, waves=(("nb-0", "nb-1"),), cfg=CFG, env=None, grace_s=15.0, timeout=120.0,
        released=lambda pids: True, while_serving=lambda: None, card_state=lambda: None, repair=None,
        promotion=None, job=None, resume=False):
    """Drives the flow; returns what it saw.

    `command(out_dir, role) -> argv` is a notebook pod's command (`role`:
    "serve", or "repair" / "promote" for the repaired notebook's pods;
    `pod_worker`). Its worker writes
    out_dir/rank-0.json whole with "pid", "env", "world", "device" and
    "times": {"context": its CUDA context (or the CPU tensor), "done": its
    work finished, epoch seconds}; the notebook's kernel is busy until
    then. `monitor(pod, chips, processes)` builds the agents' device view.
    `repair` names the notebook whose node is preempted (with a grace of
    twice the checkpoint window) once its first worker has written its
    result: that worker writes "train" with "next" (step k+1's "step",
    "loss" and "checksum" from a copy of its state) and no "done", answers
    the forwarded checkpoint requests, and its replacement writes "resumed"
    (what it restored, the step it took) and "done". With `promotion` (a
    `Promotion`), the replacement writes no "done" but the logit
    fingerprint of its params and answers the forwarded checkpoint
    requests, and the notebook is suspended (`suspend_episode`) and promoted
    (`promotion_episode`). With `resume` (and a `repair`), the notebook is
    suspended as well (with or without `promotion`), and the job episode
    runs right after, preempted by the notebook's resume
    (`resume_episode`) instead of a user. With `job` (a `Job`), the job
    episode runs after the waves (`job_episode`): the learner's worker is
    `command(out_dir, "job")`. With a cfg whose
    `accounting_period_s` is above 0, a ChipAccountant built from the
    Config ticks in the manager and what it banked is returned
    ("accounting").

    The manager is the one the port's `main.build_manager` builds (its
    webhook registered in the store's admission chain), with a
    StatusCoalescer at Config's window, one NotebookMetrics shared by the
    notebook reconciler, the gate and the culler, and the judgement layer
    of its `_wire_observability`: an SLOEngine over `default_slos()` at
    Config's window scale, an AlertManager over `default_rules` that
    mirrors onto the notebooks and snapshots the flight recorder, the
    slice-repair-in-progress inhibitor of the readiness category, a
    CanaryProber (a CPU notebook in Config's canary namespace, on a CPU
    node of its own; its loop probes once after the start, and the flow
    probes it by hand before the first wave and at the end) and, with a
    cfg's `autoscale_period_s` above 0, a ReplicaAutoscaler whose signals
    are the port's PodStatsSignals at each replica's pod address. What it
    judged is returned ("judgement"). The reconcilers it set up are tuned
    through it (`reconciler_of`). Its debug mux is bound before its start
    with CPPROFILE=1 over the flow; each notebook's readiness root is read
    over /debug/traces as it closes and the mux is read at the end
    ("debug", `read_debug_mux`). DEPLOYGUARD is armed over the flow (the
    guard that was installed before comes back at the end): every client
    call of the manager's flows is held against the RBAC of the port's
    generated manifests, and the guard's drifts and recorded surface are
    returned ("deployguard", `check_deployguard`). nb-denied is written
    through a RemoteStore
    over TLS to an ApiServer in front of the store, whose admission calls
    the HTTPS webhook through the MutatingWebhookConfiguration
    (`build_remote_stack`, the deployed shape); the user's other writes go
    to the store, whose admission chain runs the same webhook.
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
    processes = {}  # pod uid -> its processes
    acks = []  # (when, pod uid, the forwarded checkpoint's ack or the error it raised)
    restores = []  # (when, pod uid, the forwarded restore's ack or the error it raised)
    config = Config(**{**REPAIR_CFG, **PROMOTION_CFG, **JOB_CFG, **ACCOUNTING_CFG, **RESUME_CFG, **JUDGEMENT_CFG,
                       **cfg})
    suspends = resume or promotion is not None

    def pod_dir(pod):
        d = out_root / owner(pod) / pod.metadata.uid
        d.mkdir(parents=True, exist_ok=True)
        return d

    def pod_command(pod):
        if C.INFERENCE_NAME_LABEL in pod.metadata.labels:
            return list(promotion.command)
        if C.JOB_NAME_LABEL in pod.metadata.labels:
            return command(pod_dir(pod), "job")
        name = pod.metadata.labels[C.NOTEBOOK_NAME_LABEL]
        role = "serve" if name != repair else "promote" if suspends else "repair"
        return command(pod_dir(pod), role)

    def restore_hook(pod):
        forward = forward_restore(str(pod_dir(pod)), deadline_s=RESTORE_DEADLINE_S)

        def hook():
            try:
                ack = forward()
            except Exception as e:  # recorded, then reported to the agent as it would be
                restores.append((time.time(), pod.metadata.uid, repr(e)))
                raise
            restores.append((time.time(), pod.metadata.uid, ack))
            return ack

        return hook

    def idle_since(pod):
        got = result(pod_dir(pod))
        return got["times"]["done"] if got else None

    def checkpoint_hook(pod):
        window = config.job_checkpoint_window_s if C.JOB_NAME_LABEL in pod.metadata.labels \
            else config.checkpoint_window_s
        forward = forward_checkpoint(str(pod_dir(pod)), deadline_s=0.8 * window)

        def hook():
            try:
                ack = forward()
            except Exception as e:  # recorded, then reported to the agent as it would be
                acks.append((time.time(), pod.metadata.uid, repr(e)))
                raise
            acks.append((time.time(), pod.metadata.uid, ack))
            return ack

        return hook

    cluster = SimCluster().start()
    mgr = timeline = acct = endpoints = None
    teardown = []  # the wire stack's, undone in reverse
    cpprofile_env = os.environ.get("CPPROFILE")
    guard_before = deployguard.ACTIVE
    try:
        os.environ["CPPROFILE"] = "1"  # the control-plane profiler armed for the flow
        cpprofile.reset()
        deployguard.disarm()
        guard = deployguard.arm()  # a drift raised in a reconcile may be swallowed: its count is the gate
        cluster.add_pod_behavior(pod_process_behavior(
            pod_command, str(log_dir), env=env, cwd=str(REPO), monitor=monitor, idle_since=idle_since,
            grace_s=grace_s, processes=processes, checkpoint_hook=checkpoint_hook, restore_hook=restore_hook,
            control_dir=lambda pod: str(pod_dir(pod))))
        # the canary is a plain CPU container on a CPU node: no process, no card
        cluster.add_pod_behavior(lambda pod: PodDecision() if pod.metadata.namespace == config.canary_namespace
                                 else None)
        cluster.add_gpu_pool("h100", "h100", "1x1")
        cluster.add_cpu_pool("cpu", nodes=1)
        # the deployed admission shape in front of the store: a TLS
        # ApiServer whose admission calls the HTTPS webhook through the
        # MutatingWebhookConfiguration. nb-denied is written over it; the
        # user's other writes go to the store, whose admission chain runs
        # the same webhook (the smoke's time budget, PERF.md)
        _, remote, _ = build_remote_stack(cluster.store, config, teardown)
        wire = Client(remote)
        # the operator's own composition root, its webhook in the store's
        # admission chain
        mgr = build_manager(cluster.store, config, http_get=cluster.http_get)
        # tuned through what it wired: the node signal alone (no second
        # episode from the old agent going away, and the save may take the
        # whole window); suspend off until the suspend episode (the waves'
        # culls tear their slices down)
        slice_repair = reconciler_of(mgr, SliceRepairController)
        slice_repair.unreachable_dwell_s = 3600.0
        slice_repair.CHECKPOINT_TIMEOUT_S = config.checkpoint_window_s
        suspender = reconciler_of(mgr, SuspendResumeController)
        suspender.config = dataclasses.replace(config, suspend_enabled=False)
        judged = Judgement(mgr)
        acct = getattr(mgr, "accountant", None)
        if acct is not None:
            accounting_before = {r: accounting.tpu_accounting_ticks_total.value(result=r) for r in ("ok", "error")}
        # the debug mux, bound before the start as main() binds it
        endpoints = mgr.serve_endpoints(metrics_port=0, health_port=0, host="127.0.0.1")
        mgr.start()
        timeline = Timeline(cluster.store)
        judged.started()

        def logs():
            return "\n".join(f"--- {p.name}\n{p.read_text()[-3000:]}" for p in sorted(log_dir.glob("*.log")))

        def wait(fn, msg):
            return wait_for(fn, timeout, lambda: f"{msg() if callable(msg) else msg}\n{logs()}")

        def notebook(name):
            return cluster.client.get(Notebook, NS, name)

        def pod(name):
            return cluster.client.get(Pod, NS, f"{name}-0")

        def procs_of(name):
            """The processes of the notebook's current pod."""
            return processes.get(pod(name).metadata.uid)

        def root_state(name):
            """What a missing readiness root is read against: the notebook's
            traceparent and device gate now, the roots in the span ring."""
            nb = notebook(name)
            tpu = nb.status.tpu
            ring = tracing.recent_spans()
            roots = [(sp["attributes"].get("notebook"), sp["trace_id"]) for sp in ring if sp["name"] == "notebook.ready"]
            names = collections.Counter(sp["name"] for sp in ring).most_common(8)
            span = (ring[-1]["end_time"] - ring[0]["start_time"]) if ring else 0.0
            return (f"traceparent {nb.metadata.annotations.get(C.TRACEPARENT_ANNOTATION)!r}, meshReady "
                    f"{tpu and tpu.mesh_ready}, firstReadyTime {tpu and tpu.first_ready_time!r}, chipsVisible "
                    f"{tpu and tpu.chips_visible}; {len(ring)} spans in the ring over {span:.1f} s, most {names}, "
                    f"notebook.ready roots {roots}")

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

        def repair_counters():
            return {"repaired": telemetry.slice_repairs_total.value(result="repaired"),
                    "failed": telemetry.slice_repairs_total.value(result="failed"),
                    "interruptions": telemetry.slice_interruptions_total.value(cause="HostPreempted"),
                    "checkpoint saves": telemetry.slice_checkpoint_saves_total.value(),
                    "mttr observations": telemetry.slice_repair_duration_seconds.snapshot()["count"]}

        def pool_of(node):
            return cluster.client.get(Node, "", node).metadata.labels[GKE_NODEPOOL_LABEL]

        def repair_episode(name, got):
            """Preempts the node of the notebook's pod, follows the repair to
            the replacement pod's result, and returns what it saw: each
            edge's time (this process's clock), the forwarded ack, the
            state and Degraded values the notebook went through, the repair
            spans on the notebook's trace, the counters' deltas, the
            incident bundles and the replacement's result."""
            old = pod(name)
            before, wall0 = repair_counters(), time.time()
            ep = {"preempted": wall0, "old uid": old.metadata.uid, "old node": old.spec.node_name,
                  "old pool": pool_of(old.spec.node_name)}
            ep["grace"] = 2 * config.checkpoint_window_s
            cluster.preempt_node(old.spec.node_name, grace_s=ep["grace"])
            new = wait(lambda: (p := pod(name)).metadata.uid != old.metadata.uid and p.spec.node_name and p,
                       f"{name}'s replacement pod bound")
            # the old pod's tree as its stop saw it, and its worker
            ep["old alive at rebound"] = alive(sorted(set(processes[old.metadata.uid].pids) | {got["result"]["pid"]}))
            ep.update({"uid": new.metadata.uid, "node": new.spec.node_name, "pool": pool_of(new.spec.node_name)})

            def resumed():
                procs = processes.get(new.metadata.uid)
                done = result(pod_dir(new))
                assert done or procs is None or procs.running(), \
                    f"{name}'s replacement torchrun exited {procs.proc.returncode}\n{logs()}"
                return done

            ep["result"] = wait(resumed, f"{name}'s replacement worker")

            def repaired():
                nb = notebook(name)
                cond = next((c for c in nb.status.conditions if c.type == C.TPU_DEGRADED_CONDITION), None)
                return (C.TPU_REPAIR_STATE_ANNOTATION not in nb.metadata.annotations and cond is not None
                        and (cond.status, cond.reason) == ("False", "Repaired") and nb.status.tpu.mesh_ready)

            wait(repaired, f"{name} repaired")
            wait(lambda: repair_counters()["mttr observations"] > before["mttr observations"],
                 f"{name}'s repair observed")
            for edge in ("terminating", "deleted"):
                ep[f"old {edge}"] = wait(lambda: timeline.pod(old.metadata.uid, edge),
                                         f"the watches to see {name}'s old pod {edge}")[0]
            ep["rebound"] = timeline.pod(new.metadata.uid, "bound")[0]
            log = wait(lambda: (entries := timeline.notebook_log(name))[-1][2:] == ("", ("False", "Repaired"), True)
                       and entries, f"the watches to see {name} repaired")
            ep["degraded"] = next(t for t, _, _, cond, _ in log if t >= wall0 and cond == ("True", "HostPreempted"))
            # the gate's rising edge after the eviction (an entry written before
            # the gate saw the old pod go still carries its stale meshReady)
            ep["mesh-ready again"] = next(t for (t, _, _, _, ready), (_, _, _, _, was) in zip(log[1:], log)
                                          if t >= ep["old terminating"] and ready and not was)
            ep["states"] = [st for i, (_, _, st, _, _) in enumerate(log) if i == 0 or log[i - 1][2] != st]
            ep["conditions"] = list(dict.fromkeys(cond for _, _, _, cond, _ in log if cond is not None))
            ep["acks"] = [(t, ack) for t, uid, ack in acks if uid == old.metadata.uid]
            ep["checkpoint-saved"] = notebook(name).metadata.annotations.get(C.TPU_CHECKPOINT_SAVED_ANNOTATION)
            trace_id = (tracing.parse_traceparent(got["admitted"].get(C.TRACEPARENT_ANNOTATION)) or ("",))[0]
            ep["spans"] = {n: [sp["attributes"] for sp in tracing.recent_spans(trace_id=trace_id, name=n)]
                           for n in ("slice.checkpoint", "slice.repair", "slice.reschedule")}
            ep["counters"] = {k: v - before[k] for k, v in repair_counters().items()}
            ep["incidents"] = [i["reason"] for i in recorder.incidents() if i["subject"] == f"{NS}/{name}"]
            ep["goodput"] = telemetry.slice_goodput_ratio.value()
            ep["old closed at"] = processes[old.metadata.uid].closed_at
            ep["wall"] = time.time() - wall0
            return ep

        def suspend_counters():
            return {"checkpoint saves": telemetry.slice_checkpoint_saves_total.value(),
                    "hits": slicepool.slice_pool_hits_total.value(),
                    "misses": slicepool.slice_pool_misses_total.value(),
                    "resumes": slicepool.notebook_resume_seconds._totals.get((), 0),
                    **{f"reclaims {r}": slicepool.notebook_reclaims_total.value(reason=r)
                       for r in ("suspend", "job-preempt", "endpoint-drain", "pool-idle", "poisoned")},
                    **{f"verifications {r}": slicepool.notebook_restore_verifications_total.value(result=r)
                       for r in ("ok", "mismatch", "unverified")}}

        def stop_notebook(name):
            """The culler's stamp: the stop and `suspend-state: checkpointing`
            in one patch, so the reconciler holds the pods through the
            checkpoint window (a stop alone lets the scale-down race the
            controller's own stamp, and a pod of processes loses it: the
            window then finds no ready host to save)."""
            cluster.client.patch(Notebook, NS, name, {"metadata": {"annotations": {
                C.STOP_ANNOTATION: apimachinery.rfc3339_precise(time.time()),
                C.TPU_SUSPEND_STATE_ANNOTATION: "checkpointing"}}})

        def once_each(uid):
            """The forwarded saves of a pod, once per request (a re-probe
            joins the save under way, and its hook returns the same ack)."""
            out, seen_ids = [], set()
            for t, u, a in acks:
                if u == uid and (not isinstance(a, dict) or a.get("id") not in seen_ids):
                    out.append((t, a))
                    seen_ids.add(a.get("id") if isinstance(a, dict) else None)
            return out

        def suspended_and_gone(name, uid, pids):
            """Waits until the notebook is suspended, its pods gone and the
            processes of its pod `uid` with them, the card released; returns
            what the suspend wrote: the time, the annotations and the pool
            the pod ran on with its nodes' marks."""
            procs = processes[uid]
            wait(lambda: notebook(name).metadata.annotations.get(C.TPU_SUSPEND_STATE_ANNOTATION) == "suspended",
                 f"{name} suspended")
            suspended = time.time()
            wait(lambda: not cluster.client.list(Pod, namespace=NS, labels={C.NOTEBOOK_NAME_LABEL: name}),
                 f"{name}'s pod deleted after its suspend")
            wait(lambda: procs.closed and not alive(pids) and released(pids),
                 f"{name}'s processes {pids} gone and its card released")
            return {"suspended": suspended, "gone": time.time(), "closed at": procs.closed_at,
                    "annotations": dict(notebook(name).metadata.annotations)}

        def suspend_episode(name, got):
            """Enables suspend in its controller and stops the notebook with
            the culler's stamp; returns what the suspend did: the stop, the
            forwarded save's ack, the suspended time, the annotations, the
            pool released and its marks, the counters' deltas."""
            nb_pod = pod(name)
            pids = sorted(set(processes[nb_pod.metadata.uid].pids) | {got["repair"]["result"]["pid"]})
            pool = pool_of(nb_pod.spec.node_name)
            suspender.config.suspend_enabled = True
            se = {"uid": nb_pod.metadata.uid, "pool": pool, "before": suspend_counters()}
            se["stop"] = time.time()
            stop_notebook(name)
            se.update(suspended_and_gone(name, nb_pod.metadata.uid, pids))
            se["acks"] = once_each(nb_pod.metadata.uid)
            se["result"] = result(pod_dir(nb_pod))  # its saves, each with the next step on a copy
            se["pool marks"] = [(n.metadata.annotations.get(slicepool.POOL_STATE_ANNOTATION),
                                 n.metadata.annotations.get(slicepool.POOL_PRIORITY_ANNOTATION))
                                for n in cluster.client.list(Node) if n.metadata.labels[GKE_NODEPOOL_LABEL] == pool]
            se["counters"] = {k: v - se["before"][k] for k, v in suspend_counters().items()}
            return se

        def promotion_episode(name, got):
            """Promotes the suspended notebook into the endpoint, serves the
            requests, stops the endpoint; returns what it saw: each edge's
            time (this process's clock) and resourceVersion where a watch
            saw it, the suspend's ack, the endpoint's states, events,
            status, route, span and counters' deltas, the serving process's
            report and its replies."""
            p = promotion
            key = f"{NS}/{p.name}"
            watch = Recorder(cluster.store, (("kubeflow.org/v1beta1", "InferenceEndpoint"), ("v1", "Node"),
                                             ("v1", "Pod"), ("apps/v1", "StatefulSet"),
                                             ("gateway.networking.k8s.io/v1", "HTTPRoute")))
            try:
                return _promotion(name, got, p, key, watch)
            finally:
                watch.stop()

        def promotion_counters():
            return {**{f"promotions {b}": serving_metrics.inference_endpoint_promotions_total.value(bind=b)
                       for b in ("warm", "cold")},
                    **{f"verifications {r}": serving_metrics.inference_restore_verifications_total.value(result=r)
                       for r in ("ok", "mismatch", "unverified")}}

        def _promotion(name, got, p, key, watch):
            se = got["suspend"]
            before = promotion_counters()
            # the episode runs from the suspend's stop: the save, the pod's
            # processes gone, the pool warm, then the endpoint
            pe = {"t0": se["stop"], "notebook": name, "endpoint": p.name, "pool": se["pool"], "acks": se["acks"],
                  "ack": se["acks"][0] if se["acks"] else None, "suspended": se["suspended"],
                  "released pool": se["pool"], "pool at suspend": [m for m, _ in se["pool marks"]],
                  "notebook annotations": se["annotations"]}
            # the promotion
            ep = InferenceEndpoint()
            ep.metadata.name, ep.metadata.namespace = p.name, NS
            ep.spec.notebook_ref = NotebookRef(name=name)
            ep.spec.serving = ServingSpec(max_batch_slots=p.slots, max_seq=p.max_seq,
                                          max_new_tokens=max(m for _, m in p.requests), drain_timeout_s=p.drain_s,
                                          checkpoint_path=str(out_root / name / "checkpoints"),
                                          autoscaling=AutoscalingSpec(min_replicas=1, max_replicas=1,
                                                                      scale_to_zero=True, scale_to_zero_idle_s=p.idle_s)
                                          if p.idle_s else None)
            ep.spec.template.spec.containers = [Container(name=p.name, image="serving", env=[
                EnvVar(name="SERVING_MODEL_CONFIG", value=json.dumps(p.model_config)),
                EnvVar(name="SERVING_DEVICE", value=p.device)])]
            pe["created"] = time.time()
            pe["decisions at create"] = judged.decisions()
            cluster.client.create(ep)

            def endpoint():
                return cluster.client.get(InferenceEndpoint, NS, p.name)

            def state():
                return endpoint().metadata.annotations.get(C.INFERENCE_STATE_ANNOTATION, "")

            def ep_pod():
                pods = cluster.client.list(Pod, namespace=NS, labels={C.INFERENCE_NAME_LABEL: p.name})
                return next((x for x in pods if x.spec.node_name), None)

            served_pod = wait(ep_pod, f"{p.name}'s pod bound")
            ctl = pod_dir(served_pod)

            def serving_up():
                procs = processes.get(served_pod.metadata.uid)
                assert procs is None or procs.running(), \
                    f"{p.name}'s serving process exited {procs.proc.returncode}\n{logs()}"
                return state() == "serving" and serving_ready(str(ctl))

            pe["ready"] = wait(serving_up, f"{p.name} Serving")
            # where a cluster routes to the replica: the pod's IP and its serving port
            pe["address"] = wait(lambda: serving_address(cluster.client.get(Pod, NS, served_pod.metadata.name)),
                                 f"{p.name}'s pod address")
            # the route and the status mirror follow the state's write
            serving_ep = wait(lambda: (e := endpoint()).status.url and e, f"{p.name}'s status.url")
            pe["url"] = serving_ep.status.url
            pe["route while serving"] = wait(lambda: cluster.client.get(
                HTTPRoute, config.controller_namespace, endpoint_route_name(serving_ep)).metadata.name,
                f"{p.name}'s HTTPRoute")
            pe["served node"] = served_pod.spec.node_name
            pe["served pool"] = pool_of(served_pod.spec.node_name)
            pe["restores"] = [(t, a) for t, uid, a in restores if uid == served_pod.metadata.uid]
            # the requests, all at once, to the pod's server
            replies, threads = [None] * len(p.requests), []

            def send(i, prompt, max_new):
                body = json.dumps({"prompt": prompt, "max_new": max_new}).encode()
                req = urllib.request.Request(f"{pe['address']}/generate", data=body,
                                             headers={"Content-Type": "application/json"})
                sent = time.time()
                try:
                    with urllib.request.urlopen(req, timeout=timeout) as r:
                        replies[i] = (r.status, json.loads(r.read()), sent, time.time())
                except urllib.error.HTTPError as e:
                    replies[i] = (e.code, json.loads(e.read() or b"{}"), sent, time.time())

            pe["requests sent"] = time.time()
            for i, (prompt, max_new) in enumerate(p.requests):
                threads.append(threading.Thread(target=send, args=(i, prompt, max_new)))
                threads[-1].start()
            for t in threads:
                t.join(timeout)
            pe["requests done"] = time.time()
            pe["replies"] = replies
            pe["counters at replies"] = promotion_counters()
            pe["counters"] = {k: v - before[k] for k, v in pe["counters at replies"].items()}
            pe["decisions at replies"] = judged.decisions()
            live, live_ready = served_pod, pe["ready"]
            if p.idle_s:
                pe["autoscale"] = park_and_wake(p, key, watch, served_pod, pe)
                live, live_ready = pe["autoscale"]["pod"], pe["autoscale"]["ready"]
            # the stop: route first, then the drain window, then Terminated
            pe["stop"] = time.time()
            cluster.client.patch(InferenceEndpoint, NS, p.name, {"metadata": {"annotations": {
                C.STOP_ANNOTATION: apimachinery.rfc3339_precise(pe["stop"])}}})
            wait(lambda: state() == "terminated", f"{p.name} Terminated")
            wait(lambda: not cluster.client.list(Pod, namespace=NS, labels={C.INFERENCE_NAME_LABEL: p.name}),
                 f"{p.name}'s pod deleted")
            procs = processes[live.metadata.uid]
            pe["pids"] = sorted(set(procs.pids) | {live_ready["pid"]})
            wait(lambda: procs.closed and not alive(pe["pids"]) and released(pe["pids"]),
                 f"{p.name}'s processes {pe['pids']} gone and its card released")
            pe["card free"] = time.time()
            pe["wall"] = pe["card free"] - pe["t0"]
            # from the last replies (the woken ones with a park) to the card free
            last = pe["autoscale"]["counters at replies"] if p.idle_s else pe["counters at replies"]
            pe["counters after replies"] = {k: v - last[k] for k, v in promotion_counters().items()}
            pe["alive"] = alive(pe["pids"])
            pe["old closed at"] = procs.closed_at
            if p.idle_s:  # the first process wrote its exit at the park
                pe["autoscale"]["exit"] = read_json(str(pod_dir(live) / SERVING_EXIT))
            else:
                pe["exit"] = read_json(str(ctl / SERVING_EXIT))
            pe["served pool after"] = [n.metadata.annotations.get(slicepool.POOL_STATE_ANNOTATION)
                                       for n in cluster.client.list(Node)
                                       if n.metadata.labels[GKE_NODEPOOL_LABEL] == pe["served pool"]]
            # what the watches saw
            pe["states"] = watch.values("InferenceEndpoint", lambda o: (o["metadata"].get("annotations") or {})
                                        .get(C.INFERENCE_STATE_ANNOTATION, ""))
            pe["claimed"] = watch.first("Node", lambda o, t: (o["metadata"].get("annotations") or {}).get(
                slicepool.POOL_CLAIMED_BY_ANNOTATION) == key)
            pe["bound"] = watch.first("Pod", lambda o, t: o["spec"].get("nodeName") and
                                      (o["metadata"].get("labels") or {}).get(C.INFERENCE_NAME_LABEL) == p.name)
            pe["promoted"] = watch.first("InferenceEndpoint", lambda o, t: C.INFERENCE_PROMOTED_FROM_ANNOTATION in
                                         (o["metadata"].get("annotations") or {}))
            pe["mesh-ready"] = watch.first("InferenceEndpoint", lambda o, t: ((o.get("status") or {}).get("tpu")
                                                                              or {}).get("meshReady"))
            pe["serving"] = watch.first("InferenceEndpoint", lambda o, t: (o["metadata"].get("annotations") or {})
                                        .get(C.INFERENCE_STATE_ANNOTATION) == "serving")
            pe["route gone"] = watch.first("HTTPRoute", lambda o, t: t == "DELETED"
                                           and o["metadata"]["name"] == endpoint_route_name(serving_ep), pe["stop"])
            pe["set at 0"] = watch.first("StatefulSet", lambda o, t: o["spec"].get("replicas") == 0
                                         and (o["metadata"].get("labels") or {}).get(C.INFERENCE_NAME_LABEL) == p.name,
                                         pe["stop"])
            pe["terminated"] = watch.first("InferenceEndpoint", lambda o, t: (o["metadata"].get("annotations") or {})
                                           .get(C.INFERENCE_STATE_ANNOTATION) == "terminated")
            for reason in ("EndpointPromoted", "EndpointServing", "EndpointDraining", "EndpointTerminated"):
                wait(lambda: any(e.reason == reason for e in cluster.client.list(Event, namespace=NS)
                                 if e.involved_object.name == p.name), f"{p.name}'s {reason} event")
            pe["events"] = {e.reason: e.message for e in cluster.client.list(Event, namespace=NS)
                            if e.involved_object.kind == "InferenceEndpoint" and e.involved_object.name == p.name}
            final = endpoint()
            pe["annotations"] = dict(final.metadata.annotations)
            pe["status"] = final.status.to_dict()
            trace_id = (tracing.parse_traceparent(final.metadata.annotations.get(C.TRACEPARENT_ANNOTATION))
                        or ("",))[0]
            pe["spans"] = [sp["attributes"] for sp in tracing.recent_spans(trace_id=trace_id,
                                                                            name="endpoint.promotion")]
            pe["decisions at the end"] = judged.decisions()
            cluster.client.delete(InferenceEndpoint, NS, p.name)
            return pe

        def park_and_wake(p, key, watch, served_pod, pe):
            """From the last of the promotion's replies: the autoscaler parks
            the idle endpoint (desired 0: Suspended, its pods and processes
            gone, its slice released warm, its route and url kept); a
            TokenRouter over the endpoint, with no live replica, sheds the
            requests and fires its cold wake, which writes desired 1; the
            woken gang takes back the parked slice, its serving process
            restores the checkpoint, Loading verifies it, and once Serving its
            replica joins the router and the shed requests are sent again
            through it. Returns what it saw: each edge's time (this process's
            clock) and resourceVersion where a watch saw it, the parked
            status, route and pool marks, the first process's exit, the
            woken process's report, restores and replies, the counters'
            deltas and the wake's events."""
            ae = {"t0": pe["requests done"]}
            first = processes[served_pod.metadata.uid]
            pids = sorted(set(first.pids) | {pe["ready"]["pid"]})

            def endpoint():
                return cluster.client.get(InferenceEndpoint, NS, p.name)

            def ann(o, k):
                return (o["metadata"].get("annotations") or {}).get(k)

            # the park: the autoscaler's desired 0, then the controller's
            wait(lambda: endpoint().metadata.annotations.get(C.INFERENCE_STATE_ANNOTATION) == "suspended",
                 f"{p.name} parked Suspended by the autoscaler")
            wait(lambda: not cluster.client.list(Pod, namespace=NS, labels={C.INFERENCE_NAME_LABEL: p.name}),
                 f"{p.name}'s pod deleted at the park")
            wait(lambda: first.closed and not alive(pids) and released(pids),
                 f"{p.name}'s processes {pids} gone at the park and its card released")
            ae["card free"] = time.time()
            ae["parked status"] = wait(lambda: (st := endpoint().status).phase == "Suspended" and st.replicas == 0
                                       and st.to_dict(), f"{p.name}'s parked status")
            ae["route while parked"] = cluster.client.get(HTTPRoute, config.controller_namespace,
                                                          endpoint_route_name(endpoint())).metadata.name
            ae["pool at park"] = [(n.metadata.annotations.get(slicepool.POOL_STATE_ANNOTATION),
                                   n.metadata.annotations.get(slicepool.POOL_PRIORITY_ANNOTATION))
                                  for n in cluster.client.list(Node)
                                  if n.metadata.labels[GKE_NODEPOOL_LABEL] == pe["served pool"]]
            ae["alive at park"] = alive(pids)
            pe["exit"] = read_json(str(pod_dir(served_pod) / SERVING_EXIT))
            ae["decisions at park"] = judged.decisions()
            ae["desired 0"] = watch.first("InferenceEndpoint", lambda o, t: ann(
                o, C.INFERENCE_DESIRED_REPLICAS_ANNOTATION) == "0", ae["t0"])
            ae["suspended"] = watch.first("InferenceEndpoint", lambda o, t: ann(
                o, C.INFERENCE_STATE_ANNOTATION) == "suspended", ae["t0"])
            # the wake: a router with no live replica
            before = {**promotion_counters(), "reclaims pool-idle": slicepool.notebook_reclaims_total.value(
                reason="pool-idle"), "no replica": serving_metrics.inference_router_picks_total.value(
                result="no_replica")}
            ae["counters to park"] = {k: before[k] - v for k, v in pe["counters at replies"].items()}
            wakes = []

            def cold_wake():
                wakes.append(time.time())
                cluster.client.patch(InferenceEndpoint, NS, p.name, {"metadata": {"annotations": {
                    C.INFERENCE_DESIRED_REPLICAS_ANNOTATION: "1"}}})

            router = TokenRouter(endpoint=key, cold_wake=cold_wake)
            joined = threading.Event()
            replies, threads = [None] * len(p.requests), []

            def send(i, prompt, max_new):
                sent, shed = time.time(), None
                try:
                    try:
                        routed = router.generate(prompt, max_new, wait_timeout_s=timeout)
                    except QueueFull as e:  # no live replica: shed, the wake fired
                        shed = (time.time(), str(e))
                        joined.wait(timeout)
                        resent = time.time()
                        routed = router.generate(prompt, max_new, wait_timeout_s=timeout)
                    else:
                        resent = sent
                    h = routed.handle
                    replies[i] = (200 if h.result == "ok" else 503, {"tokens": h.tokens, "ttft_s": h.ttft_s,
                                                                     "result": h.result}, resent, time.time(),
                                  sent, shed, routed.replica)
                except Exception as e:  # recorded; the gates read it
                    replies[i] = (None, {"error": repr(e)}, sent, time.time(), sent, shed, None)

            ae["wake"] = time.time()
            for i, (prompt, max_new) in enumerate(p.requests):
                threads.append(threading.Thread(target=send, args=(i, prompt, max_new)))
                threads[-1].start()

            def woken_pod():
                pods = cluster.client.list(Pod, namespace=NS, labels={C.INFERENCE_NAME_LABEL: p.name})
                return next((x for x in pods if x.spec.node_name and x.metadata.uid != served_pod.metadata.uid
                             and not x.metadata.deletion_timestamp), None)

            new = wait(woken_pod, f"{p.name}'s woken pod bound")

            def woken_up():
                procs = processes.get(new.metadata.uid)
                assert procs is None or procs.running(), \
                    f"{p.name}'s woken serving process exited {procs.proc.returncode}\n{logs()}"
                return (endpoint().metadata.annotations.get(C.INFERENCE_STATE_ANNOTATION) == "serving"
                        and serving_ready(str(pod_dir(new))))

            ae["ready"] = wait(woken_up, f"{p.name} woken to Serving")
            ae["address"] = wait(lambda: serving_address(cluster.client.get(Pod, NS, new.metadata.name)),
                                 f"{p.name}'s woken pod address")
            router.add_replica(0, HttpReplica(ae["address"], timeout))
            ae["joined"] = time.time()
            joined.set()
            for t in threads:
                t.join(timeout)
            ae["requests done"] = time.time()
            ae["wall"] = ae["requests done"] - ae["t0"]
            ae.update(pod=new, uid=new.metadata.uid, node=new.spec.node_name, pool=pool_of(new.spec.node_name),
                      replies=replies, wakes=wakes, router=router.replicas())
            ae["restores"] = [(t, a) for t, uid, a in restores if uid == new.metadata.uid]
            ae["counters at replies"] = promotion_counters()
            ae["counters"] = {k: v - before[k] for k, v in {
                **ae["counters at replies"], "reclaims pool-idle": slicepool.notebook_reclaims_total.value(
                    reason="pool-idle"), "no replica": serving_metrics.inference_router_picks_total.value(
                    result="no_replica")}.items()}
            for reason in ("EndpointSuspended", "EndpointWaking"):
                wait(lambda: any(e.reason == reason for e in cluster.client.list(Event, namespace=NS)
                                 if e.involved_object.name == p.name), f"{p.name}'s {reason} event")
            ae["events"] = {e.reason: e.message for e in cluster.client.list(Event, namespace=NS)
                            if e.involved_object.kind == "InferenceEndpoint" and e.involved_object.name == p.name}
            ae["desired 1"] = watch.first("InferenceEndpoint", lambda o, t: ann(
                o, C.INFERENCE_DESIRED_REPLICAS_ANNOTATION) == "1", ae["wake"])
            ae["bound"] = watch.first("Pod", lambda o, t: o["metadata"].get("uid") == new.metadata.uid
                                      and o["spec"].get("nodeName"))
            ae["serving"] = watch.first("InferenceEndpoint", lambda o, t: ann(
                o, C.INFERENCE_STATE_ANNOTATION) == "serving", ae["wake"])
            ae["states"] = [v for v in watch.values("InferenceEndpoint", lambda o: ann(
                o, C.INFERENCE_STATE_ANNOTATION) or "")]
            return ae


        def job_counters():
            return {**{f"jobs {r}": jobmetrics.tpu_jobs_total.value(result=r) for r in ("succeeded", "failed")},
                    **{f"preemptions {c}": jobmetrics.tpu_job_preemptions_total.value(cause=c)
                       for c in ("reclaim", "host-loss", "user", "bind-timeout")},
                    "requeues": jobmetrics.tpu_job_requeues_total.value()}

        def resume_episode(name, got, unstopped, before, watch):
            """The notebook's resume, from its unstop to its second suspend
            (the job's first pod gone by then: the reclaim took its slice);
            returns what it saw: the new pod and its worker's result, each
            edge's time, the restore's forwarded acks, the annotations at
            the resume, the suspend states and attempts the watch saw, the
            events, span and counters' deltas, and the second suspend."""
            old = {got["uid"], got["repair"]["uid"]}
            re_ = {"unstop": unstopped}
            new = wait(lambda: next((p for p in cluster.client.list(Pod, namespace=NS, labels={
                C.NOTEBOOK_NAME_LABEL: name}) if p.metadata.uid not in old and p.spec.node_name), None),
                f"{name}'s resumed pod bound")
            re_.update(uid=new.metadata.uid, node=new.spec.node_name, pool=pool_of(new.spec.node_name))

            def resumed():
                procs = processes.get(new.metadata.uid)
                done = result(pod_dir(new))
                assert done or procs is None or procs.running(), \
                    f"{name}'s resumed torchrun exited {procs.proc.returncode}\n{logs()}"
                return done

            re_["result"] = wait(resumed, f"{name}'s resumed worker")
            wait(lambda: not (nb := notebook(name)).metadata.annotations.get(C.TPU_SUSPEND_STATE_ANNOTATION)
                 and nb.status.tpu.mesh_ready, f"{name} resumed")
            re_["annotations at the resume"] = dict(notebook(name).metadata.annotations)
            for reason in ("NotebookResumed", "RestoreVerified"):
                wait(lambda: any(e.reason == reason for e in cluster.client.list(Event, namespace=NS)
                                 if e.involved_object.name == name), f"{name}'s {reason} event")
            re_["restores"] = [(t, a) for t, uid, a in restores if uid == new.metadata.uid]
            # the second suspend: the stop, the save of the step it took
            pids = sorted(set(processes[new.metadata.uid].pids) | {re_["result"]["pid"]})
            re_["stop"] = time.time()
            stop_notebook(name)
            re_["suspend"] = suspended_and_gone(name, new.metadata.uid, pids)
            re_["acks"] = once_each(new.metadata.uid)
            re_["counters"] = {k: v - before[k] for k, v in suspend_counters().items()}
            re_["events"] = {e.reason: e.message for e in cluster.client.list(Event, namespace=NS)
                             if e.involved_object.kind == "Notebook" and e.involved_object.name == name}
            trace_id = (tracing.parse_traceparent(got["admitted"].get(C.TRACEPARENT_ANNOTATION)) or ("",))[0]
            re_["spans"] = [sp["attributes"] for sp in tracing.recent_spans(trace_id=trace_id, name="notebook.resume")]
            # what the watches saw
            nb_events = [(t, rv, o) for t, rv, typ, kind, o in watch.events
                         if kind == "Notebook" and typ != "DELETED" and o["metadata"]["name"] == name]

            def ann_of(o, k):
                return (o["metadata"].get("annotations") or {}).get(k)

            re_["attempts"] = sorted({int(a) for _, _, o in nb_events
                                      if (a := ann_of(o, C.TPU_RESUME_ATTEMPTS_ANNOTATION))})
            re_["resuming"] = next(((t, rv) for t, rv, o in nb_events
                                    if ann_of(o, C.TPU_SUSPEND_STATE_ANNOTATION) == "resuming"), None)
            re_["resumed"] = next(((t, rv) for t, rv, o in nb_events if t >= unstopped
                                   and not ann_of(o, C.TPU_SUSPEND_STATE_ANNOTATION)
                                   and C.STOP_ANNOTATION not in (o["metadata"].get("annotations") or {})), None)
            re_["bound"] = watch.first("Pod", lambda o, t: o["metadata"].get("uid") == new.metadata.uid
                                       and o["spec"].get("nodeName"))
            re_["mesh-ready"] = next(((t, rv) for t, rv, o in nb_events if rv > re_["bound"][1]
                                      and ((o.get("status") or {}).get("tpu") or {}).get("meshReady")), None)
            re_["ready replicas"] = next(((t, rv) for t, rv, o in nb_events if rv > re_["bound"][1]
                                          and (o.get("status") or {}).get("readyReplicas")), None)
            re_["ready"] = watch.first("Pod", lambda o, t: o["metadata"].get("uid") == new.metadata.uid and any(
                c.get("type") == "Ready" and c.get("status") == "True"
                for c in (o.get("status") or {}).get("conditions") or []))
            re_["reclaim stamp"] = watch.first("TPUJob", lambda o, t: (ann_of(o, C.JOB_PREEMPT_ANNOTATION) or "")
                                               .startswith("capacity-pressure:"))
            re_["states"] = timeline.suspend_states(name)
            return re_

        def job_episode(j, resume=None, got=None):
            """Runs the TPUJob through its preemption to Succeeded; returns
            what it saw: each edge's time (this process's clock) and
            resourceVersion where a watch saw it, the job's states, events,
            status and annotations, the counters' deltas, the goodput ratio,
            the acks and both incarnations' results and pods. With `resume`
            (the suspended notebook, `got` what the flow saw of it), the
            notebook's resume preempts the job (`resume_episode`, its
            result in got["resume"])."""
            kinds = (("kubeflow.org/v1beta1", "TPUJob"), ("v1", "Node"), ("v1", "Pod"))
            watch = Recorder(cluster.store, kinds + ((("kubeflow.org/v1beta1", "Notebook"),) if resume else ()))
            try:
                return _job(j, watch, resume, got)
            finally:
                watch.stop()

        def _job(j, watch, resume, got):
            key = f"{NS}/{j.name}"
            before, t0 = job_counters(), time.time()
            je = {"t0": t0, "name": j.name, "steps": j.steps, "period": j.period_s,
                  "cause": "reclaim" if resume else "user"}
            tj = TPUJob()
            tj.metadata.name, tj.metadata.namespace = j.name, NS
            tj.spec.tpu = TPUSpec(accelerator="h100", topology="1x1")
            tj.spec.steps, tj.spec.checkpoint_period_s = j.steps, j.period_s
            tj.spec.template.spec.containers = [Container(name=j.name, image="trainer")]
            cluster.client.create(tj)
            je["priority"] = job_priority(tj)

            def get():
                return cluster.client.get(TPUJob, NS, j.name)

            def ann(k, default=""):
                return get().metadata.annotations.get(k, default)

            def learner(exclude=()):
                pods = cluster.client.list(Pod, namespace=NS, labels={C.JOB_NAME_LABEL: j.name})
                return next((x for x in pods if x.spec.node_name and not x.metadata.deletion_timestamp
                             and x.metadata.uid not in exclude), None)

            def worker_up(p):
                """True, or the pod's torchrun exited before its stop."""
                procs = processes.get(p.metadata.uid)
                assert procs is None or procs.running() or procs.closed, \
                    f"{j.name}'s torchrun exited {procs.proc.returncode}\n{logs()}"
                return True

            def container_env_of(p):
                return {e.name: e.value for e in p.spec.containers[0].env if e.name.startswith("TPU_JOB_")}

            def incarnation_gone(p):
                procs = processes[p.metadata.uid]
                pids = sorted(set(procs.pids) | {(result(pod_dir(p)) or {}).get("pid", 0)} - {0})
                wait(lambda: procs.closed and not alive(pids) and released(pids),
                     f"{j.name}'s pod {p.metadata.uid[:8]}'s processes {pids} gone and its card released")
                return {"uid": p.metadata.uid, "node": p.spec.node_name, "pool": pool_of(p.spec.node_name),
                        "pids": pids, "alive": alive(pids), "closed at": procs.closed_at,
                        "env": container_env_of(p), "result": result(pod_dir(p))}

            first = wait(learner, f"{j.name}'s learner pod bound")
            wait(lambda: worker_up(first) and ann(C.JOB_STATE_ANNOTATION) == "running"
                 and int(ann(C.JOB_CHECKPOINT_STEP_ANNOTATION, "0") or 0) > 0,
                 f"{j.name}'s first cadence checkpoint acked")
            je["stamp"] = time.time()
            if resume:
                # the notebook's return: its resume takes the job's slice
                nb_before = suspend_counters()
                cluster.client.patch(Notebook, NS, resume, {"metadata": {"annotations": {C.STOP_ANNOTATION: None}}})
            else:
                cluster.client.patch(TPUJob, NS, j.name, {"metadata": {"annotations": {
                    C.JOB_PREEMPT_ANNOTATION: "user"}}})
            wait(lambda: int(ann(C.JOB_PREEMPTIONS_ANNOTATION, "0") or 0) >= 1, f"{j.name} preempted and requeued")
            je["first"] = incarnation_gone(first)
            if resume:
                got["resume"] = resume_episode(resume, got, je["stamp"], nb_before, watch)
            second = wait(lambda: learner(exclude=(first.metadata.uid,)), f"{j.name}'s second learner pod bound")
            wait(lambda: worker_up(second) and get().status.phase == "Succeeded", f"{j.name} Succeeded")
            wait(lambda: not cluster.client.list(Pod, namespace=NS, labels={C.JOB_NAME_LABEL: j.name}),
                 f"{j.name}'s pods deleted")
            je["second"] = incarnation_gone(second)
            je["card free"] = time.time()
            je["wall"] = je["card free"] - t0
            wait(lambda: get().status.ready_replicas == 0, f"{j.name}'s status with no pod ready")
            for reason in ("JobAdmitted", "JobRunning", "JobPreempted", "JobRequeued", "JobSucceeded"):
                wait(lambda: any(e.reason == reason for e in cluster.client.list(Event, namespace=NS)
                                 if e.involved_object.name == j.name), f"{j.name}'s {reason} event")
            je["events"] = {e.reason: e.message for e in cluster.client.list(Event, namespace=NS)
                            if e.involved_object.kind == "TPUJob" and e.involved_object.name == j.name}
            final = get()
            je["annotations"] = dict(final.metadata.annotations)
            je["status"] = final.status.to_dict()
            je["replicas"] = cluster.client.get(StatefulSet, NS, f"{j.name}-{C.JOB_GANG_LEARNER}").spec.replicas
            je["counters"] = {k: v - before[k] for k, v in job_counters().items()}
            je["goodput"] = jobmetrics.tpu_job_goodput_ratio.value()
            # the forwarded saves, once each (a re-probe joins the save under way)
            for inc in ("first", "second"):
                je[inc]["acks"] = once_each(je[inc]["uid"])
            # what the watches saw
            states = []
            for t, rv, typ, kind, o in watch.events:
                if kind == "TPUJob" and typ != "DELETED":
                    st = (o["metadata"].get("annotations") or {}).get(C.JOB_STATE_ANNOTATION, "")
                    if not states or states[-1][2] != st:
                        states.append((t, rv, st))
            je["states"] = states
            for inc in ("first", "second"):
                uid = je[inc]["uid"]
                je[inc]["bound"] = watch.first("Pod", lambda o, t: o["metadata"].get("uid") == uid
                                               and o["spec"].get("nodeName"))
                je[inc]["ready"] = watch.first("Pod", lambda o, t: o["metadata"].get("uid") == uid and any(
                    c.get("type") == "Ready" and c.get("status") == "True"
                    for c in (o.get("status") or {}).get("conditions") or []))
            pool_nodes = {n.metadata.name for n in cluster.client.list(Node)
                          if n.metadata.labels[GKE_NODEPOOL_LABEL] == je["first"]["pool"]}
            # the park of the preemption: before the second pod bound (the
            # job's success parks its slice warm at its priority too)
            je["parked"] = next(((t, rv) for t, rv, typ, kind, o in watch.events
                                 if kind == "Node" and t >= je["stamp"] and rv < je["second"]["bound"][1]
                                 and o["metadata"]["name"] in pool_nodes
                                 and (o["metadata"].get("annotations") or {}).get(slicepool.POOL_STATE_ANNOTATION)
                                 == "warm" and (o["metadata"].get("annotations") or {}).get(
                                     slicepool.POOL_PRIORITY_ANNOTATION) == str(je["priority"])), None)
            je["claims"] = [(t, rv, o["metadata"]["name"]) for t, rv, typ, kind, o in watch.events
                            if kind == "Node" and (o["metadata"].get("annotations") or {}).get(
                                slicepool.POOL_CLAIMED_BY_ANNOTATION) == key]
            trace_id = (tracing.parse_traceparent(final.metadata.annotations.get(C.TRACEPARENT_ANNOTATION))
                        or ("",))[0]
            je["spans"] = {n: [sp["attributes"] for sp in tracing.recent_spans(trace_id=trace_id, name=n)]
                           for n in ("job.admit", "job.checkpoint", "job.preempt", "job.requeue", "job.run")}
            cluster.client.delete(TPUJob, NS, j.name)
            return je

        seen = {"turns": [], "gate period": config.readiness_probe_period_s}
        debug_roots = {}  # notebook -> its root read over the debug mux
        name, accelerator, topology = DENIED
        state = card_state()
        try:
            denied_at = time.time()
            wire.create(new_notebook(name, accelerator, topology))
            raise AssertionError(f"{name}'s slice {accelerator} {topology} was admitted")
        except AdmissionDeniedError as e:
            seen["denied"] = {"name": name, "error": str(e), "left": owned_by(name),
                              "card": (state, card_state()), "wall": time.time() - denied_at}
        judged.probe(card_state)
        for wave in waves:
            if repair in wave:
                cluster.add_gpu_pool(OTHER_POOL, "h100", "1x1")
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
                    procs = procs_of(name)
                    done = result(pod_dir(pod(name)))
                    assert done or procs is None or procs.running(), \
                        f"{name}'s torchrun exited {procs.proc.returncode}\n{logs()}"
                    return done

                got["result"] = wait(served, f"{name}'s worker")
                # the readiness root, as the timeline kept it when it closed
                trace_id = (tracing.parse_traceparent(got["admitted"].get(C.TRACEPARENT_ANNOTATION)) or ("",))[0]
                got["root"] = wait(lambda: timeline.root(trace_id),
                                   lambda: f"{name}'s notebook.ready root (admitted with trace {trace_id!r}; now "
                                   f"{root_state(name)})")
                # the root over the debug mux, while the span ring holds it
                debug_roots[name] = debug_get(endpoints, f"/debug/traces?name=notebook.ready&trace_id={trace_id}")
                got["while running"] = owned_by(name)
                # the agent's readiness edges, as its device view saw them
                got["agent ready"] = [r["ready"] for r in timeline.records("probe-agent")
                                      if r.get("pod") == f"{NS}/{name}-0"]
                got["serving"] = while_serving()
                got["uid"] = pod(name).metadata.uid
                if name == repair:
                    got["repair"] = repair_episode(name, got)
                    if suspends:
                        got["suspend"] = suspend_episode(name, got)
                    if promotion is not None:
                        got["promotion"] = promotion_episode(name, got)
                    if resume and job is not None:
                        seen["job"] = job_episode(job, resume=name, got=got)
                wait(lambda: notebook(name).metadata.annotations.get(C.STOP_ANNOTATION, C.RECONCILIATION_LOCK_VALUE)
                     != C.RECONCILIATION_LOCK_VALUE, f"{name} culled")
                wait(lambda: cluster.client.get(StatefulSet, NS, name).spec.replicas == 0, f"{name}'s set at 0")
                wait(lambda: not cluster.client.list(Pod, namespace=NS, labels={C.NOTEBOOK_NAME_LABEL: name}),
                     f"{name}'s pod deleted")
                incarnations = [got] + [got[k] for k in ("repair", "resume") if k in got]
                procs = [processes[i["uid"]] for i in incarnations]
                got["pids"] = sorted({p for ps in procs for p in ps.pids} | {i["result"]["pid"] for i in incarnations})
                wait(lambda: all(ps.closed for ps in procs) and not alive(got["pids"]) and released(got["pids"]),
                     f"{name}'s processes {got['pids']} gone and its card released")
                got["free"] = time.time()
                got["alive"] = alive(got["pids"])
                got["culls"] = [r for r in timeline.records("transition")
                                if r.get("machine") == "culling" and r.get("notebook") == f"{NS}/{name}"]
                for what in ("unlocked", "bound", "mesh-ready", "stopped"):
                    got[what] = wait(lambda: timeline.get(f"{name} {what}"), f"the watches to see {name} {what}")
                got["status"] = timeline.ready_status[name]
                cluster.client.delete(Notebook, NS, name)
                wait(lambda: not owned_by(name), f"{name} deleted, its route and policies with it")
        if job is not None and "job" not in seen:
            seen["job"] = job_episode(job)
        judged.probe(card_state)
        seen["denied"]["left at the end"] = owned_by(seen["denied"]["name"])
        if acct is not None:
            acct.stop()
            acct.tick()  # the last interval
            gpu_nodes = sorted(n.metadata.name for n in cluster.client.list(Node)
                               if int(n.status.capacity.get(GPU_RESOURCE, "0") or 0) > 0)
            seen["accounting"] = {
                "period": acct.period_s, "snapshot": acct.snapshot(), "conservation": acct.conservation(),
                "by class and phase": {f"{c} {p}": v for c in accounting.CLASSES for p in accounting.PHASES
                                       if (v := acct.chip_seconds(workload_class=c, phase=p))},
                "ticks": {r: accounting.tpu_accounting_ticks_total.value(result=r) - accounting_before[r]
                          for r in ("ok", "error")},
                "attributed nodes": sorted(a.node for a in acct.classify()), "gpu nodes": gpu_nodes}
        # the phase ends once the availability page is quiet: a firing
        # resolves one long window (1h, scaled) after the outage ends
        deadline = time.monotonic() + judged.engine.windows["1h"] + 10.0
        while AVAILABILITY_PAGE in judged.alerts.firing and time.monotonic() < deadline:
            time.sleep(0.05)
        seen["judgement"] = dict(judged.result(), slo_log=timeline.slo_conditions())
        seen["debug"] = dict(read_debug_mux(endpoints), roots=debug_roots,
                             snapshot=acct.snapshot() if acct is not None else None,
                             reconciled=sorted(c.name for c in mgr.controllers if c.reconcile_count))
        seen["deployguard"] = {"drifts": guard.drifts, "surface": sorted(guard.surface), "guard": guard}
        return seen
    finally:
        deployguard.ACTIVE = guard_before
        if acct is not None:
            accounting.set_current(None)
        if timeline is not None:
            timeline.stop()
        if endpoints is not None:
            endpoints.stop()
        if mgr is not None:
            mgr.stop()
        for undo in reversed(teardown):
            undo()
        cluster.stop()
        if cpprofile_env is None:
            os.environ.pop("CPPROFILE", None)
        else:
            os.environ["CPPROFILE"] = cpprofile_env


class Judgement:
    """What the judgement layer that `build_manager` wired
    (`main._wire_observability`) judged over the flow. The layer is the
    manager's own: the SLO engine, the alert manager, the canary prober and
    the replica autoscaler (`mgr.slo_engine`, `mgr.alert_manager`,
    `mgr.prober`, `mgr.autoscaler`). The flow only observes it: it listens
    to the alert manager's transitions, keeps each autoscaler tick's signals
    (the wired `PodStatsSignals`, each replica's /stats at the pod's
    address) beside the reference's default ones (`samples`), and probes
    the canary by hand at two points (`probe`). The prober's own loop runs
    at Config's canary period, longer than any flow: it makes one probe a
    second after the start, which `started` waits out, so no hand probe
    overlaps one of its own."""

    def __init__(self, mgr):
        self.mgr = mgr
        self.engine, self.alerts, self.prober = mgr.slo_engine, mgr.alert_manager, mgr.prober
        self.alerts.add_listener(self._on_alert)
        self.autoscaler = getattr(mgr, "autoscaler", None)
        if self.autoscaler is not None:
            self.pod_signals = self.autoscaler.signals_fn
            self.autoscaler.signals_fn = self.endpoint_signals
        self._lock = threading.Lock()
        self.transitions = []  # (time, "fired" | "resolved", alert, what the flow read of its mirror)
        self.samples = []  # (time, endpoint state, the wired signals, the reference's default signals)
        self.canaries = []
        self.at_start = None

    def started(self):
        """Waits out the prober loop's first probe; what the layer had
        counted then."""
        wait_for(lambda: self.prober.probes_run >= 1, 60, "the canary prober's first probe")
        self.at_start = {"evaluations": slo_evaluations_total.value(), "events": self._events(),
                         "canary": {r: canary_probes_total.value(result=r) for r in ("ok", "timeout", "error")},
                         "decisions": self.decisions(), "inhibited": self._inhibited(), "t": time.time()}

    def decisions(self):
        return {a: runtime_metrics.autoscaler_decisions_total.value(action=a) for a in ("up", "down", "park", "hold")}

    def _events(self):
        return {name: dict(st["events"]) for name, st in self.engine.evaluate().items()}

    # -- the alerts --

    def _on_alert(self, event, alert):
        """Reads the mirror of each transition as the alert manager left it:
        on a firing, each mirrored notebook's SLOBurnRate event and
        DegradedSLO condition and the incident bundle; on a resolve, which
        mirrored notebooks another firing alert still covers (those keep
        DegradedSLO True until the last covering alert resolves)."""
        seen = {}
        client = self.mgr.api_reader
        if event == "fired":
            for key in alert.get("mirrored", []):
                ns, _, name = key.partition("/")
                try:
                    nb = client.get(Notebook, ns, name)
                    cond = next(((c.status, c.reason) for c in nb.status.conditions
                                 if c.type == C.SLO_DEGRADED_CONDITION), None)
                except NotFoundError:
                    cond = None
                # the alert manager's deduplicated event of this rule on it
                events = [e.reason for e in client.list(Event, namespace=ns)
                          if e.metadata.name == f"{name}.slo-{alert['rule'].lower()}"
                          and e.involved_object.name == name]
                seen[key] = {"condition": cond, "events": events}
            seen["incidents"] = [i["id"] for i in recorder.incidents() if i["reason"] == f"alert:{alert['rule']}"]
        else:
            covering = {k for a in list(self.alerts.firing.values()) for k in a.get("mirrored", [])}
            seen["still covered"] = sorted(set(alert.get("mirrored", [])) & covering)
            seen["covering"] = sorted(a["rule"] for a in list(self.alerts.firing.values())
                                      if set(a.get("mirrored", [])) & set(alert.get("mirrored", [])))
        with self._lock:
            self.transitions.append((time.time(), event, dict(alert), seen))

    # -- the canary --

    def probe(self, card_state):
        """One canary round trip; returns its result and latency, the card's
        compute apps before and after, and whether its CR and pods are gone."""
        before, t0 = card_state(), time.time()
        result, latency = self.prober.probe_once()
        name = f"canary-{self.prober._seq}"
        ns = self.prober.namespace

        def gone():
            try:
                self.mgr.api_reader.get(Notebook, ns, name)
                return False
            except NotFoundError:
                return not [p for p in self.mgr.api_reader.list(Pod, namespace=ns)
                            if p.metadata.labels.get(C.NOTEBOOK_NAME_LABEL) == name]

        wait_for(gone, 60, f"the canary {name} and its pods gone")
        out = {"name": name, "result": result, "latency": latency, "card": (before, card_state()),
               "gone": time.time() - t0}
        self.canaries.append(out)
        return out

    # -- the autoscaler's signals --

    def endpoint_signals(self, ep):
        """The wired signals (the port's PodStatsSignals), kept beside the
        reference's default signals at each tick."""
        ours = self.pod_signals(ep)
        with self._lock:
            self.samples.append((time.time(), ep.metadata.annotations.get(C.INFERENCE_STATE_ANNOTATION, ""), ours,
                                 self.autoscaler._default_signals(ep)))
        return ours

    def result(self):
        """What the layer judged over the flow: the evaluations, each SLO's
        good and total events since the start and its compliance over them,
        the alert transitions with their mirrors, the canaries, the
        coalescer's writes and merged patches, and the autoscaler's
        decisions and samples."""
        events = self._events()
        compliance = {}
        for name, now in events.items():
            was = self.at_start["events"].get(name, {"good": 0.0, "total": 0.0})
            good, total = now["good"] - was["good"], now["total"] - was["total"]
            compliance[name] = {"good": good, "total": total, "compliance": good / total if total > 0 else None}
        coalescer = self.mgr.status_coalescer
        with self._lock:
            transitions, samples = list(self.transitions), list(self.samples)
        return {"evaluations": slo_evaluations_total.value() - self.at_start["evaluations"],
                "compliance": compliance, "transitions": transitions, "canaries": list(self.canaries),
                "canary counters": {r: canary_probes_total.value(result=r) - self.at_start["canary"][r]
                                    for r in ("ok", "timeout", "error")},
                "coalescer": {"writes": coalescer.writes, "coalesced": coalescer.coalesced},
                "decisions": {a: v - self.at_start["decisions"][a] for a, v in self.decisions().items()},
                "samples": samples, "windows": dict(self.engine.windows), "t0": self.at_start["t"],
                "inhibited": {r: n for r, v in self._inhibited().items()
                              if (n := v - self.at_start["inhibited"].get(r, 0.0))}}

    def _inhibited(self):
        return {r.name: slo_alerts_inhibited_total.value(rule=r.name) for r in self.alerts.rules}


class Timeline:
    """Store watches on Pods and Notebooks: when (this process's clock at
    the event's arrival) and at which resourceVersion (one counter for the
    whole store) each notebook's pod was first bound, and each notebook
    first went without its reconciliation lock, was first mesh-ready (and
    its status.tpu then) and first stopped. It also copies the flight
    recorder's agent readiness edges and machine transitions as they come
    (`records`), and each `notebook.ready` root as it closes (`root`): the
    rings are bounded, and the control plane's own records and spans turn
    them over in seconds (the culler writes a notebook ~20 times a second,
    and each write is a webhook span and a reconcile's four)."""

    def __init__(self, store):
        self._watches = [store.watch("v1", "Pod"), store.watch("kubeflow.org/v1beta1", "Notebook")]
        self._done = threading.Event()
        self._lock = threading.Lock()
        self.first = {}  # "<notebook> bound|mesh-ready|stopped" -> (time, rv)
        self.ready_status = {}  # notebook -> status.tpu's JSON when first mesh-ready
        self.pods = {}  # pod uid -> {"bound" | "terminating" | "deleted": (time, rv)}
        # notebook -> [(time, rv, repair state, Degraded (status, reason) or
        # None, meshReady)], one entry each time one of the three changed
        self.log = {}
        self.suspend_log = {}  # notebook -> [(time, rv, suspend state)], one entry each time it changed
        self.slo_log = {}  # notebook -> [(time, rv, DegradedSLO (status, reason))], one entry each time it changed
        self._kept = {}  # (t, kind, subject) -> a flight-recorder record of a kept kind
        self._roots = {}  # trace id -> its notebook.ready root, as exported
        tracing.add_span_listener(self._keep_root)
        self._threads = [threading.Thread(target=self._run, args=(w,), daemon=True) for w in self._watches]
        self._threads.append(threading.Thread(target=self._copy_records, daemon=True))
        for t in self._threads:
            t.start()

    def _note(self, ev):
        obj, now = ev.object, time.time()
        meta = obj.get("metadata", {})
        keys, tpu = [], (obj.get("status") or {}).get("tpu") or {}
        rv = int(meta.get("resourceVersion", 0))
        if obj.get("kind") == "Pod" and obj.get("spec", {}).get("nodeName"):
            keys.append(f"{(meta.get('labels') or {}).get(C.NOTEBOOK_NAME_LABEL)} bound")
        if obj.get("kind") == "Pod":
            edges = [e for e, on in (("bound", obj.get("spec", {}).get("nodeName")),
                                     ("terminating", meta.get("deletionTimestamp")),
                                     ("deleted", ev.type == "DELETED")) if on]
            with self._lock:
                for edge in edges:
                    self.pods.setdefault(meta.get("uid"), {}).setdefault(edge, (now, rv))
        if obj.get("kind") == "Notebook" and ev.type != "DELETED":
            cond = next(((c.get("status"), c.get("reason")) for c in (obj.get("status") or {}).get("conditions") or []
                         if c.get("type") == C.TPU_DEGRADED_CONDITION), None)
            entry = ((meta.get("annotations") or {}).get(C.TPU_REPAIR_STATE_ANNOTATION, ""), cond,
                     bool(tpu.get("meshReady")))
            state = (meta.get("annotations") or {}).get(C.TPU_SUSPEND_STATE_ANNOTATION, "")
            slo = next(((c.get("status"), c.get("reason")) for c in (obj.get("status") or {}).get("conditions") or []
                        if c.get("type") == C.SLO_DEGRADED_CONDITION), None)
            with self._lock:
                conds = self.slo_log.setdefault(meta.get("name"), [])
                if slo is not None and (not conds or conds[-1][2] != slo):
                    conds.append((now, rv, slo))
                log = self.log.setdefault(meta.get("name"), [])
                if not log or log[-1][2:] != entry:
                    log.append((now, rv) + entry)
                states = self.suspend_log.setdefault(meta.get("name"), [])
                if not states or states[-1][2] != state:
                    states.append((now, rv, state))
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
                self.first.setdefault(key, (now, rv))
            if tpu.get("meshReady"):
                self.ready_status.setdefault(meta.get("name"), tpu)

    def _run(self, watch):
        for ev in watch.pending:
            self._note(ev)
        while not self._done.is_set():
            ev = watch.get(timeout=0.05)
            if ev is not None:
                self._note(ev)

    KEPT = ("probe-agent", "transition")

    def _copy_records(self):
        while not self._done.wait(0.05):
            for r in recorder.records():
                if r["kind"] in self.KEPT:
                    with self._lock:
                        self._kept.setdefault((r["t"], r["kind"], r.get("pod"), r.get("notebook")), r)

    def records(self, kind):
        """The kept flight-recorder records of `kind`, oldest first."""
        for r in recorder.records(kind):  # what the copier has not seen yet
            with self._lock:
                self._kept.setdefault((r["t"], r["kind"], r.get("pod"), r.get("notebook")), r)
        with self._lock:
            return [r for key, r in sorted(self._kept.items(), key=lambda kv: kv[0][0]) if key[1] == kind]

    def get(self, key):
        with self._lock:
            return self.first.get(key)

    def pod(self, uid, edge):
        """(time, rv) when the watch first saw the pod bound, terminating or
        deleted."""
        with self._lock:
            return self.pods.get(uid, {}).get(edge)

    def notebook_log(self, name):
        with self._lock:
            return list(self.log.get(name, []))

    def _keep_root(self, span):
        if span.name == "notebook.ready":
            with self._lock:
                self._roots.setdefault(span.trace_id, span.to_dict())

    def root(self, trace_id):
        """[the trace's notebook.ready root] once it has closed, else []."""
        with self._lock:
            return [self._roots[trace_id]] if trace_id in self._roots else []

    def slo_conditions(self):
        """Each notebook's DegradedSLO values, (time, rv, (status, reason))
        each change."""
        with self._lock:
            return {name: list(log) for name, log in self.slo_log.items()}

    def suspend_states(self, name):
        """The notebook's suspend states, (time, rv, state) each change."""
        with self._lock:
            return list(self.suspend_log.get(name, []))

    def stop(self):
        tracing.remove_span_listener(self._keep_root)
        self._done.set()
        for t in self._threads:
            t.join()
        for w in self._watches:
            w.stop()


class Recorder:
    """Store watches that keep every event of some kinds, each with this
    process's clock at its arrival and the store's resourceVersion."""

    def __init__(self, store, kinds):
        self._watches = [store.watch(api_version, kind) for api_version, kind in kinds]
        self._done = threading.Event()
        self._lock = threading.Lock()
        self.events = []  # (time, rv, event type, kind, object)
        self._threads = [threading.Thread(target=self._run, args=(w,), daemon=True) for w in self._watches]
        for t in self._threads:
            t.start()

    def _note(self, ev):
        with self._lock:
            self.events.append((time.time(), int(ev.object.get("metadata", {}).get("resourceVersion", 0)), ev.type,
                                ev.object.get("kind"), ev.object))

    def _run(self, watch):
        for ev in watch.pending:
            self._note(ev)
        while not self._done.is_set():
            ev = watch.get(timeout=0.05)
            if ev is not None:
                self._note(ev)

    def first(self, kind, pred, since=0.0):
        """(time, rv) of the first event of `kind` from `since` on whose
        object (and event type) `pred(obj, type)` holds for, None if none
        did."""
        with self._lock:
            return next(((t, rv) for t, rv, typ, k, o in self.events if k == kind and t >= since and pred(o, typ)),
                        None)

    def values(self, kind, of):
        """The values `of(obj)` took over the events of `kind`, each change
        once."""
        out = []
        with self._lock:
            for _, _, typ, k, o in self.events:
                if k == kind and typ != "DELETED" and (not out or out[-1] != of(o)):
                    out.append(of(o))
        return out

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


def check_repair(got, period, gate_waits):
    """The repair episode's gates (run(repair=...)): the forwarded ack came
    before the old pod's eviction and is the `checkpoint-saved` step; the
    machine went degraded -> repairing -> rest with Degraded opened by
    HostPreempted and closed Repaired; the replacement bound on the other
    pool's node only once every process of the old pod was gone (its stop
    returned before its object went, and none of its pids was alive when
    the replacement was seen bound); the
    slice.repair span (HostPreempted, repaired) is on the notebook's
    `notebook.ready` trace; one repair and one MTTR observation counted,
    the MTTR within the episode's wall time; a slice-degraded incident
    bundle; the replacement restored the acked step and checksum and its
    step k+1 is bit-equal to the first worker's (loss and params checksum);
    with `gate_waits`, mesh-ready again no earlier than the replacement's
    CUDA context less one gate period."""
    r, train = got["repair"], got["result"]["train"]
    assert [type(a) for _, a in r["acks"]] == [dict], r["acks"]
    ack_at, ack = r["acks"][0]
    assert ack["step"] == train["steps"] and ack["checksum"] == train["state checksum"], (ack, train)
    assert r["preempted"] < r["degraded"] <= ack_at < r["old terminating"] <= r["old deleted"], r
    assert r["checkpoint-saved"] == str(ack["step"]), r["checkpoint-saved"]
    assert r["states"] == ["", "degraded", "repairing", ""], r["states"]
    assert r["conditions"][0] == ("True", "HostPreempted") and r["conditions"][-1] == ("False", "Repaired"), \
        r["conditions"]
    assert r["node"] != r["old node"] and r["pool"] == OTHER_POOL != r["old pool"], r
    assert r["old closed at"] is not None and r["old closed at"] <= r["old deleted"] <= r["rebound"], r
    assert r["old alive at rebound"] == [], r["old alive at rebound"]
    (repaired,) = [a for a in r["spans"]["slice.repair"] if a["result"] == "repaired"]
    assert repaired["cause"] == "HostPreempted" and 0 < repaired["mttr_s"] <= r["wall"], repaired
    assert [a["hosts_acked"] for a in r["spans"]["slice.checkpoint"]] == [1], r["spans"]
    assert len(r["spans"]["slice.reschedule"]) == 1, r["spans"]
    assert r["counters"] == {"repaired": 1, "failed": 0, "interruptions": 1, "checkpoint saves": 1,
                             "mttr observations": 1}, r["counters"]
    assert "slice-degraded" in r["incidents"] and 0 < r["goodput"] <= 1, r
    resumed = r["result"]["resumed"]
    assert resumed["restored"]["step"] == ack["step"] and resumed["restored"]["checksum"] == ack["checksum"], \
        (resumed, ack)
    want = train["next"]
    assert (resumed["step"], resumed["loss"], resumed["checksum"]) == (want["step"], want["loss"], want["checksum"]), \
        (resumed, want)
    if gate_waits:
        assert r["mesh-ready again"] >= r["result"]["times"]["context"] - period, \
            r["mesh-ready again"] - r["result"]["times"]["context"]


def check_suspend(got):
    """The suspend episode's gates (run(resume=True) or run(promotion=...)):
    one forwarded save, of the repaired notebook's resumed step with its
    state's checksum, acked through the agent (the controller's re-probes
    joining it) before the suspend; the notebook suspended with that step
    and checksum, the stop kept; its pool released warm at the notebook's
    priority (0); one checkpoint save counted, no reclaim."""
    se, resumed = got["suspend"], got["repair"]["result"]["resumed"]
    assert [type(a) for _, a in se["acks"]] == [dict], se["acks"]
    ack_at, ack = se["acks"][0]
    assert ack["step"] == resumed["step"], (ack, resumed)
    assert se["stop"] < ack_at <= se["suspended"], se
    ann = se["annotations"]
    assert ann[C.TPU_SUSPEND_STATE_ANNOTATION] == "suspended" and ann[C.TPU_SUSPENDED_AT_ANNOTATION], ann
    assert ann[C.TPU_CHECKPOINT_SAVED_ANNOTATION] == str(ack["step"]), ann
    assert ann[C.TPU_CHECKPOINT_CHECKSUM_ANNOTATION] == ack["checksum"], ann
    assert C.STOP_ANNOTATION in ann and C.TPU_RECLAIM_ANNOTATION not in ann, ann
    assert se["pool marks"] in ([("warm", "0")], [("claimed", "0")]), se["pool marks"]
    assert se["counters"]["checkpoint saves"] == 1, se["counters"]
    assert all(v == 0 for k, v in se["counters"].items() if k.startswith("reclaims")), se["counters"]


def check_resume(got, period, gate_waits):
    """The resume episode's gates (run(resume=True, job=...)): the suspend
    states in order (from the first suspend's stop: checkpointing,
    suspended, resuming, active, checkpointing, suspended); one reclaim,
    a job preemption (`capacity-pressure:` on the job before the
    notebook's pod bound); the resumed pod on the job's pool; the worker
    restored the suspend's step and checksum and its next step is bit-equal
    to that step taken on a copy by the worker that saved; the forwarded
    /tpu/restore acked that step and checksum once, verified `ok`
    (RestoreVerified; verifications{ok} +1, no other result); one
    notebook_resume_seconds observation and one notebook.resume span; the
    idle clock re-armed from the resume; the second suspend saved the
    resumed worker's step and released the slice warm; with `gate_waits`,
    the pod Ready and the notebook mesh-ready no earlier than the worker's
    CUDA context less one gate period."""
    re_, se = got["resume"], got["suspend"]
    assert [st for _, _, st in re_["states"]] == ["", "checkpointing", "suspended", "resuming", "", "checkpointing",
                                                  "suspended"], re_["states"]
    c = re_["counters"]
    assert c["reclaims job-preempt"] == 1 and sum(v for k, v in c.items() if k.startswith("reclaims")) == 1, c
    assert c["verifications ok"] == 1 and c["verifications mismatch"] == c["verifications unverified"] == 0, c
    assert c["resumes"] == 1 and c["checkpoint saves"] == 1, c
    assert re_["reclaim stamp"] is not None and re_["bound"] is not None and \
        re_["reclaim stamp"][1] < re_["bound"][1], (re_["reclaim stamp"], re_["bound"])
    _, ack = se["acks"][0]
    restored = re_["result"]["resumed"]
    assert (restored["restored"]["step"], restored["restored"]["checksum"]) == (ack["step"], ack["checksum"]), \
        (restored, ack)
    (twin,) = [x["next"] for x in se["result"]["saves"] if x["step"] == ack["step"]]
    assert (restored["step"], restored["loss"], restored["checksum"]) == (twin["step"], twin["loss"], twin["checksum"]), \
        (restored, twin)
    assert [(a["restored"], a["step"], a["checksum"]) for _, a in re_["restores"] if isinstance(a, dict)] == \
        [(True, ack["step"], ack["checksum"])], re_["restores"]
    assert "RestoreVerified" in re_["events"] and "NotebookResumed" in re_["events"], re_["events"]
    assert len(re_["spans"]) == 1, re_["spans"]
    last = apimachinery.parse_time(re_["annotations at the resume"][C.LAST_ACTIVITY_ANNOTATION]).timestamp()
    assert last >= re_["unstop"] - 1.0, (last, re_["unstop"])
    assert [type(a) for _, a in re_["acks"]] == [dict], re_["acks"]
    _, second = re_["acks"][0]
    assert second["step"] == restored["step"], (second, restored)
    ann = re_["suspend"]["annotations"]
    assert ann[C.TPU_CHECKPOINT_SAVED_ANNOTATION] == str(second["step"]), ann
    if gate_waits:
        context = re_["result"]["times"]["context"]
        assert re_["ready"][0] >= context - period and re_["mesh-ready"][0] >= context - period, \
            (re_["ready"][0] - context, re_["mesh-ready"][0] - context)


def check_promotion(got, period, gate_waits):
    """The promotion episode's gates (run(promotion=...)): the suspend
    acked the forwarded save of the resumed step and wrote it, and released
    the notebook's pool warm (`check_suspend`); the endpoint was promoted with a
    warm bind (EndpointPromoted, promotions{bind=warm} +1, the
    endpoint.promotion span with warm_bind on the endpoint's trace), the
    pool claimed under the endpoint's key before its pod bound there; its
    states went "" -> loading -> serving -> draining -> terminated; the
    restore was verified (the forwarded /tpu/restore's checksum is the
    save's, verifications{ok} +1, no mismatch or unverified, "restore
    verified" in EndpointServing) and the served params' logit fingerprint
    is the notebook's; the route existed while Serving and status.url was
    set; every request answered 200;
    the stop removed the route before the set went to 0 and terminated the
    endpoint, its processes gone, its pool warm again, with no promotion or
    verification from the last replies (the woken ones, with a park) to
    the card free; with `gate_waits`,
    mesh-ready no earlier than the serving process's CUDA context less one
    gate period."""
    pe, resumed = got["promotion"], got["repair"]["result"]["resumed"]
    _, ack = pe["ack"]
    assert ack["step"] == resumed["step"], (ack, resumed)
    assert pe["counters"] == {"promotions warm": 1, "promotions cold": 0, "verifications ok": 1,
                              "verifications mismatch": 0, "verifications unverified": 0}, pe["counters"]
    assert all(v == 0 for v in pe["counters after replies"].values()), pe["counters after replies"]
    assert "claimed its warm slice from the pool (warm bind)" in pe["events"]["EndpointPromoted"], pe["events"]
    assert pe["spans"] == [{"endpoint": pe["endpoint"], "namespace": NS, "source": f"{NS}/{pe['notebook']}",
                            "warm_bind": True}], pe["spans"]
    assert pe["served pool"] == pe["released pool"], pe
    assert pe["claimed"] is not None and pe["bound"] is not None and pe["claimed"][1] < pe["bound"][1], pe
    woken = ["suspended", "", "loading", "serving"] if "autoscale" in pe else []
    assert pe["states"] == ["", "loading", "serving"] + woken + ["draining", "terminated"], pe["states"]
    assert pe["annotations"][C.INFERENCE_PROMOTED_FROM_ANNOTATION] == f"{NS}/{pe['notebook']}", pe["annotations"]
    restore = pe["ready"]["restore"]
    assert restore["restored"] and restore["step"] == ack["step"] and restore["checksum"] == ack["checksum"], \
        (restore, ack)
    assert [(a["restored"], a["step"], a["checksum"]) for _, a in pe["restores"]] == \
        [(True, ack["step"], ack["checksum"])], pe["restores"]
    assert "restore verified" in pe["events"]["EndpointServing"], pe["events"]
    assert pe["ready"]["logit_fingerprint"] == resumed["logit_fingerprint"], (pe["ready"], resumed)
    assert pe["url"] == f"/serving/{NS}/{pe['endpoint']}" and pe["route while serving"], pe
    assert all(r is not None and r[0] == 200 for r in pe["replies"]), pe["replies"]
    assert pe["route gone"] is not None and pe["set at 0"] is not None and \
        pe["route gone"][1] < pe["set at 0"][1] <= pe["terminated"][1], pe
    assert "route removed" in pe["events"]["EndpointDraining"], pe["events"]
    assert "released to the warm pool" in pe["events"]["EndpointTerminated"], pe["events"]
    assert pe["served pool after"] == ["warm"] and pe["alive"] == [], pe
    assert pe["serving"][1] <= pe["mesh-ready"][1], pe
    if gate_waits:
        assert pe["mesh-ready"][0] >= pe["ready"]["times"]["context"] - period, \
            pe["mesh-ready"][0] - pe["ready"]["times"]["context"]


def check_autoscale(got, period):
    """The park and the wake's gates (run(promotion=Promotion(idle_s=...))
    with a cfg's autoscale_period_s): no park before the promotion's last
    reply and one after it, no other scaling; parked Suspended with
    status.replicas and servingReplicas 0, readyReplicas 0, its url and
    route kept, its pool warm, no process of its pod alive; every request
    to the router shed once (no live replica) and the cold wake fired once;
    the woken gang on the pool the park released; no promotion or
    verification from the promotion's replies to the park; the woken
    process restored the suspend's step and checksum, verified once more
    `ok` (verifications{ok} +1, no other result, no new promotion); its logit
    fingerprint the notebook's; every woken request answered 200 through
    the router's one replica; states Suspended -> "" -> Loading ->
    Serving."""
    pe, resumed = got["promotion"], got["repair"]["result"]["resumed"]
    ae, (_, ack) = pe["autoscale"], pe["ack"]
    create, replies, park, end = (pe["decisions at create"], pe["decisions at replies"], ae["decisions at park"],
                                  pe["decisions at the end"])
    assert replies["park"] == create["park"] and park["park"] == replies["park"] + 1 == end["park"], \
        (create, replies, park, end)
    assert end["up"] == create["up"] and end["down"] == create["down"], (create, end)
    assert ae["desired 0"] is not None and ae["suspended"] is not None and ae["desired 0"][1] < ae["suspended"][1], ae
    st = ae["parked status"]
    assert (st["phase"], st.get("replicas", 0), st.get("servingReplicas", 0), st.get("readyReplicas", 0),
            st.get("drainingReplicas", [])) == ("Suspended", 0, 0, 0, []), st
    assert st["url"] == f"/serving/{NS}/{pe['endpoint']}" and ae["route while parked"], ae
    assert [m for m, _ in ae["pool at park"]] == ["warm"] and ae["alive at park"] == [], ae
    assert len(ae["wakes"]) == 1 and ae["counters"]["no replica"] == len(ae["replies"]), (ae["wakes"], ae["counters"])
    assert all(r is not None and r[0] == 200 and r[5] is not None and r[6] == 0 for r in ae["replies"]), \
        ae["replies"]
    assert ae["pool"] == pe["served pool"] and ae["router"] == [0], ae
    assert all(v == 0 for v in ae["counters to park"].values()), ae["counters to park"]
    c = ae["counters"]
    assert (c["verifications ok"], c["verifications mismatch"], c["verifications unverified"],
            c["promotions warm"], c["promotions cold"]) == (1, 0, 0, 0, 0), c
    restore = ae["ready"]["restore"]
    assert (restore["restored"], restore["step"], restore["checksum"]) == (True, ack["step"], ack["checksum"]), \
        (restore, ack)
    assert [(a["restored"], a["step"], a["checksum"]) for _, a in ae["restores"]] == \
        [(True, ack["step"], ack["checksum"])], ae["restores"]
    assert ae["ready"]["logit_fingerprint"] == resumed["logit_fingerprint"], (ae["ready"], resumed)
    assert ae["states"][-4:] == ["suspended", "", "loading", "serving"], ae["states"]
    assert ae["desired 1"] is not None and ae["bound"] is not None and ae["desired 1"][1] < ae["bound"][1], ae
    assert "EndpointSuspended" in ae["events"] and "EndpointWaking" in ae["events"], ae["events"]


def check_judgement(seen):
    """The judgement layer's gates: the engine evaluated through the flow;
    both canary probes `ok`, their CRs and pods gone, the card's compute
    apps unchanged by them; each firing of the availability page
    (AVAILABILITY_PAGE) mirrored onto its notebooks (an SLOBurnRate event,
    DegradedSLO True) with an incident bundle, and resolved by the end;
    each resolve's notebooks back to DegradedSLO False (Recovered) unless
    another firing alert still covered them; with a repaired notebook, the
    page fired between its preemption and its mesh-ready again."""
    j = seen["judgement"]
    assert j["evaluations"] > 0, j["evaluations"]
    assert [c["result"] for c in j["canaries"]] == ["ok", "ok"] and j["canary counters"]["ok"] == 2, j["canaries"]
    for c in j["canaries"]:
        assert c["card"][0] == c["card"][1], c
    page = [(t, ev, a, s) for t, ev, a, s in j["transitions"] if a["rule"] == AVAILABILITY_PAGE]
    fired = [(t, a, s) for t, ev, a, s in page if ev == "fired"]
    resolved = [(t, a, s) for t, ev, a, s in page if ev == "resolved"]
    assert len(resolved) == len(fired) and all(f[0] <= r[0] for f, r in zip(fired, resolved)), page
    for t, alert, mirror in fired:
        assert alert["notebooks"] and alert.get("mirrored") and mirror["incidents"], (alert, mirror)
        for key in alert["mirrored"]:
            assert mirror[key]["events"] == ["SLOBurnRate"] and mirror[key]["condition"] == \
                ("True", "BurnRateExceeded"), (key, mirror)
    for t, alert, mirror in resolved:
        for key in set(alert.get("mirrored", [])) - set(mirror["still covered"]):
            log = j["slo_log"].get(key.partition("/")[2], [])
            assert any(at >= alert["since"] and cond == ("False", "Recovered") for at, _, cond in log), (key, log)
    repaired = [seen[n]["repair"] for n in seen.get("turns", ()) if "repair" in seen[n]]
    for r in repaired:
        assert any(r["preempted"] <= t <= r["mesh-ready again"] for t, _, _ in fired), \
            ([t for t, _, _ in fired], r["preempted"], r["mesh-ready again"])


def job_states_in_order(states):
    """Whether the job's states (each change once) went as the episode
    must: admitted, Running, at least one cadence checkpoint back to
    Running, the preempt's checkpoint, Preempted, the requeue, admitted
    again, Running, and checkpoints until one ends Succeeded."""
    s = [st for _, _, st in states]
    head = ["", "admitted", "running", "checkpointing", "running"]
    if s[:5] != head or "preempted" not in s:
        return False
    i = s.index("preempted")
    before, after = s[5:i], s[i + 1:]
    cadence = ["checkpointing", "running"]
    return (before[-1:] == ["checkpointing"] and before[:-1] == cadence * ((len(before) - 1) // 2)
            and after[:3] == ["", "admitted", "running"] and after[-2:] == ["checkpointing", "succeeded"]
            and after[3:-2] == cadence * ((len(after) - 5) // 2))


def check_job(got, period, gate_waits):
    """The job episode's gates (run(job=...)): the states in order
    (`job_states_in_order`); one preemption (by the user's stamp, or by the
    reclaimer with `resume`), one requeue, one success counted,
    status.preemptions 1, the job at replicas 0 with no pod; the preempted
    slice parked warm at the job's priority (a user's preemption; a
    reclaim's goes to general capacity) and claimed warm again by the job
    before its second pod bound, on the same pool; every
    forwarded save acked once per request; the second pod pinned
    TPU_JOB_RESUME_STEP to the preempt's acked step (the resume-step
    annotation), restored it with the save's checksum, and its step k+1 is
    bit-equal (loss and params checksum) to the first worker's step k+1 on
    a copy; status.completedSteps at least spec.steps and one of the
    second worker's acked steps; the goodput ratio in (0, 1]; no process of
    either pod alive; with `gate_waits`, each pod ready and each Running no
    earlier than its worker's CUDA context less one gate period."""
    j = got
    assert job_states_in_order(j["states"]), [st for _, _, st in j["states"]]
    assert j["counters"] == {"jobs succeeded": 1, "jobs failed": 0, "preemptions host-loss": 0,
                             "preemptions reclaim": int(j["cause"] == "reclaim"),
                             "preemptions user": int(j["cause"] == "user"), "preemptions bind-timeout": 0,
                             "requeues": 1}, j["counters"]
    assert j["status"]["phase"] == "Succeeded" and j["status"]["preemptions"] == 1, j["status"]
    assert j["replicas"] == 0, j["replicas"]
    first, second = j["first"], j["second"]
    if j["cause"] == "user":
        assert j["parked"] is not None, "the preempted slice was not parked warm at the job's priority"
    else:  # reclaim-forced: general capacity, for the requester
        assert j["parked"] is None, "a reclaim-forced preemption parked its slice warm"
    assert second["pool"] == first["pool"], (first["pool"], second["pool"])
    claims = [c for c in j["claims"] if c[0] >= j["stamp"]]
    assert claims and second["bound"] is not None and claims[0][1] < second["bound"][1], (claims, second["bound"])
    assert "warm claim: learner" in j["events"]["JobAdmitted"], j["events"]
    for inc in (first, second):
        assert inc["acks"] and all(isinstance(a, dict) and a.get("step") is not None for _, a in inc["acks"]), \
            (inc["acks"], inc["result"]["times"])
        saves = inc["result"]["saves"]
        assert [(a["step"], a["checksum"]) for _, a in inc["acks"]] == [(x["step"], x["checksum"]) for x in saves], \
            (inc["acks"], saves)
        assert inc["alive"] == [], inc
    resume = first["acks"][-1][1]
    assert j["annotations"][C.JOB_RESUME_STEP_ANNOTATION] == second["env"]["TPU_JOB_RESUME_STEP"] \
        == str(resume["step"]), (j["annotations"], second["env"], resume)
    assert first["env"]["TPU_JOB_RESUME_STEP"] == "0", first["env"]
    resumed = second["result"]["resumed"]
    assert (resumed["restored"]["step"], resumed["restored"]["checksum"]) == (resume["step"], resume["checksum"]), \
        (resumed, resume)
    (twin,) = [x["next"] for x in first["result"]["saves"] if x["step"] == resume["step"]]
    assert (resumed["step"], resumed["loss"], resumed["checksum"]) == (twin["step"], twin["loss"], twin["checksum"]), \
        (resumed, twin)
    assert resume["step"] < j["steps"], f"the first incarnation reached {resume['step']} of {j['steps']} steps"
    done = j["status"]["completedSteps"]
    assert done >= j["steps"] and done in [a["step"] for _, a in second["acks"]], (done, second["acks"])
    assert 0 < j["goodput"] <= 1, j["goodput"]
    if gate_waits:
        running = [t for t, _, st in j["states"] if st == "running"]
        starts = [t for (t, _, st), (_, _, was) in zip(j["states"][1:], j["states"]) if st == "running"
                  and was == "admitted"]
        assert len(starts) == 2 and running, j["states"]
        for inc, start in zip((first, second), starts):
            context = inc["result"]["times"]["context"]
            assert inc["ready"][0] >= context - period and start >= context - period, \
                (inc["ready"][0] - context, start - context)


def check_accounting(acct):
    """The accountant's gates (run with cfg's accounting_period_s > 0): it ticked,
    never in error; the ledger's attributed chip-seconds equal the physical
    cards times the wall within its 1% tolerance; every GPU node is
    attributed exactly once; with a job, the job class banked
    chip-seconds."""
    cons = acct["conservation"]
    assert acct["ticks"]["ok"] > 0 and acct["ticks"]["error"] == 0, acct["ticks"]
    assert cons["physical_chip_seconds"] > 0 and cons["residual_ratio"] <= 0.01, cons
    assert acct["attributed nodes"] == acct["gpu nodes"], acct


def check_debug_mux(seen):
    """The debug mux's gates (CPPROFILE=1 over the flow): /healthz and /readyz 200; /metrics with the notebook families,
    slo_evaluations_total, the autoscaler's decisions (a park among them
    where the endpoint was parked) and, with the accountant, the
    tpu_chip_seconds_* families; /debug/slo with every default SLO judged
    and the availability page not firing; /debug/incidents with the
    repaired notebook's slice-degraded bundle carrying its cpprofile block
    (and its accounting block, with the accountant); /debug/accounting
    equal to the accountant's own snapshot, conserved within 1%; each
    notebook's readiness root over /debug/traces as it closed;
    /debug/reconciles naming every controller that reconciled; every bad
    argument a 400 (/debug/accounting's a 404 without an accountant)."""
    d = seen["debug"]
    assert d["/healthz"][0] == d["/readyz"][0] == 200, (d["/healthz"], d["/readyz"])
    status, metrics, _, _ = d["/metrics"]
    families = {line.split()[2] for line in metrics.splitlines() if line.startswith("# TYPE ")}
    want = {"notebook_create_total", "notebook_culling_total", "notebook_running_total", "notebook_available_ratio",
            "slo_evaluations_total", "autoscaler_decisions_total"}
    assert status == 200 and want <= families, sorted(want - families)
    if any("autoscale" in seen[n].get("promotion", {}) for n in seen["turns"]):
        assert re.search(r'^autoscaler_decisions_total\{action="park"\} [1-9]', metrics, re.M), \
            [line for line in metrics.splitlines() if line.startswith("autoscaler_decisions_total")]
    status, slo, _, _ = d["/debug/slo"]
    assert status == 200 and set(slo["engine"]["slos"]) == {s.name for s in default_slos()}, slo["engine"]
    assert AVAILABILITY_PAGE not in [a["rule"] for a in slo["alerts"]["firing"]], slo["alerts"]["firing"]
    status, listing, _, _ = d["/debug/incidents"]
    assert status == 200
    repaired = [n for n in seen["turns"] if "repair" in seen[n]]
    for name in repaired:
        ids = [i["id"] for i in listing["incidents"] if (i["reason"], i["subject"]) == ("slice-degraded", f"{NS}/{name}")]
        assert ids, listing
        status, bundle, _, _ = d[f"/debug/incidents?id={ids[0]}"]
        assert status == 200 and (bundle.get("cpprofile") or {}).get("controllers"), sorted(bundle)
        if "accounting" in seen:
            assert bundle["accounting"]["ticks"] > 0, bundle.get("accounting")
    if "accounting" in seen:
        status, served, _, _ = d["/debug/accounting"]
        assert status == 200 and served["ticks"] == d["snapshot"]["ticks"] > 0, (served["ticks"], d["snapshot"])
        assert served["chip_seconds"] == d["snapshot"]["chip_seconds"], (served, d["snapshot"])
        assert abs(served["chip_seconds"]["residual_ratio"]) <= 0.01, served["chip_seconds"]
    for name in seen["turns"]:
        status, traces, _, _ = d["roots"][name]
        roots = traces["spans"]
        assert status == 200 and len(roots) == 1 and roots[0]["name"] == "notebook.ready", (name, traces)
        assert roots[0]["trace_id"] == seen[name]["root"][0]["trace_id"], (name, roots)
    status, reconciles, _, _ = d["/debug/reconciles"]
    assert status == 200 and reconciles["enabled"] and set(d["reconciled"]) <= set(reconciles["controllers"]), \
        (d["reconciled"], sorted(reconciles["controllers"]))
    # with no accountant (the manager's, or the process's current one)
    # /debug/accounting answers 404 whatever its arguments
    no_accountant = d["/debug/accounting"][0] == 404
    want = {path: 404 if path.startswith("/debug/accounting") and no_accountant else 400 for path in d["bad args"]}
    assert d["bad args"] == want, d["bad args"]


def check_deployguard(seen, artifact):
    """The manager ran inside the RBAC of the port's generated manifests: no
    drift over the flow, and the rbac-coverage checker over the port's
    package, given the flow's surface dumped to `artifact`, finds no call
    the ClusterRole does not grant. Returns the checker's stale-rule
    findings (one flow does not run every controller's every verb)."""
    from odh_kubeflow_tpu_torch.analysis import deploysurface, run_analysis
    from odh_kubeflow_tpu_torch.analysis.checkers import RbacCoverageChecker

    got = seen["deployguard"]
    assert got["drifts"] == 0, got["drifts"]
    assert {f for f, _, _, _ in got["surface"]} & deploysurface.MANAGER_FLOWS, got["surface"]
    got["guard"].dump(str(artifact))
    checker = RbacCoverageChecker()
    checker.surface = deploysurface.surface_tuples_from_artifact(json.loads(Path(artifact).read_text()))
    findings = run_analysis([str(REPO / "odh_kubeflow_tpu_torch")], checkers=[checker])
    ungranted = [f for f in findings if "stale RBAC" not in f.message]
    assert not ungranted, "\n".join(map(str, ungranted))
    return findings


def check(seen, device, chips_expected=1, gate_waits=False):
    """The assertions every caller makes on run()'s result (and, for a
    repaired notebook, `check_repair`'s). `gate_waits`:
    each pod's agent first reported not ready, then ready (its device view
    follows the pod's processes, not this process), and no pod was
    mesh-ready before its worker's CUDA context, less one gate period."""
    period = seen["gate period"]
    denied = seen["denied"]
    # over the wire: the webhook's message in the Status body
    assert "denied the request: spec.tpu invalid: " in denied["error"], denied
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
        assert len(got["root"]) == 1 and got["root"][0]["start_time"] <= got["mesh-ready"][0], (name, got["root"])
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
        if "suspend" in got:  # stopped by the flow, never idle
            assert got["culls"] == [], got["culls"]
        else:
            assert got["culls"], f"{name}'s stop annotation did not come from the culler"
        if gate_waits:
            assert got["agent ready"][:1] == [False] and True in got["agent ready"], (name, got["agent ready"])
        assert got["alive"] == [], got
        if "repair" in got:
            check_repair(got, period, gate_waits)
        if "suspend" in got:
            check_suspend(got)
        if "promotion" in got:
            check_promotion(got, period, gate_waits)
        if "resume" in got:
            check_resume(got, period, gate_waits)
    # each took the card in turn: bound, stopped, and only then the next bound
    order = [seen[n][k][1] for n in turns for k in ("bound", "stopped")]
    assert order == sorted(order), dict(zip([f"{n} {k}" for n in turns for k in ("bound", "stopped")], order))
    for name in turns:
        if "autoscale" in seen[name].get("promotion", {}):
            check_autoscale(seen[name], period)
    check_judgement(seen)
    if "job" in seen:
        check_job(seen["job"], period, gate_waits)
    check_debug_mux(seen)
    if "accounting" in seen:
        check_accounting(seen["accounting"])
        if "job" in seen:
            assert seen["accounting"]["snapshot"]["chip_seconds"]["by_class"].get("job", 0) > 0, seen["accounting"]
