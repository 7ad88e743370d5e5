"""Kubelet behaviors of the port's SimCluster (cluster/kubelet.py's
`PodDecision`): what runs in a notebook or endpoint pod once the kubelet
starts it.

- `sim_agent_behavior` (counterpart of odh_kubeflow_tpu/probe/agent.py's):
  one in-process `NotebookAgent` per pod over a scripted `SimTPUMonitor`,
  its cards taken from the pod's `nvidia.com/gpu` request. The CPU tests'
  fixture.
- `pod_process_behavior`: the pod's container as real processes. Its
  `serve(pod)` starts the container's command with the env the reconciler
  rendered into that pod (`valueFrom` field refs resolved against the pod,
  as a kubelet does), and an in-process `NotebookAgent` over the monitor
  the caller builds (`cuda_monitor`: the card's `CudaMonitor`, whose chips
  visible are the cards on which a process of the pod holds a CUDA
  context, `cards_in_context`); it returns
  `(host, port, close)`, and `close` stops the processes: SIGTERM to the
  command's process group (torchrun forwards it to its workers, which it
  starts in sessions of their own), SIGKILL to every process of the tree
  after a grace period, and an error if one outlives that. The kubelet
  deletes such a pod gracefully: its object goes only once `close` has
  returned. The agent's /tpu/checkpoint can be forwarded to the pod's
  worker (`forward_checkpoint`, answered by `answer_checkpoint` in the
  worker), since the agent runs in another process than the train state,
  and an InferenceEndpoint pod's /tpu/restore to its serving process
  (`forward_restore`, `answer_restore`), whose agent is not ready until
  that process has restored and listens (`serving_ready`). A resumed (or
  repaired) notebook pod's /tpu/restore goes to its worker the same way,
  and its agent is not ready while the worker reports a restore in flight
  (`restore_report`): the suspend controller verifies the restore once, at
  mesh-ready.

A GPU node is bound to one GPU pod at a time (the scheduler's rule), so
before a GPU pod's processes start, those of any earlier pod on the same
node are stopped: the device plugin hands a card out only once the last
container holding it is gone.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import signal
import subprocess
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Pattern, Sequence, Set, Union

from ..gpu import GPU_RESOURCE
from .agent import CudaMonitor, KernelState, NotebookAgent, NvidiaSmiUtilization, SimTPUMonitor, TPUMonitor


def pod_chips(pod: Any) -> int:
    """The pod's `nvidia.com/gpu` request, summed over its containers."""
    return sum(
        int(((c.resources.requests if c.resources else None) or {}).get(GPU_RESOURCE, "0") or 0)
        for c in pod.spec.containers
    )


def sim_agent_behavior(agents: Dict[Any, NotebookAgent], duty: float = 0.9,
                       kernels_busy: bool = True, chips: Optional[int] = None,
                       visible_chips: Optional[Any] = None, cold_start_s: float = 0.0,
                       node_lookup: Optional[Callable[[str], Any]] = None):
    """Kubelet-sim pod behavior running one NotebookAgent per notebook,
    endpoint or job pod.

    Caches one agent per (pod name, uid, container restarts), aliased under
    the bare pod name for scripting (`agents["nb-0"]`, always the latest
    incarnation). Chips default to the pod's `nvidia.com/gpu` request.
    `visible_chips` degrades reported visibility from agent birth: an int
    for all pods, or {pod_name: chips}.

    `cold_start_s` models the cold slice bring-up a real pod pays (the
    device runtime's start and the group's formation) as kubelet-visible
    startup latency; a pod landing on a warm-pool node (its pool-state
    annotation present: cluster/slicepool.py) skips it. `node_lookup`
    (name -> Node) resolves the pod's node for that check; needed only when
    `cold_start_s` > 0."""
    from ..cluster.kubelet import PodDecision
    from ..cluster.slicepool import POOL_STATE_ANNOTATION
    from ..controllers import constants as C

    delay_memo: Dict[str, float] = {}

    def startup_delay(pod: Any) -> float:
        if cold_start_s <= 0:
            return 0.0
        # sticky per pod incarnation: the claim clears at resume completion,
        # and re-judging then would owe the cold delay after the fact and
        # flip a Ready pod back to Pending
        if pod.metadata.uid in delay_memo:
            return delay_memo[pod.metadata.uid]
        delay = cold_start_s
        if node_lookup is not None and pod.spec.node_name:
            try:
                node = node_lookup(pod.spec.node_name)
            except Exception:
                node = None
            if node is not None and node.metadata.annotations.get(POOL_STATE_ANNOTATION):
                delay = 0.0  # warm: the slice's env staged, its group formed
        delay_memo[pod.metadata.uid] = delay
        return delay

    def behavior(pod: Any) -> Optional[PodDecision]:
        if not (
            pod.metadata.labels.get(C.NOTEBOOK_NAME_LABEL)
            or pod.metadata.labels.get(C.INFERENCE_NAME_LABEL)
            or pod.metadata.labels.get(C.JOB_NAME_LABEL)
        ):
            return None
        # a crash-restarted container gets a fresh agent: its predecessor's
        # close() is permanent
        restarts = sum(s.restart_count for s in pod.status.container_statuses)
        key = (pod.metadata.name, pod.metadata.uid, restarts)
        if key not in agents:
            n_chips = pod_chips(pod) if chips is None else chips
            kernels = KernelState()
            if kernels_busy:
                kernels.set_busy()
            else:
                kernels.set_idle(time.time())
            visible = n_chips
            if isinstance(visible_chips, dict):
                visible = visible_chips.get(pod.metadata.name, n_chips)
            elif visible_chips is not None:
                visible = visible_chips
            agent = NotebookAgent(monitor=SimTPUMonitor(chips=visible, expected=n_chips, duty=duty),
                                  kernels=kernels)
            agent.identity = f"{pod.metadata.namespace}/{pod.metadata.name}"
            agents[key] = agent
            agents[pod.metadata.name] = agent
        agent = agents[key]
        return PodDecision(ready_after=startup_delay(pod), serve=lambda p: agent.serve())

    return behavior


# ---------------------------------------------------------------------------
# real processes
# ---------------------------------------------------------------------------

_FIELD_REF = re.compile(r"^metadata\.(labels|annotations)\['([^']+)'\]$")


def field_ref(pod: Any, path: str) -> str:
    """A downward-API fieldPath of the pod, as the kubelet resolves it."""
    m = _FIELD_REF.match(path)
    if m:
        return getattr(pod.metadata, m.group(1)).get(m.group(2), "")
    if path == "metadata.name":
        return pod.metadata.name
    if path == "metadata.namespace":
        return pod.metadata.namespace
    if path == "spec.nodeName":
        return pod.spec.node_name
    raise ValueError(f"unsupported downward-API fieldPath {path!r}")


def container_env(pod: Any, container: Any) -> Dict[str, str]:
    """The container's env as its process sees it: values as written, and
    `valueFrom.fieldRef` resolved against the pod."""
    env = {}
    for e in container.env:
        if e.value_from is not None:
            ref = e.value_from.field_ref or {}
            if "fieldPath" not in ref:
                raise ValueError(f"env {e.name}: only fieldRef valueFrom is supported, got {e.value_from.to_dict()}")
            env[e.name] = field_ref(pod, ref["fieldPath"])
        else:
            env[e.name] = e.value
    return env


def _primary(pod: Any) -> Any:
    """The container named after the pod's notebook, endpoint or job, else
    the first."""
    from ..controllers import constants as C

    labels = pod.metadata.labels
    name = labels.get(C.NOTEBOOK_NAME_LABEL) or labels.get(C.INFERENCE_NAME_LABEL) or labels.get(C.JOB_NAME_LABEL, "")
    return next((c for c in pod.spec.containers if c.name == name), pod.spec.containers[0])


def _children() -> Dict[int, List[int]]:
    """ppid -> pids, from /proc."""
    out: Dict[int, List[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        out.setdefault(int(fields[1]), []).append(int(entry))
    return out


def process_tree(pid: int) -> List[int]:
    """pid and every live descendant of it."""
    children, out, todo = _children(), [], [pid]
    while todo:
        p = todo.pop()
        out.append(p)
        todo += children.get(p, [])
    return out


# the device node of card N. The driver's initialisation (cuInit: any
# device query, torchrun's launcher, an NVML-only tool) opens it with
# /dev/nvidiactl and /dev/nvidia-uvm and maps it; only a CUDA context maps
# /dev/nvidia-uvm as well (tools/gate_nodes.py on an H100: the launcher
# never does, the worker at its context). It maps it partway through the
# context's creation, 0.06-0.13 s before cuDevicePrimaryCtxRetain returns;
# the driver's event-handler thread starts near the creation's end,
# 1.3-32 ms before it returns (tools/context_stamp.py on an H100), so a
# context counts once both are there
_CARD_NODE = re.compile(r"^/dev/nvidia(\d+)$")
_CONTEXT_NODE = re.compile(r"^/dev/nvidia-uvm$")
_CONTEXT_THREAD = "cuda-EvtHandlr"


def _mapped(pid: int) -> Set[str]:
    """The paths of the files pid maps into its memory."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return {parts[5].strip() for parts in (line.split(maxsplit=5) for line in f) if len(parts) == 6}
    except OSError:
        return set()


def _thread_names(pid: int) -> Set[str]:
    """The names of pid's threads."""
    out: Set[str] = set()
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/{pid}/task/{tid}/comm") as f:
                out.add(f.read().strip())
        except OSError:
            continue
    return out


def cards_in_context(pid: int, node: Pattern[str] = _CARD_NODE,
                     context: Pattern[str] = _CONTEXT_NODE, thread: str = _CONTEXT_THREAD) -> Set[int]:
    """The cards on which pid or a descendant of it holds a CUDA context:
    the numbers `node` matches in the paths a process maps, once that
    process also maps a path `context` matches and runs a thread named
    `thread`."""
    out: Set[int] = set()
    for p in process_tree(pid):
        paths = _mapped(p)
        if any(context.match(path) for path in paths) and thread in _thread_names(p):
            out |= {int(m.group(1)) for m in map(node.match, paths) if m}
    return out


def _alive(pid: int) -> bool:
    """Running, and not a zombie waiting for its parent."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return False
    return stat[stat.rindex(")") + 2] != "Z"


class PodProcesses:
    """One pod's container, started as a process in a session of its own,
    its output in `log_path`."""

    def __init__(self, argv: Sequence[str], env: Dict[str, str], cwd: Optional[str], log_path: str,
                 node: str):
        self.node = node
        self.log_path = log_path
        with open(log_path, "w") as log:
            self.proc = subprocess.Popen(list(argv), env=env, cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                                         start_new_session=True)
        self.pids: List[int] = [self.proc.pid]
        self._lock = threading.Lock()
        self.closed = False
        self.closed_at: Optional[float] = None  # when the last process of the tree was gone

    def running(self) -> bool:
        return self.proc.poll() is None

    def cards(self) -> Set[int]:
        """The cards on which the pod's processes hold a CUDA context."""
        return cards_in_context(self.proc.pid) if self.running() else set()

    def close(self, grace_s: float) -> None:
        """SIGTERM to the process group, SIGKILL to every process of the
        tree (snapshotted before the signals, so workers in sessions of
        their own are among them) after `grace_s`; raises if any outlives
        SIGKILL, and is then not closed: the next call tries again.
        Idempotent once it has returned.

        The waits sleep under `_lock` on purpose: only `close` takes it, to
        make a retried stop exclusive, so the sleeps stall no one but a
        second `close`, which must wait for the first anyway."""
        with self._lock:
            if self.closed:
                return
            tree = process_tree(self.proc.pid) if self.running() else [self.proc.pid]
            self.pids = sorted(set(self.pids) | set(tree))
            if self.running():
                os.killpg(self.proc.pid, signal.SIGTERM)
                try:
                    self.proc.wait(timeout=grace_s)
                except subprocess.TimeoutExpired:
                    pass
            deadline = time.monotonic() + grace_s
            while any(_alive(p) for p in self.pids if p != self.proc.pid) and time.monotonic() < deadline:
                time.sleep(0.05)  # lint: disable=lock-discipline
            for p in self.pids:
                if _alive(p):
                    try:
                        os.kill(p, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
            if self.running():
                self.proc.wait(timeout=grace_s)
            deadline = time.monotonic() + grace_s
            while any(_alive(p) for p in self.pids) and time.monotonic() < deadline:
                time.sleep(0.05)  # lint: disable=lock-discipline
            left = [p for p in self.pids if _alive(p)]
            if not left:
                self.closed = True
                self.closed_at = time.time()
        if left:
            raise RuntimeError(f"processes {left} of the pod outlived SIGKILL")


class ProcessKernels:
    """What /api/kernels reports for a pod whose work is a process: one
    kernel, busy until `idle_since()` returns a time (the work finished),
    then idle since that time. It has no terminals."""

    def __init__(self, idle_since: Callable[[], Optional[float]]):
        self._idle_since = idle_since
        self._state = KernelState()
        self._state.set_busy()
        self._done: Optional[float] = None

    @property
    def kernels(self) -> List[Dict[str, Any]]:
        if self._done is None:
            self._done = self._idle_since()
            if self._done is None:
                self._state.set_busy()  # last_activity follows the clock while busy
            else:
                self._state.set_idle(self._done)
        return self._state.kernels

    @property
    def terminals(self) -> List[Dict[str, Any]]:
        return []


Monitor = Callable[[Any, int, PodProcesses], TPUMonitor]


def cuda_monitor(window_s: float, sample_period_s: float) -> Monitor:
    """A monitor factory: the card's CudaMonitor with explicit chips
    expected (the pod's request), window and sample period, nvidia-smi's
    reading reused for one sample period, and as chips visible the cards
    on which the pod's processes hold a CUDA context (`PodProcesses.cards`):
    the gate opens once the pod's workload has its device runtime up, as
    the reference's agent counts `jax.local_devices()`, not when the
    driver is first opened nor because the operator's process sees a card.
    Until the pod's processes first hold every card, the agent answers its
    readiness with 503 (`CudaMonitor.came_up`): a pod Ready before its
    worker's CUDA context is coming up, not a ChipFailure; a card lost
    after that is one."""

    def make(pod: Any, chips: int, procs: PodProcesses) -> TPUMonitor:
        return CudaMonitor(chips_expected=chips, window_s=window_s, sample_period_s=sample_period_s,
                           utilization_reader=NvidiaSmiUtilization(ttl_s=sample_period_s),
                           chips_reader=lambda: len(procs.cards()))

    return make


# a request a pod's agent forwards to its worker (one per route: the
# checkpoint's, the restore's), and the ack the worker writes back for it
# (one file per request id)
_REQUEST = "{kind}-request.json"
_ACK = "{kind}-ack-{id}.json"
CHECKPOINT_REQUEST = _REQUEST.format(kind="checkpoint")
RESTORE_REQUEST = _REQUEST.format(kind="restore")
# the serving process's control directory (its pod's own), named in its env:
# it writes SERVING_READY there once it has restored its checkpoint and
# listens, answers the forwarded restore requests there, and writes
# SERVING_EXIT when it stops
CONTROL_DIR_ENV = "SERVING_CONTROL_DIR"
SERVING_READY = "serving.json"
SERVING_EXIT = "serving-exit.json"
# a notebook pod's worker that restores a checkpoint before it works (a
# resumed or repaired notebook's) reports it in its pod's directory:
# {"restoring": true} before it touches its card, then {"restoring": false,
# "restored": true, "step", "checksum", ...} once the state is back
RESTORE_REPORT = "restore.json"


def write_json(path: str, obj: Dict[str, Any]) -> None:
    """Written whole, then renamed: a reader never sees half a file."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def read_json(path: str) -> Optional[Dict[str, Any]]:
    """The file's object, None while it does not exist."""
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _forward(directory: str, kind: str, deadline_s: float, done: Callable[[dict], None]) -> Callable[[], dict]:
    """The agent's half: a request written into `directory`, its ack
    awaited. A call made while an earlier request is still unanswered and
    younger than `deadline_s` joins it instead of writing another: a
    controller that re-probes because its GET timed out before a long save
    acked gets that save's ack, and the worker does not save twice."""
    seq = itertools.count()
    lock = threading.Lock()
    pending: Dict[str, Any] = {}  # the unanswered request: its ack path and when it was written

    def hook() -> dict:
        with lock:
            now = time.monotonic()
            if not pending or now - pending["at"] >= deadline_s:
                request_id = f"{os.getpid()}-{time.time_ns()}-{next(seq)}"
                pending.update(id=request_id, at=now,
                               ack=os.path.join(directory, _ACK.format(kind=kind, id=request_id)))
                write_json(os.path.join(directory, _REQUEST.format(kind=kind)), {"id": request_id, "at": time.time()})
            request_id, ack_path, deadline = pending["id"], pending["ack"], pending["at"] + deadline_s
        while time.monotonic() < deadline:
            ack = read_json(ack_path)
            if ack is not None:
                with lock:
                    if pending.get("id") == request_id:
                        pending.clear()
                done(ack)
                return ack
            time.sleep(0.02)
        raise TimeoutError(f"the pod's worker did not ack {kind} request {request_id} in {deadline_s} s")

    return hook


def _answer(directory: str, kind: str, act: Callable[[], dict], answered: Set[str]) -> Optional[dict]:
    try:
        request = read_json(os.path.join(directory, _REQUEST.format(kind=kind)))
    except ValueError:
        return None
    if request is None or request["id"] in answered:
        return None
    answered.add(request["id"])
    try:
        ack = dict(act())
    except Exception as e:  # reported to the agent in the ack
        ack = {"error": repr(e)}
    ack["id"] = request["id"]
    write_json(os.path.join(directory, _ACK.format(kind=kind, id=request["id"])), ack)
    return ack


def _saved(ack: dict) -> None:
    if ack.get("error"):
        raise RuntimeError(f"the worker's save failed: {ack['error']}")


def forward_checkpoint(directory: str, deadline_s: float) -> Callable[[], dict]:
    """A checkpoint hook for the agent of a pod whose train state lives in
    its worker process: it writes a request into `directory` (the pod's
    own), waits up to `deadline_s` for the worker's ack
    (`answer_checkpoint`) and returns it, {"step", "checksum", ...}. A
    worker that does not ack in time, or acks a failed save, makes the hook
    raise, and the agent then reports the save as not done; the hook never
    acks on the worker's behalf."""
    return _forward(directory, "checkpoint", deadline_s, _saved)


def answer_checkpoint(directory: str, save: Callable[[], dict], answered: Set[str]) -> Optional[dict]:
    """The worker's half of `forward_checkpoint`: if a request is waiting in
    `directory` that is not in `answered`, runs `save()` and writes its ack
    (or the error it raised) for that request; returns the ack, None when
    nothing was asked. Call it from the worker's loop."""
    return _answer(directory, "checkpoint", save, answered)


def forward_restore(directory: str, deadline_s: float) -> Callable[[], dict]:
    """The restore half of `forward_checkpoint`: a /tpu/restore hook for
    the agent of a pod whose model lives in its serving process. It returns
    that process's ack (`answer_restore`), {"restored", "step",
    "checksum", ...}; an ack with an error, or none within `deadline_s`
    (keep it under the probe's timeout), makes the hook raise, and the
    agent reports the restore as not done: never verified on the worker's
    behalf."""

    def restored(ack: dict) -> None:
        if ack.get("error"):
            raise RuntimeError(f"the worker's restore failed: {ack['error']}")

    return _forward(directory, "restore", deadline_s, restored)


def answer_restore(directory: str, ack: Callable[[], dict], answered: Set[str]) -> Optional[dict]:
    """The serving process's half of `forward_restore`: answers a waiting
    request with `ack()`, what it restored ({"restored", "step",
    "checksum"} of the state it loaded); None when nothing was asked."""
    return _answer(directory, "restore", ack, answered)


def serving_ready(directory: str) -> Optional[Dict[str, Any]]:
    """The serving process's report once it has restored and listens
    (SERVING_READY in its control directory), None until then."""
    return read_json(os.path.join(directory, SERVING_READY))


def restore_report(directory: str) -> Optional[Dict[str, Any]]:
    """The worker's RESTORE_REPORT in `directory`, None while it has not
    written one (a worker that restores nothing never does)."""
    return read_json(os.path.join(directory, RESTORE_REPORT))


class _LatchedMonitor:
    """A pod's device view that has not come up until `ready()` also holds,
    whatever cards it holds: until then the agent answers its readiness
    with 503, the host coming up. An endpoint pod's waits for its serving
    process to have restored its checkpoint and to listen
    (`serving_ready`), so no reader takes the pod as ready while the model
    it will serve is not there yet; a notebook pod's waits while its worker
    reports a restore in flight (`restore_report`), which the worker writes
    before it creates the CUDA context the card's view comes up on, so the
    suspend controller's one restore check at mesh-ready finds the worker
    able to answer it."""

    def __init__(self, monitor: TPUMonitor, ready: Callable[[], bool]):
        self._monitor, self._ready = monitor, ready
        self._up = False

    def came_up(self) -> bool:
        if not self._up:
            self._up = self._monitor.came_up() and self._ready()
        return self._up

    def __getattr__(self, name: str) -> Any:
        return getattr(self._monitor, name)


def agent_ready(agent: Optional[NotebookAgent]) -> bool:
    """A readiness probe on the agent: its /tpu/readiness answers 200,
    ready."""
    if agent is None:
        return False
    report = agent.routes("/tpu/readiness")
    return report.get("_status", 200) == 200 and bool(report["ready"])


def pod_address(pod: Any, attempts: int = 64) -> str:
    """A loopback address for a pod whose processes run on this host: one
    drawn at random from 127.64.0.0/10 (every 127/8 address reaches the
    host), on which every port the pod's containers declare is free, so
    pods of one host, and of other runs on it, never share one."""
    import random
    import socket

    ports = [p.container_port for c in pod.spec.containers for p in c.ports if p.container_port]
    draw = random.SystemRandom()
    for _ in range(attempts):
        ip = f"127.{draw.randint(64, 127)}.{draw.randint(0, 255)}.{draw.randint(1, 254)}"
        try:
            for port in ports:
                with socket.socket() as sock:
                    sock.bind((ip, port))
        except OSError:
            continue
        return ip
    raise RuntimeError(f"no loopback address with the ports {ports} free")


def pod_process_behavior(
    command: Union[Sequence[str], Callable[[Any], Sequence[str]]],
    log_dir: str,
    *,
    monitor: Monitor,
    idle_since: Callable[[Any], Optional[float]],
    env: Optional[Dict[str, str]] = None,
    cwd: Optional[str] = None,
    grace_s: float = 20.0,
    processes: Optional[Dict[str, PodProcesses]] = None,
    checkpoint_hook: Optional[Callable[[Any], Callable[[], dict]]] = None,
    restore_hook: Optional[Callable[[Any], Callable[[], dict]]] = None,
    control_dir: Optional[Callable[[Any], str]] = None,
):
    """Kubelet behavior that runs a notebook pod's, an InferenceEndpoint
    pod's or a TPUJob pod's container as processes.

    `command` is the container's argv (or pod -> argv); its env is `env`
    (this process's by default) under the primary container's rendered env.
    Each pod's output goes to `log_dir/<pod>-<uid8>.log`. `monitor(pod,
    chips, processes) -> TPUMonitor` builds the agent's device view
    (`cuda_monitor` for the card); `idle_since(pod)` is when the pod's work finished, None
    while it runs (what /api/kernels reports). `processes` (by pod uid: a
    StatefulSet's replacement pod keeps its predecessor's name) is filled
    for the caller to read. `checkpoint_hook(pod)` and `restore_hook(pod)`,
    when given, are the hooks of the pod's agent's /tpu/checkpoint and
    /tpu/restore (`forward_checkpoint`, `forward_restore`).

    `control_dir(pod)`, when given, is the pod's control directory, named
    to its processes in CONTROL_DIR_ENV. An endpoint pod's agent then has
    not come up until the serving process has restored its checkpoint and
    listens there (`serving_ready`): its readiness is 503 meanwhile. A
    notebook pod's agent has not come up while its worker reports a restore
    in flight there (`restore_report`).

    A pod goes Ready only once its agent's readiness is (`agent_ready`): on
    the card, once its processes hold a CUDA context on every card, and for
    an endpoint pod once its serving process listens. A TPUJob counts its
    gang by that Ready condition.

    Each pod gets an address of its own, as a cluster gives each pod an IP:
    a loopback address (`pod_address`), which the kubelet writes as the
    pod's IP and its processes read in POD_IP (the downward API's name), so
    a process listens there on the port its container declares and a
    reader finds it from the pod object alone."""
    from ..cluster.kubelet import PodDecision
    from ..controllers import constants as C

    base_env = dict(os.environ if env is None else env)
    processes = {} if processes is None else processes
    agents: Dict[str, NotebookAgent] = {}  # pod uid -> its agent, until closed
    addresses: Dict[str, str] = {}  # pod uid -> its IP
    live: Dict[str, PodProcesses] = {}  # pod uid -> its processes, until closed
    lock = threading.Lock()

    def reap_node(node: str, uid: str) -> None:
        """Stops the processes of earlier pods on a GPU node."""
        with lock:
            stale = [(u, p) for u, p in live.items() if p.node == node and u != uid]
        for u, p in stale:
            p.close(grace_s)
            with lock:
                live.pop(u, None)

    def serve(pod: Any):
        chips = pod_chips(pod)
        if chips:
            reap_node(pod.spec.node_name, pod.metadata.uid)
        argv = command(pod) if callable(command) else command
        pod_env = {**base_env, **container_env(pod, _primary(pod)), "POD_IP": address_of(pod)}
        if control_dir is not None:
            pod_env[CONTROL_DIR_ENV] = control_dir(pod)
        procs = PodProcesses(argv, pod_env, cwd,
                             os.path.join(log_dir, f"{pod.metadata.name}-{pod.metadata.uid[:8]}.log"),
                             pod.spec.node_name)
        with lock:
            live[pod.metadata.uid] = procs
        processes[pod.metadata.uid] = procs
        device_view = monitor(pod, chips, procs)
        if control_dir is not None and pod.metadata.labels.get(C.INFERENCE_NAME_LABEL):
            directory = control_dir(pod)
            device_view = _LatchedMonitor(device_view, lambda: serving_ready(directory) is not None)
        elif control_dir is not None and pod.metadata.labels.get(C.NOTEBOOK_NAME_LABEL):
            directory = control_dir(pod)
            device_view = _LatchedMonitor(
                device_view, lambda: not (restore_report(directory) or {}).get("restoring", False))
        agent = NotebookAgent(monitor=device_view, kernels=ProcessKernels(lambda: idle_since(pod)),
                              checkpoint_hook=checkpoint_hook(pod) if checkpoint_hook is not None else None)
        if restore_hook is not None:
            agent.restore_hook = restore_hook(pod)
        agent.identity = f"{pod.metadata.namespace}/{pod.metadata.name}"
        host, port, close_agent = agent.serve()
        with lock:
            agents[pod.metadata.uid] = agent

        def close() -> None:
            close_agent()
            procs.close(grace_s)  # a pod whose processes outlive it stays live, its card held
            with lock:
                live.pop(pod.metadata.uid, None)
                agents.pop(pod.metadata.uid, None)

        return host, port, close

    def address_of(pod: Any) -> str:
        with lock:
            if pod.metadata.uid not in addresses:
                addresses[pod.metadata.uid] = pod_address(pod)
            return addresses[pod.metadata.uid]

    def behavior(pod: Any) -> Optional[PodDecision]:
        # notebook, serving-endpoint and batch-job pods all run the same
        # in-pod agent (the reference's sim_agent_behavior takes the three).
        # The reference's agent owns its runtime, so its pod is Ready with
        # it; here the workload is a process beside the agent, so the pod
        # is Ready once a readiness probe on its agent passes
        labels = pod.metadata.labels
        if not (labels.get(C.NOTEBOOK_NAME_LABEL) or labels.get(C.INFERENCE_NAME_LABEL)
                or labels.get(C.JOB_NAME_LABEL)):
            return None
        return PodDecision(serve=serve, graceful=True, ready=lambda: agent_ready(agents.get(pod.metadata.uid)),
                           pod_ip=address_of(pod))

    return behavior
