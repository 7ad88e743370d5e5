"""Controller configuration.

The reference stacks CLI flags + env vars + kustomize params (SURVEY §5
config/flag system); this build centralizes them in one dataclass whose
from_env() reads the same env names the reference uses, so deployment
manifests translate directly. The control-plane profiler is armed by
CPPROFILE=1 (runtime/cpprofile.py reads it at each hook), as in the
reference. ENV_CONTRACT, at the end, declares every environment knob the
port reads."""
from __future__ import annotations

import os
from dataclasses import dataclass


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclass(frozen=True)
class EnvKnob:
    """One declared environment knob — the env half of the deployment-surface
    contract (analysis/deploysurface.py). The env-contract checker
    (analysis/checkers/deploylint.py) proves every os.environ read
    package-wide resolves to an entry here, that every entry has a live
    reader, and that manifest=True knobs ride the generated Deployment env
    stanza / culler ConfigMap (deploy/manifests.py)."""

    name: str
    default: str
    consumer: str  # module that reads it
    doc: str
    # True: the generated manifests must carry this knob (and vice versa)
    manifest: bool = False


@dataclass
class Config:
    """The fields that the port's controllers, webhook, extension, chip
    accountant, pool prewarmer, status coalescer, judgement layer and
    main.py read. The reference's Config also holds the token router's
    knobs, which come back with a main.py that builds a router. The pool
    prewarmer's default shape is the port's own (h100 1x4)."""

    # core reconciler (reference notebook_controller.go:238,514,576-599)
    cluster_domain: str = "cluster.local"
    add_fsgroup: bool = True

    # culling (reference culling_controller.go:525-558; minutes, same defaults)
    enable_culling: bool = False
    cull_idle_time_min: float = 1440.0
    idleness_check_period_min: float = 1.0
    dev_mode: bool = False

    # accelerator culling signal: require BOTH Jupyter-idle and device-idle
    tpu_idle_threshold: float = 0.05  # duty cycle below which the slice is idle
    probe_port: int = 8889
    # probe circuit breaker (runtime/breaker.py): after `threshold`
    # consecutive jupyter-probe failures for one notebook, skip probing it
    # for a growing cooldown instead of paying connect timeouts every cycle
    probe_breaker_threshold: int = 3
    probe_breaker_cooldown_s: float = 30.0
    # device-visibility readiness gate (controllers/probe_status.py): poll
    # cadence for /tpu/readiness until the mesh gate is green
    readiness_probe_period_s: float = 10.0
    # slice repair (controllers/slice_repair.py): the checkpoint-before-evict
    # window (how long a Degraded slice gets to save state before the gang is
    # evicted), and the bounded jittered retry while capacity recovers —
    # attempt N waits ~ base * 2^N (+/- jitter), RepairFailed after max
    checkpoint_window_s: float = 30.0
    repair_max_attempts: int = 6
    repair_backoff_s: float = 1.0
    repair_backoff_max_s: float = 30.0
    # MaxConcurrentReconciles analog: worker threads per controller. The
    # workqueue's per-key single-flight makes >1 safe
    max_concurrent_reconciles: int = 4
    # suspend/resume + warm slice pools (controllers/suspend.py,
    # cluster/slicepool.py): culling a GPU notebook checkpoints kernel state
    # and releases the slice into a warm pool instead of tearing it down;
    # resume binds from the pool (hit) or falls back to cold placement
    # (miss). Opt-in like culling itself.
    suspend_enabled: bool = False
    # checkpoint-before-suspend window (the cull path's analog of the repair
    # path's checkpoint_window_s)
    suspend_checkpoint_window_s: float = 15.0
    # per-ordinal checkpoint-hook retries inside the window: bounded, jittered
    # (the cluster/client.py 429 pattern) so one transient probe-agent blip
    # never aborts the whole suspend
    suspend_checkpoint_retries: int = 3
    suspend_checkpoint_backoff_s: float = 0.2
    # resume: one attempt = one warm-claim-or-cold-placement try; a resume
    # that hasn't reached mesh-ready within resume_timeout_s re-claims (a
    # poisoned warm slice must not wedge the notebook), ResumeFailed after max
    resume_timeout_s: float = 60.0
    resume_max_attempts: int = 6
    # oversubscription policy: total admitted card demand (notebooks,
    # endpoints and admitted jobs) may not exceed this budget; a job whose
    # admission would pass it queues with a QueuedOverBudget condition
    # instead of reclaiming anything. 0 = no budget cap.
    chip_budget: int = 0
    # how long a GPU pod must sit unschedulable before the reclaimer acts —
    # the scheduler's capacity-freed fast path gets first shot
    reclaim_pending_grace_s: float = 1.0
    # slice-pool pre-warming (cluster/slicepool.py PoolPrewarmer): keep this
    # many warm slices of the configured shape AHEAD of demand instead of
    # only recycling suspended ones. 0 = off. The shape is one
    # `gpu.plan_slice` plans: h100 1x4, one host of 4 cards (the reference's
    # v5e 2x2 is one host of 4 chips)
    pool_prewarm: int = 0
    pool_prewarm_accelerator: str = "h100"
    pool_prewarm_topology: str = "1x4"
    # inference serving (controllers/inference.py): how long Loading gets to
    # reach mesh-ready + verified restore before LoadFailed, and the default
    # drain window a stopped endpoint's in-flight requests get (overridable
    # per-endpoint via spec.serving.drainTimeoutS)
    serving_loading_window_s: float = 30.0
    serving_drain_timeout_s: float = 5.0
    # batch/RL jobs (controllers/job.py): the bounded window a cadence or
    # preempt checkpoint gets before the job moves on, the requeue
    # backoff a preempted job waits before re-admitting (an instant
    # re-admission would race the very requester its slice was reclaimed
    # for), and the bind timeout after which an Admitted job whose gangs
    # never all came ready parks and requeues instead of wedging (a
    # claimed slice can die under the gang mid-bind)
    job_checkpoint_window_s: float = 10.0
    job_requeue_backoff_s: float = 2.0
    job_admission_timeout_s: float = 120.0
    # fleet chip-time accountant (runtime/accounting.py): its tick period
    # (0 = off), and the idle window past which a bound+ready notebook
    # counts idle-bound
    accounting_period_s: float = 1.0
    accounting_idle_after_s: float = 300.0
    # SLO engine + alerting (runtime/slo.py, runtime/alerts.py): window_scale
    # shrinks the canonical 5m/30m/1h/6h burn windows (soaks/tests run the
    # real rule shapes in seconds); eval period 0 derives from the scale
    slo_enabled: bool = True
    slo_window_scale: float = 1.0
    slo_eval_period_s: float = 0.0
    # black-box canary prober (runtime/prober.py): period 0 disables; an
    # accelerator/topology makes the canary exercise the device-visibility
    # gate instead of a plain CPU notebook
    canary_period_s: float = 0.0
    canary_timeout_s: float = 120.0
    canary_namespace: str = "slo-canary"
    canary_accelerator: str = ""
    canary_topology: str = ""
    # SLO-burn replica autoscaler (runtime/autoscaler.py): period 0 disables;
    # stabilization/idle are the DEFAULTS an endpoint's autoscaling spec can
    # override per endpoint
    autoscale_period_s: float = 0.0
    autoscale_stabilization_s: float = 30.0
    autoscale_idle_s: float = 120.0
    # status-write coalescing window (runtime/coalesce.py): adjacent status
    # mirror patches for one object within this window batch into a single
    # PATCH (leading-edge write-through, so steady state is unchanged).
    # 0 disables coalescing entirely
    status_coalesce_window_s: float = 0.05

    # extension controller / webhook (reference odh main.go + webhook consts)
    auth_proxy_image: str = "kube-rbac-proxy:latest"
    gateway_name: str = "data-science-gateway"
    gateway_namespace: str = "openshift-ingress"
    controller_namespace: str = "tpu-notebooks-system"
    set_pipeline_rbac: bool = False
    set_pipeline_secret: bool = False
    inject_cluster_proxy_env: bool = False

    @classmethod
    def from_env(cls) -> "Config":
        c = cls()
        c.cluster_domain = os.environ.get("CLUSTER_DOMAIN", c.cluster_domain)
        c.add_fsgroup = _env_bool("ADD_FSGROUP", c.add_fsgroup)
        c.enable_culling = _env_bool("ENABLE_CULLING", c.enable_culling)
        if os.environ.get("CULL_IDLE_TIME"):
            c.cull_idle_time_min = float(os.environ["CULL_IDLE_TIME"])
        if os.environ.get("IDLENESS_CHECK_PERIOD"):
            c.idleness_check_period_min = float(os.environ["IDLENESS_CHECK_PERIOD"])
        if os.environ.get("TPU_IDLE_THRESHOLD"):
            c.tpu_idle_threshold = max(0.0, float(os.environ["TPU_IDLE_THRESHOLD"]))
        c.dev_mode = _env_bool("DEV", c.dev_mode)
        c.auth_proxy_image = os.environ.get("AUTH_PROXY_IMAGE", c.auth_proxy_image)
        c.gateway_name = os.environ.get("NOTEBOOK_GATEWAY_NAME", c.gateway_name)
        c.gateway_namespace = os.environ.get(
            "NOTEBOOK_GATEWAY_NAMESPACE", c.gateway_namespace
        )
        c.controller_namespace = os.environ.get("K8S_NAMESPACE", c.controller_namespace)
        c.set_pipeline_rbac = _env_bool("SET_PIPELINE_RBAC", c.set_pipeline_rbac)
        c.set_pipeline_secret = _env_bool("SET_PIPELINE_SECRET", c.set_pipeline_secret)
        c.inject_cluster_proxy_env = _env_bool(
            "INJECT_CLUSTER_PROXY_ENV", c.inject_cluster_proxy_env
        )
        if os.environ.get("PROBE_BREAKER_THRESHOLD"):
            c.probe_breaker_threshold = max(
                1, int(os.environ["PROBE_BREAKER_THRESHOLD"])
            )
        if os.environ.get("PROBE_BREAKER_COOLDOWN_S"):
            c.probe_breaker_cooldown_s = float(
                os.environ["PROBE_BREAKER_COOLDOWN_S"]
            )
        if os.environ.get("READINESS_PROBE_PERIOD_S"):
            c.readiness_probe_period_s = float(os.environ["READINESS_PROBE_PERIOD_S"])
        if os.environ.get("CHECKPOINT_WINDOW_S"):
            c.checkpoint_window_s = float(os.environ["CHECKPOINT_WINDOW_S"])
        if os.environ.get("REPAIR_MAX_ATTEMPTS"):
            # clamp: at least one attempt, or every degradation would be
            # declared RepairFailed before the first re-placement
            c.repair_max_attempts = max(1, int(os.environ["REPAIR_MAX_ATTEMPTS"]))
        if os.environ.get("REPAIR_BACKOFF_S"):
            c.repair_backoff_s = float(os.environ["REPAIR_BACKOFF_S"])
        if os.environ.get("REPAIR_BACKOFF_MAX_S"):
            c.repair_backoff_max_s = float(os.environ["REPAIR_BACKOFF_MAX_S"])
        c.suspend_enabled = _env_bool("ENABLE_SUSPEND", c.suspend_enabled)
        if os.environ.get("SUSPEND_CHECKPOINT_WINDOW_S"):
            c.suspend_checkpoint_window_s = float(
                os.environ["SUSPEND_CHECKPOINT_WINDOW_S"]
            )
        if os.environ.get("RESUME_TIMEOUT_S"):
            # clamp: a zero/negative timeout would burn every resume attempt
            # in one reconcile pass and land straight in ResumeFailed
            c.resume_timeout_s = max(0.1, float(os.environ["RESUME_TIMEOUT_S"]))
        if os.environ.get("RESUME_MAX_ATTEMPTS"):
            c.resume_max_attempts = max(1, int(os.environ["RESUME_MAX_ATTEMPTS"]))
        if os.environ.get("POOL_PREWARM"):
            c.pool_prewarm = max(0, int(os.environ["POOL_PREWARM"]))
        c.pool_prewarm_accelerator = os.environ.get(
            "POOL_PREWARM_ACCELERATOR", c.pool_prewarm_accelerator
        )
        c.pool_prewarm_topology = os.environ.get(
            "POOL_PREWARM_TOPOLOGY", c.pool_prewarm_topology
        )
        if os.environ.get("MAX_CONCURRENT_RECONCILES"):
            # clamp: 0/negative would spawn no workers and silently disable
            # every controller
            c.max_concurrent_reconciles = max(
                1, int(os.environ["MAX_CONCURRENT_RECONCILES"])
            )
        if os.environ.get("RECLAIM_PENDING_GRACE_S"):
            c.reclaim_pending_grace_s = max(
                0.0, float(os.environ["RECLAIM_PENDING_GRACE_S"])
            )
        if os.environ.get("CHIP_BUDGET"):
            c.chip_budget = max(0, int(os.environ["CHIP_BUDGET"]))
        if os.environ.get("SERVING_LOADING_WINDOW_S"):
            # clamp: a zero window would declare LoadFailed before the first
            # readiness probe ever ran
            c.serving_loading_window_s = max(
                0.1, float(os.environ["SERVING_LOADING_WINDOW_S"])
            )
        if os.environ.get("SERVING_DRAIN_TIMEOUT_S"):
            c.serving_drain_timeout_s = max(
                0.0, float(os.environ["SERVING_DRAIN_TIMEOUT_S"])
            )
        if os.environ.get("JOB_CHECKPOINT_WINDOW_S"):
            # clamp: a zero window would abandon every save before the first
            # checkpoint probe ever ran
            c.job_checkpoint_window_s = max(
                0.1, float(os.environ["JOB_CHECKPOINT_WINDOW_S"])
            )
        if os.environ.get("JOB_REQUEUE_BACKOFF_S"):
            c.job_requeue_backoff_s = max(
                0.0, float(os.environ["JOB_REQUEUE_BACKOFF_S"])
            )
        if os.environ.get("JOB_ADMISSION_TIMEOUT_S"):
            # 0 disables the bind timeout entirely
            c.job_admission_timeout_s = max(
                0.0, float(os.environ["JOB_ADMISSION_TIMEOUT_S"])
            )
        c.slo_enabled = _env_bool("SLO_ENABLED", c.slo_enabled)
        if os.environ.get("SLO_WINDOW_SCALE"):
            # clamp: non-positive would collapse every burn window to zero
            c.slo_window_scale = max(1e-6, float(os.environ["SLO_WINDOW_SCALE"]))
        if os.environ.get("SLO_EVAL_PERIOD_S"):
            c.slo_eval_period_s = max(0.0, float(os.environ["SLO_EVAL_PERIOD_S"]))
        if os.environ.get("STATUS_COALESCE_WINDOW_S"):
            c.status_coalesce_window_s = max(
                0.0, float(os.environ["STATUS_COALESCE_WINDOW_S"])
            )
        if os.environ.get("CANARY_PERIOD_S"):
            c.canary_period_s = max(0.0, float(os.environ["CANARY_PERIOD_S"]))
        if os.environ.get("CANARY_TIMEOUT_S"):
            c.canary_timeout_s = max(1.0, float(os.environ["CANARY_TIMEOUT_S"]))
        c.canary_namespace = os.environ.get("CANARY_NAMESPACE", c.canary_namespace)
        c.canary_accelerator = os.environ.get(
            "CANARY_ACCELERATOR", c.canary_accelerator
        )
        c.canary_topology = os.environ.get("CANARY_TOPOLOGY", c.canary_topology)
        if os.environ.get("AUTOSCALE_PERIOD_S"):
            c.autoscale_period_s = max(
                0.0, float(os.environ["AUTOSCALE_PERIOD_S"])
            )
        if os.environ.get("AUTOSCALE_STABILIZATION_S"):
            c.autoscale_stabilization_s = max(
                0.0, float(os.environ["AUTOSCALE_STABILIZATION_S"])
            )
        if os.environ.get("AUTOSCALE_IDLE_S"):
            c.autoscale_idle_s = max(0.0, float(os.environ["AUTOSCALE_IDLE_S"]))
        if os.environ.get("ACCOUNTING_PERIOD_S"):
            c.accounting_period_s = max(
                0.0, float(os.environ["ACCOUNTING_PERIOD_S"])
            )
        if os.environ.get("ACCOUNTING_IDLE_AFTER_S"):
            c.accounting_idle_after_s = max(
                0.0, float(os.environ["ACCOUNTING_IDLE_AFTER_S"])
            )
        return c


# ---------------------------------------------------------------------------
# ENV_CONTRACT: every environment knob the port reads, declared once.
# The env-contract checker fails on undeclared reads and dead entries;
# keep consumer/doc accurate — they are the operator-facing registry.
# ---------------------------------------------------------------------------

ENV_CONTRACT: tuple = (
    # -- manager config (this module, Config.from_env) --
    EnvKnob("CLUSTER_DOMAIN", "cluster.local", "controllers/config.py",
            "cluster DNS suffix for service URLs"),
    EnvKnob("ADD_FSGROUP", "true", "controllers/config.py",
            "inject pod fsGroup for notebook volumes"),
    EnvKnob("ENABLE_CULLING", "false", "controllers/config.py",
            "enable the idle-culling controller", manifest=True),
    EnvKnob("CULL_IDLE_TIME", "1440", "controllers/config.py",
            "idle minutes before a notebook is culled", manifest=True),
    EnvKnob("IDLENESS_CHECK_PERIOD", "1", "controllers/config.py",
            "minutes between idleness probes", manifest=True),
    EnvKnob("TPU_IDLE_THRESHOLD", "0.05", "controllers/config.py",
            "device duty cycle below which a slice counts idle", manifest=True),
    EnvKnob("DEV", "false", "controllers/config.py",
            "dev mode: relax webhook/cert requirements"),
    EnvKnob("NOTEBOOK_GATEWAY_NAME", "data-science-gateway",
            "controllers/config.py", "Gateway routes attach to"),
    EnvKnob("NOTEBOOK_GATEWAY_NAMESPACE", "openshift-ingress",
            "controllers/config.py", "namespace of the Gateway"),
    EnvKnob("K8S_NAMESPACE", "tpu-notebooks-system", "controllers/config.py",
            "the manager's own namespace", manifest=True),
    EnvKnob("AUTH_PROXY_IMAGE", "kube-rbac-proxy:latest",
            "controllers/config.py",
            "kube-rbac-proxy sidecar image for oauth workbenches",
            manifest=True),
    EnvKnob("SET_PIPELINE_RBAC", "false", "controllers/config.py",
            "grant pipeline RBAC per workbench namespace"),
    EnvKnob("SET_PIPELINE_SECRET", "false", "controllers/config.py",
            "mirror the elyra pipeline secret per workbench"),
    EnvKnob("INJECT_CLUSTER_PROXY_ENV", "false", "controllers/config.py",
            "inject cluster-wide proxy env into notebooks"),
    EnvKnob("PROBE_BREAKER_THRESHOLD", "3", "controllers/config.py",
            "consecutive probe failures before the circuit opens"),
    EnvKnob("PROBE_BREAKER_COOLDOWN_S", "30", "controllers/config.py",
            "probe circuit-breaker cooldown seconds"),
    EnvKnob("READINESS_PROBE_PERIOD_S", "10", "controllers/config.py",
            "device-visibility readiness poll period"),
    EnvKnob("CHECKPOINT_WINDOW_S", "30", "controllers/config.py",
            "checkpoint-before-evict window for degraded slices"),
    EnvKnob("REPAIR_MAX_ATTEMPTS", "6", "controllers/config.py",
            "re-placement attempts before RepairFailed"),
    EnvKnob("REPAIR_BACKOFF_S", "1", "controllers/config.py",
            "base repair retry backoff"),
    EnvKnob("REPAIR_BACKOFF_MAX_S", "30", "controllers/config.py",
            "repair retry backoff cap"),
    EnvKnob("ENABLE_SUSPEND", "false", "controllers/config.py",
            "cull GPU notebooks into the warm slice pool"),
    EnvKnob("SUSPEND_CHECKPOINT_WINDOW_S", "15", "controllers/config.py",
            "checkpoint-before-suspend window"),
    EnvKnob("RESUME_TIMEOUT_S", "60", "controllers/config.py",
            "per-attempt resume-to-mesh-ready timeout"),
    EnvKnob("RESUME_MAX_ATTEMPTS", "6", "controllers/config.py",
            "resume attempts before ResumeFailed"),
    EnvKnob("CHIP_BUDGET", "0", "controllers/config.py",
            "oversubscription budget in cards (also read by utils/invcheck)"),
    EnvKnob("RECLAIM_PENDING_GRACE_S", "1", "controllers/config.py",
            "unschedulable grace before reclaim acts"),
    EnvKnob("POOL_PREWARM", "0", "controllers/config.py",
            "warm slices to keep ahead of demand"),
    EnvKnob("POOL_PREWARM_ACCELERATOR", "h100", "controllers/config.py",
            "accelerator type of pre-warmed slices"),
    EnvKnob("POOL_PREWARM_TOPOLOGY", "1x4", "controllers/config.py",
            "topology of pre-warmed slices"),
    EnvKnob("SERVING_LOADING_WINDOW_S", "30", "controllers/config.py",
            "InferenceEndpoint Loading window before LoadFailed"),
    EnvKnob("SERVING_DRAIN_TIMEOUT_S", "5", "controllers/config.py",
            "default endpoint drain window (also serving/__main__)"),
    EnvKnob("JOB_CHECKPOINT_WINDOW_S", "10", "controllers/config.py",
            "TPUJob (the batch kind) checkpoint window"),
    EnvKnob("JOB_REQUEUE_BACKOFF_S", "2", "controllers/config.py",
            "preempted-job requeue backoff"),
    EnvKnob("JOB_ADMISSION_TIMEOUT_S", "120", "controllers/config.py",
            "gang-bind timeout before a job parks and requeues"),
    EnvKnob("SLO_ENABLED", "true", "controllers/config.py",
            "run the SLO engine"),
    EnvKnob("SLO_WINDOW_SCALE", "1", "controllers/config.py",
            "shrink factor for burn-rate windows in soaks"),
    EnvKnob("SLO_EVAL_PERIOD_S", "0", "controllers/config.py",
            "SLO evaluation period (0 = derive from scale)"),
    EnvKnob("STATUS_COALESCE_WINDOW_S", "0.05", "controllers/config.py",
            "status-write coalescing window (0 disables)"),
    EnvKnob("CANARY_PERIOD_S", "0", "controllers/config.py",
            "canary probe period (0 disables; also gates main.py wiring)"),
    EnvKnob("CANARY_TIMEOUT_S", "120", "controllers/config.py",
            "canary round-trip timeout"),
    EnvKnob("CANARY_NAMESPACE", "slo-canary", "controllers/config.py",
            "namespace canary notebooks land in"),
    EnvKnob("CANARY_ACCELERATOR", "", "controllers/config.py",
            "canary accelerator ('' = CPU canary)"),
    EnvKnob("CANARY_TOPOLOGY", "", "controllers/config.py",
            "canary slice topology"),
    EnvKnob("AUTOSCALE_PERIOD_S", "0", "controllers/config.py",
            "replica-autoscaler sweep period (0 disables; also gates "
            "main.py wiring)"),
    EnvKnob("AUTOSCALE_STABILIZATION_S", "30", "controllers/config.py",
            "default scale-down stabilization window (flap damping)"),
    EnvKnob("AUTOSCALE_IDLE_S", "120", "controllers/config.py",
            "default idle window before scale-to-zero parks an endpoint"),
    EnvKnob("ACCOUNTING_PERIOD_S", "1", "controllers/config.py",
            "chip-time accountant tick period (0 disables; also gates "
            "main.py wiring)"),
    EnvKnob("ACCOUNTING_IDLE_AFTER_S", "300", "controllers/config.py",
            "activity staleness before bound chips count idle-bound"),
    EnvKnob("MAX_CONCURRENT_RECONCILES", "4", "controllers/config.py",
            "worker threads per controller"),
    # -- manager process wiring (main.py) --
    EnvKnob("LOG_FORMAT", "text", "main.py", "text or json log output"),
    EnvKnob("KUBERNETES_SERVICE_HOST", "", "main.py",
            "in-cluster apiserver host (also cluster/remote.py)"),
    EnvKnob("KUBERNETES_SERVICE_PORT", "443", "cluster/remote.py",
            "in-cluster apiserver port"),
    EnvKnob("KUBECONFIG", "", "main.py",
            "out-of-cluster kubeconfig path (also cluster/remote.py)"),
    EnvKnob("KUBE_API_QPS", "20", "main.py",
            "client-side rate limit for the remote transport"),
    EnvKnob("KUBE_API_BURST", "30", "main.py",
            "client-side burst for the remote transport"),
    EnvKnob("WEBHOOK_CERT_DIR", "/tmp/k8s-webhook-server/serving-certs",
            "main.py", "webhook TLS cert directory"),
    EnvKnob("WEBHOOK_PORT", "9443", "main.py", "webhook listen port"),
    EnvKnob("METRICS_PORT", "8080", "main.py", "metrics listen port"),
    EnvKnob("HEALTH_PORT", "8081", "main.py", "health listen port"),
    # -- probe agent (runs in the notebook pod, not the manager) --
    EnvKnob("NB_PROBE_PORT", "8889", "probe/__main__.py",
            "probe agent listen port"),
    EnvKnob("NB_TPU_CHIPS_EXPECTED", "0", "probe/agent.py",
            "cards the agent expects to see locally"),
    EnvKnob("NB_TPU_HOSTS", "1", "probe/agent.py",
            "hosts in the slice gang"),
    EnvKnob("JAX_PROCESS_ID", "0", "probe/agent.py",
            "the webhook's process index (also parallel/distributed.py)"),
    EnvKnob("TPU_RUNTIME_METRICS_PORTS", "", "probe/agent.py",
            "device runtime metrics ports to scrape (the reference's name)"),
    EnvKnob("HOSTNAME", "", "probe/agent.py",
            "pod hostname for ordinal derivation"),
    # -- the slice a pod belongs to (gpu/topology.py slice_from_env; the
    # webhook renders them into the pod) --
    EnvKnob("TPU_ACCELERATOR_TYPE", "", "gpu/topology.py",
            "the slice's accelerator (the reference's name)"),
    EnvKnob("TPU_TOPOLOGY", "", "gpu/topology.py",
            "the slice's topology (the reference's name)"),
    # -- serving engine (decode pod) --
    EnvKnob("SERVING_PORT", "8000", "serving/__main__.py",
            "inference server listen port"),
    EnvKnob("SERVING_MAX_SLOTS", "8", "serving/server.py",
            "continuous-batching slot count"),
    EnvKnob("SERVING_MAX_SEQ", "2048", "serving/server.py",
            "max sequence length"),
    EnvKnob("SERVING_MAX_QUEUE", "64", "serving/server.py",
            "admission queue bound"),
    EnvKnob("SERVING_DECODE_BURST", "8", "serving/server.py",
            "decode steps per scheduler turn"),
    EnvKnob("SERVING_CHECKPOINT", "", "serving/server.py",
            "checkpoint path to restore"),
    EnvKnob("SERVING_MODEL_CONFIG", "", "serving/server.py",
            "model config JSON (TransformerConfig fields)"),
    EnvKnob("SERVING_DEVICE", "cuda", "serving/__main__.py",
            "torch device the server runs on"),
    EnvKnob("POD_IP", "", "serving/__main__.py",
            "address the server binds (0.0.0.0 when unset)"),
    EnvKnob("SERVING_CONTROL_DIR", "", "serving/__main__.py",
            "directory of forwarded restore requests (probe.behavior)"),
    # -- multi-host runtime (parallel/distributed.py): torchrun's worker
    # env first, else the names the webhook injects --
    EnvKnob("WORLD_SIZE", "", "parallel/distributed.py",
            "torchrun's world size (set: env:// rendezvous)"),
    EnvKnob("RANK", "0", "parallel/distributed.py",
            "torchrun's global rank"),
    EnvKnob("LOCAL_RANK", "", "parallel/distributed.py",
            "torchrun's local rank: picks the process's card"),
    EnvKnob("PET_NODE_RANK", "0", "probe/agent.py",
            "torchrun's node rank (static rendezvous): the agent's host "
            "index when JAX_PROCESS_ID is unset"),
    EnvKnob("JAX_NUM_PROCESSES", "1", "parallel/distributed.py",
            "the webhook's process count, without torchrun"),
    EnvKnob("TPU_WORKER_ID", "0", "parallel/distributed.py",
            "worker ordinal fallback for process id"),
    EnvKnob("JAX_COORDINATOR_ADDRESS", "", "parallel/distributed.py",
            "coordinator address for multi-host init"),
    EnvKnob("TPU_WORKER_HOSTNAMES", "", "parallel/distributed.py",
            "comma-separated gang hostnames"),
    # -- debug / guard rails (utils/, cluster/remote_fixture.py) --
    EnvKnob("ODH_WIRE_DEBUG_DIR", "", "cluster/remote_fixture.py",
            "dump wire-protocol transcripts here"),
    EnvKnob("RACECHECK", "0", "utils/racecheck.py",
            "arm the lock-discipline runtime guard"),
    EnvKnob("INVCHECK", "0", "utils/invcheck.py",
            "arm the invariant-monitor runtime guard"),
    EnvKnob("TORCHGUARD", "0", "utils/torchguard.py",
            "arm the data-plane discipline runtime guard"),
    EnvKnob("DEPLOYGUARD", "0", "utils/deployguard.py",
            "arm the deployment-surface runtime guard"),
    EnvKnob("DEPLOYGUARD_SURFACE_OUT", "", "utils/deployguard.py",
            "dump the recorded (flow, verb, kind) surface to this path"),
    EnvKnob("PROFILE", "0", "utils/profiler.py",
            "arm the continuous data-plane profiler"),
    EnvKnob("CPPROFILE", "0", "runtime/cpprofile.py",
            "arm the control-plane profiler (reconcile causes, cache-scan "
            "accounting, takeover decomposition)"),
)
