"""Controller configuration.

The reference stacks CLI flags + env vars + kustomize params (SURVEY §5
config/flag system); this build centralizes them in one dataclass whose
from_env() reads the same env names the reference uses, so deployment
manifests translate directly. The control-plane profiler is armed by
CPPROFILE=1 (runtime/cpprofile.py reads it at each hook), as in the
reference."""
from __future__ import annotations

import os
from dataclasses import dataclass


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclass
class Config:
    """The fields that the port's controllers, webhook, extension, chip
    accountant, pool prewarmer, status coalescer and judgement layer (the
    SLO engine, the canary prober, the replica autoscaler) read. The JAX
    package's Config also holds the router's knobs, the switches that only
    its main.py reads (the SLO layer on or off, the canary's period) and
    the deployment-surface env table; each comes back with the code that
    reads it."""

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
