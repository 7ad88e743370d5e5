"""Annotation/label contracts of the notebook stack.

Keys are kept byte-identical to the reference where they are user-facing
contracts (stop/culling state machine, restart, update-pending, auth) so CRs
and tooling written for the reference keep working (reference
pkg/culler/culler.go:40-41, odh notebook_controller.go:56-79,
notebook_webhook.go constants)."""

# -- stop / culling state machine --
STOP_ANNOTATION = "kubeflow-resource-stopped"
RECONCILIATION_LOCK_VALUE = "odh-notebook-controller-lock"
LAST_ACTIVITY_ANNOTATION = "notebooks.kubeflow.org/last-activity"
LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION = (
    "notebooks.kubeflow.org/last_activity_check_timestamp"
)

# -- core reconciler --
NOTEBOOK_NAME_LABEL = "notebook-name"
NOTEBOOK_RESTART_ANNOTATION = "notebooks.opendatahub.io/notebook-restart"
NOTEBOOK_PORT = 8888
NOTEBOOK_PORT_NAME = "http-notebook"  # service port name (Istio/mesh RBAC relies on it)
DEFAULT_WORKING_DIR = "/home/jovyan"
DEFAULT_FS_GROUP = 100
PREFIX_ENV = "NB_PREFIX"

# -- webhook / extension --
UPDATE_PENDING_ANNOTATION = "notebooks.opendatahub.io/update-pending"
INJECT_AUTH_ANNOTATION = "notebooks.opendatahub.io/inject-auth"
IMAGE_SELECTION_ANNOTATION = "notebooks.opendatahub.io/last-image-selection"
IMAGE_NAMESPACE_ANNOTATION = "notebooks.opendatahub.io/workbench-image-namespace"
AUTH_SIDECAR_CPU_REQUEST_ANNOTATION = "notebooks.opendatahub.io/auth-sidecar-cpu-request"
AUTH_SIDECAR_MEMORY_REQUEST_ANNOTATION = (
    "notebooks.opendatahub.io/auth-sidecar-memory-request"
)
AUTH_SIDECAR_CPU_LIMIT_ANNOTATION = "notebooks.opendatahub.io/auth-sidecar-cpu-limit"
AUTH_SIDECAR_MEMORY_LIMIT_ANNOTATION = "notebooks.opendatahub.io/auth-sidecar-memory-limit"
FEAST_LABEL = "opendatahub.io/feast-integration"
RUNTIME_IMAGE_LABEL = "opendatahub.io/runtime-image"

# -- observability --
# W3C traceparent of the readiness trace, stamped by the webhook at CREATE
# and copied into the pod template so every actor on the CR-submit ->
# jax.devices()-ready path (reconciler, kubelet, probe gate) joins ONE trace
from ..utils.tracing import TRACEPARENT_ANNOTATION  # noqa: E402,F401  (canonical home)

# -- slice repair (controllers/slice_repair.py) --
# The durable repair state machine lives in annotations (SURVEY §5: the API
# server is the database), mirrored into conditions for humans:
#   Ready -> Degraded (fault detected; checkpoint-before-evict window)
#         -> Repairing (gang evicted; all-or-nothing re-placement)
#         -> Ready (repaired)  |  RepairFailed (attempts exhausted; terminal)
TPU_REPAIR_STATE_ANNOTATION = "notebooks.tpu.kubeflow.org/repair-state"
TPU_REPAIR_STARTED_ANNOTATION = "notebooks.tpu.kubeflow.org/repair-started"
TPU_REPAIR_ATTEMPTS_ANNOTATION = "notebooks.tpu.kubeflow.org/repair-attempts"
TPU_REPAIR_CAUSE_ANNOTATION = "notebooks.tpu.kubeflow.org/repair-cause"
# checkpoint-before-evict contract: the repair controller stamps the window
# deadline here BEFORE evicting the gang; the in-pod agent's /tpu/checkpoint
# hook (probe/agent.py -> models/checkpoint.py) is driven inside that window,
# and the last acked step is recorded for the resumed workload to restore
TPU_CHECKPOINT_REQUEST_ANNOTATION = "notebooks.tpu.kubeflow.org/checkpoint-before-evict"
TPU_CHECKPOINT_SAVED_ANNOTATION = "notebooks.tpu.kubeflow.org/checkpoint-saved"

# condition types on NotebookStatus (owned by probe_status / slice_repair /
# the alert manager; the core reconciler's pod-condition mirror preserves
# these)
TPU_HEALTHY_CONDITION = "TPUHealthy"
TPU_DEGRADED_CONDITION = "Degraded"
# stamped by the alert manager (runtime/alerts.py) on the worst offenders
# while a burn-rate alert fires; cleared (reason Recovered) at resolution
SLO_DEGRADED_CONDITION = "DegradedSLO"

# -- suspend / resume (controllers/suspend.py) --
# The capacity-multiplexing state machine, annotation-durable like the repair
# machine above:
#   Active -> Checkpointing (cull/stop with state saved before the scale-down)
#          -> Suspended (slice released to the warm pool; replicas 0)
#          -> Resuming (unstop: warm-pool claim or cold fallback)
#          -> Active (mesh ready again)  |  ResumeFailed (attempts exhausted)
TPU_SUSPEND_STATE_ANNOTATION = "notebooks.tpu.kubeflow.org/suspend-state"
TPU_SUSPEND_STARTED_ANNOTATION = "notebooks.tpu.kubeflow.org/suspend-started"
TPU_SUSPENDED_AT_ANNOTATION = "notebooks.tpu.kubeflow.org/suspended-at"
TPU_RESUME_STARTED_ANNOTATION = "notebooks.tpu.kubeflow.org/resume-started"
TPU_RESUME_ATTEMPTS_ANNOTATION = "notebooks.tpu.kubeflow.org/resume-attempts"
# checkpoint deadline of the suspend path (the repair path has its own key
# above; two concurrent windows must not clobber each other's deadline)
TPU_SUSPEND_CHECKPOINT_DEADLINE_ANNOTATION = (
    "notebooks.tpu.kubeflow.org/suspend-checkpoint-deadline"
)
# stamped (with the reclaim reason) when a suspend was FORCED by the
# oversubscription reclaimer rather than idleness: the suspend path then
# returns the slice to general capacity instead of the warm pool — the
# requester that triggered the reclaim needs the chips
TPU_RECLAIM_ANNOTATION = "notebooks.tpu.kubeflow.org/reclaimed"
# never a reclaim victim: the SLO canary (runtime/prober.py) stamps this on
# its CRs — suspending the prober would blind the very signal that detects
# the pressure incident
TPU_RECLAIM_EXEMPT_LABEL = "notebooks.tpu.kubeflow.org/reclaim-exempt"

# -- inference serving (controllers/inference.py) --
# The promotion state machine, annotation-durable like the suspend/repair
# machines above (declared as data in analysis/machines.py):
#   Pending ("") -> Loading (pods ready; checkpoint restore + verification)
#                -> Serving (verified; route live)  |  LoadFailed (terminal)
#   Serving/Loading/Pending --stop--> Draining (route torn down; bounded
#   drain window) -> Terminated (replicas 0; slice released warm)
INFERENCE_STATE_ANNOTATION = "inference.tpu.kubeflow.org/endpoint-state"
INFERENCE_LOADING_DEADLINE_ANNOTATION = (
    "inference.tpu.kubeflow.org/loading-deadline"
)
INFERENCE_DRAIN_DEADLINE_ANNOTATION = "inference.tpu.kubeflow.org/drain-deadline"
# stamped at promotion time with the source notebook's ns/name so the
# endpoint's warm claim, checkpoint lineage, and trace all name their origin
INFERENCE_PROMOTED_FROM_ANNOTATION = "inference.tpu.kubeflow.org/promoted-from"
# pod -> owning InferenceEndpoint (the serving analog of notebook-name: the
# scheduler's claimed-pool owner check and the sim probe agent both key on it)
INFERENCE_NAME_LABEL = "inference-endpoint-name"
# -- serving fleet --
# pod -> replica index within the endpoint's fleet: readiness is counted PER
# replica gang (a gang is ready only when all its hosts are), while every pod
# still carries INFERENCE_NAME_LABEL so the slicepool claim owner stays ns/name
INFERENCE_REPLICA_LABEL = "inference-endpoint-replica"
# the autoscaler's output channel (the HPA analog): runtime/autoscaler.py
# writes the desired replica count HERE, controllers/inference.py clamps it
# into autoscaling.{min,max} and reconciles toward it — single-writer
# ownership of INFERENCE_STATE_ANNOTATION stays with the inference controller
INFERENCE_DESIRED_REPLICAS_ANNOTATION = (
    "inference.tpu.kubeflow.org/desired-replicas"
)
# route-first per-replica drain (scale-down): JSON {"replica": i, "deadline":
# rfc3339} stamped when the controller picks a scale-down victim; the router
# stops sending it traffic (status.draining_replicas mirrors it), in-flight
# requests get the bounded window, then the gang scales away and its slice
# releases warm. Cleared at retire (or when the scale-down is withdrawn)
INFERENCE_REPLICA_DRAIN_ANNOTATION = (
    "inference.tpu.kubeflow.org/replica-draining"
)
# scale-to-zero park marker: stamped when the autoscaler parks the fleet
# (endpoint-state -> suspended, route left up); ANY writer clearing it (the
# router's cold-wake, an operator) pops the endpoint back to Pending
INFERENCE_SUSPENDED_AT_ANNOTATION = "inference.tpu.kubeflow.org/suspended-at"
# status condition while the fleet is degraded (>=1 but < desired replicas
# healthy): the endpoint keeps Serving — partial capacity is not an outage —
# but humans and the alert surface see the reduced strength
DEGRADED_SERVING_CONDITION = "DegradedServing"
# Serving endpoints default ABOVE interactive notebooks in the reclaim
# ordering: a spec.tpu.priority of 0 on an endpoint reads
# as this value, so an idle notebook is always suspended before live traffic
ENDPOINT_DEFAULT_PRIORITY = 10

# -- batch/RL jobs (controllers/job.py) --
# The gang-scheduled job state machine, annotation-durable like the
# suspend/repair/inference machines above (declared as data in
# analysis/machines.py):
#   Pending ("") -> Admitted (gangs secured: warm claim(s) or free capacity;
#                   sebulba claims BOTH gangs atomically or neither)
#             -> Running (every host of every gang ready; steps progress)
#             -> Checkpointing (cadence or preempt: /tpu/checkpoint driven,
#                acked step recorded) -> Running | Succeeded | Preempted
#   Running --host loss--> Preempted --requeue--> Pending (resume from the
#   saved step); Failed (backoffLimit / maxRuntime) is terminal + incident
JOB_STATE_ANNOTATION = "jobs.tpu.kubeflow.org/job-state"
# last ACKED checkpoint step — the durable resume point; survives requeues
JOB_CHECKPOINT_STEP_ANNOTATION = "jobs.tpu.kubeflow.org/checkpoint-step"
JOB_CHECKPOINT_DEADLINE_ANNOTATION = (
    "jobs.tpu.kubeflow.org/checkpoint-deadline"
)
# stamped by the oversubscription reclaimer ("capacity-pressure:<ns/name>")
# or an operator ("user"): the job controller answers with
# checkpoint-before-preempt; capacity-pressure preempts release the slice to
# general capacity (the requester needs the chips), anything else parks warm
JOB_PREEMPT_ANNOTATION = "jobs.tpu.kubeflow.org/preempt-requested"
JOB_QUEUED_AT_ANNOTATION = "jobs.tpu.kubeflow.org/queued-at"  # first submit
# current episode's queue entry (reset per requeue; feeds the queue-wait
# histogram episode by episode)
JOB_EPISODE_QUEUED_AT_ANNOTATION = "jobs.tpu.kubeflow.org/episode-queued-at"
JOB_ADMITTED_AT_ANNOTATION = "jobs.tpu.kubeflow.org/admitted-at"
# first admission EVER (survives requeues, reset only on terminal rerun):
# the spec.maxRuntimeS clock starts here — queue wait before the first
# admission is free, parked/requeued time after it is not
JOB_FIRST_ADMITTED_AT_ANNOTATION = "jobs.tpu.kubeflow.org/first-admitted-at"
# the checkpoint step this EPISODE resumed from, pinned at admission: the
# pod template's TPU_JOB_RESUME_STEP reads this, never the live
# checkpoint-step — a cadence save mid-run must not mutate the template
# and roll the very gang it just checkpointed
JOB_RESUME_STEP_ANNOTATION = "jobs.tpu.kubeflow.org/resume-step"
JOB_RUN_STARTED_AT_ANNOTATION = "jobs.tpu.kubeflow.org/run-started"
# productive seconds banked at checkpoint acks (progress that SURVIVES a
# preemption); the job_goodput_ratio numerator
JOB_RUN_SECONDS_ANNOTATION = "jobs.tpu.kubeflow.org/run-seconds"
JOB_PREEMPTIONS_ANNOTATION = "jobs.tpu.kubeflow.org/preemptions"
JOB_FAILURES_ANNOTATION = "jobs.tpu.kubeflow.org/failures"
# pod -> owning TPUJob (the batch analog of notebook-name: the scheduler's
# claimed-pool owner check and the sim probe agent both key on it) + which
# gang of a sebulba job the pod belongs to
JOB_NAME_LABEL = "tpu-job-name"
JOB_GANG_LABEL = "tpu-job-gang"
JOB_GANG_LEARNER = "learner"
JOB_GANG_ACTORS = "actors"
# batch defaults BELOW interactive notebooks in the reclaim ordering: an
# unset spec.tpu.priority on a job reads as this value, so contention
# suspends a batch job before it ever touches a notebook or an endpoint
JOB_DEFAULT_PRIORITY = -10
# status condition set while a job queues over the chip budget
JOB_QUEUED_CONDITION = "QueuedOverBudget"

# -- checkpoint restore verification --
# checksum of the state the checkpoint hook saved (probe agent ack); after
# resume — and after endpoint Loading — the /tpu/restore probe's checksum is
# compared against this, so "the restored kernel equals the saved one" is
# asserted end-to-end instead of assumed
TPU_CHECKPOINT_CHECKSUM_ANNOTATION = (
    "notebooks.tpu.kubeflow.org/checkpoint-checksum"
)

# -- TPU-native additions --
TPU_SLICE_POOL_LABEL = "notebooks.tpu.kubeflow.org/slice-pool"
# stamped on Events the mirror controller creates, and checked on ingest, so
# a mirrored Event is never re-mirrored into an infinite loop
TPU_MIRRORED_EVENT_ANNOTATION = "notebooks.tpu.kubeflow.org/mirrored"
TPU_PROBE_PORT = 8889  # in-pod probe agent (readiness + utilization + activity)

# -- GPU slices (gpu/podspec.py, gpu/topology.py) --
# on a notebook's StatefulSet: the env names gpu.apply_slice rendered into
# the primary container (comma-separated), so a later apply replaces them
# and keeps the user's
GPU_ENV_ANNOTATION = "notebooks.opendatahub.io/gpu-slice-env"
# the slice shape ("HOSTSxCARDS") of a GPU node's pool. GKE labels a TPU
# pool's nodes with its topology and the reference's pods select on it; a
# GPU pool has no such label, so the pool carries this one (set on its
# nodes when the pool is made) and a slice's pods select on it: a one-host
# pod never lands on a node of a multi-host pool of the same card
GPU_TOPOLOGY_LABEL = "notebooks.opendatahub.io/gpu-topology"

# -- finalizers (extension controller) --
ROUTE_FINALIZER = "notebooks.tpu.kubeflow.org/route-cleanup"
REFERENCE_GRANT_FINALIZER = "notebooks.tpu.kubeflow.org/referencegrant-cleanup"
AUTH_BINDING_FINALIZER = "notebooks.tpu.kubeflow.org/auth-binding-cleanup"
