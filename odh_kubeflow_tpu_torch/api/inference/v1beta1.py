"""InferenceEndpoint CRD, v1beta1 (the port's copy of
odh_kubeflow_tpu/api/inference/v1beta1.py, registered in the port's scheme).

The second workload class: a long-lived serving deployment promoted from an
interactive notebook (or pointed straight at a checkpoint path). The spec
mirrors the Notebook CR's shape — the same ``spec.tpu`` block drives slice
planning (on a GPU slice here, `gpu.plan_slice`), the same pod-template
escape hatch exists — so the reconciler reuses the StatefulSet, headless
Service, HTTPRoute, scheduler and slice-pool machinery.

Promotion contract: with ``spec.notebookRef`` set, the endpoint inherits the
source notebook's slice shape (when ``spec.tpu`` is empty) and its saved
checkpoint lineage (step + checksum annotations), and — when the notebook
just suspended — claims its warm slice from the pool, so promotion is a warm
bind, not a cold create.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ...apimachinery import Condition, KubeModel, KubeObject, default_scheme
from ..notebook.v1beta1 import NotebookTemplateSpec, TPUSpec, TPUStatus

GROUP = "kubeflow.org"
API_VERSION = "kubeflow.org/v1beta1"
KIND = "InferenceEndpoint"


@dataclass
class NotebookRef(KubeModel):
    """Source notebook of a promotion; empty = serve straight from
    ``spec.serving.checkpointPath`` with no lineage."""

    name: str = ""
    namespace: str = ""  # "" -> the endpoint's own namespace


@dataclass
class AutoscalingSpec(KubeModel):
    """SLO-burn autoscaling bounds (runtime/autoscaler.py). The signal is
    burn rate / queue pressure from the SLO engine — never CPU. minReplicas
    is a hard floor under sustained burn; maxReplicas caps how much of the
    warm pool one endpoint may bind; scaleToZero allows parking the whole
    fleet Suspended-with-a-route when idle (cold-wake on first request)."""

    min_replicas: int = 1
    max_replicas: int = 4
    # scale up when the serving SLOs' fast-window burn rate crosses this
    # (1.0 = burning exactly the error budget); 0 keeps the default
    target_burn_rate: float = 2.0
    scale_to_zero: bool = False
    # flap damping: a scale-down (or park-to-zero) only fires after the
    # signal has been below target for this long (0 -> controller default)
    scale_down_stabilization_s: float = 0.0
    # idle window before scale-to-zero parks the fleet (0 -> default)
    scale_to_zero_idle_s: float = 0.0


@dataclass
class ServingSpec(KubeModel):
    """Continuous-batching engine shape (serving/engine.py): KV-cache slots,
    admission-queue bound, and sequence budget per request."""

    max_batch_slots: int = 8  # concurrent sequences (KV-cache slots)
    max_queue_depth: int = 64  # bounded admission queue; overflow = 429
    max_seq: int = 2048  # per-slot KV-cache extent
    max_new_tokens: int = 256  # per-request generation cap
    # decode steps per dispatch (the prefill/decode scheduling knob):
    # amortizes the per-dispatch latency floor while bounding admission
    # delay at this many decode steps
    decode_burst: int = 8
    checkpoint_path: str = ""  # orbax dir; promotion fills it from the source
    # bounded drain: Draining waits this long for in-flight requests before
    # the gang scales away (0 -> the controller default)
    drain_timeout_s: float = 0.0
    # serving fleet: N independent per-replica gangs, each its own
    # STS + gang-DNS Service + slicepool claim. The endpoint stays Serving
    # while >=1 replica is healthy (DegradedServing condition below full
    # strength). The autoscaler moves the live count within
    # autoscaling.{min,max}; `replicas` is the static default
    replicas: int = 1
    autoscaling: Optional[AutoscalingSpec] = None


@dataclass
class InferenceEndpointSpec(KubeModel):
    notebook_ref: Optional[NotebookRef] = None
    tpu: Optional[TPUSpec] = None  # empty + notebookRef -> inherited
    serving: ServingSpec = field(default_factory=ServingSpec)
    # pod template override (the serving image); defaulted like a notebook's
    template: NotebookTemplateSpec = field(default_factory=NotebookTemplateSpec)


@dataclass
class InferenceEndpointStatus(KubeModel):
    conditions: List[Condition] = field(default_factory=list)
    ready_replicas: int = 0  # ready HOSTS across the whole fleet
    # human mirror of the annotation-durable machine (the annotation is the
    # durable truth; this is for kubectl get)
    phase: str = ""
    tpu: Optional[TPUStatus] = None
    url: str = ""  # route path while Serving (or parked Suspended)
    # fleet view — the router's signal contract: `replicas` is
    # the converged-toward fleet size, `servingReplicas` how many full gangs
    # can take traffic, `drainingReplicas` which gang indexes are in their
    # route-first drain window (the router must stop picking them)
    replicas: int = 0
    serving_replicas: int = 0
    draining_replicas: List[int] = field(default_factory=list)


@dataclass
class InferenceEndpoint(KubeObject):
    spec: InferenceEndpointSpec = field(default_factory=InferenceEndpointSpec)
    status: InferenceEndpointStatus = field(
        default_factory=InferenceEndpointStatus
    )


default_scheme.register(API_VERSION, KIND, InferenceEndpoint)
