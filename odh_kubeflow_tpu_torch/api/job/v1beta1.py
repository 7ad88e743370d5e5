"""TPUJob CRD, v1beta1 (the port's copy of odh_kubeflow_tpu/api/job/v1beta1.py,
registered in the port's scheme).

The third workload class: gang-scheduled batch/RL training jobs contending
for the same cards as notebooks and serving endpoints. The spec mirrors the
Notebook CR's shape — the same ``spec.tpu`` block drives slice planning (on
a GPU slice here, `gpu.plan_slice`), the same pod-template escape hatch
exists — so the reconciler reuses the StatefulSet, headless Service,
scheduler and slice-pool machinery rather than growing a parallel batch
stack.

Layouts come from the Podracer paper:

- ``anakin``: ONE SPMD gang — acting and learning colocated on a single
  slice (``spec.tpu`` is the whole job),
- ``sebulba``: a SPLIT actor-gang + learner-gang — ``spec.tpu`` shapes the
  learner slice, ``spec.actors`` shapes the actor slice, and admission is
  atomic across BOTH gangs (both slices secured, or neither; a half-placed
  sebulba job would deadlock against another half-placed one).

A job is preemptible by design: it ranks in the ONE priority ordering with
notebooks and endpoints (batch defaults BELOW interactive via
``JOB_DEFAULT_PRIORITY``), and a preempted job checkpoints, parks
``Preempted``, and requeues to resume from the saved step — it loses only
progress since the last checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ...apimachinery import Condition, KubeModel, KubeObject, default_scheme
from ..notebook.v1beta1 import NotebookTemplateSpec, TPUSpec, TPUStatus

GROUP = "kubeflow.org"
API_VERSION = "kubeflow.org/v1beta1"
KIND = "TPUJob"

LAYOUT_ANAKIN = "anakin"
LAYOUT_SEBULBA = "sebulba"


@dataclass
class TPUJobSpec(KubeModel):
    # learner/SPMD gang (anakin: the whole job). `priority` rides here and
    # feeds the one reclaim ordering shared with notebooks/endpoints; unset
    # (0) reads as JOB_DEFAULT_PRIORITY — batch below interactive.
    tpu: Optional[TPUSpec] = None
    layout: str = LAYOUT_ANAKIN  # anakin | sebulba
    # sebulba actor gang shape (required for layout=sebulba; per-gang
    # topology — actors typically run a smaller/cheaper slice)
    actors: Optional[TPUSpec] = None
    # step budget per completion; the job Succeeds when the last ACKED
    # checkpoint step reaches steps * completions (the workload reports
    # progress through the /tpu/checkpoint ack's step counter)
    steps: int = 1000
    completions: int = 1
    # checkpoint cadence: while Running, every `checkpointPeriodS` the
    # controller opens a Checkpointing window and drives the learner gang's
    # /tpu/checkpoint hooks — the durable resume point preemption relies on
    checkpoint_period_s: float = 30.0
    # unexplained failures (host loss with no preemption notice) tolerated
    # before Failed; reclaim-driven preemptions never count against this
    backoff_limit: int = 3
    # wallclock cap from the FIRST admission (queue wait before it is free;
    # parked/requeued time after it is not); 0 = off
    max_runtime_s: float = 0.0
    # pod template override (the training image); defaulted like a notebook's
    template: NotebookTemplateSpec = field(default_factory=NotebookTemplateSpec)


@dataclass
class TPUJobStatus(KubeModel):
    conditions: List[Condition] = field(default_factory=list)
    # human mirror of the annotation-durable machine (the annotation is the
    # durable truth; this is for kubectl get)
    phase: str = ""
    ready_replicas: int = 0  # ready hosts across all gangs
    completed_steps: int = 0  # last acked checkpoint step
    preemptions: int = 0  # checkpoint-preempt-requeue round trips survived
    failures: int = 0  # unexplained interruptions charged to backoffLimit
    # spec generation the terminal state judged: a spec bump past it reruns
    observed_generation: int = 0
    tpu: Optional[TPUStatus] = None  # learner gang


@dataclass
class TPUJob(KubeObject):
    spec: TPUJobSpec = field(default_factory=TPUJobSpec)
    status: TPUJobStatus = field(default_factory=TPUJobStatus)


default_scheme.register(API_VERSION, KIND, TPUJob)
