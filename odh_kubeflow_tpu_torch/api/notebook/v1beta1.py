"""Notebook CRD, v1beta1 (hub version).

Shape-compatible with the reference CRD (reference components/notebook-controller/
api/v1beta1/notebook_types.go:27-88: Spec.Template.Spec is a raw corev1.PodSpec;
Status mirrors conditions + ReadyReplicas + ContainerState), extended with a
first-class ``spec.tpu`` block and ``status.tpu`` — the TPU-native surface the
north star requires (slice accelerator/topology in, hosts/chips/mesh readiness
out)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ...apimachinery import Condition, KubeObject, KubeModel, default_scheme
from ..core import ContainerState, PodSpec

GROUP = "kubeflow.org"
API_VERSION = "kubeflow.org/v1beta1"
KIND = "Notebook"


@dataclass
class TPUSpec(KubeModel):
    """What slice this notebook binds. Empty accelerator = CPU notebook."""

    accelerator: str = ""  # e.g. "v4" | "v5e" | "v5p" | "v6e"
    topology: str = ""  # e.g. "2x2x1", "2x4", "2x2x4"; "" -> smallest for chips
    chips: int = 0  # alternative to topology: minimum total chip count
    runtime: str = ""  # "jax" (default) | "pytorch-xla"
    reserved: Optional[bool] = None  # reservation-bound node pool
    # oversubscription reclaim ordering (controllers/suspend.py): under
    # capacity pressure the LOWEST-priority suspend-eligible slice is
    # checkpoint-suspended first; higher survives longer
    priority: int = 0


@dataclass
class NotebookTemplateSpec(KubeModel):
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class NotebookSpec(KubeModel):
    template: NotebookTemplateSpec = field(default_factory=NotebookTemplateSpec)
    tpu: Optional[TPUSpec] = None


@dataclass
class TPUStatus(KubeModel):
    """Slice bring-up state, aggregated from per-host probe reports."""

    accelerator: str = ""
    topology: str = ""
    hosts: int = 0
    hosts_ready: int = 0
    chips_per_host: int = 0
    chips_expected: int = 0
    chips_visible: int = 0
    mesh_ready: bool = False
    first_ready_time: str = ""  # set once; anchors the CR->ready latency metric


@dataclass
class NotebookStatus(KubeModel):
    conditions: List[Condition] = field(default_factory=list)
    ready_replicas: int = 0
    container_state: Optional[ContainerState] = None
    tpu: Optional[TPUStatus] = None


@dataclass
class Notebook(KubeObject):
    spec: NotebookSpec = field(default_factory=NotebookSpec)
    status: NotebookStatus = field(default_factory=NotebookStatus)

    def primary_container(self) -> Optional["object"]:
        """The container named after the notebook, else the first container
        (the reference indexes by name match — notebook_controller.go:493-521)."""
        podspec = self.spec.template.spec
        for c in podspec.containers:
            if c.name == self.metadata.name:
                return c
        return podspec.containers[0] if podspec.containers else None


default_scheme.register(API_VERSION, KIND, Notebook)
