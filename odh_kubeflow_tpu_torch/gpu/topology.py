"""GPU generations, slice shapes and the slice planner (counterpart of
odh_kubeflow_tpu/tpu/topology.py).

The reference turns ``Notebook.spec.tpu`` into a TPU slice: hosts x chips,
the GKE TPU node selectors and the `google.com/tpu` request. Here the same
block plans a slice of NVIDIA H100 nodes: hosts x cards, the GKE accelerator
node selector, and the `nvidia.com/gpu` request of the NVIDIA device plugin.
The field names are the reference's (a "chip" is a card), so a reader of
either package finds the same `SliceShape`.

Node shapes come from Google Cloud's A3 machine series: `a3-highgpu-1g`,
`-2g`, `-4g` and `-8g` carry 1, 2, 4 and 8 H100 80GB cards. A single-host
slice takes the smallest of these shapes that holds it; every host of a
multi-host slice planned from a card count is a whole 8-card machine (one
NVSwitch domain). A topology "HOSTSxCARDS" names both numbers itself, and
each host is one machine shape: "2x2" is two 2-card hosts.

`max_chips` (256) is the ceiling of the reference's largest 2D TPU
generations (v5e and v6e in odh_kubeflow_tpu/tpu/topology.py): the size of
slice that this operator's per-ordinal readiness and utilization sweeps
and its slice repair were built for, not a limit of the hardware.

A pod selects its node by the card's GKE accelerator label and by the
pool's slice shape (`GPU_TOPOLOGY_LABEL`), as the reference's select by the
TPU accelerator and topology labels.

The reference's `chips_per_host_bounds` and `host_bounds` describe the
TPU_* torus layout of a host's chips and of the hosts in the slice. They
have no counterpart: a host's cards are all-to-all on NVSwitch, and the
hosts meet over the network, so there is no layout to name.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

from ..apimachinery import InvalidError
# the slice shape ("HOSTSxCARDS") label of a GPU node's pool; its home is
# the operator's constants, re-exported here for the planner's callers
from ..controllers.constants import GPU_TOPOLOGY_LABEL  # noqa: F401

GPU_RESOURCE = "nvidia.com/gpu"  # the NVIDIA device plugin's resource
GKE_GPU_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"


@dataclass(frozen=True)
class GPUGeneration:
    name: str  # "h100"
    gke_accelerator: str  # value of the gke-accelerator node label
    machine_shapes: Tuple[int, ...]  # cards of each single-host machine shape, ascending
    chips_per_host: int  # cards on every host of a multi-host slice
    max_chips: int  # largest supported slice


GENERATIONS: Dict[str, GPUGeneration] = {
    "h100": GPUGeneration("h100", "nvidia-h100-80gb", (1, 2, 4, 8), 8, 256),
}


def parse_topology(topology: str) -> Tuple[int, int]:
    """"HOSTSxCARDS" -> (hosts, cards per host)."""
    try:
        parts = tuple(int(p) for p in topology.lower().split("x"))
    except ValueError:
        raise InvalidError(f"malformed GPU topology {topology!r}")
    if len(parts) != 2 or any(p < 1 for p in parts):
        raise InvalidError(f"GPU topology {topology!r} must be HOSTSxCARDS, two positive numbers (e.g. '2x8')")
    return parts


@dataclass(frozen=True)
class SliceShape:
    """Fully-resolved slice placement plan."""

    accelerator: str  # generation name, e.g. "h100"
    topology: str  # canonical "HOSTSxCARDS"
    chips: int  # total cards in the slice
    hosts: int  # pod/host count (StatefulSet replicas)
    chips_per_host: int  # nvidia.com/gpu request per pod
    gke_accelerator: str  # node label value
    multi_host: bool = False

    @property
    def accelerator_type(self) -> str:
        """Card-count alias, e.g. h100 2x8 -> 'h100-16'."""
        return f"{self.accelerator}-{self.chips}"

    def node_selector(self) -> Dict[str, str]:
        return {GKE_GPU_ACCELERATOR_LABEL: self.gke_accelerator, GPU_TOPOLOGY_LABEL: self.topology}


def plan_slice(accelerator: str, topology: str = "", chips: int = 0) -> SliceShape:
    """Resolve a ``spec.tpu`` block into a SliceShape.

    Exactly one of topology/chips may drive sizing; with neither, the minimum
    slice (one host of the smallest machine shape) is planned. `chips` takes
    the smallest single-host shape that holds it, and past one host the
    fewest whole 8-card hosts that hold it."""
    gen = GENERATIONS.get(accelerator)
    if gen is None:
        raise InvalidError(f"unknown GPU accelerator {accelerator!r}; valid: {sorted(GENERATIONS)}")
    if topology and chips:
        raise InvalidError("spec.tpu: set topology or chips, not both")
    if chips < 0:
        raise InvalidError(f"spec.tpu.chips must not be negative, got {chips}")

    if topology:
        hosts, per_host = parse_topology(topology)
        if per_host not in gen.machine_shapes:
            raise InvalidError(
                f"{gen.name} hosts carry {list(gen.machine_shapes)} cards, not {per_host} "
                f"(topology {topology!r})"
            )
    elif chips:
        fits = [n for n in gen.machine_shapes if n >= chips]
        if fits:
            hosts, per_host = 1, fits[0]
        else:
            hosts, per_host = -(-chips // gen.chips_per_host), gen.chips_per_host
    else:
        hosts, per_host = 1, gen.machine_shapes[0]

    total = hosts * per_host
    if total > gen.max_chips:
        raise InvalidError(f"{gen.name} slice of {total} cards exceeds max {gen.max_chips}")
    return SliceShape(
        accelerator=gen.name,
        topology=f"{hosts}x{per_host}",
        chips=total,
        hosts=hosts,
        chips_per_host=per_host,
        gke_accelerator=gen.gke_accelerator,
        multi_host=hosts > 1,
    )


def slice_from_env(env: Optional[Mapping[str, str]] = None) -> SliceShape:
    """The slice a pod was planned on, from the env gpu/env.py renders into
    it (TPU_ACCELERATOR_TYPE "h100-16", TPU_TOPOLOGY "2x8"): what a worker
    hands `parallel.slice_mesh_axes`. `env` defaults to os.environ."""
    env = os.environ if env is None else env
    kind, topology = env.get("TPU_ACCELERATOR_TYPE", ""), env.get("TPU_TOPOLOGY", "")
    if not kind or not topology:
        raise InvalidError("TPU_ACCELERATOR_TYPE and TPU_TOPOLOGY are not set (no GPU slice env in this pod?)")
    return plan_slice(kind.rsplit("-", 1)[0], topology=topology)
