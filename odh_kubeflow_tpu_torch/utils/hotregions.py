"""Hot-region registry of the port: the data-plane regions where a host
sync or a recompile is a latency bug (the region table of
odh_kubeflow_tpu/analysis/hotregions.py, with `module` pointing at the
port's files).

Two runtime consumers look a region up by name: `utils/torchguard.py`
enforces its budgets when the guard is armed (`compile_budget` caps the
compiles attributed to one region object over its lifetime,
`transfer_budget` caps device->host copies per entry), and
`utils/profiler.py` validates region names against it. `None` means
unbudgeted by design: counted and reported, never fatal.

The reference's static half (the `jaxlint` host-transfer checker, which
walks each region's functions in the source) is not ported: the guard's
runtime checks are the port's only enforcement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class HotRegion:
    """One declared hot region; `module` is the repo-relative file that
    holds it."""

    name: str
    module: str
    # max compiles (CUDA-graph captures, compiled programs) attributed to
    # one region object's lifetime; None = unbudgeted
    compile_budget: Optional[int]
    # max device->host copies per region entry; None = unbudgeted
    transfer_budget: Optional[int]
    rationale: str


REGIONS: Tuple[HotRegion, ...] = (
    HotRegion(
        name="serving.decode_burst",
        module="odh_kubeflow_tpu_torch/serving/engine.py",
        # the burst program plus one spare capture for a deliberate shape
        # change on a live engine
        compile_budget=2,
        # zero copies inside the burst: the one post-burst drain happens
        # after the region closes
        transfer_budget=0,
        rationale="a decode burst is one dispatch; a host sync or a "
        "recompile inside it multiplies per-token latency",
    ),
    HotRegion(
        name="serving.prefill",
        module="odh_kubeflow_tpu_torch/serving/engine.py",
        compile_budget=None,
        # exactly one: the first-token argmax copy that makes TTFT
        # independent of the decode batch
        transfer_budget=1,
        rationale="admission runs between bursts; a second host sync here "
        "stalls every active slot, not just the admitted request",
    ),
    HotRegion(
        name="models.generate",
        module="odh_kubeflow_tpu_torch/models/decode.py",
        compile_budget=None,
        transfer_budget=0,
        rationale="generate() leaves its tokens on the device; a host sync "
        "inside it would add a per-token round trip",
    ),
    HotRegion(
        name="bench.train_step",
        module="odh_kubeflow_tpu_torch/models/transformer.py",
        # the step compiles once; a second compile means it closed over
        # something shape-varying
        compile_budget=1,
        transfer_budget=None,
        rationale="a train-step timing assumes one compiled program; a "
        "recompile poisons the timing",
    ),
)

_BY_NAME: Dict[str, HotRegion] = {r.name: r for r in REGIONS}


def get(name: str) -> HotRegion:
    """Look a region up by name; an unknown name raises, so a mistyped
    guard cannot run unbudgeted."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown hot region {name!r}; declare it in utils/hotregions.py "
            f"(known: {sorted(_BY_NAME)})"
        ) from None
