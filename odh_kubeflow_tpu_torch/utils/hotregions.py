"""Hot-region registry of the port: the data-plane regions where a host
sync or a recompile is a latency bug (the region table of
odh_kubeflow_tpu/analysis/hotregions.py, with `module` pointing at the
port's files).

One table, two halves:

- the STATIC half (`analysis/checkers/torchlint.py` host-transfer) treats
  each region's `functions` as roots and flags every device->host copy
  (`.item()`, `.cpu()`, `.tolist()`, `torchguard.to_host`, `np.asarray`
  over a tensor, `int()` over a tensor, ...) inside them or inside the
  same-module functions they reach;
- the RUNTIME half looks a region up by name: `utils/torchguard.py`
  enforces its budgets when the guard is armed (`compile_budget` caps the
  compiles attributed to one region object over its lifetime,
  `transfer_budget` caps device->host copies per entry), and
  `utils/profiler.py` validates region names against it. `None` means
  unbudgeted by design: counted and reported, never fatal.

The table imports nothing but the standard library, so the static half
runs where torch is not installed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class HotRegion:
    """One declared hot region.

    `module` is the repo-relative file that holds it (matched with endswith,
    so cwd-relative and absolute paths both resolve); `functions` are the
    root qualnames (`Class.method` or bare function) the static
    host-transfer checker starts its same-module reachability walk from."""

    name: str
    module: str
    functions: Tuple[str, ...]
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
        functions=("ServingEngine.step",),
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
        functions=("ServingEngine._admit",),
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
        functions=("generate",),
        compile_budget=None,
        transfer_budget=0,
        rationale="generate() leaves its tokens on the device; a host sync "
        "inside it would add a per-token round trip",
    ),
    HotRegion(
        name="bench.train_step",
        module="odh_kubeflow_tpu_torch/models/transformer.py",
        # no root for the static walk, as in the reference: the region is
        # entered by a benchmark's train step, which the port has not yet
        functions=(),
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


def hot_functions_for(path: str) -> Dict[str, HotRegion]:
    """Root qualname -> region for every region whose module matches
    `path` (endswith, so cwd-relative and absolute paths both hit). The
    static host-transfer checker's entry point."""
    out: Dict[str, HotRegion] = {}
    for region in REGIONS:
        if path.endswith(region.module):
            for fn in region.functions:
                out[fn] = region
    return out
