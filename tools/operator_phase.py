#!/usr/bin/env python3
"""chip_smoke.py's phase 15 alone on one NVIDIA Hopper card: the kernels
built from this checkout, then `chip_smoke.operator_phase` (the operator
the port's `main.build_manager` builds, on a SimCluster with one h100 1x1
node, its debug mux read at the end with CPPROFILE=1, a TLS API server
whose admission calls the HTTPS webhook in front of its store: an
unplannable Notebook written over it and denied over HTTPS, then three Notebook CRs, each pod a `torchrun` serving the
flagship beside a NotebookAgent over the card's CudaMonitor, which counts
the cards on which the pod's processes hold a CUDA context, each culled,
its card freed and the notebook deleted in turn; nb-2's node preempted
after its worker has trained, the pod checkpointed through the forwarded
/tpu/checkpoint, evicted, re-placed in a second pool and resumed bit-equal
by the SliceRepairController; then nb-2 suspended by the
SuspendResumeController and promoted into an InferenceEndpoint, which
the ReplicaAutoscaler parks to zero once idle and a TokenRouter's cold
wake brings back, and a TPUJob preempted by the reclaimer for nb-2's
resume, which is verified and bit-equal, the job resumed to Succeeded;
the SLO engine, the burn-rate alerts and the canary prober judge it all).
It fails as the smoke does.

    python3 tools/operator_phase.py     # from the repository root
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from odh_kubeflow_tpu_torch.ops import _build, attention  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    torch.empty(1, device="cuda")  # a CUDA context in this process, as the smoke holds one by phase 15
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    print("launches", chip_smoke.operator_phase(attention, smi), flush=True)


if __name__ == "__main__":
    main()
