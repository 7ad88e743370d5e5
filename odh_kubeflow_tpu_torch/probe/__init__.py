"""The in-pod probe agent of the port (counterpart of odh_kubeflow_tpu/probe):
`python -m odh_kubeflow_tpu_torch.probe` serves the /tpu/* routes the
operator reads, over a `CudaMonitor` of the card. `probe.behavior` holds the
SimCluster kubelet's pod behaviors: scripted agents for the CPU tests, and a
pod's container as real processes beside an agent of the card."""
from .agent import (
    CudaMonitor,
    KernelState,
    NotebookAgent,
    NvidiaSmiUtilization,
    SimTPUMonitor,
    TPUMonitor,
    parse_duty_cycle_metrics,
)

__all__ = [
    "CudaMonitor",
    "KernelState",
    "NotebookAgent",
    "NvidiaSmiUtilization",
    "SimTPUMonitor",
    "TPUMonitor",
    "parse_duty_cycle_metrics",
]
