"""The in-pod probe agent of the port (counterpart of odh_kubeflow_tpu/probe):
`python -m odh_kubeflow_tpu_torch.probe` serves the /tpu/* routes the
operator reads, over a `CudaMonitor` of the card."""
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
