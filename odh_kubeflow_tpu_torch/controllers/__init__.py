"""The port's controllers (copies of odh_kubeflow_tpu/controllers' notebook,
probe-status, culling, slice-repair, suspend/resume, InferenceEndpoint and
TPUJob reconcilers, the admission webhook and the workbench extension, on
GPU slices).

`constants` and `config` load with the package; each reconciler module
loads when a name of it is first asked for. The `gpu` package takes its
annotation keys from `constants`, and the reconcilers import `gpu`: loading
them with the package would make `import odh_kubeflow_tpu_torch.gpu` a
circular import."""
import importlib

from . import constants
from .config import Config

_LAZY = {
    "NotebookMetrics": "metrics",
    "EventMirrorController": "notebook",
    "NotebookReconciler": "notebook",
    "hosts_service_name": "notebook",
    "CullingReconciler": "culling",
    "InferenceEndpointReconciler": "inference",
    "TPUJobReconciler": "job",
    "ProbeStatusController": "probe_status",
    "SliceRepairController": "slice_repair",
    "SuspendResumeController": "suspend",
    "NotebookWebhook": "webhook",
    "TPUWorkbenchReconciler": "extension",
}

_MODULES = {
    "conditions", "culling", "extension", "inference", "job", "metrics",
    "notebook", "probe_status", "slice_repair", "suspend", "webhook",
}

__all__ = ["Config", "constants", *_LAZY]


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | _MODULES)
