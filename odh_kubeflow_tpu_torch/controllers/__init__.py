"""The port's controllers (copies of odh_kubeflow_tpu/controllers' notebook,
probe-status, culling, slice-repair, suspend/resume, InferenceEndpoint and
TPUJob reconcilers, the admission webhook and the workbench extension, on
GPU slices)."""
from . import constants
from .config import Config
from .metrics import NotebookMetrics
from .notebook import EventMirrorController, NotebookReconciler, hosts_service_name
from .culling import CullingReconciler
from .inference import InferenceEndpointReconciler
from .job import TPUJobReconciler
from .probe_status import ProbeStatusController
from .slice_repair import SliceRepairController
from .suspend import SuspendResumeController
from .webhook import NotebookWebhook
from .extension import TPUWorkbenchReconciler
