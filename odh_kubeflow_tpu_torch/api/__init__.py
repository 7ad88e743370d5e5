"""The API types of the port's control plane (the port's copy of the core,
apps, coordination and Notebook types of odh_kubeflow_tpu/api), registered
in the port's own `apimachinery.default_scheme`."""
from . import apps, coordination, core
from . import notebook
