"""The API types of the port's control plane (the port's copy of the core,
apps, coordination, Notebook, InferenceEndpoint, TPUJob, admission, networking,
RBAC, Gateway and DSPA types of odh_kubeflow_tpu/api), registered in the
port's own `apimachinery.default_scheme`."""
from . import admission, apps, coordination, core, dspa, gateway, networking, rbac
from . import inference, job, notebook
