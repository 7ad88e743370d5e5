"""The port's in-process cluster: the store and typed client, the
StatefulSet controller, the GPU-aware gang scheduler, the kubelet and the
`SimCluster` fixture that boots them (copies of odh_kubeflow_tpu/cluster's,
adapted to `nvidia.com/gpu` nodes), the warm slice pool
(`cluster.slicepool`), the admission webhook dispatcher and its
pooled transport (`cluster.remote.HostPool`), the fault injector
(`cluster.faults`), flow control (`cluster.flowcontrol`), which the
router uses, and the wire: the API server (`ApiServer`), the real-cluster
client (`RemoteStore`) and the stack that joins them
(`cluster.remote_fixture.build_remote_stack`)."""
from .client import Client, retry_on_conflict
from .store import (
    ADDED,
    DELETED,
    DROPPED,
    MODIFIED,
    AdmissionRequest,
    Store,
    Watch,
    WatchEvent,
)
from .apiserver import ApiServer, parse_label_selector
from .faults import (
    MAINTENANCE_WINDOW_ANNOTATION,
    PREEMPTION_TAINT_KEY,
    FaultInjector,
    FaultRule,
    seeded_bad_day,
    seeded_pool_bad_day,
    seeded_slice_bad_day,
)
from .kubelet import Behavior, Kubelet, NodeLifecycle, PodDecision
from .remote import RemoteStore, RemoteWatch
from .scheduler import Scheduler
from .sim import SimCluster
from .slicepool import PoolEntry, SlicePool
from .statefulset import StatefulSetController
from .webhook_dispatch import WebhookDispatcher
