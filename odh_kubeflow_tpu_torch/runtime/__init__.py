"""The port's controller runtime (copies of odh_kubeflow_tpu/runtime's
workqueue, controller, informer, cached client, builder and manager), the
control-plane metric families (`runtime.metrics`), the circuit breaker
(`runtime.breaker`), the status coalescer (`runtime.coalesce`) and the
judgement layer over the telemetry: the SLO engine (`runtime.slo`), the
burn-rate alerts (`runtime.alerts`), the canary prober (`runtime.prober`)
and the replica autoscaler (`runtime.autoscaler`)."""
from .builder import Builder, Mapper, Predicate
from .controller import Controller, Reconciler, Request, Result
from .informer import Informer, InformerRegistry
from .manager import LeaderElector, Manager
from .metrics import Counter, Gauge, Histogram, Registry, global_registry
from .workqueue import RateLimiter, WorkQueue
