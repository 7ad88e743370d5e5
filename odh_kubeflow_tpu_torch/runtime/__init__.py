"""The port's controller runtime (copies of odh_kubeflow_tpu/runtime's
workqueue, controller, informer, cached client, builder and manager), the
control-plane metric families (`runtime.metrics`) and the circuit breaker
(`runtime.breaker`)."""
from .builder import Builder, Mapper, Predicate
from .controller import Controller, Reconciler, Request, Result
from .informer import Informer, InformerRegistry
from .manager import LeaderElector, Manager
from .metrics import Counter, Gauge, Histogram, Registry, global_registry
from .workqueue import RateLimiter, WorkQueue
