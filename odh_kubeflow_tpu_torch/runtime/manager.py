"""Manager: owns the client, informers, controllers, webhook registrations,
leader election, and health/metrics — ctrl.NewManager + mgr.Start() analog
(reference notebook-controller/main.go:87-148, odh main.go:117-245). The
port's copy of odh_kubeflow_tpu/runtime/manager.py.

Sharding: a Manager may own a `ShardSpec` — a deterministic
hash partition of the object keyspace. Its builders then drop events for
objects outside the shard, and its leader-election lease is per-shard
(`{id}-shard-{i}`), so N manager replicas per shard give standby takeover
within lease bounds while shards scale the reconcile budget horizontally
(the NotebookOS shape: replicated control plane, one leader per partition)."""
from __future__ import annotations

import logging
import threading
import time
import uuid
import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional

from ..api.coordination import Lease, LeaseSpec
from ..apimachinery import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    Scheme,
    default_scheme,
    now_rfc3339,
    parse_time,
)
from ..cluster.client import Client
from ..cluster.store import Store
from . import cpprofile
from .controller import Controller
from .informer import InformerRegistry
from .metrics import Registry, global_registry

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class ShardSpec:
    """A hash partition of the object keyspace: shard `index` of `count`.

    Ownership is crc32("{ns}/{name}") % count — stable across processes and
    restarts (no coordination needed to agree on the partition), uniform
    enough that mixed-class fleets spread evenly. Every shard sees every
    event (shared informers); non-owned keys are dropped at enqueue time
    (runtime/builder.py), so the filter costs one hash per event."""

    index: int
    count: int

    def __post_init__(self) -> None:
        if self.count < 1 or not (0 <= self.index < self.count):
            raise ValueError(f"invalid shard {self.index}/{self.count}")

    def owns(self, namespace: str, name: str) -> bool:
        if self.count == 1:
            return True
        key = f"{namespace}/{name}".encode()
        return zlib.crc32(key) % self.count == self.index


class LeaderElector:
    """Lease-based leader election with the standard acquire/renew loop."""

    def __init__(
        self,
        client: Client,
        lease_name: str,
        namespace: str = "kube-system",
        identity: Optional[str] = None,
        lease_duration: float = 15.0,
        renew_period: float = 5.0,
    ):
        self.client = client
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity or f"mgr-{uuid.uuid4().hex[:8]}"
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.is_leader = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.on_stopped_leading: Optional[Callable[[], None]] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name="leader-elector")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    @staticmethod
    def _now() -> str:
        # sub-second precision: whole-second truncation (now_rfc3339) would
        # inflate lease age by up to 1s and let rivals steal a healthy lease
        import datetime

        return datetime.datetime.now(datetime.timezone.utc).isoformat()

    def _try_acquire(self) -> bool:
        try:
            lease = self.client.get(Lease, self.namespace, self.lease_name)
        except NotFoundError:
            lease = Lease()
            lease.metadata.name = self.lease_name
            lease.metadata.namespace = self.namespace
            lease.spec = LeaseSpec(
                holder_identity=self.identity,
                lease_duration_seconds=int(self.lease_duration),
                acquire_time=self._now(),
                renew_time=self._now(),
            )
            try:
                self.client.create(lease)
                return True
            except AlreadyExistsError:
                return False
        if lease.spec.holder_identity == self.identity:
            lease.spec.renew_time = self._now()
        else:
            if lease.spec.renew_time:
                age = time.time() - parse_time(lease.spec.renew_time).timestamp()
                if age < (lease.spec.lease_duration_seconds or self.lease_duration):
                    return False  # healthy other leader
            lease.spec.holder_identity = self.identity
            lease.spec.acquire_time = self._now()
            lease.spec.renew_time = self._now()
            lease.spec.lease_transitions += 1
        try:
            self.client.update(lease)
            return True
        except (ConflictError, NotFoundError):
            return False

    def _run(self) -> None:
        last_renew = time.monotonic()
        while not self._stop.is_set():
            try:
                acquired = self._try_acquire()
                if acquired:
                    last_renew = time.monotonic()
            except Exception as e:
                # transient API/transport errors must not kill the elector
                # thread (a dead elector with is_leader still set is silent
                # split-brain). While the lease we hold is still within its
                # duration, one failed renew tick is NOT lease loss — stand
                # down only when renewal keeps failing past the deadline.
                # stand-down deadline is STRICTLY shorter than the lease: at
                # lease_duration a rival may legally take the lease, so keeping
                # leadership that long guarantees an overlap window
                renew_deadline = max(1.0, self.lease_duration - self.renew_period)
                held = (
                    self.is_leader.is_set()
                    and time.monotonic() - last_renew < renew_deadline
                )
                log.warning(
                    "leader election tick failed (%s): %r",
                    "lease still held" if held else "standing down",
                    e,
                )
                acquired = held
            was_leader = self.is_leader.is_set()
            if acquired:
                self.is_leader.set()
            else:
                self.is_leader.clear()
                if was_leader:
                    # leadership lost mid-flight: the manager must stand down
                    # (controller-runtime terminates the process here)
                    log.error(
                        "leader election: lost lease %s/%s; standing down",
                        self.namespace,
                        self.lease_name,
                    )
                    cb = self.on_stopped_leading
                    if cb is not None:
                        cb()
                    return
            self._stop.wait(self.renew_period)


class Manager:
    def __init__(
        self,
        store: Store,
        scheme: Scheme = default_scheme,
        leader_election: bool = False,
        leader_election_id: str = "tpu-notebook-controller",
        metrics_registry: Optional[Registry] = None,
        cached_reads: bool = True,
        shard: Optional[ShardSpec] = None,
        lease_duration: float = 15.0,
        renew_period: float = 5.0,
    ):
        self.store = store
        self.scheme = scheme
        self.shard = shard
        self.informers = InformerRegistry(store, scheme)
        # controller-runtime's split client: reconciler reads serve from the
        # informer caches (mgr.GetClient()); api_reader bypasses the cache
        # (mgr.GetAPIReader()) for read-modify-write freshness.
        # cached_reads=False keeps every read direct — the sim's SYSTEM
        # manager (scheduler/statefulset/kubelet, the cluster side) uses it:
        # those controllers make destructive decisions (pod deletes) where
        # kube's real counterparts read authoritative etcd state
        self.api_reader = Client(store, scheme)
        if cached_reads:
            from .cached_client import CachedClient

            self.client: Client = CachedClient(store, scheme, self.informers)
        else:
            self.client = self.api_reader
        self.metrics = metrics_registry or global_registry
        # cache-sync age is computed at scrape time (the pull-style collector
        # pattern); weakref-bound so the registry never pins the manager, and
        # a GC finalizer UNREGISTERS the collector — the global registry is
        # process-lifetime, so dead managers' closures must not accumulate
        # scrape cost forever
        import weakref

        registry = self.metrics

        def _collect_cache_age() -> None:
            mgr = ref()
            if mgr is not None:
                mgr._collect_informer_ages()

        ref = weakref.ref(
            self, lambda _r: registry.remove_collector(_collect_cache_age)
        )
        registry.add_collector(_collect_cache_age)
        self.controllers: List[Controller] = []
        self._runnables: List[Callable[[], None]] = []  # extra start hooks
        # observability services (SLO engine, alert manager, canary prober,
        # flight recorder): started/stopped with the manager and exposed by
        # name so the debug mux (runtime/serving.py) can serve their state
        self._services: List = []  # objects with start()/stop()
        self.slo_engine = None
        self.alert_manager = None
        self.prober = None
        self.flight_recorder = None
        self._started = False
        self.elector: Optional[LeaderElector] = None
        if leader_election:
            # the elector gets its OWN unfenced client: lease acquisition is
            # the one write that must go through while we are NOT leader.
            # It declares the leader-election flow, so the flowcontrol exempt
            # level carries lease traffic even through an admission storm —
            # failover must never queue behind the work it is failing over.
            from ..cluster.flowcontrol import LEADER_ELECTION_FLOW

            elector_client = Client(store, scheme)
            elector_client.flow = LEADER_ELECTION_FLOW
            lease_id = leader_election_id
            if shard is not None and shard.count > 1:
                # per-shard lease: shard i's leader and standbys contend for
                # their own lock, independent of every other shard
                lease_id = f"{leader_election_id}-shard-{shard.index}"
            self.elector = LeaderElector(
                elector_client,
                lease_id,
                lease_duration=lease_duration,
                renew_period=renew_period,
            )
            # fencing: once the lease lapses, every write through the
            # manager's client is refused — a partitioned ex-leader's
            # in-flight reconciles cannot mutate the cluster past its lease
            # (the lease-loss path also stops the controllers; the fence
            # closes the in-flight window)
            elector = self.elector
            self.client.write_fence = lambda: elector.is_leader.is_set()

    def _collect_informer_ages(self) -> None:
        from .metrics import informer_cache_sync_age_seconds

        now = time.time()
        for inf in list(self.informers._informers.values()):
            if inf.synced_at:
                informer_cache_sync_age_seconds.set(
                    now - inf.synced_at, kind=inf.kind
                )

    def builder(self, name: str) -> "Builder":
        # deferred: builder imports cluster.store, whose package init reaches
        # back into runtime.manager via the kubelet — a module-level import
        # here would make `import odh_kubeflow_tpu.runtime` order-dependent
        from .builder import Builder

        return Builder(self, name)

    def add_controller(self, ctrl: Controller) -> None:
        self.controllers.append(ctrl)
        if self._started:
            ctrl.start()

    def add_runnable(self, fn: Callable[[], None]) -> None:
        self._runnables.append(fn)

    def add_service(self, service) -> None:
        """Register a start()/stop() service tied to the manager lifecycle
        (the SLO engine's evaluation loop, the canary prober)."""
        self._services.append(service)
        if self._started:
            service.start()

    def start(self, wait_for_leadership_timeout: Optional[float] = None) -> None:
        """With leader election, blocks until leadership is acquired —
        indefinitely by default, as controller-runtime does: during a rolling
        update the incoming replica must WAIT out the old lease, not crash
        into CrashLoopBackOff. A timeout is for tests."""
        if self._started:
            return
        # CPPROFILE=1 takeover decomposition (runtime/cpprofile.py): phase
        # marks bracket the sequential legs of bring-up — lease-acquire,
        # relist (informer sync), cache-warm (controller/service start) —
        # and the tracker stays live past start() to catch first-sweep
        # (first reconcile completion) and first-owned-write (first write
        # through THIS manager's fenced clients). None disarmed.
        tracker = cpprofile.takeover_begin(
            self.elector.identity if self.elector is not None
            else f"manager-{id(self) & 0xFFFFFF:x}",
            {id(self.client), id(self.api_reader)},
        )
        self._cp_takeover = tracker
        if self.elector is not None:
            self.elector.on_stopped_leading = self.stop
            self.elector.start()
            if wait_for_leadership_timeout is not None:
                deadline = time.monotonic() + wait_for_leadership_timeout
                while not self.elector.is_leader.wait(
                    timeout=min(0.2, max(0.01, deadline - time.monotonic()))
                ):
                    if time.monotonic() >= deadline:
                        raise TimeoutError("failed to acquire leadership")
                    if tracker is not None:
                        # still waiting: lease-acquire must measure the
                        # acquisition, not the standby's healthy wait
                        tracker.touch_waiting()
            else:
                while not self.elector.is_leader.wait(timeout=1.0):
                    if self.elector._stop.is_set():
                        return
                    if tracker is not None:
                        tracker.touch_waiting()
        if tracker is not None:
            tracker.mark("leader")
        self.informers.start_all()
        if tracker is not None:
            tracker.mark("synced")
        for ctrl in self.controllers:
            ctrl.start()
        for fn in self._runnables:
            fn()
        for service in self._services:
            service.start()
        self._started = True
        if tracker is not None:
            tracker.mark(
                "started",
                controller_ids={id(c) for c in self.controllers},
            )

    def stop(self) -> None:
        tracker = getattr(self, "_cp_takeover", None)
        if tracker is not None:
            tracker.abandon()  # no-op if the decomposition already completed
            self._cp_takeover = None
        for service in self._services:
            try:
                service.stop()
            except Exception:
                log.exception("stopping %r failed", service)
        for ctrl in self.controllers:
            ctrl.stop()
        self.informers.stop_all()
        if self.elector is not None:
            self.elector.stop()
        self._started = False

    # health endpoints contract (healthz/readyz — both reference main.go
    # files bind ping handlers at :8081; here the checks are real)
    def healthz(self) -> bool:
        """Liveness: no controller worker thread has died, and once started,
        leadership (when enabled) is still held."""
        for ctrl in self.controllers:
            for t in getattr(ctrl, "_threads", []):
                if not t.is_alive():
                    return False
        if self._started and self.elector is not None:
            t = self.elector._thread
            if t is not None and not t.is_alive():
                return False  # dead elector = undetectable lease loss
            if not self.elector.is_leader.is_set():
                return False
        return True

    def readyz(self) -> bool:
        """Readiness: started and every informer cache has synced."""
        if not self._started:
            return False
        for inf in self.informers._informers.values():
            if not inf.synced.is_set():
                return False
        return True

    def serve_endpoints(self, metrics_port: int = 8080, health_port: int = 8081,
                        host: str = "0.0.0.0"):
        """Bind /metrics (Prometheus exposition) and /healthz + /readyz —
        reference notebook-controller/main.go:125-133."""
        from .serving import ServingEndpoints

        server = ServingEndpoints(
            self, metrics_port=metrics_port, health_port=health_port, host=host
        ).start()
        return server

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Test/bench helper: wait for every controller queue to drain."""
        deadline = time.monotonic() + timeout
        for ctrl in self.controllers:
            remaining = max(0.1, deadline - time.monotonic())
            if not ctrl.wait_idle(timeout=remaining):
                return False
        # second pass: controller A's work may have re-fed controller B
        for ctrl in self.controllers:
            remaining = max(0.1, deadline - time.monotonic())
            if not ctrl.wait_idle(timeout=remaining):
                return False
        return True
