"""Fault injection for the sim control plane (the port's copy of
odh_kubeflow_tpu/cluster/faults.py).

The runtime (runtime/informer.py, runtime/cached_client.py, the webhook
dispatcher) is reimplemented from scratch, so its recovery behavior is
exercised explicitly: a `FaultInjector` that the Store, the kubelet, the
webhook dispatcher and the sim's cluster DNS consult at named fault sites.
Tests script rules against those sites and assert the cluster still
converges.

Design constraints:
- **Deterministic.** Rules fire on call counts ("the next N updates of
  Notebook conflict"), never on wall-clock timers or unseeded randomness.
  The seeded "bad day" schedule derives every count from random.Random(seed).
- **Zero-cost when idle.** Every hook site is `if faults is not None` on a
  plain attribute; a store without an injector pays one identity check.
- **Layered like production faults.** Injection happens at the boundary the
  real failure would occur at: watch severing at the store's subscriber
  queues (a dropped TCP stream), 410 at watch-resume (trimmed watch cache),
  429 at request admission (API priority & fairness), webhook faults at the
  dispatcher's callout, crashes at the kubelet, partitions at cluster DNS.

Fault sites (the `site` strings components consult):
- ``store.read``          GET/LIST against the store (ctx: kind)
- ``store.write``         create/update/patch/delete (ctx: kind, obj)
- ``store.watch_resume``  a watch resuming from a resourceVersion (ctx: kind)
- ``apiserver.request``   every HTTP request before dispatch (ctx: method, path)
- ``webhook.call``        the dispatcher's AdmissionReview POST (ctx: name, url)
- ``kubelet.pod``         each kubelet reconcile (ctx: namespace, name, obj) —
  action rules here ("crash") are *decided*, not raised
- ``probe.http``          the sim cluster-DNS HTTP transport (ctx: host, url)

Slice-level faults (the accelerator layer): host preemption is an *active
operation* like drop_watches — `preempt_host` taints the node with a
cluster-autoscaler-style deletion-candidate taint plus a maintenance-window
notice, and the sim's node lifecycle (cluster/kubelet.py NodeLifecycle)
drains it when the grace window lapses. Card loss / link degradation are
scripted at the in-pod probe agent (its monitor REPORTS the fault; the probe
controller aggregates it into the `TPUHealthy` condition). The combined
seeded schedule is `seeded_slice_bad_day`.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..apimachinery import ConflictError, GoneError, TooManyRequestsError
from ..utils import racecheck

# Host preemption surfaces exactly the way GKE announces it: a soft
# cluster-autoscaler-style taint plus a maintenance-window notice annotation
# carrying the drain deadline. These are CLUSTER-side contracts (node keys),
# not operator annotation keys — their home is the fault substrate.
PREEMPTION_TAINT_KEY = "DeletionCandidateOfClusterAutoscaler"
MAINTENANCE_WINDOW_ANNOTATION = "cloud.google.com/active-node-maintenance"


@dataclass
class FaultRule:
    """One scripted fault: fires at a site while its budget lasts.

    `times=None` keeps firing until the rule is removed; an exhausted rule
    stays registered (fired == times) so tests can assert how often it hit.
    """

    site: str
    error: Optional[Callable[[], Exception]] = None  # raise-on-match
    action: str = ""  # non-raising verdict ("crash", "partition", "delay")
    kind: Optional[str] = None  # match ctx["kind"]
    name: Optional[str] = None  # substring match on ctx name/host/url
    times: Optional[int] = None  # budget; None = unlimited
    match: Optional[Callable[[Dict[str, Any]], bool]] = None  # extra predicate
    param: float = 0.0  # action parameter (e.g. "delay" sleep seconds)
    fired: int = 0

    def _matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        if site != self.site:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.kind is not None and ctx.get("kind") != self.kind:
            return False
        if self.name is not None:
            hay = str(
                ctx.get("name") or ctx.get("host") or ctx.get("url") or ""
            )
            if self.name not in hay:
                return False
        if self.match is not None and not self.match(ctx):
            return False
        return True

    @property
    def exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times


class FaultInjector:
    """Registry of FaultRules plus active operations (watch severing).

    Components hold a reference and call `check(site, **ctx)` (raises the
    first matching rule's error) or `decide(site, **ctx)` (returns the
    matching action rule, for sites where the component — not an exception —
    implements the fault, e.g. the kubelet's crash-restart).
    """

    def __init__(self, seed: Optional[int] = None):
        self._lock = racecheck.make_lock("FaultInjector._lock")
        self._rules: List[FaultRule] = []
        self.rng = random.Random(seed)
        self._stores: List[Any] = []  # bound Stores, for sever_watches
        self._cluster: Any = None  # bound SimCluster, for preempt_host

    # -- rule management --

    def add(self, rule: FaultRule) -> FaultRule:
        with self._lock:
            self._rules.append(rule)
        return rule

    def remove(self, rule: FaultRule) -> None:
        with self._lock:
            try:
                self._rules.remove(rule)
            except ValueError:
                pass

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()

    def rules(self) -> List[FaultRule]:
        with self._lock:
            return list(self._rules)

    # -- consult sites --

    def check(self, site: str, **ctx: Any) -> None:
        """Raise the first matching error rule (consuming one firing)."""
        err: Optional[Exception] = None
        with self._lock:
            for rule in self._rules:
                if rule.error is not None and rule._matches(site, ctx):
                    rule.fired += 1
                    err = rule.error()
                    break
        if err is not None:
            raise err

    def decide(self, site: str, **ctx: Any) -> Optional[FaultRule]:
        """Return the first matching action rule (consuming one firing)."""
        with self._lock:
            for rule in self._rules:
                if rule.action and rule._matches(site, ctx):
                    rule.fired += 1
                    return rule
        return None

    # -- active operations --

    def bind_store(self, store: Any) -> None:
        """Register a Store so drop_watches can sever its streams."""
        with self._lock:
            if store not in self._stores:
                self._stores.append(store)

    def drop_watches(self, api_version: Optional[str] = None,
                     kind: Optional[str] = None) -> int:
        """Sever matching live watch streams on every bound store — the
        network-level analog of an apiserver closing watch connections.
        Returns the number of subscriber queues severed."""
        with self._lock:
            stores = list(self._stores)
        severed = 0
        for store in stores:
            severed += store.sever_watches(api_version=api_version, kind=kind)
        return severed

    def bind_cluster(self, cluster: Any) -> None:
        """Register the SimCluster so host-level faults can be enacted
        through one injector handle (SimCluster binds itself at __init__)."""
        with self._lock:
            self._cluster = cluster

    def preempt_host(self, node_name: str, grace_s: float = 0.5) -> None:
        """Preempt a host: the node gets the deletion-candidate taint +
        a maintenance-window notice whose deadline is now+grace_s; the node
        lifecycle drains it when the window lapses. The grace window is the
        slice-repair controller's checkpoint-before-evict opportunity."""
        with self._lock:
            cluster = self._cluster
        if cluster is None:
            raise RuntimeError("no SimCluster bound (FaultInjector.bind_cluster)")
        cluster.preempt_node(node_name, grace_s=grace_s)

    def restore_host(self, node_name: str) -> None:
        """End a host's maintenance: taint + notice removed, capacity returns
        (the scheduler's capacity-freed watch re-attempts pending gangs)."""
        with self._lock:
            cluster = self._cluster
        if cluster is None:
            raise RuntimeError("no SimCluster bound (FaultInjector.bind_cluster)")
        cluster.restore_node(node_name)

    def poison_host(self, node_name: str) -> None:
        """Silently fail a host (Ready=False, no taint, no notice) — the
        pool-poisoning op: a warm slice whose host dies unannounced sits in
        the pool as a trap until the suspend controller's sweep or a
        claim-time health check evicts it. Heal with restore_host."""
        with self._lock:
            cluster = self._cluster
        if cluster is None:
            raise RuntimeError("no SimCluster bound (FaultInjector.bind_cluster)")
        cluster.fail_node(node_name)

    # -- scripted fault constructors --

    def conflict_storm(self, kind: str, times: int = 3) -> FaultRule:
        """The next `times` UPDATEs of `kind` fail with 409 Conflict
        (optimistic-concurrency conflicts only exist on updates — a create
        can 409 AlreadyExists, never Conflict)."""
        return self.add(FaultRule(
            site="store.write", kind=kind, times=times,
            match=lambda ctx: ctx.get("verb") == "update",
            error=lambda: ConflictError(
                f"injected conflict storm on {kind}"),
        ))

    def throttle(self, times: int = 5, retry_after: float = 0.05,
                 kind: Optional[str] = None, writes_only: bool = False,
                 match: Optional[Callable[[Dict[str, Any]], bool]] = None,
                 ) -> List[FaultRule]:
        """429 + Retry-After on the next `times` store operations."""
        def err() -> Exception:
            return TooManyRequestsError(
                "injected throttle", retry_after=retry_after)

        sites = ["store.write"] if writes_only else ["store.write", "store.read"]
        return [
            self.add(FaultRule(site=s, kind=kind, times=times, error=err,
                               match=match))
            for s in sites
        ]

    def expire_watch(self, kind: Optional[str] = None,
                     times: int = 1) -> FaultRule:
        """The next `times` watch resumes answer 410 Expired — forces the
        informer/reflector relist path regardless of history depth."""
        return self.add(FaultRule(
            site="store.watch_resume", kind=kind, times=times,
            error=lambda: GoneError("injected: too old resource version"),
        ))

    def webhook_outage(self, name: Optional[str] = None,
                       times: int = 3, mode: str = "timeout") -> FaultRule:
        """The dispatcher's next `times` webhook callouts fail before the
        POST — `timeout` (socket timeout) or `error` (connection refused)."""
        import socket

        def err() -> Exception:
            if mode == "timeout":
                return socket.timeout("injected webhook timeout")
            return ConnectionError("injected webhook connection failure")

        return self.add(FaultRule(
            site="webhook.call", name=name, times=times, error=err))

    def crash_pod(self, name: str, restarts: int = 1) -> FaultRule:
        """The kubelet crash-restarts matching pods: container goes
        not-ready (CrashLoopBackOff, restartCount++), its server dies, and
        after `restarts` firings the pod comes back up."""
        return self.add(FaultRule(
            site="kubelet.pod", name=name, times=restarts, action="crash"))

    def reclaim_race(self, times: int = 3) -> FaultRule:
        """The next `times` Node updates 409 — exactly the write the warm-
        pool claim CAS rides (the reference's cluster/slicepool.py _stamp). Two resumes
        racing for the last warm slice plus this storm exercise the
        lose-and-move-on path: the loser must fall to the next pool or a
        cold miss, never double-claim or wedge."""
        return self.add(FaultRule(
            site="store.write", kind="Node", times=times,
            match=lambda ctx: ctx.get("verb") == "update",
            error=lambda: ConflictError("injected reclaim race on Node"),
        ))

    def partition_probe(self, host: Optional[str] = None,
                        times: Optional[int] = None) -> FaultRule:
        """Cluster-DNS HTTP requests to matching hosts fail — the probe
        agent's network partition. times=None holds the partition until the
        rule is removed (heal by `injector.remove(rule)`)."""
        return self.add(FaultRule(
            site="probe.http", name=host, times=times,
            error=lambda: ConnectionError("injected network partition"),
        ))


def apiserver_overload(injector: FaultInjector, seed: int,
                       scale: float = 1.0) -> List[FaultRule]:
    """A deterministic apiserver-overload schedule: the symptoms
    an admission storm produces at the API boundary — bursts of 429 on create
    traffic plus request-latency injection — with every budget drawn from
    random.Random(seed). Pair it with a client-side create storm so recovery
    has real work: clients must retry through the bursts, nothing may wedge,
    and exempt-level (lease) traffic must never be starved.

    `scale` multiplies the drawn budgets so soak lanes can lengthen the bad
    day without changing its shape."""
    rng = random.Random(seed)

    def n(lo: int, hi: int) -> int:
        return max(1, int(rng.randint(lo, hi) * scale))

    rules = [
        # 429 bursts on create traffic at the HTTP boundary (wire mode)
        injector.add(FaultRule(
            site="apiserver.request", times=n(5, 15),
            match=lambda ctx: ctx.get("method") == "POST",
            error=lambda: TooManyRequestsError(
                "injected apiserver overload", retry_after=0.05),
        )),
        # request-latency injection: every verb slows down under load
        injector.add(FaultRule(
            site="apiserver.request", action="delay",
            param=0.005 * rng.randint(1, 6), times=n(10, 30),
        )),
        # the same 429 bursts at the store boundary (sim mode, where typed
        # clients skip the HTTP layer); creates excluded per seeded_bad_day's
        # rationale — the scenario's own storm must enter the system
        *injector.throttle(times=n(4, 10), retry_after=0.02 * rng.randint(1, 3),
                           match=lambda ctx: ctx.get("verb") != "create"),
    ]
    return rules


def seeded_bad_day(injector: FaultInjector, seed: int,
                   kind: str = "Notebook") -> List[FaultRule]:
    """A deterministic combined fault schedule: every budget is drawn from
    random.Random(seed), so two runs with the same seed inject the identical
    fault set. Watch drops are count-scheduled by the caller (the test loop
    calls injector.drop_watches between convergence waits) — nothing here
    fires on wall-clock time."""
    rng = random.Random(seed)
    rules = [
        injector.conflict_storm(kind, times=rng.randint(2, 6)),
        # throttle everything except creates: the scenario's own
        # object creation must enter the system so recovery has work to do
        *injector.throttle(times=rng.randint(3, 8),
                           retry_after=0.02 * rng.randint(1, 3),
                           match=lambda ctx: ctx.get("verb") != "create"),
        injector.expire_watch(times=rng.randint(1, 3)),
        injector.webhook_outage(times=rng.randint(1, 4), mode="timeout"),
        injector.partition_probe(times=rng.randint(2, 5)),
    ]
    return rules


def seeded_slice_bad_day(
    cluster: Any,
    seed: int,
    pod_nodes: Dict[str, str],
    agents: Optional[Dict[str, Any]] = None,
    grace_s: float = 0.4,
    control_plane: bool = True,
) -> Dict[str, List[str]]:
    """One deterministic accelerator-layer bad day on top of the control-plane
    schedule: every victim choice is drawn from random.Random(seed).

    `pod_nodes` maps pod name -> node name for the candidate victims (the
    caller reads placements after bring-up). Enacts, per seeded draw:
    - host preemption (taint + maintenance notice; the node lifecycle drains
      after `grace_s`) on 1..len/2 distinct hosts,
    - chip loss (agent's monitor drops half its visible chips) or ICI
      degradation on 0..2 of the remaining pods, when `agents` is given.

    Returns the enacted plan {"preempted": [nodes], "chip_loss": [pods],
    "ici": [pods]} so the soak can heal preemptions and assert outcomes."""
    rng = random.Random(seed)
    # draw the control-plane seed FIRST so the fault set is a pure function
    # of `seed`, but install those rules LAST: the slice-fault enactment
    # below goes through the same store, and a 429 rule swallowing the
    # scenario's own taint write would silently shrink the bad day
    cp_seed = rng.randrange(2**31) if control_plane else None
    plan: Dict[str, List[str]] = {"preempted": [], "chip_loss": [], "ici": []}
    pods = sorted(pod_nodes)
    if pods:
        n_preempt = rng.randint(1, max(1, len(pods) // 2))
        victims = rng.sample(pods, n_preempt)
        for pod in victims:
            cluster.preempt_node(pod_nodes[pod], grace_s=grace_s)
            plan["preempted"].append(pod_nodes[pod])
        if agents is not None:
            survivors = [p for p in pods if p not in victims and p in agents]
            for pod in rng.sample(survivors, min(len(survivors), rng.randint(0, 2))):
                monitor = agents[pod].monitor
                if rng.random() < 0.5 and getattr(monitor, "chips", 0) > 1:
                    monitor.chips = monitor.chips // 2
                    plan["chip_loss"].append(pod)
                else:
                    monitor.ici_fault = True
                    plan["ici"].append(pod)
    if cp_seed is not None:
        seeded_bad_day(cluster.faults, seed=cp_seed)
    return plan


def seeded_pool_bad_day(
    cluster: Any,
    seed: int,
    warm_nodes: List[str],
    control_plane: bool = True,
) -> Dict[str, List[str]]:
    """One deterministic warm-pool bad day: every choice drawn from
    random.Random(seed).

    - **pool poisoning**: a seeded subset of the given WARM hosts fails
      silently (Ready=False, nothing announced) — resumes must route around
      the trap via the pool sweep / claim-time health check, never wedge on
      a dead warm slice,
    - **reclaim race**: a Node-update conflict storm lands exactly on the
      claim CAS writes, so racing claimants exercise the lose-and-move-on
      path,
    - plus the usual control-plane schedule (seeded_bad_day).

    Returns {"poisoned": [nodes]} so the soak can heal and assert outcomes.
    """
    rng = random.Random(seed)
    cp_seed = rng.randrange(2**31) if control_plane else None
    plan: Dict[str, List[str]] = {"poisoned": []}
    candidates = sorted(warm_nodes)
    if candidates:
        n = rng.randint(1, max(1, len(candidates) // 2))
        for node in rng.sample(candidates, min(n, len(candidates))):
            cluster.fail_node(node)
            plan["poisoned"].append(node)
    cluster.faults.reclaim_race(times=rng.randint(2, 6))
    if cp_seed is not None:
        seeded_bad_day(cluster.faults, seed=cp_seed)
    return plan


def seeded_router_bad_day(
    cluster: Any,
    seed: int,
    replica_nodes: Dict[int, List[str]],
    grace_s: float = 0.4,
    control_plane: bool = True,
    slow_factor_range: Tuple[float, float] = (2.0, 6.0),
) -> Dict[str, Any]:
    """One deterministic serving-fleet bad day: every victim
    choice is drawn from random.Random(seed).

    `replica_nodes` maps replica index -> the node names hosting that gang
    (the caller reads placements after fleet bring-up). Enacts, per draw:

    - **replica loss mid-stream**: EVERY host of one seeded victim replica
      is preempted (taint + maintenance notice; NodeLifecycle drains after
      `grace_s`) — the fleet's unit of failure is a whole gang, and the
      router must eject it while the controller re-places through the
      repair/warm-pool paths,
    - **slow replica**: one surviving replica is named in the plan with a
      seeded latency factor. The engines live OUTSIDE the cluster sim, so
      the caller applies the slowdown at its engine boundary (wrapping
      submit with the factor) — the router's TTFT-tail scoring and
      hedging must route around it,
    - **probe flaps**: a count-bounded cluster-DNS partition on half of one
      surviving replica's hosts — transient probe failures that must feed
      the router's breaker WITHOUT permanently ejecting a healthy replica
      (bounded re-admission earns it back),
    - plus the usual control-plane schedule (seeded_bad_day).

    Returns the enacted plan {"killed_replica", "preempted": [nodes],
    "slow_replica", "slow_factor", "probe_flap_hosts": [nodes]} so the soak
    can heal and assert outcomes."""
    rng = random.Random(seed)
    # draw the control-plane seed FIRST, install its rules LAST (the
    # preemption writes below must not be swallowed by a 429 rule) — the
    # seeded_slice_bad_day idiom
    cp_seed = rng.randrange(2**31) if control_plane else None
    plan: Dict[str, Any] = {
        "killed_replica": None,
        "preempted": [],
        "slow_replica": None,
        "slow_factor": 1.0,
        "probe_flap_hosts": [],
    }
    indexes = sorted(replica_nodes)
    if indexes:
        victim = rng.choice(indexes)
        plan["killed_replica"] = victim
        for node in sorted(replica_nodes[victim]):
            cluster.preempt_node(node, grace_s=grace_s)
            plan["preempted"].append(node)
        survivors = [i for i in indexes if i != victim]
        if survivors:
            plan["slow_replica"] = rng.choice(survivors)
            plan["slow_factor"] = round(rng.uniform(*slow_factor_range), 2)
            flap_hosts = sorted(replica_nodes[rng.choice(survivors)])
            for node in flap_hosts[: max(1, len(flap_hosts) // 2)]:
                cluster.faults.partition_probe(
                    host=node, times=rng.randint(1, 3)
                )
                plan["probe_flap_hosts"].append(node)
    if cp_seed is not None:
        seeded_bad_day(cluster.faults, seed=cp_seed)
    return plan
