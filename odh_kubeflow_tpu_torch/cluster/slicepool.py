"""Warm slice pool: capacity multiplexing for suspend/resume and promotion
(the port's copy of odh_kubeflow_tpu/cluster/slicepool.py, on GPU node
pools).

The reference's culling path scales replicas to 0 and throws the slice back
into general capacity, so every user return pays the full cold
admission -> schedule -> bring-up path. This module is the NotebookOS-style
alternative: on suspend, the slice's node pool is RELEASED WARM — nodes kept
with the slice's env staged — and on resume (or an InferenceEndpoint's
promotion) the scheduler binds from the pool (hit) instead of cold
placement.

State lives on the Nodes themselves (the API server is the database — the
same durability idiom as the repair/suspend annotation machines), so the
pool survives controller restarts and both managers (the product-side
controllers and the cluster-side scheduler) read one source of truth:

- ``pool-state: warm``     the slice is held for resume binds; the scheduler
                           places NO pods here until it is claimed or
                           reclaimed,
- ``pool-state: claimed``  a resuming workload owns the bind window; only
                           pods of ``pool-claimed-by`` may land,
- (no annotation)          general capacity.

Claims are CAS'd through the node's resourceVersion (a plain update, not a
merge patch): two claimants racing for the last warm slice resolve by
optimistic concurrency — the loser sees Conflict or a non-warm re-read and
moves to the next pool (or a cold miss). The sweep drops warm/claimed marks
from unhealthy nodes (pool poisoning: a preempted host must not sit in the
pool masquerading as a fast resume).

A pool's shape is read off its lead node's GKE accelerator label and its
slice-shape label (`gpu.GPU_TOPOLOGY_LABEL`, which `SimCluster.add_gpu_pool`
stamps and a GPU pod selects), where the reference reads the TPU topology.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..api.core import Node
from ..apimachinery import ConflictError, NotFoundError, rfc3339_precise
from .faults import PREEMPTION_TAINT_KEY
from ..runtime.metrics import global_registry
from ..gpu import GKE_GPU_ACCELERATOR_LABEL, GKE_NODEPOOL_LABEL, GPU_TOPOLOGY_LABEL

log = logging.getLogger(__name__)

# Node-side pool contract. These are CLUSTER keys stamped on Nodes (like
# faults.py's taint/notice keys), not Notebook-CR annotations — their
# canonical home is this module, which controllers/constants.py cannot be
# (importing it from cluster/ at module level would cycle through the
# controllers package __init__).
POOL_STATE_ANNOTATION = "notebooks.tpu.kubeflow.org/pool-state"  # lint: disable=annotation-convention
POOL_SINCE_ANNOTATION = "notebooks.tpu.kubeflow.org/pool-since"  # lint: disable=annotation-convention
POOL_PRIORITY_ANNOTATION = "notebooks.tpu.kubeflow.org/pool-priority"  # lint: disable=annotation-convention
POOL_CLAIMED_BY_ANNOTATION = "notebooks.tpu.kubeflow.org/pool-claimed-by"  # lint: disable=annotation-convention

POOL_STATE_WARM = "warm"
POOL_STATE_CLAIMED = "claimed"

# ---------------------------------------------------------------------------
# metrics: slice_pool_{size,hit_ratio}, notebook_reclaims_total, and the
# resume-latency histogram the resume SLO judges
# ---------------------------------------------------------------------------

slice_pool_size = global_registry.gauge(
    "slice_pool_size",
    "Warm slices currently held in the pool (mesh-formed, libtpu env "
    "staged, awaiting a resume bind), by accelerator",
    labels=("accelerator",),
)
slice_pool_hits_total = global_registry.counter(
    "slice_pool_hits_total",
    "Resume attempts that bound a warm slice from the pool",
)
slice_pool_misses_total = global_registry.counter(
    "slice_pool_misses_total",
    "Resume attempts that found no matching warm slice and fell back to "
    "cold placement",
)
slice_pool_hit_ratio = global_registry.gauge(
    "slice_pool_hit_ratio",
    "Cumulative warm-pool hit fraction over all resume claims "
    "(hits / (hits + misses); 1.0 until the first miss)",
)
notebook_reclaims_total = global_registry.counter(
    "notebook_reclaims_total",
    "Slices reclaimed under oversubscription pressure, by reason "
    "(pool-idle = an idle warm slice returned to general capacity; "
    "suspend = a running lower-priority notebook checkpoint-suspended; "
    "poisoned = an unhealthy slice swept out of the pool)",
    labels=("reason",),
)
slice_pool_prewarmed_total = global_registry.counter(
    "slice_pool_prewarmed_total",
    "Free slices proactively parked warm by the POOL_PREWARM target "
    "(spun up, mesh-formed, held ahead of demand) rather than recycled "
    "from a suspension",
)
notebook_resume_seconds = global_registry.histogram(
    "notebook_resume_seconds",
    "Unstop -> mesh-ready-again latency per resumed notebook (the warm-pool "
    "counterpart of the cold-create north-star histogram)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300),
)
notebook_restore_verifications_total = global_registry.counter(
    "notebook_restore_verifications_total",
    "Resume-side checkpoint restore verifications by result (ok = the "
    "/tpu/restore checksum matched the saved one; mismatch = the restored "
    "kernel differs from what the suspend saved; unverified = no saved "
    "checksum or no restore hook to ask)",
    labels=("result",),
)


def record_claim(hit: bool) -> None:
    """One resume claim outcome; keeps the cumulative hit-ratio gauge true."""
    if hit:
        slice_pool_hits_total.inc()
    else:
        slice_pool_misses_total.inc()
    hits = slice_pool_hits_total.value()
    misses = slice_pool_misses_total.value()
    slice_pool_hit_ratio.set(hits / (hits + misses) if hits + misses else 1.0)


@dataclass(frozen=True)
class PoolEntry:
    """One warm/claimed slice: a whole node pool of one topology."""

    pool: str
    accelerator: str  # GKE accelerator label value (e.g. nvidia-h100-80gb)
    topology: str
    state: str  # warm | claimed
    priority: int  # releasing notebook's priority (reclaim ordering)
    since: str
    claimed_by: str
    nodes: List[str]


class SlicePool:
    """Pool operations over the store. Stateless between calls — every verb
    re-reads the Nodes, so any number of controller instances (and the
    scheduler, read-only) agree without shared memory."""

    def __init__(self, client, reader=None):
        self.client = client
        # what the verbs read by (`client` unless given): a controller
        # passes a direct read of the store, so a claim sees the marks of a
        # release that finished before it, whatever its cache has applied
        self.reader = client if reader is None else reader

    # ---------- reads ----------

    def node_healthy(self, node: Node) -> bool:
        """The pool's one health predicate (claim eligibility, sweep, and
        the reclaimer's free-capacity judgment all share it — drifting
        copies would re-open the reclaim-while-capacity-free window)."""
        if any(
            t.get("key") == PREEMPTION_TAINT_KEY
            for t in node.spec.get("taints", [])
        ):
            return False
        return not any(
            c.type == "Ready" and c.status == "False"
            for c in node.status.conditions
        )

    def entries(self, include_unhealthy: bool = False) -> List[PoolEntry]:
        """Current pool membership, grouped by node pool. A pool counts as a
        member when EVERY node of that node pool carries a pool annotation —
        judged against the pool's FULL node set, not just the annotated
        subset (a half-marked pool is a write in flight or a lost-CAS
        remnant, not capacity: claiming it would disagree with the
        scheduler's reservation view of the unmarked lead node) — and,
        unless asked, every node is healthy."""
        by_pool: Dict[str, List[Node]] = {}
        marked: Dict[str, int] = {}
        for node in self.reader.list(Node):
            pool = node.metadata.labels.get(GKE_NODEPOOL_LABEL, node.metadata.name)
            if POOL_STATE_ANNOTATION in node.metadata.annotations:
                marked[pool] = marked.get(pool, 0) + 1
            by_pool.setdefault(pool, []).append(node)
        out: List[PoolEntry] = []
        for pool, nodes in sorted(by_pool.items()):
            if marked.get(pool, 0) != len(nodes):
                continue  # unmarked or half-marked: not pool capacity
            if not include_unhealthy and not all(
                self.node_healthy(n) for n in nodes
            ):
                continue
            lead = min(nodes, key=lambda n: n.metadata.name)
            ann = lead.metadata.annotations
            try:
                priority = int(ann.get(POOL_PRIORITY_ANNOTATION, "0") or 0)
            except ValueError:
                priority = 0
            out.append(
                PoolEntry(
                    pool=pool,
                    accelerator=lead.metadata.labels.get(
                        GKE_GPU_ACCELERATOR_LABEL, ""
                    ),
                    topology=lead.metadata.labels.get(GPU_TOPOLOGY_LABEL, ""),
                    state=ann.get(POOL_STATE_ANNOTATION, ""),
                    priority=priority,
                    since=ann.get(POOL_SINCE_ANNOTATION, ""),
                    claimed_by=ann.get(POOL_CLAIMED_BY_ANNOTATION, ""),
                    nodes=sorted(n.metadata.name for n in nodes),
                )
            )
        return out

    def refresh_gauges(self) -> None:
        counts: Dict[str, int] = {}
        for e in self.entries():
            if e.state == POOL_STATE_WARM:
                counts[e.accelerator or "unknown"] = (
                    counts.get(e.accelerator or "unknown", 0) + 1
                )
        seen = {
            labels.get("accelerator")
            for labels, _ in slice_pool_size.series()
        }
        for accel in seen - set(counts):
            if accel is not None:
                slice_pool_size.set(0, accelerator=accel)
        for accel, n in counts.items():
            slice_pool_size.set(n, accelerator=accel)

    # ---------- writes (all CAS'd through node resourceVersions) ----------

    _ANY_STATE = "<any>"  # _stamp sentinel: skip the expect_state guard

    def _stamp(self, node_name: str, updates: Dict[str, Optional[str]],
               expect_state: str = _ANY_STATE) -> bool:
        """CAS one node's pool annotations via update (NOT merge patch): the
        read's resourceVersion rides into the write, so a racing claimant
        gets Conflict instead of silently stacking. `expect_state` guards the
        transition (e.g. claim requires warm); the default skips the guard."""
        for _ in range(3):
            try:
                node = self.reader.get(Node, "", node_name)
            except NotFoundError:
                return False
            if expect_state is not self._ANY_STATE and (
                node.metadata.annotations.get(POOL_STATE_ANNOTATION)
                != expect_state
            ):
                return False
            for key, value in updates.items():
                if value is None:
                    node.metadata.annotations.pop(key, None)
                else:
                    node.metadata.annotations[key] = value
            try:
                self.client.update(node)
                return True
            except ConflictError:
                continue  # re-read and re-judge — the guard is the point
            except NotFoundError:
                return False
        return False

    def release(self, pool: str, nodes: List[str], priority: int = 0) -> bool:
        """Suspend path: hold this slice warm. Returns False when any node
        refused (gone/raced) — the caller then leaves the slice to general
        capacity rather than half-reserving it."""
        stamped = []
        for name in sorted(nodes):
            ok = self._stamp(
                name,
                {
                    POOL_STATE_ANNOTATION: POOL_STATE_WARM,
                    POOL_SINCE_ANNOTATION: rfc3339_precise(time.time()),
                    POOL_PRIORITY_ANNOTATION: str(int(priority)),
                    POOL_CLAIMED_BY_ANNOTATION: None,
                },
            )
            if not ok:
                for done in stamped:  # unwind: no half-reserved slices
                    self._clear(done)
                return False
            stamped.append(name)
        self.refresh_gauges()
        log.info("slice pool: released %s warm (%d nodes, priority %d)",
                 pool, len(nodes), priority)
        return True

    def claim(self, gke_accelerator: str, topology: str,
              notebook_key: str) -> Optional[PoolEntry]:
        """Resume path: claim a matching warm slice for `notebook_key`
        (ns/name). The lead node's CAS is the lock — losing it means another
        resume won this pool; try the next. None = pool miss."""
        for entry in self.entries():
            if entry.state != POOL_STATE_WARM:
                continue
            if entry.accelerator != gke_accelerator or entry.topology != topology:
                continue
            lead, rest = entry.nodes[0], entry.nodes[1:]
            updates = {
                POOL_STATE_ANNOTATION: POOL_STATE_CLAIMED,
                POOL_CLAIMED_BY_ANNOTATION: notebook_key,
            }
            if not self._stamp(lead, updates, expect_state=POOL_STATE_WARM):
                continue  # raced: another claimant took the lead node
            for name in rest:
                # followers follow the lead unconditionally — the lead CAS
                # already serialized the claim
                self._stamp(name, updates)
            self.refresh_gauges()
            log.info("slice pool: %s claimed by %s (warm hit)",
                     entry.pool, notebook_key)
            return entry
        return None

    def _clear(self, node_name: str) -> bool:
        return self._stamp(
            node_name,
            {
                POOL_STATE_ANNOTATION: None,
                POOL_SINCE_ANNOTATION: None,
                POOL_PRIORITY_ANNOTATION: None,
                POOL_CLAIMED_BY_ANNOTATION: None,
            },
        )

    def unclaim(self, pool: str) -> None:
        """Resume completed (or abandoned): the slice is plainly owned by its
        pods now — drop the pool marks so a later scale-down returns it to
        general capacity instead of leaving a phantom claim."""
        for entry in self.entries(include_unhealthy=True):
            if entry.pool != pool:
                continue
            for name in entry.nodes:
                self._clear(name)
        self.refresh_gauges()

    def reclaim_idle(
        self, gke_accelerator: str, topology: str
    ) -> Optional[PoolEntry]:
        """Oversubscription pressure: return the lowest-priority MATCHING
        idle warm slice to general capacity (oldest first on ties). Policy:
        an idle warm slice is free capacity wearing a reservation, so ANY
        pressured requester may take one — deliberately unlike the
        active-victim path, which requires strictly-below priority (the
        owner only loses a fast resume here, never its running session).
        The suspended owner's next resume becomes a pool miss — cold, but
        alive: degrade by queueing, never by failure."""
        candidates = [
            e for e in self.entries()
            if e.state == POOL_STATE_WARM
            and e.accelerator == gke_accelerator
            and e.topology == topology
        ]
        if not candidates:
            return None
        victim = min(candidates, key=lambda e: (e.priority, e.since))
        lead, rest = victim.nodes[0], victim.nodes[1:]
        if not self._stamp(
            lead,
            {
                POOL_STATE_ANNOTATION: None,
                POOL_SINCE_ANNOTATION: None,
                POOL_PRIORITY_ANNOTATION: None,
                POOL_CLAIMED_BY_ANNOTATION: None,
            },
            expect_state=POOL_STATE_WARM,
        ):
            return None  # raced a claim: the resume won, pressure re-judges
        for name in rest:
            self._clear(name)
        notebook_reclaims_total.inc(reason="pool-idle")
        self.refresh_gauges()
        log.warning(
            "slice pool: reclaimed idle warm slice %s (priority %d) under "
            "capacity pressure", victim.pool, victim.priority,
        )
        return victim

    def prewarm(self, gke_accelerator: str, topology: str, target: int) -> int:
        """POOL_PREWARM: keep `target` warm slices of
        this shape AHEAD of demand — free, healthy, unreserved pools are
        parked warm (env staged, mesh formed) instead of waiting for a
        suspension to recycle one. Priority 0: a prewarmed slice is the
        FIRST idle-reclaim victim under pressure, so prewarming never
        outranks a real suspended user's warm hold. Returns slices parked."""
        from ..api.core import Pod

        warm = sum(
            1 for e in self.entries()
            if e.state == POOL_STATE_WARM
            and e.accelerator == gke_accelerator
            and e.topology == topology
        )
        if warm >= target:
            return 0
        occupied = {
            p.spec.node_name
            for p in self.reader.list(Pod)
            if p.spec.node_name and not p.metadata.deletion_timestamp
        }
        by_pool: Dict[str, List[Node]] = {}
        for node in self.reader.list(Node):
            labels = node.metadata.labels
            if labels.get(GKE_GPU_ACCELERATOR_LABEL) != gke_accelerator:
                continue
            if labels.get(GPU_TOPOLOGY_LABEL) != topology:
                continue
            by_pool.setdefault(
                labels.get(GKE_NODEPOOL_LABEL, node.metadata.name), []
            ).append(node)
        parked = 0
        for pool, nodes in sorted(by_pool.items()):
            if warm + parked >= target:
                break
            free = all(
                n.metadata.name not in occupied
                and not n.metadata.annotations.get(POOL_STATE_ANNOTATION)
                and self.node_healthy(n)
                for n in nodes
            )
            if not free:
                continue
            if self.release(pool, [n.metadata.name for n in nodes], priority=0):
                slice_pool_prewarmed_total.inc()
                parked += 1
                log.info("slice pool: prewarmed %s (%s %s)",
                         pool, gke_accelerator, topology)
        return parked

    def sweep(self) -> int:
        """Drop pool marks from slices that are no longer honest pool
        members: unhealthy nodes (pool poisoning — a warm entry whose host
        got preempted or went NotReady is a trap a resume would wedge on)
        AND half-marked pools (a lost-CAS remnant from an unwound release
        or partial clear — a stray mark on a lead node would reserve the
        pool against the scheduler forever with no entry to ever claim it).
        Returns pools swept."""
        by_pool: Dict[str, List[Node]] = {}
        marks: Dict[str, List[str]] = {}
        for node in self.reader.list(Node):
            pool = node.metadata.labels.get(GKE_NODEPOOL_LABEL, node.metadata.name)
            by_pool.setdefault(pool, []).append(node)
            if POOL_STATE_ANNOTATION in node.metadata.annotations:
                marks.setdefault(pool, []).append(node.metadata.name)
        swept = 0
        for pool, marked in sorted(marks.items()):
            nodes = by_pool[pool]
            fully_marked = len(marked) == len(nodes)
            healthy = all(self.node_healthy(n) for n in nodes)
            if fully_marked and healthy:
                continue
            # count only a COMPLETED eviction: under a Node-write conflict
            # storm _clear can lose its CAS retries, the marks stay, and the
            # next sweep retries — counting the attempt would inflate the
            # poisoned counter once per heartbeat for one incident
            cleared = [self._clear(name) for name in marked]
            if not all(cleared):
                continue
            if not healthy:
                notebook_reclaims_total.inc(reason="poisoned")
                log.warning(
                    "slice pool: swept poisoned slice %s out of the pool", pool
                )
            else:
                log.warning(
                    "slice pool: cleared half-marked remnant on %s", pool
                )
            swept += 1
        if swept:
            self.refresh_gauges()
        return swept


class PoolPrewarmer:
    """Manager service (start/stop lifecycle) holding the POOL_PREWARM
    target: every period it sweeps poisoned entries and parks free slices of
    the configured shape warm until `target` are held. The suspend path's
    recycling and this proactive path share every pool verb, so the
    scheduler/claim/reclaim contracts hold identically for both."""

    def __init__(self, client, gke_accelerator: str, topology: str,
                 target: int, period_s: float = 5.0):
        import threading

        self.pool = SlicePool(client)
        self.gke_accelerator = gke_accelerator
        self.topology = topology
        self.target = max(0, target)
        self.period_s = max(0.05, period_s)
        self._stop = threading.Event()
        self._thread = None

    def tick(self) -> int:
        self.pool.sweep()
        return self.pool.prewarm(
            self.gke_accelerator, self.topology, self.target
        )

    def start(self) -> None:
        import threading

        if self._thread is not None or self.target <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="pool-prewarmer"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            except Exception:
                # one bad sweep (apiserver blip mid-scan) must not kill the
                # prewarmer loop; the next period retries
                log.exception("pool prewarm tick failed")

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        self._thread = None


def add_prewarmer(manager, config) -> Optional[PoolPrewarmer]:
    """The manager's POOL_PREWARM wiring (the reference's `build_manager`,
    odh_kubeflow_tpu/main.py): with `config.pool_prewarm` above 0, a
    PoolPrewarmer of the slice `gpu.plan_slice` plans from
    `config.pool_prewarm_accelerator` and `pool_prewarm_topology`, ticking
    every half readiness-probe period (at least 0.5 s), added to the manager
    as a service (started and stopped with it); returns it, or None when
    prewarming is off."""
    if config.pool_prewarm <= 0:
        return None
    from ..gpu import plan_slice

    shape = plan_slice(config.pool_prewarm_accelerator, config.pool_prewarm_topology)
    prewarmer = PoolPrewarmer(
        manager.client, shape.gke_accelerator, shape.topology,
        target=config.pool_prewarm,
        period_s=max(0.5, config.readiness_probe_period_s / 2),
    )
    manager.add_service(prewarmer)
    return prewarmer
