"""The durable state machines of the operator, declared as data (the port's
copy of odh_kubeflow_tpu/analysis/machines.py, every spec field for field).

Each machine lives in one annotation: the suspend/resume, slice-repair and
culling machines on a Notebook, the inference machine on an
InferenceEndpoint, the job machine on a TPUJob and the warm-pool machine on
a Node. The port reads the specs in one place today: the INVCHECK=1 store
monitor (utils/invcheck.py `check_machine_transitions`) judges every
observed old->new change of a state annotation against the declared
transitions. The specs of machines whose controllers the port does not have
yet (suspend, inference, job, pool) are here for them.

State names are the literal annotation VALUES; `""` is the cleared/absent
key (each machine's rest state). A transition's `via` is the
`module.py:function` whose code makes the write; `None` marks an external
actor (the user's unstop is a kubectl patch, not the operator's code).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class State:
    name: str  # annotation value; "" = key absent (rest state)
    title: str
    doc: str = ""
    terminal: bool = False
    # terminal escape hatches (a terminal state with neither is a dead end
    # spec_errors flags): self_healing = a declared transition
    # leaves it; incident = entering it snapshots a flight-recorder bundle
    self_healing: bool = False
    incident: bool = False


@dataclass(frozen=True)
class Transition:
    src: str  # state name, or "*" (defensive clear from any state)
    dst: str
    # "module.py:function" containing the write; None = external actor
    via: Optional[str]
    trigger: str = ""


@dataclass(frozen=True)
class MachineSpec:
    name: str
    # constant NAME in controllers/constants.py holding the annotation key
    annotation: str
    owner: str  # owning controller module (basename)
    states: Tuple[State, ...]
    transitions: Tuple[Transition, ...]
    doc: str = ""
    # API kind the annotation lives on — the INVCHECK write monitor judges a
    # machine only against writes of its own kind (the inference machine's
    # states on an InferenceEndpoint, never on a Notebook)
    kind: str = "Notebook"
    # annotation VALUE -> state name, for values that are not state names
    # themselves (the webhook's reconciliation-lock sentinel)
    value_states: Dict[str, str] = field(default_factory=dict)
    # the state a non-literal (computed) write maps to, e.g. the culler's
    # `now_rfc3339()` stop timestamp; None = computed writes are findings
    dynamic_state: Optional[str] = None

    def state(self, name: str) -> Optional[State]:
        for s in self.states:
            if s.name == name:
                return s
        return None

    def writer_modules(self) -> Tuple[str, ...]:
        return tuple(sorted({
            t.via.split(":", 1)[0] for t in self.transitions if t.via
        }))

    def classify_value(self, value: Optional[str], dynamic: bool = False
                       ) -> Optional[str]:
        """Map a written annotation value to a state name; None = unmappable
        (an undeclared state — a conformance finding)."""
        if dynamic:
            return self.dynamic_state
        if value is None:
            value = ""
        if value in self.value_states:
            return self.value_states[value]
        if self.state(value) is not None:
            return value
        return None

    def allows(self, src: Optional[str], dst: str) -> bool:
        """Is src->dst a declared transition? src=None means 'unknown source'
        (the writer does not know it): any declared inbound edge to dst
        counts. Same-state writes are always legal (level-triggered
        controllers re-assert)."""
        if src is not None and src == dst:
            return True
        for t in self.transitions:
            if t.dst != dst:
                continue
            if src is None or t.src == src or t.src == "*":
                return True
        return False


# ---------------------------------------------------------------------------
# suspend/resume (controllers/suspend.py)
# ---------------------------------------------------------------------------

SUSPEND_MACHINE = MachineSpec(
    name="suspend",
    annotation="TPU_SUSPEND_STATE_ANNOTATION",
    owner="suspend.py",
    doc="Checkpointed capacity multiplexing: cull/stop checkpoints kernel "
        "state and releases the slice warm; unstop resumes from the pool.",
    states=(
        State("", "Active", "no suspend episode; slice owned by its pods"),
        State("checkpointing", "Checkpointing",
              "stop stamped; replicas held while every ready host's "
              "/tpu/checkpoint hook is driven inside a bounded window"),
        State("suspended", "Suspended",
              "slice released (warm pool, or general capacity when "
              "reclaim-forced); replicas 0"),
        State("resuming", "Resuming",
              "unstopped; warm claim bound or cold fallback placing"),
        State("resume-failed", "ResumeFailed",
              "attempts exhausted; the reclaimer keeps watching",
              terminal=True, self_healing=True, incident=True),
    ),
    transitions=(
        Transition("", "checkpointing", "culling.py:reconcile",
                   "cull: the checkpointing stamp rides the SAME patch as "
                   "the stop annotation"),
        Transition("", "checkpointing", "suspend.py:reconcile",
                   "user stop without the culler's atomic stamp"),
        Transition("", "checkpointing", "suspend.py:_maybe_reclaim_for",
                   "oversubscription reclaim: victim checkpoint-suspends"),
        Transition("checkpointing", "suspended",
                   "suspend.py:_run_checkpoint_window",
                   "window closed (all ready hosts acked, or deadline)"),
        Transition("checkpointing", "", "suspend.py:_clear_updates",
                   "abort: notebook unstopped during the window"),
        Transition("suspended", "resuming", "suspend.py:_begin_resume",
                   "unstop: warm claim or cold fallback"),
        Transition("resuming", "suspended", "suspend.py:reconcile",
                   "re-stopped mid-resume: park; claims return to warm"),
        Transition("resume-failed", "suspended", "suspend.py:reconcile",
                   "re-stopped after a failed resume"),
        Transition("resuming", "", "suspend.py:_clear_updates",
                   "mesh ready: resume complete; idle clock re-arms"),
        Transition("resuming", "resume-failed", "suspend.py:_fail_resume",
                   "attempts exhausted"),
        Transition("resume-failed", "", "suspend.py:_clear_updates",
                   "self-heal: capacity returned and the mesh formed"),
        Transition("*", "", "suspend.py:reconcile",
                   "defensive clear of an unknown state value"),
    ),
)

# ---------------------------------------------------------------------------
# slice repair (controllers/slice_repair.py)
# ---------------------------------------------------------------------------

REPAIR_MACHINE = MachineSpec(
    name="slice-repair",
    annotation="TPU_REPAIR_STATE_ANNOTATION",
    owner="slice_repair.py",
    doc="Survive the accelerator layer: checkpoint-before-evict, whole-gang "
        "re-placement, bounded retry. Stands down whenever the suspend "
        "machine owns the slice (any suspend-state, or the stop annotation).",
    states=(
        State("", "Ready", "no repair episode"),
        State("degraded", "Degraded",
              "fault detected; checkpoint-before-evict window open"),
        State("repairing", "Repairing",
              "gang evicted; waiting for all-or-nothing re-placement"),
        State("failed", "RepairFailed",
              "attempts exhausted; operator attention required",
              terminal=True, self_healing=True, incident=True),
    ),
    transitions=(
        Transition("", "degraded", "slice_repair.py:_enter_degraded",
                   "node taint/NotReady, chip/ICI fault, or unreachable "
                   "hosts past the dwell"),
        Transition("degraded", "repairing",
                   "slice_repair.py:_run_checkpoint_window",
                   "checkpoint window closed; gang evicted"),
        Transition("repairing", "failed", "slice_repair.py:_fail",
                   "attempts exhausted"),
        Transition("repairing", "", "slice_repair.py:_clear_updates",
                   "slice healthy again; MTTR observed"),
        Transition("degraded", "", "slice_repair.py:_clear_updates",
                   "abort: notebook stopped or suspend machine took over"),
        Transition("failed", "", "slice_repair.py:_clear_updates",
                   "self-heal: capacity returned and the slice recovered"),
        Transition("*", "", "slice_repair.py:reconcile",
                   "defensive clear of an unknown state value"),
    ),
)

# ---------------------------------------------------------------------------
# culling / probe-gate stop machine (kubeflow-resource-stopped)
# ---------------------------------------------------------------------------

CULLING_MACHINE = MachineSpec(
    name="culling",
    annotation="STOP_ANNOTATION",
    owner="culling.py",
    doc="The reference's stop/culling contract: the stop annotation scales "
        "the slice away; the webhook's reconciliation lock rides the SAME "
        "key with a sentinel value until the extension controller clears it.",
    states=(
        State("", "Running", "no stop annotation; slice live"),
        State("locked", "ReconciliationLock",
              "webhook handshake: replicas held at 0 until the extension "
              "controller finishes bring-up"),
        State("stopped", "Stopped",
              "culled or user-stopped; replicas scale to 0 (or the suspend "
              "machine checkpoints first)"),
    ),
    transitions=(
        Transition("", "locked", "webhook.py:inject_reconciliation_lock",
                   "CREATE admission stamps the lock sentinel"),
        Transition("locked", "", "extension.py:remove_reconciliation_lock",
                   "extension controller releases the handshake"),
        Transition("", "stopped", "culling.py:reconcile",
                   "idle (Jupyter AND TPU duty-cycle agree): cull"),
        Transition("", "stopped", "suspend.py:_maybe_reclaim_for",
                   "oversubscription reclaim stops the victim"),
        Transition("stopped", "", None,
                   "user unstop (kubectl annotate / UI) — external actor"),
        Transition("locked", "stopped", None,
                   "user stop during bring-up overwrites the lock sentinel "
                   "— external actor"),
    ),
    value_states={"odh-notebook-controller-lock": "locked"},
    dynamic_state="stopped",  # the stop value is the cull/stop timestamp
)

# ---------------------------------------------------------------------------
# inference endpoint promotion/serving (controllers/inference.py)
# ---------------------------------------------------------------------------

INFERENCE_MACHINE = MachineSpec(
    name="inference",
    annotation="INFERENCE_STATE_ANNOTATION",
    owner="inference.py",
    kind="InferenceEndpoint",
    doc="Notebook->serving promotion: a Pending endpoint warm-binds its "
        "source notebook's released slice, Loading restores+verifies the "
        "checkpoint, Serving holds the route, and a stop drains bounded "
        "before the slice is released back warm. The machine has "
        "a scale-to-zero edge: an idle fleet parks Suspended with the route "
        "left up, and the first request (or any desired-replicas bump) "
        "cold-wakes it through a fresh Pending episode.",
    states=(
        State("", "Pending",
              "STS/services converging; pods scheduling (warm claim bound "
              "at promotion when the source notebook just suspended)"),
        State("loading", "Loading",
              "all hosts ready; checkpoint restore driven and verified "
              "(checksum parity with the saved state) inside a bounded "
              "window"),
        State("serving", "Serving",
              "restore verified, mesh ready; HTTPRoute live, engine "
              "accepting traffic"),
        State("draining", "Draining",
              "stop requested: route torn down first, in-flight requests "
              "drain inside a bounded window; never a reclaim victim"),
        State("terminated", "Terminated",
              "drained; replicas 0, slice released (warm unless "
              "reclaim-forced)",
              terminal=True, self_healing=True),
        State("load-failed", "LoadFailed",
              "loading window expired or restore checksum mismatched",
              terminal=True, self_healing=True, incident=True),
        State("suspended", "Suspended",
              "scale-to-zero park: replicas 0, every slice "
              "released warm, route left UP — the router's cold-wake (first "
              "request) or a desired-replicas bump pops it back to Pending"),
    ),
    transitions=(
        Transition("", "loading", "inference.py:_run_pending",
                   "every host Ready: open the restore/verify window"),
        Transition("serving", "loading", "inference.py:_run_serving",
                   "host readiness lost while Serving (preemption/crash): "
                   "re-form and re-verify — the repair machine never touches "
                   "endpoints, so this edge is the recovery story"),
        Transition("loading", "serving", "inference.py:_complete_loading",
                   "restore verified and the mesh gate green"),
        Transition("loading", "load-failed", "inference.py:_fail_loading",
                   "window expired or checksum mismatch"),
        Transition("load-failed", "", "inference.py:reconcile",
                   "self-heal: pods ready again (or spec changed) — retry "
                   "the load"),
        Transition("", "draining", "inference.py:reconcile",
                   "stopped before serving: drain whatever started"),
        Transition("loading", "draining", "inference.py:reconcile",
                   "stopped mid-load"),
        Transition("serving", "draining", "inference.py:reconcile",
                   "stop/reclaim: route torn down, drain window opens"),
        Transition("load-failed", "draining", "inference.py:reconcile",
                   "stopped while LoadFailed: wind down cleanly"),
        Transition("draining", "terminated", "inference.py:_complete_drain",
                   "drained (or deadline): replicas 0, slice released"),
        Transition("terminated", "", "inference.py:reconcile",
                   "unstop: serve again (a fresh Pending episode)"),
        Transition("serving", "suspended", "inference.py:_park_suspended",
                   "scale-to-zero: desired replicas 0 with "
                   "autoscaling.scaleToZero — drain every replica warm, "
                   "keep the route for the cold-wake"),
        Transition("suspended", "", "inference.py:reconcile",
                   "cold-wake: first request (router) or desired-replicas "
                   "bump clears the park — a fresh Pending episode "
                   "warm-binds from the pool"),
        Transition("suspended", "draining", "inference.py:reconcile",
                   "stopped while parked: wind down for real (route torn "
                   "down, Terminated keeps nothing routable)"),
        Transition("*", "", "inference.py:reconcile",
                   "defensive clear of an unknown state value"),
    ),
)

# ---------------------------------------------------------------------------
# gang-scheduled batch/RL job (controllers/job.py)
# ---------------------------------------------------------------------------

JOB_MACHINE = MachineSpec(
    name="job",
    annotation="JOB_STATE_ANNOTATION",
    owner="job.py",
    kind="TPUJob",
    doc="Gang-scheduled batch/RL jobs (Podracer anakin/sebulba layouts): "
        "all-or-nothing gang admission through the scheduler/slicepool "
        "(warm-claim first; sebulba secures BOTH gangs atomically or "
        "neither), checkpoint-before-preempt when the reclaimer or a host "
        "preemption takes the slice, and a Preempted job requeues to resume "
        "from the saved step — it loses only progress since the last "
        "checkpoint.",
    states=(
        State("", "Pending",
              "not admitted; gang capacity being secured (queued-over-"
              "budget jobs wait here with a QueuedOverBudget condition)"),
        State("admitted", "Admitted",
              "gangs secured (warm claims bound or free capacity found) and "
              "the workload created; waiting for every host of every gang "
              "to come ready"),
        State("running", "Running",
              "all gangs ready; steps progressing (the workload reports "
              "progress through checkpoint acks)"),
        State("checkpointing", "Checkpointing",
              "cadence or preempt: the learner gang's /tpu/checkpoint hooks "
              "are driven inside a bounded window and the acked step is "
              "recorded; never a reclaim victim mid-window"),
        State("preempted", "Preempted",
              "gang(s) scaled away, slice released (warm at the JOB's "
              "priority unless reclaim-forced); requeues to Pending to "
              "resume from the saved step"),
        State("succeeded", "Succeeded",
              "acked step reached the budget; replicas 0, slice released",
              terminal=True, self_healing=True),
        State("failed", "Failed",
              "backoffLimit or maxRuntime exhausted",
              terminal=True, self_healing=True, incident=True),
    ),
    transitions=(
        Transition("", "admitted", "job.py:_run_pending",
                   "gang capacity secured: warm claim(s) bound — sebulba "
                   "claims BOTH gangs atomically or neither — or whole free "
                   "slices found for every gang; workload created"),
        Transition("admitted", "running", "job.py:_run_admitted",
                   "every host of every gang ready; queue-wait observed and "
                   "the job.ready root closes"),
        Transition("admitted", "preempted", "job.py:_preempt",
                   "preempt requested (or placement lost) before the run "
                   "started: nothing to checkpoint, park and requeue"),
        Transition("running", "checkpointing", "job.py:_run_running",
                   "checkpoint cadence due, or preempt requested: save "
                   "before anything moves"),
        Transition("checkpointing", "running", "job.py:_complete_checkpoint",
                   "acked (or window expired): cadence checkpoint, keep "
                   "running"),
        Transition("checkpointing", "succeeded",
                   "job.py:_complete_checkpoint",
                   "acked step reached steps x completions: done"),
        Transition("checkpointing", "preempted", "job.py:_preempt",
                   "preempt requested: state saved (_complete_checkpoint "
                   "banked the ack), park and requeue"),
        Transition("running", "preempted", "job.py:_preempt",
                   "host preemption / readiness lost mid-run: park and "
                   "requeue; progress since the last checkpoint is lost"),
        Transition("running", "failed", "job.py:_fail",
                   "backoffLimit exhausted or maxRuntime exceeded"),
        Transition("preempted", "", "job.py:reconcile",
                   "requeue: a fresh Pending episode resumes from the "
                   "saved step"),
        Transition("succeeded", "", "job.py:reconcile",
                   "user rerun (spec bump / annotation clear): a fresh "
                   "episode"),
        Transition("failed", "", "job.py:reconcile",
                   "self-heal: user reset after the failure"),
        Transition("*", "", "job.py:reconcile",
                   "defensive clear of an unknown state value"),
    ),
)

# ---------------------------------------------------------------------------
# warm-pool node machine (cluster/slicepool.py): its annotations live on
# Nodes; declared here so observed Node pool-state transitions can be judged
# against the same kind of contract
# ---------------------------------------------------------------------------

POOL_MACHINE = MachineSpec(
    name="slice-pool",
    annotation="POOL_STATE_ANNOTATION",
    owner="slicepool.py",
    kind="Node",
    doc="Node-durable warm pool: release holds a suspended slice warm; "
        "claims CAS through the lead node's resourceVersion.",
    states=(
        State("", "GeneralCapacity", "no pool mark; the scheduler owns it"),
        State("warm", "Warm", "held for resume binds; scheduler places "
              "nobody here"),
        State("claimed", "Claimed", "a resuming notebook owns the bind "
              "window; only the claimant's pods may land"),
    ),
    transitions=(
        Transition("", "warm", "slicepool.py:release",
                   "suspend released the slice warm"),
        Transition("warm", "claimed", "slicepool.py:claim",
                   "resume won the lead-node CAS"),
        Transition("", "claimed", "slicepool.py:claim",
                   "follower re-stamp: the lead CAS already serialized the "
                   "claim; a racing sweep may have cleared this follower"),
        Transition("claimed", "warm", "slicepool.py:release",
                   "claim abandoned (poisoned slice / raced reclaim): "
                   "back to warm"),
        Transition("warm", "", "slicepool.py:reclaim_idle",
                   "idle warm slice reclaimed under capacity pressure"),
        Transition("warm", "", "slicepool.py:_clear",
                   "swept (poisoned / half-marked remnant)"),
        Transition("claimed", "", "slicepool.py:_clear",
                   "resume completed (unclaim) or swept"),
    ),
)

# the annotation machines of the operator's CRs, and with them the pool
# machine on Nodes
MACHINES: Tuple[MachineSpec, ...] = (
    SUSPEND_MACHINE, REPAIR_MACHINE, CULLING_MACHINE, INFERENCE_MACHINE,
    JOB_MACHINE,
)
ALL_MACHINES: Tuple[MachineSpec, ...] = MACHINES + (POOL_MACHINE,)


def machine_for_annotation(const_name: str) -> Optional[MachineSpec]:
    for spec in MACHINES:
        if spec.annotation == const_name:
            return spec
    return None


def spec_errors(spec: MachineSpec) -> Tuple[str, ...]:
    """Data-level validation: dead/unreachable declared states and terminal
    dead ends, before any code is consulted."""
    errors = []
    names = {s.name for s in spec.states}
    if "" not in names:
        errors.append(f"machine {spec.name!r}: no rest state ('') declared")
    for t in spec.transitions:
        for endpoint in (t.src, t.dst):
            if endpoint != "*" and endpoint not in names:
                errors.append(
                    f"machine {spec.name!r}: transition {t.src or 'rest'!r}"
                    f"->{t.dst or 'rest'!r} references undeclared state"
                )
    inbound = {t.dst for t in spec.transitions}
    outbound = {t.src for t in spec.transitions}
    for s in spec.states:
        if s.name and s.name not in inbound:
            errors.append(
                f"machine {spec.name!r}: state {s.name!r} is unreachable "
                "(no declared transition enters it)"
            )
        if s.terminal:
            if not (s.self_healing or s.incident):
                errors.append(
                    f"machine {spec.name!r}: terminal state {s.name!r} has "
                    "neither a self-heal path nor an incident bundle — a "
                    "silent dead end"
                )
            if s.self_healing and s.name not in outbound:
                errors.append(
                    f"machine {spec.name!r}: state {s.name!r} claims "
                    "self-healing but no declared transition leaves it"
                )
        elif s.name and s.name not in outbound and "*" not in outbound:
            errors.append(
                f"machine {spec.name!r}: non-terminal state {s.name!r} has "
                "no exit transition (would wedge forever)"
            )
    return tuple(errors)


def render_markdown(specs: Tuple[MachineSpec, ...] = ALL_MACHINES) -> str:
    """The specs as Markdown tables: each machine's states, then its
    transitions."""
    out = []
    for spec in specs:
        out.append(f"#### `{spec.name}` — `{spec.annotation}` "
                   f"(owner: `{spec.owner}`)")
        out.append("")
        out.append(spec.doc)
        out.append("")
        out.append("| state | annotation value | terminal | notes |")
        out.append("|---|---|---|---|")
        for s in spec.states:
            flags = []
            if s.terminal:
                flags.append("terminal")
                if s.self_healing:
                    flags.append("self-healing")
                if s.incident:
                    flags.append("incident bundle")
            out.append(
                f"| {s.title} | `{s.name or '(absent)'}` | "
                f"{', '.join(flags) or '—'} | {s.doc} |"
            )
        out.append("")
        out.append("| from | to | via | trigger |")
        out.append("|---|---|---|---|")
        for t in spec.transitions:
            via = f"`{t.via}`" if t.via else "_external (user)_"
            out.append(
                f"| `{t.src or 'rest'}` | `{t.dst or 'rest'}` | {via} "
                f"| {t.trigger} |"
            )
        out.append("")
    return "\n".join(out)
