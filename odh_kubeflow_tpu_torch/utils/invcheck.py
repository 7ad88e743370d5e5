"""INVCHECK=1: the opt-in runtime invariant monitor (the port's copy of
odh_kubeflow_tpu/utils/invcheck.py, with the write-tier invariants whose
objects the port has).

RACECHECK catches lock misuse; INVCHECK catches state misuse: after every
store write it re-judges the cross-object invariants and raises
`InvariantViolation` at the exact write that broke one.

- **machine-transition legality**: an observed old->new change of a state
  annotation must be a declared transition of its machine spec
  (analysis/machines.py; same-state re-asserts are always legal). The
  store serializes writes, so observed transitions are real transitions —
  a lost-update race that lands an undeclared edge is caught
  deterministically.
- **pool-claim CAS**: a Node's `pool-claimed-by` never jumps from one
  claimant directly to a different one — every legal path goes through
  warm/cleared first (the lead-node CAS contract). Pool-state values must
  be legal pool-machine states.
- **chip budget**: cards on GPU nodes hosting bound pods never exceed the
  monitor's `chip_budget` (`CHIP_BUDGET` env by default); unset/0 skips
  the check.

`check_checkpoint_before_suspend` (a notebook passes checkpointing ->
suspended only with checkpoint evidence while ready hosts were live) is not
a write-tier invariant: a real chaos run can lapse the window with every
agent unreachable. A caller arms it with `Monitor(extra=...)`, as the
reference's systematic explorer does.

Zero-cost when off: the store holds `invariants=None` and pays one
attribute check per write.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

CtxCheck = Callable[["WriteContext"], Optional[str]]


def enabled() -> bool:
    return os.environ.get("INVCHECK", "") not in ("", "0", "false")


class InvariantViolation(RuntimeError):
    """A store write broke a declared global invariant."""

    def __init__(self, invariant: str, detail: str):
        super().__init__(f"[{invariant}] {detail}")
        self.invariant = invariant
        self.detail = detail


class WriteContext:
    """One observed write: old/new object (None = create/delete) plus a
    read view of the whole store (peek_raw: lock-held, fault-hook-free)
    and the observing monitor's knobs (chip_budget)."""

    __slots__ = ("store", "api_version", "kind", "old", "new", "chip_budget")

    def __init__(self, store: Any, api_version: str, kind: str,
                 old: Optional[dict], new: Optional[dict],
                 chip_budget: Optional[int] = None):
        self.store = store
        self.api_version = api_version
        self.kind = kind
        self.old = old
        self.new = new
        self.chip_budget = chip_budget

    def objects(self, api_version: str, kind: str) -> List[dict]:
        return self.store.peek_raw(api_version, kind)

    def name(self) -> str:
        meta = (self.new or self.old or {}).get("metadata", {})
        ns = meta.get("namespace", "")
        return f"{ns}/{meta.get('name', '?')}" if ns else meta.get("name", "?")


def _annotations(obj: Optional[dict]) -> Dict[str, str]:
    return ((obj or {}).get("metadata", {}) or {}).get("annotations", {}) or {}


# ---------------------------------------------------------------------------
# write-tier invariants
# ---------------------------------------------------------------------------


def check_machine_transitions(ctx: WriteContext) -> Optional[str]:
    """Observed state-annotation changes must be declared transitions
    (analysis/machines.py). Each machine is judged only
    against writes of its own kind: the suspend/repair/culling machines on
    Notebooks, the inference machine on InferenceEndpoints, the job machine
    on TPUJobs."""
    if ctx.kind not in ("Notebook", "InferenceEndpoint", "TPUJob"):
        return None
    from ..analysis.machines import MACHINES
    from ..controllers import constants as C

    old_ann, new_ann = _annotations(ctx.old), _annotations(ctx.new)
    for spec in MACHINES:
        if spec.kind != ctx.kind:
            continue
        key = getattr(C, spec.annotation)
        old_state = spec.classify_value(
            old_ann.get(key), dynamic=False
        )
        new_raw = new_ann.get(key)
        new_state = spec.classify_value(new_raw)
        if new_state is None:
            # not a declared literal: a stop timestamp etc. maps through
            # dynamic_state; anything else is an undeclared state value
            new_state = spec.dynamic_state if new_raw is not None else ""
            if new_state is None:
                return (
                    f"{spec.name} machine: {ctx.name()} written with "
                    f"undeclared state value {new_raw!r}"
                )
        if old_state is None:
            old_state = spec.dynamic_state if old_ann.get(key) is not None else ""
        if old_state == new_state:
            continue
        if not spec.allows(old_state, new_state):
            return (
                f"{spec.name} machine: {ctx.name()} transitioned "
                f"{old_state or 'rest'!r} -> {new_state or 'rest'!r}, which "
                "is not a declared transition (analysis/machines.py)"
            )
    return None


def check_pool_claim_cas(ctx: WriteContext) -> Optional[str]:
    """A node's pool claim can never be STOLEN: claimed-by changes from one
    non-empty owner directly to a different one only when a claimant
    ignored the lead-node CAS. Pool-state values and observed transitions
    are judged against the POOL_MACHINE spec (analysis/machines.py)."""
    if ctx.kind != "Node":
        return None
    from ..analysis.machines import POOL_MACHINE
    from ..cluster.slicepool import (
        POOL_CLAIMED_BY_ANNOTATION,
        POOL_STATE_ANNOTATION,
        POOL_STATE_WARM,
    )

    old_ann, new_ann = _annotations(ctx.old), _annotations(ctx.new)
    old_state = POOL_MACHINE.classify_value(old_ann.get(POOL_STATE_ANNOTATION))
    new_state = POOL_MACHINE.classify_value(new_ann.get(POOL_STATE_ANNOTATION))
    if new_state is None:
        return (
            f"node {ctx.name()}: undeclared pool-state "
            f"{new_ann.get(POOL_STATE_ANNOTATION)!r}"
        )
    if old_state is not None and not POOL_MACHINE.allows(old_state, new_state):
        return (
            f"slice-pool machine: node {ctx.name()} transitioned "
            f"{old_state or 'rest'!r} -> {new_state or 'rest'!r}, which is "
            "not a declared transition (analysis/machines.py)"
        )
    if new_state == POOL_STATE_WARM and new_ann.get(POOL_CLAIMED_BY_ANNOTATION):
        return (
            f"node {ctx.name()}: warm but still claimed by "
            f"{new_ann[POOL_CLAIMED_BY_ANNOTATION]!r}"
        )
    old_claim = old_ann.get(POOL_CLAIMED_BY_ANNOTATION, "")
    new_claim = new_ann.get(POOL_CLAIMED_BY_ANNOTATION, "")
    if old_claim and new_claim and old_claim != new_claim:
        return (
            f"node {ctx.name()}: pool claim stolen — claimed-by changed "
            f"{old_claim!r} -> {new_claim!r} without passing through "
            "warm/cleared (a claimant ignored the lead-node CAS)"
        )
    return None


def check_chip_budget(ctx: WriteContext) -> Optional[str]:
    """Cards on GPU nodes hosting bound pods never exceed the configured
    budget. Judged only on Pod writes (the binds) — calm-path Notebook
    status churn costs nothing."""
    if ctx.kind != "Pod":
        return None
    budget = ctx.chip_budget or 0
    if budget <= 0:
        return None
    from ..gpu import GKE_GPU_ACCELERATOR_LABEL, GPU_RESOURCE

    hosting = {
        ((p.get("spec") or {}).get("nodeName") or "")
        for p in ctx.objects("v1", "Pod")
        if not (p.get("metadata", {}) or {}).get("deletionTimestamp")
    }
    hosting.discard("")
    bound = 0
    for node in ctx.objects("v1", "Node"):
        meta = node.get("metadata", {}) or {}
        if meta.get("name") not in hosting:
            continue
        if GKE_GPU_ACCELERATOR_LABEL not in (meta.get("labels") or {}):
            continue
        cap = ((node.get("status") or {}).get("capacity") or {})
        try:
            bound += int(cap.get(GPU_RESOURCE, 0))
        except (TypeError, ValueError):
            pass
    if bound > budget:
        return (
            f"chips bound ({bound}) exceed CHIP_BUDGET ({budget}) after a "
            f"write to pod {ctx.name()}"
        )
    return None


def check_checkpoint_before_suspend(ctx: WriteContext) -> Optional[str]:
    """Explorer-tier extra (registered via Monitor(extra=...)): a notebook
    may only pass checkpointing -> suspended with checkpoint evidence when
    ready hosts existed to save — the 'suspend that skipped
    checkpoint-saved' mutant is exactly this violation. NOT soak-safe: a
    real chaos run can legitimately lapse the window with every agent
    unreachable."""
    if ctx.kind != "Notebook" or ctx.new is None or ctx.old is None:
        return None
    from ..controllers import constants as C

    old_ann, new_ann = _annotations(ctx.old), _annotations(ctx.new)
    if not (
        old_ann.get(C.TPU_SUSPEND_STATE_ANNOTATION) == "checkpointing"
        and new_ann.get(C.TPU_SUSPEND_STATE_ANNOTATION) == "suspended"
    ):
        return None
    if new_ann.get(C.TPU_CHECKPOINT_SAVED_ANNOTATION):
        return None
    name = (ctx.new.get("metadata", {}) or {}).get("name", "")
    ns = (ctx.new.get("metadata", {}) or {}).get("namespace", "")
    for p in ctx.objects("v1", "Pod"):
        meta = p.get("metadata", {}) or {}
        if meta.get("namespace") != ns or meta.get("deletionTimestamp"):
            continue
        if (meta.get("labels") or {}).get(C.NOTEBOOK_NAME_LABEL) != name:
            continue
        ready = any(
            c.get("type") == "Ready" and c.get("status") == "True"
            for c in ((p.get("status") or {}).get("conditions") or [])
        )
        if ready:
            return (
                f"{ctx.name()} suspended while ready hosts were live but "
                "recorded no checkpoint-saved step — the checkpoint window "
                "was skipped"
            )
    return None


WRITE_INVARIANTS: Dict[str, CtxCheck] = {
    "machine-transition": check_machine_transitions,
    "pool-claim-cas": check_pool_claim_cas,
    "chip-budget": check_chip_budget,
}


def _env_chip_budget() -> Optional[int]:
    try:
        return int(os.environ["CHIP_BUDGET"])
    except (KeyError, ValueError):
        return None


class Monitor:
    """The store's write hook. Collecting mode (explorer) records
    violations and lets execution continue — the scheduler wants the full
    trace; raising mode (INVCHECK=1 soaks) fails the offending write.

    `chip_budget` is PER-MONITOR (explorer worlds inject their scenario's
    budget without arming the check for every other store in the process);
    the default comes from the CHIP_BUDGET env the soak deployments set."""

    def __init__(self, extra: Dict[str, CtxCheck] = {},
                 collect: bool = False,
                 chip_budget: Optional[int] = None):
        self.checks: Dict[str, CtxCheck] = dict(WRITE_INVARIANTS)
        self.checks.update(extra)
        self.collect = collect
        self.chip_budget = (
            chip_budget if chip_budget is not None else _env_chip_budget()
        )
        self.violations: List[InvariantViolation] = []

    def observe(self, store: Any, api_version: str, kind: str,
                old: Optional[dict], new: Optional[dict]) -> None:
        ctx = WriteContext(store, api_version, kind, old, new,
                           chip_budget=self.chip_budget)
        for name, check in self.checks.items():
            detail = check(ctx)
            if detail is None:
                continue
            violation = InvariantViolation(name, detail)
            if self.collect:
                self.violations.append(violation)
            else:
                raise violation

    def reset(self) -> None:
        self.violations.clear()


def store_monitor() -> Optional[Monitor]:
    """What Store.__init__ installs: a raising monitor under INVCHECK=1,
    nothing otherwise (one attribute check per write when off)."""
    return Monitor() if enabled() else None
