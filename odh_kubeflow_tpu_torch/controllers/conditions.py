"""Notebook condition helpers shared by the device-health gate and the
slice-repair controller.

NotebookStatus.conditions has TWO writers: the core reconciler mirrors pod 0's
conditions (notebook.py _update_status), and the repair stack owns the
device/repair conditions (`TPUHealthy`, `Degraded` — constants.py). The mirror
preserves the repair-owned types; this module gives the repair stack a safe
read-modify-write (`write_condition`: fresh read under conflict retry,
everything else in the conditions list untouched) so neither writer can lose
the other's entries. The upsert mechanics delegate to the apimachinery
helper, so transition-time rules live in exactly one place.
"""
from __future__ import annotations

from typing import List, Optional

from ..api.notebook import Notebook
from ..apimachinery import Condition, NotFoundError
from ..apimachinery import get_condition as _get_in_list
from ..apimachinery import set_condition as _upsert_in_list
from ..cluster.client import retry_on_conflict
from ..runtime.flightrecorder import recorder
from . import constants as C

# condition types owned by the repair/SLO stack, NOT the pod-condition
# mirror (the mirror preserves these when rebuilding from pod 0)
REPAIR_OWNED_CONDITIONS = (
    C.TPU_HEALTHY_CONDITION,
    C.TPU_DEGRADED_CONDITION,
    C.SLO_DEGRADED_CONDITION,
)


def get_condition(nb: Notebook, ctype: str) -> Optional[Condition]:
    return _get_in_list(nb.status.conditions, ctype)


def condition_is(nb: Notebook, ctype: str, status: str) -> bool:
    c = get_condition(nb, ctype)
    return c is not None and c.status == status


def upsert_condition(
    conditions: List[Condition],
    ctype: str,
    status: str,
    reason: str = "",
    message: str = "",
) -> bool:
    """In-place upsert (apimachinery transition-time semantics: the
    timestamp only moves on a status flip); returns whether anything
    changed."""
    cur = _get_in_list(conditions, ctype)
    if cur is not None and cur.status == status and cur.reason == reason \
            and cur.message == message:
        return False
    conditions[:] = _upsert_in_list(
        conditions,
        Condition(type=ctype, status=status, reason=reason, message=message),
    )
    return True


def write_condition(
    client,
    api_reader,
    nb: Notebook,
    ctype: str,
    status: str,
    reason: str = "",
    message: str = "",
) -> None:
    """Write one condition via fresh-read RMW under conflict retry. No-ops
    (same status/reason/message) cost one read and zero writes. Writes that
    actually land are sampled into the flight-recorder ring — condition
    transitions are the incident bundle's state-machine timeline."""
    # cheap pre-check against the object in hand; a stale cache self-heals
    # level-triggered (the event that updates it re-enqueues the notebook)
    cur = get_condition(nb, ctype)
    if cur is not None and cur.status == status and cur.reason == reason \
            and cur.message == message:
        return

    def attempt() -> bool:
        fresh = api_reader.get(Notebook, nb.metadata.namespace, nb.metadata.name)
        if upsert_condition(fresh.status.conditions, ctype, status, reason, message):
            client.update_status(fresh)
            return True
        return False

    try:
        changed = retry_on_conflict(attempt)
    except NotFoundError:
        return  # deleted mid-reconcile
    if changed:
        recorder.record(
            "condition",
            notebook=f"{nb.metadata.namespace}/{nb.metadata.name}",
            type=ctype,
            status=status,
            reason=reason,
        )
