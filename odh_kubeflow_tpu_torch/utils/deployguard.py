"""DEPLOYGUARD: runtime deployment-surface guard of the port.

Sibling of RACECHECK/INVCHECK/TORCHGUARD. Armed with ``DEPLOYGUARD=1``,
the typed client (cluster/client.py) reports every call as a
(flow, method, kind) triple; the guard

- records the live surface (dumpable via ``DEPLOYGUARD_SURFACE_OUT`` — the
  surface artifact the rbac-coverage checker consumes to flag stale RBAC
  with runtime confidence), and
- raises :class:`RBACDriftError` AT THE OFFENDING CALL when traffic on a
  manager-controller flow exceeds the RBAC the port's manifests grant
  (analysis/deploysurface.py is the shared contract) — catching the dynamic
  kinds and subresources the AST pass cannot resolve.

Attribution mirrors the static checker: only flows in
``deploysurface.MANAGER_FLOWS`` are enforced (those run under the manager's
ServiceAccount); sim actors (kubelet/scheduler/...), loadtest drivers and
anonymous test clients are record-only. Two flow-identity invariants are
enforced as well: the leader-election flow may only carry Lease traffic,
and Lease traffic may never ride a controller flow (a lease write
misattributed after a shard failover is exactly the drift this catches).

Off (the default) the client pays one ``is None`` check per call — zero
allocations, zero imports.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Optional, Set, Tuple


def enabled() -> bool:
    return os.environ.get("DEPLOYGUARD", "") not in ("", "0", "false")


class RBACDriftError(RuntimeError):
    """A request exceeded the declared deployment surface for its flow."""


class Guard:
    """Thread-safe recorder + enforcer of the live API surface."""

    def __init__(self) -> None:
        # resolve the contract once at arm time, not per call
        from ..analysis import deploysurface as ds
        from ..cluster.flowcontrol import LEADER_ELECTION_FLOW

        self._ds = ds
        self._le_flow = LEADER_ELECTION_FLOW
        self._lock = threading.Lock()
        self.surface: Set[Tuple[str, str, str, str]] = set()
        self.drifts = 0

    # -- the hot path (cluster/client.py _call) --

    def observe(self, flow: str, method: str, kind: str) -> None:
        ds = self._ds
        sub = ds.CLIENT_VERBS.get(method, ("", ""))[1]
        entry = (flow, method, kind, sub)
        with self._lock:
            self.surface.add(entry)
        LEADER_ELECTION_FLOW = self._le_flow
        if flow == LEADER_ELECTION_FLOW:
            if kind != "Lease":
                self._drift(
                    f"leader-election flow issued {method} {kind} — only "
                    "Lease traffic may ride the exempt elector identity"
                )
            return
        if flow not in ds.MANAGER_FLOWS:
            return  # sim actors / drivers / tests: record-only
        if kind == "Lease":
            self._drift(
                f"controller flow {flow!r} issued {method} Lease — lease "
                "traffic must use the elector client (flow="
                f"{LEADER_ELECTION_FLOW!r}); a misattributed lease write "
                "would contend in the workload budget and dodge the fence"
            )
            return
        ok, detail = ds.rbac_allows(method, kind)
        if not ok:
            self._drift(f"flow {flow!r} issued {method} {kind}: {detail}")

    def _drift(self, msg: str) -> None:
        with self._lock:
            self.drifts += 1
        raise RBACDriftError(f"DEPLOYGUARD: {msg}")

    # -- artifact --

    def dump(self, path: str) -> None:
        """Write (merging with an existing artifact — faults lanes run
        several processes against one file) the recorded surface as the
        surface JSON the checker consumes."""
        p = Path(path)
        merged: Set[Tuple[str, str, str, str]] = set(self.surface)
        if p.exists():
            try:
                prior = json.loads(p.read_text())
            except (ValueError, OSError):
                prior = {}
            merged |= self._ds.surface_tuples_from_artifact(prior)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(
            json.dumps({"surface": sorted(list(t) for t in merged)}, indent=0)
            + "\n"
        )


ACTIVE: Optional[Guard] = None


def arm() -> Guard:
    """Install the process-wide guard (tests call this directly; import
    arms automatically when DEPLOYGUARD=1)."""
    global ACTIVE
    if ACTIVE is None:
        ACTIVE = Guard()
        out = os.environ.get("DEPLOYGUARD_SURFACE_OUT", "")
        if out:
            import atexit

            atexit.register(ACTIVE.dump, out)
    return ACTIVE


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


if enabled():  # pragma: no cover - exercised via subprocess lanes
    arm()
