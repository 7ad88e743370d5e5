"""ObjectMeta / TypeMeta / conditions — the metadata model every API type shares.

Shape mirrors k8s.io/apimachinery metav1 as used by the reference's API types
(reference components/notebook-controller/api/v1beta1/notebook_types.go:27-88),
re-expressed as Python dataclasses.
"""
from __future__ import annotations

import dataclasses
import datetime
import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .serde import KubeModel, jfield


def rfc3339(ts: float) -> str:
    """Unix timestamp -> RFC3339 (whole seconds, Z suffix, k8s-style)."""
    return (
        datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
        .replace(microsecond=0)
        .isoformat()
        .replace("+00:00", "Z")
    )


def now_rfc3339() -> str:
    return rfc3339(_time.time())


def rfc3339_precise(ts: float) -> str:
    """Unix timestamp -> RFC3339 with microseconds. For MACHINE deadlines
    (maintenance windows, checkpoint-before-evict, repair anchors): the
    k8s-style whole-second form FLOORS, so a sub-second grace window
    serialized through rfc3339() can collapse to zero or negative and a
    drain fires before the checkpoint opportunity it was announcing."""
    return (
        datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
        .isoformat()
        .replace("+00:00", "Z")
    )


def parse_time(s: str) -> datetime.datetime:
    return datetime.datetime.fromisoformat(s.replace("Z", "+00:00"))


@dataclass
class GroupVersionKind:
    group: str
    version: str
    kind: str

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version

    def __hash__(self) -> int:
        return hash((self.group, self.version, self.kind))


@dataclass
class OwnerReference(KubeModel):
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: Optional[bool] = None
    block_owner_deletion: Optional[bool] = None


@dataclass
class ObjectMeta(KubeModel):
    name: str = ""
    generate_name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    generation: int = 0
    creation_timestamp: str = ""
    deletion_timestamp: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)
    finalizers: List[str] = field(default_factory=list)


@dataclass
class Condition(KubeModel):
    """Pod-style condition as mirrored into NotebookStatus.

    Reference keeps Type/Status/Reason/Message plus both timestamps
    (notebook_types.go:59-75); we keep the same JSON keys.
    """

    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""
    last_probe_time: str = ""
    last_transition_time: str = ""


@dataclass
class KubeObject(KubeModel):
    """Base for all top-level API objects (has TypeMeta + ObjectMeta)."""

    api_version: str = ""
    kind: str = ""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    # -- convenience accessors used throughout the controllers --
    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        ns = self.metadata.namespace
        return f"{ns}/{self.metadata.name}" if ns else self.metadata.name

    def gvk(self) -> GroupVersionKind:
        av = self.api_version
        if "/" in av:
            g, v = av.split("/", 1)
        else:
            g, v = "", av
        return GroupVersionKind(g, v, self.kind)

    def set_owner(self, owner: "KubeObject", controller: bool = True) -> None:
        """Add an owner reference. controller=True replaces any existing
        controller reference; controller=False appends without disturbing it."""
        new = OwnerReference(
            api_version=owner.api_version,
            kind=owner.kind,
            name=owner.metadata.name,
            uid=owner.metadata.uid,
            controller=controller or None,
            block_owner_deletion=True,
        )
        refs = [
            r
            for r in self.metadata.owner_references
            if not (controller and r.controller)
            and not (
                r.kind == new.kind
                and r.name == new.name
                and r.api_version == new.api_version
            )
        ]
        refs.append(new)
        self.metadata.owner_references = refs

    def owned_by(self, owner: "KubeObject") -> bool:
        for r in self.metadata.owner_references:
            if r.uid and owner.metadata.uid:
                if r.uid == owner.metadata.uid:
                    return True
            elif (
                r.kind == owner.kind
                and r.name == owner.metadata.name
                and r.api_version == owner.api_version
            ):
                return True
        return False


def controller_owner(obj: KubeObject) -> Optional[OwnerReference]:
    for r in obj.metadata.owner_references:
        if r.controller:
            return r
    return None


@dataclass
class ListMeta(KubeModel):
    resource_version: str = ""


def set_condition(conds: List[Condition], new: Condition) -> List[Condition]:
    """Upsert by type, preserving lastTransitionTime when status is unchanged."""
    out = []
    replaced = False
    for c in conds:
        if c.type == new.type:
            if c.status == new.status and not new.last_transition_time:
                new = dataclasses.replace(
                    new, last_transition_time=c.last_transition_time
                )
            elif not new.last_transition_time:
                new = dataclasses.replace(new, last_transition_time=now_rfc3339())
            out.append(new)
            replaced = True
        else:
            out.append(c)
    if not replaced:
        if not new.last_transition_time:
            new = dataclasses.replace(new, last_transition_time=now_rfc3339())
        out.append(new)
    return out


def get_condition(conds: List[Condition], ctype: str) -> Optional[Condition]:
    for c in conds:
        if c.type == ctype:
            return c
    return None


def sanitize_name(name: str, max_len: int = 63) -> str:
    """RFC1123-ish clamp used where the reference switches to generateName
    when a derived name would exceed limits (notebook_controller.go:58-59,
    notebook_route.go generateName if >63)."""
    name = name.lower()
    if len(name) <= max_len:
        return name
    return name[: max_len - 8].rstrip("-.") + "-" + _short_hash(name)


def _short_hash(s: str) -> str:
    import hashlib

    return hashlib.sha256(s.encode()).hexdigest()[:7]
