"""Controller builder: the For/Owns/Watches wiring DSL.

Mirrors the reference's SetupWithManager topologies, e.g. the core reconciler's
`For(Notebook).Owns(StatefulSet).Owns(Service).Watches(Pod, mapped-by-label)
.Watches(Event, filtered)` (reference notebook_controller.go:778-826)."""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Type

from ..apimachinery import KubeObject, controller_owner
from ..cluster.store import DELETED
from . import cpprofile
from .controller import Controller, Reconciler, Request

# predicate(event_type, obj_dict, old_obj_dict) -> bool
Predicate = Callable[[str, dict, Optional[dict]], bool]
# mapper(obj_dict) -> list of (namespace, name) to enqueue
Mapper = Callable[[dict], List[Tuple[str, str]]]


def _meta(obj: dict) -> dict:
    return obj.get("metadata", {})


class Builder:
    def __init__(self, manager, name: str):
        self.manager = manager
        self.name = name
        self._for: Optional[Type[KubeObject]] = None
        self._for_predicate: Optional[Predicate] = None
        self._owns: List[Type[KubeObject]] = []
        self._watches: List[Tuple[Type[KubeObject], Mapper, Optional[Predicate]]] = []
        self._workers = 1
        self._max_retries: Optional[int] = None

    def for_(self, cls: Type[KubeObject], predicate: Optional[Predicate] = None) -> "Builder":
        self._for = cls
        self._for_predicate = predicate
        return self

    def owns(self, cls: Type[KubeObject]) -> "Builder":
        self._owns.append(cls)
        return self

    def watches(
        self, cls: Type[KubeObject], mapper: Mapper, predicate: Optional[Predicate] = None
    ) -> "Builder":
        self._watches.append((cls, mapper, predicate))
        return self

    def with_workers(self, n: int) -> "Builder":
        self._workers = n
        return self

    def complete(self, reconciler: Reconciler) -> Controller:
        if self._for is None:
            raise ValueError("Builder.for_ is required")
        ctrl = Controller(
            self.name, reconciler, workers=self._workers, max_retries=self._max_retries
        )
        primary_gvk = self.manager.scheme.gvk_for(self._for)
        # shard ownership filter (runtime/manager.py ShardSpec): a sharded
        # manager sees every event through the shared informers but only
        # enqueues PRIMARY keys its shard owns — owned/watched events are
        # filtered on the key they map to, so the whole ownership decision
        # is one hash of the reconcile target
        shard = getattr(self.manager, "shard", None)

        def owned_by_shard(ns: str, name: str) -> bool:
            return shard is None or shard.owns(ns, name)

        # CPPROFILE=1 cause chain (runtime/cpprofile.py): an event that
        # actually enqueues — after predicates and the shard filter — stamps
        # its (source kind, verb, object, resourceVersion) onto the pending
        # request, so the reconcile it wakes can report why it fired. The
        # stamp site knows the watched kind statically (it is bound per
        # informer registration, not read off the object).
        def enqueue_caused(
            ns: str, name: str, src_kind: str, ev_type: str, obj: dict
        ) -> None:
            cpprofile.stamp_cause(
                self.name, f"{ns}/{name}" if ns else name,
                kind=src_kind, verb=ev_type, obj=obj,
            )
            ctrl.enqueue(ns, name)

        def on_primary(ev_type: str, obj: dict, old: Optional[dict]) -> None:
            if self._for_predicate and not self._for_predicate(ev_type, obj, old):
                return
            m = _meta(obj)
            ns, name = m.get("namespace", ""), m.get("name", "")
            if owned_by_shard(ns, name):
                enqueue_caused(ns, name, primary_gvk.kind, ev_type, obj)

        self.manager.informers.informer_for(self._for).add_handler(on_primary)

        for cls in self._owns:
            owned_kind = self.manager.scheme.gvk_for(cls).kind

            def on_owned(
                ev_type: str,
                obj: dict,
                old: Optional[dict],
                owned_kind: str = owned_kind,
            ) -> None:
                for ref in _meta(obj).get("ownerReferences", []):
                    if (
                        ref.get("controller")
                        and ref.get("kind") == primary_gvk.kind
                        and ref.get("apiVersion", "").split("/")[0]
                        == primary_gvk.api_version.split("/")[0]
                    ):
                        ns = _meta(obj).get("namespace", "")
                        name = ref.get("name", "")
                        if owned_by_shard(ns, name):
                            enqueue_caused(ns, name, owned_kind, ev_type, obj)

            self.manager.informers.informer_for(cls).add_handler(on_owned)

        for cls, mapper, predicate in self._watches:
            watched_kind = self.manager.scheme.gvk_for(cls).kind

            def on_watched(
                ev_type: str,
                obj: dict,
                old: Optional[dict],
                mapper: Mapper = mapper,
                predicate: Optional[Predicate] = predicate,
                watched_kind: str = watched_kind,
            ) -> None:
                if predicate and not predicate(ev_type, obj, old):
                    return
                for ns, name in mapper(obj):
                    if owned_by_shard(ns, name):
                        enqueue_caused(ns, name, watched_kind, ev_type, obj)

            self.manager.informers.informer_for(cls).add_handler(on_watched)

        self.manager.add_controller(ctrl)
        return ctrl
