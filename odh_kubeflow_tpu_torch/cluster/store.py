"""In-process API server: the storage + watch + admission core.

This is the build's answer to kube-apiserver/etcd *and* to the reference's
envtest fixture (reference odh controllers/suite_test.go:91-275 boots a real
kube-apiserver; here the control plane itself is in-process). Semantics kept
faithful where the controllers depend on them:

- optimistic concurrency: update with a stale resourceVersion raises
  ConflictError (drives every retry_on_conflict site),
- finalizers: delete on a finalized object only sets deletionTimestamp;
  removal happens when the last finalizer is gone,
- admission: mutating webhook chain runs on CREATE/UPDATE before persistence,
  failurePolicy=Fail (exceptions reject the write),
- status is a subresource: spec writes don't clobber status and vice versa,
- watches: every subscriber sees ADDED/MODIFIED/DELETED in order,
- owner-reference GC: cascading (background-style) deletion of dependents.
"""
from __future__ import annotations

import collections
import copy
import itertools
import json
import queue
import uuid
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Type

from ..apimachinery import (
    AdmissionDeniedError,
    AlreadyExistsError,
    ConflictError,
    GoneError,
    InvalidError,
    KubeObject,
    NotFoundError,
    Scheme,
    default_scheme,
    json_merge_patch,
    match_labels,
    now_rfc3339,
)
from ..utils import invcheck, racecheck

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
BOOKMARK = "BOOKMARK"  # progress marker: current RV, no object payload


# CPPROFILE scan-accounting hook (runtime/cpprofile.py), resolved lazily and
# cached: cluster modules must not import the runtime package at load time
# (runtime.manager imports cluster.client while runtime/__init__ is mid-init).
_cpprofile_mod = None


def _cpprofile():
    global _cpprofile_mod
    if _cpprofile_mod is None:
        from ..runtime import cpprofile

        _cpprofile_mod = cpprofile
    return _cpprofile_mod
DROPPED = "DROPPED"  # stream severed (fault injection / server restart):
# consumers must treat the watch as dead and re-establish from their last RV

# kinds whose GVK groups several served versions onto one storage key
_STORAGE_KEY_OVERRIDES: Dict[Tuple[str, str], Tuple[str, str]] = {}


def register_storage_alias(served_api_version: str, kind: str, storage_api_version: str) -> None:
    """Serve `served_api_version/kind` from the storage of `storage_api_version/kind`
    (the conversion-webhook analog for our multi-version Notebook CRD)."""
    _STORAGE_KEY_OVERRIDES[(served_api_version, kind)] = (storage_api_version, kind)


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: Dict[str, Any]  # canonical JSON form at (or before, for DELETED) the event

    def decode(self, scheme: Scheme = default_scheme) -> KubeObject:
        return scheme.decode(self.object)


@dataclass
class AdmissionRequest:
    operation: str  # CREATE | UPDATE
    object: Dict[str, Any]  # mutable: webhooks edit in place or return a new dict
    old_object: Optional[Dict[str, Any]] = None
    dry_run: bool = False


AdmissionHandler = Callable[[AdmissionRequest], Optional[Dict[str, Any]]]


@dataclass
class _WebhookRegistration:
    name: str
    api_version: str
    kind: str
    operations: Tuple[str, ...]
    handler: AdmissionHandler


class Watch:
    """A subscription to store changes. Iterate or poll with get()."""

    def __init__(
        self,
        q: "queue.Queue[Optional[WatchEvent]]",
        cancel: Callable[[], None],
        namespace: Optional[str] = None,
        bookmark: Optional[Callable[[], None]] = None,
    ):
        self._q = q
        self._cancel = cancel
        self._namespace = namespace
        self._bookmark = bookmark
        self.stopped = False
        self.pending: List[WatchEvent] = []  # initial-list synthetic ADDEDs

    def request_bookmark(self) -> None:
        """Enqueue a BOOKMARK event carrying the store's current RV, ORDERED
        with the event stream: the RV is read and the event queued under the
        store lock, so a bookmark can never claim progress past an event that
        has not yet been queued to this watch (reading current_rv out-of-band
        races exactly that way)."""
        if self._bookmark is not None:
            self._bookmark()

    def _admit(self, ev: Optional[WatchEvent]) -> bool:
        if ev is None or self._namespace is None:
            return True
        if ev.type in (BOOKMARK, DROPPED):  # stream-level, namespace-less
            return True
        return ev.object.get("metadata", {}).get("namespace", "") == self._namespace

    def get(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        if self.pending:
            return self.pending.pop(0)
        while True:
            try:
                ev = self._q.get(timeout=timeout)
            except queue.Empty:
                return None
            if self._admit(ev):
                return ev

    def stop(self) -> None:
        self.stopped = True
        self._cancel()
        self._q.put(None)

    def __iter__(self):
        while True:
            ev = self.get()
            if ev is None:
                return
            yield ev


def _to_json(obj: Dict[str, Any]) -> str:
    """Serialize to canonical JSON — the store's data contract (API objects
    ARE JSON documents, as in etcd). Non-JSON values (sets, datetimes, NaN)
    raise InvalidError; non-string dict keys are coerced to strings, exactly
    as any JSON API server would."""
    try:
        return json.dumps(obj, separators=(",", ":"), allow_nan=False)
    except (TypeError, ValueError) as e:
        raise InvalidError(f"object is not canonical JSON: {e}") from e


class _PyBucket:
    """Canonical-JSON bucket, pure Python. Value semantics: every read
    deserializes a fresh dict, every write serializes — so callers can never
    alias stored state."""

    def __init__(self) -> None:
        self._objs: Dict[str, str] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._objs

    def __getitem__(self, key: str) -> Dict[str, Any]:
        return json.loads(self._objs[key])

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        raw = self._objs.get(key)
        return None if raw is None else json.loads(raw)

    def __len__(self) -> int:
        return len(self._objs)

    def raw(self, key: str) -> str:
        return self._objs[key]

    def store(self, key: str, obj: Dict[str, Any]) -> str:
        """Serialize once; returns the canonical form for local reuse."""
        raw = _to_json(obj)
        self._objs[key] = raw
        return raw

    def __setitem__(self, key: str, obj: Dict[str, Any]) -> None:
        self.store(key, obj)

    def pop(self, key: str) -> Dict[str, Any]:
        return json.loads(self._objs.pop(key))

    def values(self) -> Iterable[Dict[str, Any]]:
        return [json.loads(raw) for raw in self._objs.values()]


class Store:
    """The versioned object store. Keys: (storage_api_version, kind) -> {ns/name -> obj}.

    Storage: every kind's bucket is a `_PyBucket` of canonical JSON (the
    reference's pure-Python backend; its native one is not ported)."""

    def __init__(
        self,
        scheme: Scheme = default_scheme,
        watch_history_limit: int = 4096,
        faults: Optional[Any] = None,
        invariants: Optional[Any] = None,
    ):
        self.scheme = scheme
        # fault injection seam (cluster/faults.py FaultInjector); None in
        # production — every hook site is a single attribute check
        self.faults = faults
        # INVCHECK seam (utils/invcheck.py Monitor): observed after every
        # successful write with (old, new) so cross-object invariants and
        # machine-transition legality are judged at the exact write that
        # would break them. None in production (INVCHECK=1 arms it; the
        # explorer injects a collecting monitor explicitly) — one attribute
        # check per write when off, mirroring the faults seam.
        self.invariants = invariants if invariants is not None \
            else invcheck.store_monitor()
        if faults is not None:
            faults.bind_store(self)
        # instrumented under RACECHECK=1: the in-process admission chain
        # runs under this lock, so its acquisition order against the
        # informer/registry locks is the control plane's hottest ABBA risk
        self._lock = racecheck.make_rlock("Store._lock")
        self._rv = itertools.count(1)
        self._last_rv = 0
        # Watch cache: per-storage-key retained (rv, event) history so watches
        # can resume from a resourceVersion (kube-apiserver's watch cache is
        # per-resource too — a busy kind must not evict a quiet kind's resume
        # window). When a requested RV predates the retained window we answer
        # 410 Gone and the client must relist — the informer relist contract.
        self._watch_history_limit = watch_history_limit
        self._history: Dict[Tuple[str, str], "collections.deque[Tuple[int, WatchEvent]]"] = {}
        self._history_dropped_rv: Dict[Tuple[str, str], int] = {}
        self._objects: Dict[Tuple[str, str], Any] = {}
        self._watchers: Dict[Tuple[str, str], List[queue.Queue]] = {}
        self._webhooks: List[_WebhookRegistration] = []
        self._gc_enabled = True

    # ---------- helpers ----------

    def _storage_key(self, api_version: str, kind: str) -> Tuple[str, str]:
        return _STORAGE_KEY_OVERRIDES.get((api_version, kind), (api_version, kind))

    def _bucket(self, api_version: str, kind: str) -> Any:
        skey = self._storage_key(api_version, kind)
        bucket = self._objects.get(skey)
        if bucket is None:
            bucket = _PyBucket()
            self._objects[skey] = bucket
        return bucket

    @staticmethod
    def _obj_key(namespace: str, name: str) -> str:
        return f"{namespace}/{name}" if namespace else name

    def _next_rv(self) -> str:
        rv = next(self._rv)
        self._last_rv = max(self._last_rv, int(rv))
        return str(rv)

    def current_rv(self) -> str:
        """Most recently issued resourceVersion — the collection RV a LIST
        response reports (listMeta.resourceVersion) and a watch resumes from."""
        with self._lock:
            return str(self._last_rv)

    def _emit(self, api_version: str, kind: str, ev: WatchEvent) -> None:
        skey = self._storage_key(api_version, kind)
        try:
            rv = int(ev.object.get("metadata", {}).get("resourceVersion", "0"))
        except ValueError:
            rv = 0
        hist = self._history.get(skey)
        if hist is None:
            hist = self._history[skey] = collections.deque(maxlen=self._watch_history_limit)
        if hist.maxlen and len(hist) == hist.maxlen:
            self._history_dropped_rv[skey] = hist[0][0]
        hist.append((rv, ev))
        for q in self._watchers.get(skey, []):
            q.put(ev)

    def _run_admission(self, req: AdmissionRequest) -> Dict[str, Any]:
        obj = req.object
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        skey = self._storage_key(av, kind)
        for wh in self._webhooks:
            if self._storage_key(wh.api_version, wh.kind) != skey:
                continue
            if req.operation not in wh.operations:
                continue
            req.object = obj
            result = wh.handler(req)
            if result is not None:
                obj = result
        return obj

    # ---------- admission registration ----------

    def register_webhook(
        self,
        name: str,
        api_version: str,
        kind: str,
        operations: Iterable[str],
        handler: AdmissionHandler,
    ) -> None:
        with self._lock:
            self._webhooks.append(
                _WebhookRegistration(name, api_version, kind, tuple(operations), handler)
            )

    # ---------- CRUD (dict-level; the typed client wraps these) ----------

    def create_raw(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        obj = copy.deepcopy(obj)
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        if not av or not kind:
            raise InvalidError("object missing apiVersion/kind")
        if self.faults is not None:
            self.faults.check("store.write", kind=kind, obj=obj, verb="create")
        with self._lock:
            # intentional: the in-process admission chain runs under the
            # Store lock so admission + persist are one atomic step (the
            # real apiserver serializes per-object the same way). Webhook
            # handlers therefore must not take locks ordered before the
            # Store's — see InformerRegistry.peek, which is deliberately
            # lock-free for exactly this reason.
            obj = self._run_admission(  # lint: disable=lock-discipline
                AdmissionRequest(operation="CREATE", object=obj)
            )
            meta = obj.setdefault("metadata", {})
            name = meta.get("name", "")
            if not name:
                gen = meta.get("generateName", "")
                if not gen:
                    raise InvalidError("metadata.name or generateName required")
                name = gen + uuid.uuid4().hex[:5]
                meta["name"] = name
            ns = meta.get("namespace", "")
            bucket = self._bucket(av, kind)
            key = self._obj_key(ns, name)
            if key in bucket:
                raise AlreadyExistsError(kind=kind, name=key)
            meta["uid"] = meta.get("uid") or str(uuid.uuid4())
            meta["resourceVersion"] = self._next_rv()
            meta["generation"] = 1
            meta["creationTimestamp"] = now_rfc3339()
            meta.pop("deletionTimestamp", None)
            raw = bucket.store(key, obj)  # one serialization; never aliases obj
            stored = json.loads(raw)
            self._emit(av, kind, WatchEvent(ADDED, stored))
            if self.invariants is not None:
                # the monitor only reads; sharing the emitted snapshot (as
                # every watcher queue already does) avoids a re-parse per
                # armed write
                self.invariants.observe(self, av, kind, None, stored)
            if self._gc_enabled and self._owner_dangling(obj):
                # k8s GC-controller semantics, made synchronous like the
                # cascade above: an object created with a DANGLING owner
                # reference (owner deleted between the creator's read and
                # this create — e.g. a mid-flight reconcile re-creating a
                # StatefulSet after its Notebook's cascade delete) is
                # collected immediately instead of surviving as an orphan
                # no future delete will ever cascade to. The create still
                # returns success (as in k8s, where GC runs async); watchers
                # see ADDED then DELETED and converge level-triggered.
                self._remove(av, kind, bucket, key)
            return json.loads(raw)

    def get_raw(self, api_version: str, kind: str, namespace: str, name: str) -> Dict[str, Any]:
        if self.faults is not None:
            self.faults.check("store.read", kind=kind, name=name, verb="get")
        with self._lock:
            bucket = self._bucket(api_version, kind)
            key = self._obj_key(namespace, name)
            if key not in bucket:
                raise NotFoundError(kind=kind, name=key)
            return bucket[key]  # fresh deserialization = snapshot copy

    def list_raw(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict[str, Any]]:
        if self.faults is not None:
            self.faults.check("store.read", kind=kind, verb="list")
        with self._lock:
            bucket = self._bucket(api_version, kind)
            scanned = len(bucket)
            out = []
            for obj in bucket.values():
                meta = obj.get("metadata", {})
                if namespace is not None and meta.get("namespace", "") != namespace:
                    continue
                if not match_labels(label_selector, meta.get("labels")):
                    continue
                out.append(obj)
            out.sort(key=lambda o: (o["metadata"].get("namespace", ""), o["metadata"]["name"]))
        # CPPROFILE=1 scan accounting: the DIRECT list path — the system
        # manager's scheduler/kubelet sweeps and every other uncached read
        # walk the whole kind bucket. Outside the store lock; one
        # cached-module + env check when disarmed.
        _cpprofile().note_scan(kind, scanned, len(out))
        return out

    def peek_raw(
        self, api_version: str, kind: str
    ) -> List[Dict[str, Any]]:
        """Invariant-monitor read view: every object of a kind WITHOUT the
        fault-injection hook (an invariant re-judge must neither consume
        count-based fault rules nor be failed by them) — re-entrant under
        the store lock, so a monitor firing mid-write sees the state that
        write just produced."""
        with self._lock:
            return list(self._bucket(api_version, kind).values())

    def list_raw_with_rv(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> Tuple[List[Dict[str, Any]], str]:
        """List plus the collection resourceVersion, under ONE lock acquisition —
        the atomic list-then-watch snapshot the transport's informer resume
        depends on (an interleaved create would otherwise be invisible to both
        the list and the `erv > rv` watch replay)."""
        with self._lock:
            return (
                self.list_raw(api_version, kind, namespace=namespace, label_selector=label_selector),
                str(self._last_rv),
            )

    def update_raw(self, obj: Dict[str, Any], subresource: str = "") -> Dict[str, Any]:
        obj = copy.deepcopy(obj)
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        meta = obj.get("metadata", {})
        ns, name = meta.get("namespace", ""), meta.get("name", "")
        if self.faults is not None:
            self.faults.check(
                "store.write", kind=kind, obj=obj, name=name, verb="update"
            )
        with self._lock:
            bucket = self._bucket(av, kind)
            key = self._obj_key(ns, name)
            if key not in bucket:
                raise NotFoundError(kind=kind, name=key)
            current_raw = bucket.raw(key)
            current = json.loads(current_raw)
            cur_meta = current["metadata"]
            if meta.get("resourceVersion") and meta["resourceVersion"] != cur_meta["resourceVersion"]:
                raise ConflictError(
                    f"Operation cannot be fulfilled on {kind} {key!r}: "
                    f"the object has been modified"
                )
            if subresource == "status":
                merged = current  # already a snapshot copy from the bucket
                if "status" in obj:
                    merged["status"] = obj["status"]
                else:
                    merged.pop("status", None)
            else:
                merged = obj
                # status is a subresource: plain updates cannot change it
                if "status" in current:
                    merged["status"] = current["status"]
                else:
                    merged.pop("status", None)
                # intentional: same atomic admission+persist contract as
                # create_raw above (handlers must stay Store-lock-clean)
                merged = self._run_admission(  # lint: disable=lock-discipline
                    AdmissionRequest(
                        operation="UPDATE",
                        object=merged,
                        old_object=json.loads(current_raw),
                    )
                )
            mmeta = merged.setdefault("metadata", {})
            # immutable fields
            for f in ("uid", "creationTimestamp", "name", "namespace"):
                if cur_meta.get(f):
                    mmeta[f] = cur_meta[f]
            if cur_meta.get("deletionTimestamp"):
                mmeta["deletionTimestamp"] = cur_meta["deletionTimestamp"]
            mmeta["resourceVersion"] = self._next_rv()
            gen = cur_meta.get("generation", 1)
            if subresource != "status" and json.dumps(
                merged.get("spec"), sort_keys=True
            ) != json.dumps(current.get("spec"), sort_keys=True):
                gen += 1
            mmeta["generation"] = gen
            raw = bucket.store(key, merged)
            stored = json.loads(raw)
            self._emit(av, kind, WatchEvent(MODIFIED, stored))
            if self.invariants is not None:
                # old state re-parses current_raw: `current` may BE `merged`
                # (status branch mutates it in place); `stored` is shared
                # read-only with the emit above
                self.invariants.observe(
                    self, av, kind, json.loads(current_raw), stored
                )
            self._finalize_if_ready(av, kind, bucket, key)
            # finalize may have removed the object; either way `raw` is the
            # state this update produced
            return json.loads(raw)

    def patch_raw(
        self,
        api_version: str,
        kind: str,
        namespace: str,
        name: str,
        patch: Dict[str, Any],
        subresource: str = "",
    ) -> Dict[str, Any]:
        """RFC 7386 merge patch; no resourceVersion precondition (like kubectl patch)."""
        with self._lock:
            current = self.get_raw(api_version, kind, namespace, name)
            patched = json_merge_patch(current, patch)
            # patches can't change identity
            patched["apiVersion"], patched["kind"] = current["apiVersion"], current["kind"]
            pmeta = patched.setdefault("metadata", {})
            pmeta["name"], pmeta["namespace"] = name, namespace or pmeta.get("namespace", "")
            pmeta["resourceVersion"] = current["metadata"]["resourceVersion"]
            return self.update_raw(patched, subresource=subresource)

    def delete_raw(self, api_version: str, kind: str, namespace: str, name: str) -> None:
        if self.faults is not None:
            self.faults.check("store.write", kind=kind, name=name, verb="delete")
        with self._lock:
            bucket = self._bucket(api_version, kind)
            key = self._obj_key(namespace, name)
            if key not in bucket:
                raise NotFoundError(kind=kind, name=key)
            obj = bucket[key]  # snapshot copy: changes must be written back
            meta = obj["metadata"]
            if meta.get("finalizers"):
                if not meta.get("deletionTimestamp"):
                    old = bucket[key] if self.invariants is not None else None
                    meta["deletionTimestamp"] = now_rfc3339()
                    meta["resourceVersion"] = self._next_rv()
                    bucket[key] = obj
                    self._emit(api_version, kind, WatchEvent(MODIFIED, obj))
                    if self.invariants is not None:
                        # the deletionTimestamp stamp is a write like any
                        # other — the monitor's contract is EVERY write
                        self.invariants.observe(
                            self, api_version, kind, old, obj
                        )
                return
            self._remove(api_version, kind, bucket, key)

    def _finalize_if_ready(
        self, api_version: str, kind: str, bucket: Any, key: str
    ) -> None:
        """If deletionTimestamp is set and finalizers are now empty, remove."""
        obj = bucket.get(key)
        if obj is None:
            return
        meta = obj["metadata"]
        if meta.get("deletionTimestamp") and not meta.get("finalizers"):
            self._remove(api_version, kind, bucket, key)

    def _remove(self, api_version: str, kind: str, bucket: Any, key: str) -> None:
        obj = bucket.pop(key)
        # the DELETED event carries a fresh RV (as kube-apiserver does) so
        # watch resume from that RV does not replay the deletion
        obj.setdefault("metadata", {})["resourceVersion"] = self._next_rv()
        self._emit(api_version, kind, WatchEvent(DELETED, obj))
        if self.invariants is not None:
            self.invariants.observe(self, api_version, kind, obj, None)
        if self._gc_enabled:
            self._cascade_delete(obj)

    def _owner_dangling(self, obj: Dict[str, Any]) -> bool:
        """True when any uid-carrying ownerReference points at an owner that
        no longer exists (or exists with a different uid — same name,
        recreated object). Callers hold self._lock."""
        meta = obj.get("metadata", {})
        ns = meta.get("namespace", "")
        for ref in meta.get("ownerReferences", []):
            uid = ref.get("uid")
            if not uid:
                continue
            # resolve through the STORAGE key: a spoke-version ownerReference
            # (e.g. kubeflow.org/v1 Notebook) lives in the hub's bucket, and
            # the raw (apiVersion, kind) key would read every spoke-owned
            # object as dangling and GC it at birth
            bucket = self._objects.get(
                self._storage_key(ref.get("apiVersion", ""), ref.get("kind", ""))
            )
            owner = None
            if bucket is not None:
                owner = bucket.get(self._obj_key(ns, ref.get("name", ""))) \
                    or bucket.get(self._obj_key("", ref.get("name", "")))
            if owner is None or owner["metadata"].get("uid") != uid:
                return True
        return False

    def _cascade_delete(self, owner: Dict[str, Any]) -> None:
        """Owner-reference garbage collection (synchronous cascade for
        determinism — semantics of k8s background GC)."""
        owner_uid = owner["metadata"].get("uid")
        if not owner_uid:
            return
        victims: List[Tuple[str, str, str, str]] = []
        for (av, kind), bucket in self._objects.items():
            for obj in bucket.values():
                for ref in obj["metadata"].get("ownerReferences", []):
                    if ref.get("uid") == owner_uid:
                        m = obj["metadata"]
                        victims.append((av, kind, m.get("namespace", ""), m["name"]))
                        break
        for av, kind, ns, name in victims:
            try:
                self.delete_raw(av, kind, ns, name)
            except NotFoundError:
                pass

    # ---------- watches ----------

    def watch(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
        since_rv: Optional[str] = None,
    ) -> Watch:
        """Subscribe; atomically delivers synthetic ADDEDs for the current
        state first (list+watch without a gap, which is what informers need).

        With since_rv, instead replays retained history strictly after that
        resourceVersion (the `?watch=true&resourceVersion=N` resume path);
        raises GoneError when the window has been trimmed past it."""
        q: "queue.Queue[Optional[WatchEvent]]" = queue.Queue()
        skey = self._storage_key(api_version, kind)
        if self.faults is not None and since_rv is not None:
            # injected 410: the resume window is "trimmed" regardless of the
            # real history depth — forces the client's relist path
            self.faults.check("store.watch_resume", kind=kind, rv=since_rv)
        with self._lock:
            pending: List[WatchEvent] = []
            if since_rv is not None:
                try:
                    rv = int(since_rv)
                except ValueError:
                    raise GoneError(f"invalid resourceVersion {since_rv!r}")
                if rv < self._history_dropped_rv.get(skey, 0):
                    raise GoneError(f"too old resource version: {since_rv}")
                pending = [
                    ev for (erv, ev) in self._history.get(skey, ())
                    if erv > rv
                    and (
                        namespace is None
                        or ev.object.get("metadata", {}).get("namespace", "") == namespace
                    )
                ]
            elif send_initial:
                pending = [
                    WatchEvent(ADDED, obj)
                    for obj in self.list_raw(api_version, kind, namespace=namespace)
                ]
            self._watchers.setdefault(skey, []).append(q)

            def cancel() -> None:
                with self._lock:
                    try:
                        self._watchers[skey].remove(q)
                    except ValueError:
                        pass

            def bookmark() -> None:
                # under the store lock: RV read + enqueue are atomic w.r.t.
                # every _emit, so queue order == RV order
                with self._lock:
                    q.put(
                        WatchEvent(
                            BOOKMARK,
                            {"metadata": {"resourceVersion": self.current_rv()}},
                        )
                    )

            w = Watch(q, cancel, namespace=namespace, bookmark=bookmark)
            w.pending = pending
        return w

    def sever_watches(
        self, api_version: Optional[str] = None, kind: Optional[str] = None
    ) -> int:
        """Fault injection: sever live watch streams as a dropped connection
        would — each subscriber queue receives a DROPPED event and is
        unsubscribed, so no further events arrive on it. Consumers (the
        informer reflector loop, the HTTP watch handler) must re-establish
        from their last seen resourceVersion. Returns queues severed."""
        with self._lock:
            severed = 0
            for skey, queues in list(self._watchers.items()):
                if api_version is not None and skey[0] != api_version:
                    continue
                if kind is not None and skey[1] != kind:
                    continue
                for q in queues:
                    q.put(WatchEvent(DROPPED, {}))
                    severed += 1
                self._watchers[skey] = []
            return severed
