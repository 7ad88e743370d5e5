"""Cache-backed typed client — controller-runtime's split client semantics.

The reference's reconcilers read through mgr.GetClient(), which serves GETs
and LISTs from the shared informer caches and sends writes straight to the
apiserver; only mgr.GetAPIReader() bypasses the cache. This mirrors that
split exactly: for kinds that have a (synced) informer, reads come from the
informer's store — no API round-trip, which is the difference between ~10^3
requests per reconcile storm and ~10^1 against a real apiserver (measured by
the loadtest's client_throttle stats) — and for everything else reads fall
through to the live store. Writes always go direct.

Staleness contract (same as controller-runtime): a reconciler may observe a
cache that does not yet include its own last write; every write path that
read-modify-writes must use retry_on_conflict with a FRESH read, which is
what the `api_reader` (uncached Client) is for.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Type

from ..apimachinery import KubeObject, NotFoundError, Scheme, default_scheme
from ..cluster.client import Client, T
from ..cluster.store import Store
from ..utils import racecheck
from .informer import InformerRegistry


class CachedClient(Client):
    def __init__(
        self,
        store: Store,
        scheme: Scheme = default_scheme,
        informers: Optional[InformerRegistry] = None,
    ):
        super().__init__(store, scheme)
        self.informers = informers

    def _cache_for(self, cls: Type[KubeObject]):
        """The informer to serve this kind from, or None for a direct read.
        Only EXISTING, synced informers are consulted (InformerRegistry.peek)
        — reads must not implicitly spin up watches for kinds no controller
        asked to watch (controller-runtime does auto-start them; here the
        watch set is the Builder's explicit For/Owns/Watches topology, and a
        lazily-started informer would race its own initial sync)."""
        if self.informers is None:
            return None
        av, kind = self._av_kind(cls)
        return self.informers.peek(av, kind)

    def get(self, cls: Type[T], namespace: str, name: str) -> T:
        inf = self._cache_for(cls)
        if inf is None:
            return super().get(cls, namespace, name)
        obj = inf.get(namespace, name)
        if obj is None:
            # the cache is authoritative for watched kinds (controller-runtime
            # returns NotFound from cache too; falling through would turn
            # every informer-lag miss into an API GET storm)
            av, kind = self._av_kind(cls)
            raise NotFoundError(f"{kind} {namespace}/{name} not found (cache)")
        return self._decode(cls, obj)

    def list(
        self,
        cls: Type[T],
        namespace: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> List[T]:
        inf = self._cache_for(cls)
        if inf is None:
            return super().list(cls, namespace=namespace, labels=labels)
        # filtering happens inside the informer on the raw dicts, before the
        # defensive deepcopy
        return [
            self._decode(cls, obj)
            for obj in inf.list(namespace=namespace, labels=labels)
        ]


class TTLReadClient(Client):
    """Short-TTL read memo over an uncached Client — the admission webhook's
    cache where no informer registry is reachable (the webhook server runs
    with its OWN unthrottled client, reference-style; see
    cluster/remote_fixture.py).

    The webhook chain re-reads the same 3-4 per-namespace ConfigMaps (image
    catalog, CA bundle, runtime-image sources, proxy env) on EVERY
    AdmissionReview; under a create storm that is 3 apiserver round-trips per
    admission, nearly all answering 404 (round-5 loadtest: 240 of ~1000
    requests). NEGATIVE results are memoized too — the absent-ConfigMap case
    is the common one. Staleness is bounded by ttl_s and self-heals: the
    extension reconciler re-syncs the same objects level-triggered, and its
    CA-source watch re-triggers affected notebooks.

    Writes pass through and invalidate the touched key, so the webhook's own
    sync writes (runtime-images catalog) never serve themselves stale."""

    # expired-entry sweep threshold: prevents monotonic memo growth across
    # namespace churn in a long-lived webhook process
    MAX_ENTRIES = 512

    def __init__(self, inner: Client, ttl_s: float = 2.0):
        super().__init__(inner.store, inner.scheme)
        self._inner = inner
        self.ttl_s = ttl_s
        self._lock = racecheck.make_lock("TTLReadClient._lock")
        self._get_memo: Dict[Tuple, Tuple[float, Optional[dict]]] = {}
        self._list_memo: Dict[Tuple, Tuple[float, List[dict]]] = {}

    @property
    def fresh(self) -> Client:
        """Unmemoized view — the side every write decision must use (see
        sync_runtime_images' read/write split). Its WRITES invalidate this
        memo, so a helper that creates through `fresh` never has its own
        object served stale by the memoized 404 it read moments before."""
        return _FreshView(self)

    def _invalidate_key(self, cls, namespace: str, name: str) -> None:
        with self._lock:
            self._get_memo.pop(self._key(cls, namespace, name), None)
            self._list_memo.clear()  # lists are cheap to refill; stay correct

    def _key(self, cls, namespace, name):
        av, kind = self._av_kind(cls)
        return (av, kind, namespace, name)

    def _prune(self, memo: Dict, now: float) -> None:
        # call with self._lock held
        if len(memo) < self.MAX_ENTRIES:
            return
        for k in [k for k, (ts, _) in memo.items() if now - ts >= self.ttl_s]:
            del memo[k]
        if len(memo) >= self.MAX_ENTRIES:  # all live: drop everything (rare)
            memo.clear()

    def get(self, cls: Type[T], namespace: str, name: str) -> T:
        key = self._key(cls, namespace, name)
        now = time.monotonic()
        with self._lock:
            hit = self._get_memo.get(key)
            if hit is not None and now - hit[0] < self.ttl_s:
                if hit[1] is None:
                    raise NotFoundError(f"{key[1]} {namespace}/{name} not found (ttl)")
                return self._decode(cls, hit[1])
        try:
            obj = self._inner.get(cls, namespace, name)
        except NotFoundError:
            with self._lock:
                self._prune(self._get_memo, now)
                self._get_memo[key] = (now, None)
            raise
        with self._lock:
            self._prune(self._get_memo, now)
            # memo entries are cache-owned the same way informer entries
            # are: under RACECHECK they carry the write barrier so a caller
            # mutating a decoded object's shared substructure raises
            self._get_memo[key] = (
                now, racecheck.guard_cache_object(obj.to_dict(), f"ttl-memo/{key}")
            )
        return obj

    def list(
        self,
        cls: Type[T],
        namespace: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> List[T]:
        av, kind = self._av_kind(cls)
        key = (av, kind, namespace, tuple(sorted((labels or {}).items())))
        now = time.monotonic()
        with self._lock:
            hit = self._list_memo.get(key)
            if hit is not None and now - hit[0] < self.ttl_s:
                return [self._decode(cls, o) for o in hit[1]]
        out = self._inner.list(cls, namespace=namespace, labels=labels)
        with self._lock:
            self._prune(self._list_memo, now)
            self._list_memo[key] = (
                now,
                [
                    racecheck.guard_cache_object(o.to_dict(), f"ttl-memo/{key}")
                    for o in out
                ],
            )
        return out

    # writes delegate to the fresh view: inner write + memo invalidation
    def create(self, obj):
        return self.fresh.create(obj)

    def update(self, obj):
        return self.fresh.update(obj)

    def delete(self, cls: Type[T], namespace: str, name: str) -> None:
        self.fresh.delete(cls, namespace, name)

    def patch(self, cls: Type[T], namespace: str, name: str, patch: dict) -> T:
        return self.fresh.patch(cls, namespace, name, patch)

    def update_status(self, obj):
        return self.fresh.update_status(obj)

    def patch_status(self, cls: Type[T], namespace: str, name: str, patch: dict) -> T:
        return self.fresh.patch_status(cls, namespace, name, patch)


class _FreshView(Client):
    """TTLReadClient.fresh: unmemoized reads straight off the inner client,
    writes that clear the owner's memo for the touched key."""

    def __init__(self, owner: TTLReadClient):
        super().__init__(owner._inner.store, owner._inner.scheme)
        self._owner = owner
        self._inner = owner._inner

    def get(self, cls: Type[T], namespace: str, name: str) -> T:
        return self._inner.get(cls, namespace, name)

    def list(self, cls, namespace=None, labels=None):
        return self._inner.list(cls, namespace=namespace, labels=labels)

    def create(self, obj):
        out = self._inner.create(obj)
        self._owner._invalidate_key(type(obj), obj.metadata.namespace,
                                    obj.metadata.name)
        return out

    def update(self, obj):
        out = self._inner.update(obj)
        self._owner._invalidate_key(type(obj), obj.metadata.namespace,
                                    obj.metadata.name)
        return out

    def delete(self, cls: Type[T], namespace: str, name: str) -> None:
        self._inner.delete(cls, namespace, name)
        self._owner._invalidate_key(cls, namespace, name)

    def patch(self, cls: Type[T], namespace: str, name: str, patch: dict) -> T:
        out = self._inner.patch(cls, namespace, name, patch)
        self._owner._invalidate_key(cls, namespace, name)
        return out

    def update_status(self, obj):
        out = self._inner.update_status(obj)
        self._owner._invalidate_key(type(obj), obj.metadata.namespace,
                                    obj.metadata.name)
        return out

    def patch_status(self, cls: Type[T], namespace: str, name: str, patch: dict) -> T:
        out = self._inner.patch_status(cls, namespace, name, patch)
        self._owner._invalidate_key(cls, namespace, name)
        return out
