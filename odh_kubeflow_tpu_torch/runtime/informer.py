"""Shared informers: one watch per kind, an in-memory cache, and fan-out to
event handlers. This is the informer/cache layer controller-runtime gives the
reference for free; reads in our controllers go through the cache just like
the reference's mgr.GetClient() reads (with the same staleness caveats).

The watch loop is a full reflector (client-go Reflector semantics): a severed
stream is re-established from the last seen resourceVersion with jittered
exponential backoff, and a 410 Expired resume degrades to relist+diff — the
cache is compared against the fresh list so handlers observe synthetic
MODIFIED/ADDED upserts and DELETED for keys that vanished while the watch was
down. `synced` stays set across relists: the cache keeps serving (stale)
reads during recovery, exactly as client-go does."""
from __future__ import annotations

import inspect
import logging
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from ..apimachinery import GoneError, Scheme, default_scheme
from ..cluster.store import ADDED, DELETED, DROPPED, MODIFIED, Store, WatchEvent
from ..utils import racecheck
from . import cpprofile
from .metrics import (
    informer_last_sync_timestamp_seconds,
    informer_synced,
    relists_total,
    watch_restarts_total,
)

log = logging.getLogger(__name__)

# handler(event_type, obj_dict, old_obj_dict_or_None)
EventHandler = Callable[[str, dict, Optional[dict]], None]


class Informer:
    # reconnect backoff: base * 2^n, jittered to [0.5, 1.5)x, capped — fast
    # enough that a test-scale drop heals in tens of ms, slow enough that a
    # down apiserver is not hammered by every informer in lockstep
    BACKOFF_BASE = 0.05
    BACKOFF_MAX = 2.0

    def __init__(self, store: Store, api_version: str, kind: str):
        self.store = store
        self.api_version = api_version
        self.kind = kind
        self._cache: Dict[str, dict] = {}
        self._handlers: List[EventHandler] = []
        # RACECHECK=1 swaps in the instrumented lock (acquisition-order
        # audit) and the cache write barrier; both are plain threading
        # primitives / identity otherwise
        self._lock = racecheck.make_rlock(f"Informer[{kind}]._lock")
        self._racecheck = racecheck.enabled()
        self._watch = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self.synced = threading.Event()
        self.synced_at: float = 0.0  # wall time of the last (re)sync
        self._rv: str = ""  # last seen resourceVersion (the resume point)
        # deterministic per-kind jitter stream (no shared global RNG state)
        import random

        self._rng = random.Random(zlib.crc32(f"{api_version}/{kind}".encode()))
        # resume capability: the in-proc Store replays history after an RV;
        # RemoteStore's watch is itself a reflector (resume handled inside),
        # so reconnects there fall back to the relist path
        try:
            self._can_resume = "since_rv" in inspect.signature(store.watch).parameters
        except (TypeError, ValueError):  # builtins / exotic callables
            self._can_resume = False

    def add_handler(self, handler: EventHandler) -> None:
        with self._lock:
            self._handlers.append(handler)
            # late registrants see the current state as synthetic ADDs.
            # intentional lock-discipline exception: the replay must be
            # atomic with registration — dispatching outside the lock opens
            # a window where a concurrent _dispatch delivers an event for a
            # key whose synthetic ADD has not fired yet (observed as a
            # MODIFIED-before-ADDED inversion by the handler). Registration
            # happens at controller setup, pre-traffic, so the hold is short
            # and uncontended in practice.
            for obj in self._cache.values():
                handler(ADDED, obj, None)  # lint: disable=lock-discipline

    def start(self) -> None:
        if self._thread is not None:
            return
        try:
            self._watch = self.store.watch(self.api_version, self.kind)
        except Exception as e:
            # a throttled/unreachable apiserver at startup must not kill the
            # manager — the reflector loop establishes the watch with backoff
            log.warning(
                "informer %s: initial watch failed (%r); retrying with backoff",
                self.kind, e,
            )
            self._watch = None
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self.kind}", daemon=True
        )
        self._thread.start()

    def _key(self, obj: dict) -> str:
        m = obj.get("metadata", {})
        ns = m.get("namespace", "")
        return f"{ns}/{m.get('name', '')}" if ns else m.get("name", "")

    # -- reflector loop --

    def _run(self) -> None:
        w = self._watch
        if w is None:  # initial establishment failed: retry with backoff
            w = self._reestablish()
            if w is None:
                return
            self._watch = w
        # drain the initial synthetic ADDs, then mark synced
        while w.pending:
            self._dispatch(w.pending.pop(0))
        self._mark_synced()
        while not self._stopped.is_set():
            ev = w.get()
            if self._stopped.is_set():
                return
            if ev is None or ev.type == DROPPED:
                # stream severed (connection drop / server restart): the
                # informer must not die with it — re-establish from _rv
                w = self._reestablish()
                if w is None:
                    return
                self._watch = w
                while w.pending:
                    if self._stopped.is_set():
                        return
                    self._dispatch(w.pending.pop(0))
                continue
            self._dispatch(ev)

    def _reestablish(self):
        """Reconnect the watch with jittered exponential backoff; a 410 on
        resume (or no resume point at all) degrades to relist+diff."""
        watch_restarts_total.inc(kind=self.kind)
        backoff = self.BACKOFF_BASE
        last_err = ""
        while not self._stopped.is_set():
            delay = backoff * (0.5 + self._rng.random())
            if self._stopped.wait(delay):
                return None
            try:
                if self._rv and self._can_resume:
                    return self.store.watch(
                        self.api_version, self.kind,
                        send_initial=False, since_rv=self._rv,
                    )
                return self._relist_watch()
            except GoneError:
                try:
                    return self._relist_watch()
                except Exception as e:
                    err = e  # relist itself failed (throttle/outage): back off
            except Exception as e:
                err = e
            # a transient blip heals silently in one backoff step, but a
            # PERSISTENT failure (bad token, dead apiserver) must not spin
            # invisibly forever — log each distinct error once
            if repr(err) != last_err:
                last_err = repr(err)
                log.warning(
                    "informer %s: watch re-establish failed (%r); "
                    "retrying with backoff", self.kind, err,
                )
            backoff = min(backoff * 2, self.BACKOFF_MAX)
        return None

    def _relist_watch(self):
        """Replace cache state via a fresh list: handlers see the DIFF —
        DELETED for keys that vanished while the watch was down, ADDED for
        new keys, MODIFIED upserts for survivors (level-triggered handlers
        re-run; edge-triggered ones see a correct transition). Returns the
        new watch, established from the list's collection RV so no event in
        the gap is missed."""
        if self._can_resume:
            items, rv = self.store.list_raw_with_rv(self.api_version, self.kind)
            w = self.store.watch(
                self.api_version, self.kind, send_initial=False, since_rv=rv
            )
        else:
            # RemoteStore: its watch reflector snapshots internally and
            # streams from THAT snapshot's RV — using its pending events as
            # the list means no separate LIST and, crucially, no window
            # between our list and the watch's own where an event could be
            # lost for good
            w = self.store.watch(self.api_version, self.kind)
            items = [ev.object for ev in w.pending]
            w.pending = []
            rv = ""
        relists_total.inc(kind=self.kind)
        self._mark_synced()  # a relist IS a fresh sync of the cache
        fresh: Dict[str, dict] = {self._key(o): o for o in items}
        with self._lock:
            vanished: List[Tuple[str, dict]] = [
                (k, obj) for k, obj in self._cache.items() if k not in fresh
            ]
            known = set(self._cache)
        for _key, obj in vanished:
            self._dispatch(WatchEvent(DELETED, obj))
        for key, obj in fresh.items():
            self._dispatch(WatchEvent(MODIFIED if key in known else ADDED, obj))
        if rv:
            self._rv = rv
        return w

    def _mark_synced(self) -> None:
        import time

        self.synced.set()
        self.synced_at = time.time()
        informer_synced.set(1.0, kind=self.kind)
        informer_last_sync_timestamp_seconds.set(self.synced_at, kind=self.kind)

    def _dispatch(self, ev: WatchEvent) -> None:
        key = self._key(ev.object)
        rv = ev.object.get("metadata", {}).get("resourceVersion")
        if rv:
            self._rv = rv
        if self._racecheck:
            # the dict entering the cache (and every handler) becomes
            # cache-owned NOW: wrap it in the write barrier so any in-place
            # mutation downstream raises instead of corrupting the cache
            ev = WatchEvent(
                ev.type,
                racecheck.guard_cache_object(ev.object, f"{self.kind}/{key}"),
            )
        with self._lock:
            old = self._cache.get(key)
            if ev.type == DELETED:
                self._cache.pop(key, None)
            else:
                self._cache[key] = ev.object
            handlers = list(self._handlers)
        for h in handlers:
            try:
                h(ev.type, ev.object, old)
            except Exception:  # handler bugs must not kill the watch loop
                import traceback

                traceback.print_exc()

    def stop(self) -> None:
        self._stopped.set()
        if self._watch is not None:
            self._watch.stop()

    # -- cache reads (deep-copied: callers must never mutate the cache) --
    def get(self, namespace: str, name: str) -> Optional[dict]:
        import copy

        key = f"{namespace}/{name}" if namespace else name
        with self._lock:
            obj = self._cache.get(key)
            if obj is None:
                return None
            if self._racecheck:
                # copy-on-read becomes a write barrier: the guarded object
                # is safe to hand out (mutation raises), and skipping the
                # copy is what lets RACECHECK runs catch callers that relied
                # on the defensive deepcopy instead of making their own
                return obj
            return copy.deepcopy(obj)

    def list(self, namespace: Optional[str] = None, labels: Optional[dict] = None) -> List[dict]:
        """Snapshot of matching objects. Filters apply on the RAW cached
        dicts BEFORE the defensive deepcopy — a label-filtered list must not
        pay for copies of every non-matching object cluster-wide."""
        import copy

        from ..apimachinery import match_labels

        with self._lock:
            scanned = len(self._cache)
            out = []
            for o in self._cache.values():
                meta = o.get("metadata", {})
                if namespace is not None and meta.get("namespace", "") != namespace:
                    continue
                if labels is not None and not match_labels(labels, meta.get("labels")):
                    continue
                out.append(o if self._racecheck else copy.deepcopy(o))
        # CPPROFILE=1 scan accounting: every cached list walks the
        # WHOLE flat cache to yield its matches — report scanned-vs-used,
        # attributed to the reconcile/sweep on this thread. Outside the cache
        # lock (one env check inside when disarmed).
        cpprofile.note_scan(self.kind, scanned, len(out))
        return out


class InformerRegistry:
    def __init__(self, store: Store, scheme: Scheme = default_scheme):
        self.store = store
        self.scheme = scheme
        self._informers: Dict[Tuple[str, str], Informer] = {}
        self._lock = racecheck.make_lock("InformerRegistry._lock")
        self._started = False

    def informer_for(self, cls_or_gvk) -> Informer:
        if isinstance(cls_or_gvk, tuple):
            av, kind = cls_or_gvk
        else:
            gvk = self.scheme.gvk_for(cls_or_gvk)
            av, kind = gvk.api_version, gvk.kind
        with self._lock:
            inf = self._informers.get((av, kind))
            if inf is None:
                inf = Informer(self.store, av, kind)
                self._informers[(av, kind)] = inf
                if self._started:
                    inf.start()
            return inf

    def peek(self, api_version: str, kind: str) -> Optional[Informer]:
        """The informer for (api_version, kind) iff it already exists AND
        has synced — never creates or starts one. The read-path lookup for
        CachedClient: cache-backed reads must not implicitly spin up
        watches for kinds no controller asked to watch.

        Deliberately LOCK-FREE (GIL-atomic dict read): peek is called from
        the in-process admission chain, which runs UNDER the Store lock
        (store.update_raw -> webhook handler -> cached read), while
        informer_for holds this registry's lock when it calls store.watch
        (needs the Store lock) — taking the registry lock here closes an
        ABBA deadlock cycle. A racing registration at worst returns None,
        and the caller falls through to a direct read."""
        inf = self._informers.get((api_version, kind))
        if inf is None or not inf.synced.is_set():
            return None
        return inf

    def start_all(self) -> None:
        with self._lock:
            self._started = True
            informers = list(self._informers.values())
        for inf in informers:
            inf.start()
        for inf in informers:
            inf.synced.wait(timeout=5)

    def stop_all(self) -> None:
        with self._lock:
            for inf in self._informers.values():
                inf.stop()
