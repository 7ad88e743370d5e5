"""RACECHECK=1: the opt-in lock-order checker (the port's copy of the
lock-order half of odh_kubeflow_tpu/utils/racecheck.py).

Every instrumented acquisition records an edge from each lock the thread
already holds to the one it is taking. Before blocking, the global
acquisition graph is checked: if the new edge closes a cycle,
`LockOrderError` raises deterministically, the first time both orders have
been seen, not in the rare run where two threads interleave into the
deadlock. Re-acquiring a non-reentrant lock the thread already holds raises
too, instead of deadlocking.

Zero cost when off: `make_lock`/`make_rlock` return plain threading
primitives unless RACECHECK is set when the lock is made. The tracing,
flow-control, breaker and router copies of the port take their locks here.
The reference's informer-cache write barrier is control plane and is not
copied.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple


def enabled() -> bool:
    return os.environ.get("RACECHECK", "") not in ("", "0", "false")


class LockOrderError(RuntimeError):
    """A lock acquisition would establish an order that inverts one already
    observed: a potential ABBA deadlock, reported deterministically."""


class OrderGraph:
    """Global directed graph of observed lock-acquisition orders, plus a
    per-thread stack of currently-held instrumented locks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # edge A -> B: a thread holding A acquired B, with the first site seen
        self._edges: Dict[str, Dict[str, str]] = {}
        self._tls = threading.local()

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def reset(self) -> None:
        """Drop all recorded edges (test isolation)."""
        with self._mu:
            self._edges.clear()

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A recorded acquisition path src -> ... -> dst, if any."""
        stack: List[Tuple[str, List[str]]] = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, {}):
                if nxt == dst:
                    return path + [dst]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def before_acquire(self, name: str, reentrant: bool) -> None:
        held = self._held()
        if name in held:
            if reentrant:
                return
            raise LockOrderError(
                f"re-entrant acquisition of non-reentrant lock {name!r} "
                f"(held stack: {held}): this thread would deadlock on itself"
            )
        with self._mu:
            for h in held:
                if h == name:
                    continue
                # adding h -> name closes a cycle iff name already reaches h
                inverse = self._path(name, h)
                if inverse is not None:
                    raise LockOrderError(
                        f"lock-order inversion: acquiring {name!r} while "
                        f"holding {h!r}, but the order "
                        f"{' -> '.join(inverse)} was already observed "
                        f"(first at {self._edges[inverse[0]][inverse[1]]}): "
                        f"potential ABBA deadlock"
                    )
            site = threading.current_thread().name
            for h in held:
                self._edges.setdefault(h, {}).setdefault(name, site)

    def after_acquire(self, name: str) -> None:
        self._held().append(name)

    def on_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return


_global_graph = OrderGraph()


def reset() -> None:
    """Clear the global acquisition graph (between tests)."""
    _global_graph.reset()


class RaceCheckLock:
    """Drop-in lock with acquisition-order auditing; context-manager and
    acquire/release compatible with threading.Lock / RLock."""

    def __init__(self, name: str, reentrant: bool = False,
                 graph: Optional[OrderGraph] = None):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._graph = graph or _global_graph

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._graph.before_acquire(self.name, self.reentrant)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._graph.after_acquire(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._graph.on_release(self.name)

    def __enter__(self) -> "RaceCheckLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


def make_lock(name: str) -> Any:
    """An instrumented Lock under RACECHECK=1, a plain threading.Lock
    otherwise."""
    return RaceCheckLock(name) if enabled() else threading.Lock()


def make_rlock(name: str) -> Any:
    return RaceCheckLock(name, reentrant=True) if enabled() else threading.RLock()
