"""TORCHGUARD=1: the opt-in transfer and compile guard of the port's data
plane (counterpart of odh_kubeflow_tpu/utils/jaxguard.py, armed by its own
environment variable, TORCHGUARD). Budgets come from the region table in
`utils/hotregions.py`.

1. **Transfer count and budget.** Every device->host copy of the data
   plane goes through `to_host()`, which counts it (`transfer_count()` for
   the process, `thread_transfer_count()` for the calling thread). Inside
   an armed `region(...)` each entry gets the region's `transfer_budget`
   copies; the copy over budget raises `HostTransferError` before it
   copies. `allow_transfer()` is the audited escape.
2. **Hidden syncs.** A sync that does not go through `to_host()` (an
   `.item()`, a blocking upload) is caught by torch's sync debug mode: an
   armed CUDA region with transfer budget 0, or any region built with
   `check_syncs=True`, runs with `torch.cuda.set_sync_debug_mode("error")`,
   so a hidden sync inside it raises.
3. **Compile budget.** `record_compile(name)` counts a compile (a
   CUDA-graph capture, a compiled program) against the region;
   `compile_count(name)` reads the process total. An armed region object
   that has seen more than its `compile_budget` raises `CompileBudgetError`
   at exit. Nothing compiles on the port's paths yet, so the counts read 0.

The reference's `DonationError` has no counterpart: the port updates its
buffers in place and donates nothing.

**One switch for the whole process.** The sync debug mode is global to the
process, not to a thread. Two engines on two threads (a router's replicas)
would otherwise break each other: one engine's post-burst copy raises
inside the other's "error" window, and one engine's restore of the mode
ends the other's window early. So one process-wide lock (`_sync_lock`) is
held for the whole of every "error" window and for every copy `to_host()`
makes: a window and a counted copy never overlap, and windows never nest
across threads, so each window sets "error" from the mode it found and
restores it. A copy the window's own thread makes inside it (under
`allow_transfer()`) lifts the mode for that copy alone. What this asks of
the code around it: every sync that may run while another thread holds a
window goes through `to_host()`; the engine's uploads are pinned and
non-blocking, so they do not sync.

Zero cost when off: `region` pays one env check per entry, unless the
caller asked for `check_syncs`.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import hotregions, profiler, racecheck


def enabled() -> bool:
    return os.environ.get("TORCHGUARD", "") not in ("", "0", "false")


class CompileBudgetError(RuntimeError):
    """A region compiled past its declared compile budget."""


class HostTransferError(RuntimeError):
    """A device->host copy inside an armed region exceeded the region's
    per-entry transfer budget."""


_mu = threading.Lock()
_compiles: Dict[str, int] = {}  # region name -> total compiles (stats)
_transfers = 0  # total copies through to_host
_tls = threading.local()
# held across every "error" window and every counted copy (module docstring)
_sync_lock = racecheck.make_rlock("torchguard._sync_lock")


def _region_stack() -> List["region"]:
    stack = getattr(_tls, "regions", None)
    if stack is None:
        stack = _tls.regions = []
    return stack


def compile_count(name: str) -> int:
    """Total compiles attributed to `name` since process start (monotonic:
    consumers snapshot and diff; see ServingEngine.stats())."""
    with _mu:
        return _compiles.get(name, 0)


def transfer_count() -> int:
    """Total copies made through `to_host()` in this process."""
    with _mu:
        return _transfers


def thread_transfer_count() -> int:
    """Copies made through `to_host()` by the calling thread: an engine
    counts its burst's copies with it, whatever other engines copy."""
    return getattr(_tls, "transfers", 0)


def reset() -> None:
    """Clear the counters (test isolation); active regions belong to their
    owners and stay."""
    global _transfers
    with _mu:
        _compiles.clear()
        _transfers = 0
    _tls.transfers = 0


def record_compile(name: str, duration_s: float = 0.0) -> None:
    """One compile attributed to region `name`: counted for the process and
    against the innermost armed region object on this thread (its budget),
    and timed for the profiler."""
    hotregions.get(name)
    with _mu:
        _compiles[name] = _compiles.get(name, 0) + 1
    stack = _region_stack()
    if stack:
        stack[-1]._compiles_seen += 1
    if profiler.enabled():
        profiler.on_compile(name, duration_s)


def to_host(t: torch.Tensor) -> np.ndarray:
    """The data plane's one device->host copy: counted, held to the
    innermost armed region's transfer budget (raising before it copies),
    and made under the process-wide sync lock."""
    global _transfers
    with _mu:
        _transfers += 1
    _tls.transfers = getattr(_tls, "transfers", 0) + 1
    stack = _region_stack()
    if stack and not getattr(_tls, "allow_depth", 0):
        top = stack[-1]
        top._entry_transfers += 1
        budget = top.spec.transfer_budget
        if budget is not None and top._entry_transfers > budget:
            raise HostTransferError(
                f"device->host copy inside guarded region {top.name!r}: "
                f"{top._entry_transfers} copies this entry, budget {budget} "
                f"(utils/hotregions.py); move the copy out of the region, "
                f"batch it into the post-region drain, or wrap an audited "
                f"exception in torchguard.allow_transfer()"
            )
    with _sync_lock:
        if not getattr(_tls, "windows", 0):
            return t.cpu().numpy()
        # this thread's own window: lift "error" for this one copy
        torch.cuda.set_sync_debug_mode("default")
        try:
            return t.cpu().numpy()
        finally:
            torch.cuda.set_sync_debug_mode("error")


class allow_transfer:
    """Copies inside do not count against the enclosing region's budget:
    the audited escape."""

    def __enter__(self) -> "allow_transfer":
        _tls.allow_depth = getattr(_tls, "allow_depth", 0) + 1
        return self

    def __exit__(self, *exc: Any) -> None:
        _tls.allow_depth -= 1


class region:
    """A reusable guarded region bound to a hot-region declaration. Hold one
    instance per consumer (an engine keeps `_burst_guard` for its
    lifetime), so the compile budget is judged per consumer.

    `device` is where the region's work runs; on CUDA, an armed region with
    transfer budget 0, or any region with `check_syncs=True`, is an "error"
    window (module docstring). Disarmed and without `check_syncs` it only
    reports to the profiler."""

    def __init__(self, name: str, device: Optional[torch.device] = None,
                 check_syncs: bool = False):
        self.name = name
        self.spec = hotregions.get(name)
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self.check_syncs = check_syncs
        self._compiles_seen = 0
        self._entry_transfers = 0
        self._armed = False
        self._window: Optional[Any] = None
        self._prof_token: Any = None

    @property
    def compiles(self) -> int:
        """Compiles attributed to this consumer while armed."""
        return self._compiles_seen

    def __enter__(self) -> "region":
        self._prof_token = profiler.region_enter(self.name)
        self._armed = enabled()
        if self._armed:
            self._entry_transfers = 0
            _region_stack().append(self)
        if self._cuda and (self.check_syncs or (self._armed and self.spec.transfer_budget == 0)):
            _sync_lock.acquire()
            self._window = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            _tls.windows = getattr(_tls, "windows", 0) + 1
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        if self._window is not None:
            prev, self._window = self._window, None
            _tls.windows -= 1
            torch.cuda.set_sync_debug_mode(prev)
            _sync_lock.release()
        token, self._prof_token = self._prof_token, None
        profiler.region_exit(token)
        if not self._armed:
            return
        self._armed = False
        stack = _region_stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            return  # don't shadow the failure inside the region
        budget = self.spec.compile_budget
        if budget is not None and self._compiles_seen > budget:
            raise CompileBudgetError(
                f"guarded region {self.name!r} has compiled "
                f"{self._compiles_seen} time(s), compile budget {budget} "
                f"(utils/hotregions.py): something recompiles at steady state"
            )
