"""In-pod notebook agent: readiness, device utilization and activity probes
(counterpart of odh_kubeflow_tpu/probe/agent.py, the port's own copy).

The operator's controllers read the workload pod through these routes,
with the same JSON as the reference's agent:

- GET /tpu/readiness   -> {"chips_visible", "chips_expected", "ready",
                           "process_id", "device_health", "chips_failed",
                           "ici_degraded"}: the readiness gate counts every
  host's report,
- GET /tpu/utilization -> {"duty_cycle", "last_busy", "warming"}: the culler
  reclaims a card only when it is both Jupyter-idle and device-idle,
- GET /tpu/checkpoint, /tpu/restore -> the acks of the checkpoint and
  restore hooks (models/checkpoint.py) that suspend, slice repair and an
  InferenceEndpoint's Loading compare,
- GET /api/kernels, /api/terminals -> Jupyter-compatible JSON (served by the
  real Jupyter in production; by this agent in the sim and in bare
  training pods that run no Jupyter).

`TPUMonitor` keeps its name: it is the seam the /tpu/* routes answer
through. `CudaMonitor` reads the CUDA card; `SimTPUMonitor` is scripted
state for tests.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..telemetry import read_allocator_stats, record_device_memory
from ..utils.flightrecorder import recorder

# how long a scraped or nvidia-smi reading is reused: a dead exporter's
# connect timeout, or a slow nvidia-smi, must not land on every probe
READING_TTL_S = 10.0

DeviceReading = List[Tuple[Optional[int], Optional[int]]]


def _utc(ts: float) -> str:
    """Unix timestamp -> RFC3339 (whole seconds, Z suffix, k8s-style)."""
    return (
        datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
        .replace(microsecond=0)
        .isoformat()
        .replace("+00:00", "Z")
    )


class TPUMonitor:
    """Interface: what the agent knows about the local accelerator host.
    (The name is the reference's: the operator's contract is the same for a
    TPU host and a GPU host.)"""

    def chips_visible(self) -> int:
        raise NotImplementedError

    def chips_expected(self) -> int:
        raise NotImplementedError

    def process_id(self) -> int:
        return 0

    def duty_cycle(self) -> float:
        """0.0-1.0 utilization over the recent window."""
        raise NotImplementedError

    def last_busy(self) -> float:
        """Unix timestamp of last observed device activity."""
        raise NotImplementedError

    def warming(self) -> bool:
        """True while the monitor does not yet have a full observation
        window of evidence: consumers must not treat the notebook as idle
        on a warming signal. Default False: monitors whose signal is valid
        from the first read (sim, scraped runtime metrics)."""
        return False

    def device_health(self) -> List[Dict[str, Any]]:
        """Per-local-device health reports, derived from chip visibility by
        default: an expected-but-invisible chip is a dead chip."""
        visible = self.chips_visible()
        expected = self.chips_expected()
        return [
            {"id": i, "healthy": i < visible}
            for i in range(max(visible, expected))
        ]

    def ici_degraded(self) -> bool:
        """True when the host observes degraded chip-to-chip links. No
        monitor here observes links; the sim scripts it."""
        return False


def _uuid_key(uuid: str) -> str:
    # torch prints a card's UUID bare, nvidia-smi with a "GPU-" prefix
    uuid = uuid.strip().lower()
    return uuid[4:] if uuid.startswith("gpu-") else uuid


class NvidiaSmiUtilization:
    """The card's own utilization counter (the counterpart of libtpu's duty
    cycle gauge): `utilization.gpu` from nvidia-smi, the share of the last
    sample period in which a kernel ran, as 0..1, the max over this
    process's cards. Cards are matched by UUID
    (`torch.cuda.get_device_properties(i).uuid`), not by index: under
    CUDA_VISIBLE_DEVICES the two numberings differ. Returns None when
    nvidia-smi is absent or fails, or no card is visible; a reading (None
    included) is reused for `ttl_s`. Never raises."""

    def __init__(self, ttl_s: float = READING_TTL_S):
        self._ttl_s = ttl_s
        self._cache: Tuple[float, Optional[float]] = (float("-inf"), None)
        self._uuids: Optional[List[str]] = None

    def _visible_uuids(self) -> List[str]:
        if self._uuids is None:
            try:
                n = torch.cuda.device_count()
                self._uuids = [_uuid_key(str(torch.cuda.get_device_properties(i).uuid))
                               for i in range(n)]
            except (RuntimeError, AssertionError):
                self._uuids = []
        return self._uuids

    def read(self) -> Optional[float]:
        uuids = self._visible_uuids()
        if not uuids:
            return None
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=uuid,utilization.gpu",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=5, check=True,
            ).stdout
        except (OSError, subprocess.SubprocessError):
            return None
        values = []
        for line in out.splitlines():
            uuid, _, util = line.partition(",")
            if _uuid_key(uuid) in uuids:
                try:
                    values.append(float(util) / 100.0)
                except ValueError:  # "[N/A]" on a card that does not report it
                    continue
        return max(values) if values else None

    def __call__(self) -> Optional[float]:
        ts, cached = self._cache
        if time.time() - ts < self._ttl_s:
            return cached
        value = self.read()
        self._cache = (time.time(), value)
        return value


class CudaMonitor(TPUMonitor):
    """Real implementation over the CUDA card (counterpart of the
    reference's JaxTPUMonitor).

    Duty cycle is a measurement, not an honor system: three sources, the
    best wins (a plain-PyTorch busy loop that never imports this package
    must still read as busy, or the culler would reclaim a working card):

    1. the card's own utilization counter, from nvidia-smi
       (`NvidiaSmiUtilization`), and the runtime-metrics endpoint the
       operator injects as TPU_RUNTIME_METRICS_PORTS, whose `*duty_cycle*`
       gauges are scraped; both are cached for READING_TTL_S;
    2. sampling the caching allocator: a background sampler fingerprints
       each card's `torch.cuda.memory_stats` (bytes allocated and the
       cumulative count of allocation requests); any change between
       samples is device activity, whichever library drove it. The first
       sample only sets the baseline. It reads only once this process has
       initialised CUDA: a sidecar agent must not create a CUDA context
       (hundreds of MB of the card) to read its own empty allocator, so in
       a sidecar only source 1 sees the notebook's work (source 1's UUID
       read initialises torch's CUDA state but creates no context, so the
       sidecar then reads its own allocator, empty and still);
    3. cooperative pings: `record_activity()` around device work.

    Both device readers can be injected: `device_reader() -> [(bytes,
    allocs), ...] or None` and `utilization_reader() -> 0..1 or None`.
    Chips visible are `torch.cuda.device_count()`: a machine with no card
    reports 0 and is never ready; the CPU is never counted as a chip. The
    env is the reference's: NB_TPU_CHIPS_EXPECTED (over NB_TPU_HOSTS hosts)
    and JAX_PROCESS_ID, or in a GPU pod (gpu/env.py) the node rank
    PET_NODE_RANK where JAX_PROCESS_ID is absent."""

    def __init__(
        self,
        chips_expected: Optional[int] = None,
        window_s: float = 120.0,
        metrics_port: Optional[int] = None,
        sample_period_s: float = 5.0,
        device_reader: Optional[Callable[[], Optional[DeviceReading]]] = None,
        utilization_reader: Optional[Callable[[], Optional[float]]] = None,
    ):
        self._expected = chips_expected
        if self._expected is None:
            self._expected = int(os.environ.get("NB_TPU_CHIPS_EXPECTED", "0") or 0)
        self._hosts = int(os.environ.get("NB_TPU_HOSTS", "1") or 1)
        self._process_id = int(os.environ.get("JAX_PROCESS_ID") or os.environ.get("PET_NODE_RANK") or 0)
        self._window_s = window_s
        self._activity: List[Tuple[float, float]] = []  # (timestamp, busy seconds)
        # bring-up counts as activity: a monitor cannot certify idleness it
        # has not observed, so last_busy starts at construction time rather
        # than 0 ("idle since epoch")
        self._last_busy = time.time()
        # set by start_sampling; warming() is True until a full window has
        # elapsed since then
        self._sampling_since: Optional[float] = None
        self._lock = threading.Lock()
        if metrics_port is None:
            ports = os.environ.get("TPU_RUNTIME_METRICS_PORTS", "")
            metrics_port = int(ports.split(",")[0]) if ports.strip() else 0
        self._metrics_port = metrics_port
        self._scrape_cache: Tuple[float, Optional[float]] = (0.0, None)
        self._sample_period_s = sample_period_s
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop = threading.Event()
        self._last_mem: Optional[DeviceReading] = None
        self._primed = False
        self._read_devices = device_reader or read_allocator_stats
        self._read_utilization = utilization_reader or NvidiaSmiUtilization()

    def record_activity(self, busy_seconds: float = 0.0) -> None:
        now = time.time()
        with self._lock:
            self._last_busy = now
            self._activity.append((now, busy_seconds))
            cutoff = now - self._window_s
            self._activity = [(t, b) for t, b in self._activity if t >= cutoff]

    # -- source 1: the card's counter (self._read_utilization) and the
    # runtime-metrics scrape --

    def scrape_runtime_duty_cycle(self) -> Optional[float]:
        """Best `*duty_cycle*` gauge from the runtime-metrics endpoint
        (TPU_RUNTIME_METRICS_PORTS); None when it is absent or unreachable.
        Success and failure are cached for a TTL."""
        if not self._metrics_port:
            return None
        ts, cached = self._scrape_cache
        if time.time() - ts < READING_TTL_S:
            return cached
        import http.client
        import urllib.request

        value: Optional[float] = None
        try:
            # 127.0.0.1 explicitly: `localhost` may resolve to ::1 first and
            # the exporter binds the IPv4 loopback
            with urllib.request.urlopen(
                f"http://127.0.0.1:{self._metrics_port}/metrics", timeout=2
            ) as resp:
                text = resp.read().decode(errors="replace")
            value = parse_duty_cycle_metrics(text)
        except (OSError, http.client.HTTPException):  # URLError is an OSError
            value = None
        self._scrape_cache = (time.time(), value)
        return value

    # -- source 2: allocator sampling --

    def start_sampling(self) -> None:
        """Start the background allocator sampler (idempotent)."""
        if self._sampler is not None and self._sampler.is_alive():
            return
        if self._sampling_since is None:
            self._sampling_since = time.time()
        self._sampler_stop.clear()

        def run() -> None:
            while not self._sampler_stop.wait(self._sample_period_s):
                self.sample_once()

        self._sampler = threading.Thread(
            target=run, name="cuda-activity-sampler", daemon=True
        )
        self._sampler.start()

    def stop_sampling(self) -> None:
        self._sampler_stop.set()

    def sample_once(self) -> bool:
        """One sampler tick; returns True when activity was detected: the
        allocator fingerprint moved since the previous read. Each read also
        publishes per-device memory (telemetry.record_device_memory)."""
        activity = False
        mems = self._read_devices()
        if mems:
            if self._last_mem is not None and mems != self._last_mem:
                activity = True
            self._last_mem = mems
            record_device_memory(mems)
        if not self._primed:
            # the first sample only sets the baseline: pre-existing state
            # must not read as startup activity
            self._primed = True
            return False
        if activity:
            # state moved within the sample period: count the whole period
            # as busy (coarse but workload-agnostic)
            self.record_activity(busy_seconds=self._sample_period_s)
            return True
        return False

    # -- TPUMonitor interface --

    def chips_visible(self) -> int:
        try:
            return torch.cuda.device_count()
        except (RuntimeError, AssertionError):
            return 0

    def chips_expected(self) -> int:
        if self._expected:
            return max(1, self._expected // max(1, self._hosts))
        return self.chips_visible()

    def process_id(self) -> int:
        return self._process_id

    def window_duty_cycle(self) -> float:
        """Sources 2 and 3: busy seconds recorded in the window, over the
        window."""
        with self._lock:
            # prune here too: once activity stops, the window must drain even
            # though record_activity (the other pruning site) never runs again
            cutoff = time.time() - self._window_s
            self._activity = [(t, b) for t, b in self._activity if t >= cutoff]
            busy = sum(b for _, b in self._activity)
            return min(1.0, busy / self._window_s) if self._activity else 0.0

    def duty_cycle(self) -> float:
        sources = (self._read_utilization(), self.scrape_runtime_duty_cycle(),
                   self.window_duty_cycle())
        return max(s or 0.0 for s in sources)

    def last_busy(self) -> float:
        with self._lock:
            return self._last_busy

    def warming(self) -> bool:
        # no idleness verdict before one full window of samples: the
        # sampler's first detection can land arbitrarily late under CPU
        # starvation, and an aggressive culler would otherwise kill a busy
        # notebook during bring-up
        since = self._sampling_since
        return since is None or (time.time() - since) < self._window_s


def parse_duty_cycle_metrics(text: str) -> Optional[float]:
    """Extract a 0..1 duty cycle from Prometheus exposition text: the max of
    any series whose name contains 'duty_cycle', percent-normalized."""
    best: Optional[float] = None
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name = line.split("{")[0].split(" ")[0]
        if "duty_cycle" not in name:
            continue
        try:
            value = float(line.rsplit(None, 1)[-1])
        except ValueError:
            continue
        if "pct" in name or "percent" in name or value > 1.5:
            value /= 100.0
        best = value if best is None else max(best, value)
    return best


@dataclass
class SimTPUMonitor(TPUMonitor):
    """Scriptable monitor for tests. Chip failure is scripted by dropping
    `chips` below `expected`; link degradation via `ici_fault`."""

    chips: int = 4
    expected: int = 4
    pid: int = 0
    duty: float = 0.0
    last_busy_ts: float = 0.0
    ici_fault: bool = False

    def chips_visible(self) -> int:
        return self.chips

    def chips_expected(self) -> int:
        return self.expected

    def process_id(self) -> int:
        return self.pid

    def duty_cycle(self) -> float:
        return self.duty

    def last_busy(self) -> float:
        return self.last_busy_ts

    def ici_degraded(self) -> bool:
        return self.ici_fault


@dataclass
class KernelState:
    """Scriptable Jupyter state (what /api/kernels reports)."""

    kernels: List[Dict[str, Any]] = field(default_factory=list)
    terminals: List[Dict[str, Any]] = field(default_factory=list)

    def set_busy(self) -> None:
        self.kernels = [
            {"id": "k0", "execution_state": "busy", "last_activity": _utc(time.time())}
        ]

    def set_idle(self, last_activity: float) -> None:
        self.kernels = [
            {"id": "k0", "execution_state": "idle", "last_activity": _utc(last_activity)}
        ]


class NotebookAgent:
    """The HTTP server. serve() returns (host, port, close), the kubelet
    sim's PodDecision.serve contract, and works the same as a standalone
    process entrypoint (python -m odh_kubeflow_tpu_torch.probe)."""

    def __init__(
        self,
        monitor: Optional[TPUMonitor] = None,
        kernels: Optional[KernelState] = None,
        base_path: str = "",
        checkpoint_hook: Optional[Callable[[], dict]] = None,
    ):
        self.monitor = monitor or CudaMonitor()
        self.kernels = kernels or KernelState()
        self.base_path = base_path.rstrip("/")
        # checkpoint-before-evict: the slice-repair and suspend controllers
        # GET /tpu/checkpoint; the hook (models/checkpoint.py
        # make_checkpoint_hook) saves the live train state and returns
        # {"step", "checksum"}. None -> saved=False, and the controller
        # proceeds on window expiry instead of an ack.
        self.checkpoint_hook = checkpoint_hook
        # restore-side verification: after resume, and during an
        # InferenceEndpoint's Loading, the controller GETs /tpu/restore; the
        # hook (make_restore_hook) restores the latest checkpoint and acks
        # {"restored", "step", "checksum"}
        self.restore_hook: Optional[Callable[[], dict]] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._serve_lock = threading.Lock()
        self._closed = False
        self._last_ready: Optional[bool] = None  # flight-recorder edge detect
        # who this agent speaks for ("ns/pod"); the standalone entrypoint
        # uses HOSTNAME
        self.identity = os.environ.get("HOSTNAME", "")

    def routes(self, path: str) -> Optional[Dict[str, Any]]:
        if self.base_path and path.startswith(self.base_path):
            path = path[len(self.base_path) :] or "/"
        path = path.split("?")[0]
        if path.endswith("/api/kernels"):
            return {"_raw": self.kernels.kernels}
        if path.endswith("/api/terminals"):
            return {"_raw": self.kernels.terminals}
        if path.endswith("/tpu/readiness"):
            visible = self.monitor.chips_visible()
            expected = self.monitor.chips_expected()
            ici_degraded = self.monitor.ici_degraded()
            ready = expected > 0 and visible >= expected and not ici_degraded
            if ready != self._last_ready:
                # agent-side readiness edge: the device view's own timeline,
                # independent of what the probe gate concluded from it
                self._last_ready = ready
                recorder.record(
                    "probe-agent", pod=self.identity, ready=ready,
                    chips_visible=visible, chips_expected=expected,
                    ici_degraded=ici_degraded,
                )
            return {
                "chips_visible": visible,
                "chips_expected": expected,
                "ready": ready,
                "process_id": self.monitor.process_id(),
                "device_health": self.monitor.device_health(),
                "chips_failed": max(0, expected - visible),
                "ici_degraded": ici_degraded,
            }
        if path.endswith("/tpu/checkpoint"):
            hook = self.checkpoint_hook
            if hook is None:
                return {"saved": False, "reason": "no checkpoint hook configured"}
            try:
                out = hook() or {}
            except Exception as e:
                # degrade into the response: the agent has no logger, and the
                # repair controller treats a failed save as "proceed on
                # window expiry" rather than blocking the evict forever
                return {"saved": False, "reason": f"checkpoint hook failed: {e!r}"}
            return {
                "saved": True,
                "step": out.get("step"),
                "checksum": out.get("checksum"),
            }
        if path.endswith("/tpu/restore"):
            hook = self.restore_hook
            if hook is None:
                return {"restored": False, "reason": "no restore hook configured"}
            try:
                out = hook() or {}
            except Exception as e:
                # same degrade-into-the-response contract as the checkpoint
                # hook: an unverifiable restore is reported, never a 500
                return {"restored": False, "reason": f"restore hook failed: {e!r}"}
            return {
                "restored": bool(out.get("restored", True)),
                "step": out.get("step"),
                "checksum": out.get("checksum"),
                "reason": out.get("reason"),
            }
        if path.endswith("/tpu/utilization"):
            lb = self.monitor.last_busy()
            return {
                "duty_cycle": self.monitor.duty_cycle(),
                "last_busy": _utc(lb) if lb else "",
                "warming": self.monitor.warming(),
            }
        if path.endswith("/healthz"):
            return {"status": "ok"}
        return None

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        agent = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                payload = agent.routes(self.path)
                if payload is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = json.dumps(
                    payload["_raw"] if "_raw" in payload else payload
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:
                pass

        # race-safe and idempotent against a concurrent or earlier close():
        # a live agent returns its existing endpoint (no duplicate servers
        # when the kubelet retries), and a closed agent stays closed and
        # returns port 0, the explicit "no listener" sentinel: a freed
        # ephemeral port may by now belong to an unrelated server
        with self._serve_lock:
            if self._closed:
                return (host, 0, self.close)
            if self._server is not None:
                return (host, self._server.server_port, self.close)
            server = ThreadingHTTPServer((host, port), Handler)
            self._server = server
        # measured duty cycle by default: monitors that sample do so from
        # the moment the probe serves (and only for a started server)
        if hasattr(self.monitor, "start_sampling"):
            self.monitor.start_sampling()
        threading.Thread(
            target=server.serve_forever, name="notebook-agent", daemon=True
        ).start()
        return (host, server.server_port, self.close)

    def close(self) -> None:
        with self._serve_lock:
            server, self._server = self._server, None
            self._closed = True
        if hasattr(self.monitor, "stop_sampling"):
            self.monitor.stop_sampling()  # symmetric with serve()'s start
        if server is not None:
            server.shutdown()
            # release the listening socket: probes to the old port fail
            # fast instead of hanging on a half-dead listener
            server.server_close()
