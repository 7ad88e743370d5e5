"""The port's probe agent (odh_kubeflow_tpu_torch.probe), device reads and
workload telemetry on the CPU.

- Route parity: for the same scripted monitor state, every route of the
  port's `NotebookAgent` returns the reference agent's JSON, and the
  readiness edge lands in the flight-recorder ring with the same fields.
- `CudaMonitor` with injected device readers (the allocator fingerprint and
  the card's utilization counter): baseline, activity, best source, warming,
  the window's drain, the env, and no read before CUDA is initialised.
- `NvidiaSmiUtilization` and `parse_duty_cycle_metrics` never raise.
- The JAX package's operator (its manager and culler over SimCluster) reads
  the port's agent: a busy card keeps the notebook alive, an idle one is
  culled (tests/test_duty_cycle.py's acceptance test, same parameters).
"""
import json
import subprocess
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import pytest
import torch

import torch_threads
from odh_kubeflow_tpu.probe import agent as ref
from odh_kubeflow_tpu.runtime.flightrecorder import recorder as ref_recorder
from odh_kubeflow_tpu_torch import device, telemetry
from odh_kubeflow_tpu_torch.models import TransformerConfig, init_params
from odh_kubeflow_tpu_torch.probe import agent
from odh_kubeflow_tpu_torch.serving.engine import ServingEngine
from odh_kubeflow_tpu_torch.runtime.flightrecorder import recorder

torch_threads.cap()

NOW = 1_760_000_000.0


def _pair(**monitor):
    """(reference agent, port agent) over the same scripted monitor state and
    the same Jupyter state."""
    agents = []
    for mod in (ref, agent):
        kernels = mod.KernelState(terminals=[{"name": "1"}])
        kernels.set_idle(NOW - 3600)
        agents.append(mod.NotebookAgent(monitor=mod.SimTPUMonitor(**monitor), kernels=kernels,
                                        base_path="/notebook/ns/nb/"))
    return agents


ROUTES = ["/api/kernels", "/api/terminals", "/tpu/readiness", "/tpu/utilization", "/healthz",
          "/tpu/checkpoint", "/tpu/restore", "/nope", "/notebook/ns/nb/tpu/readiness?x=1",
          "/notebook/ns/nb/api/kernels?token=abc", "/notebook/ns/nb", "/notebook/ns/nb/"]
STATES = {
    "ready": dict(chips=4, expected=4, pid=1, duty=0.25, last_busy_ts=NOW),
    "chip lost": dict(chips=3, expected=4, duty=0.0, last_busy_ts=0.0),
    "ici degraded": dict(chips=4, expected=4, ici_fault=True),
    "nothing expected": dict(chips=0, expected=0),
}


@pytest.mark.parametrize("state", STATES, ids=list(STATES))
@pytest.mark.parametrize("path", ROUTES)
def test_routes_equal_the_reference(state, path):
    jax_agent, port_agent = _pair(**STATES[state])
    assert port_agent.routes(path) == jax_agent.routes(path)


def _ok_hook():
    return {"step": 12, "checksum": "0123456789abcdef"}


def _failing_hook():
    raise RuntimeError("disk full")


HOOKS = {
    "working": _ok_hook,
    "raising": _failing_hook,
    "no checkpoint": lambda: {"restored": False, "reason": "no checkpoint under '/ckpt'"},
    "empty ack": lambda: None,
}


@pytest.mark.parametrize("hook", HOOKS, ids=list(HOOKS))
@pytest.mark.parametrize("route", ["/tpu/checkpoint", "/tpu/restore"])
def test_hook_routes_equal_the_reference(hook, route):
    jax_agent, port_agent = _pair()
    for a in (jax_agent, port_agent):
        a.checkpoint_hook = HOOKS[hook]
        a.restore_hook = HOOKS[hook]
    assert port_agent.routes(route) == jax_agent.routes(route)


def test_readiness_edges_reach_the_ring_with_the_reference_fields():
    jax_agent, port_agent = _pair(chips=3, expected=4)
    for a in (jax_agent, port_agent):
        a.identity = "ns/nb-0"
    got = []
    for a, ring in ((jax_agent, ref_recorder), (port_agent, recorder)):
        before = len(ring.records("probe-agent"))
        a.routes("/tpu/readiness")
        a.routes("/tpu/readiness")  # no edge: not recorded again
        a.monitor.chips = 4
        a.routes("/tpu/readiness")
        new = ring.records("probe-agent")[before:]
        got.append([{k: v for k, v in r.items() if k != "t"} for r in new
                    if r.get("pod") == "ns/nb-0"])
    assert len(got[1]) == 2 and [r["ready"] for r in got[1]] == [False, True]
    assert got[1] == got[0]


def test_serve_and_close_are_idempotent():
    a = agent.NotebookAgent(monitor=agent.SimTPUMonitor())
    host, port, close = a.serve()
    assert port != 0
    assert a.serve()[1] == port, "a live agent returns its endpoint, no second server"
    with urllib.request.urlopen(f"http://{host}:{port}/tpu/readiness", timeout=10) as resp:
        assert json.loads(resp.read())["ready"] is True
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=10)
    assert err.value.code == 404
    close()
    close()
    assert a.serve()[1] == 0, "a closed agent stays closed: port 0"
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=2)


def test_close_before_serve_returns_port_0():
    a = agent.NotebookAgent(monitor=agent.SimTPUMonitor())
    a.close()
    assert a.serve()[1] == 0


class ScriptedCard:
    """A device reader: one card whose allocator a worker advances."""

    def __init__(self):
        self.allocs = 0
        self.bytes = 1 << 20
        self.reads = 0

    def alloc(self, nbytes=4096):
        self.allocs += 1
        self.bytes += nbytes

    def __call__(self):
        self.reads += 1
        return [(self.bytes, self.allocs)]


def monitor(card=None, util=None, **kw):
    return agent.CudaMonitor(metrics_port=0, device_reader=card or ScriptedCard(),
                             utilization_reader=util or (lambda: None), **kw)


def test_first_sample_sets_the_baseline():
    card = ScriptedCard()
    mon = monitor(card, window_s=10.0, sample_period_s=0.5)
    card.alloc()
    assert mon.sample_once() is False, "the first sample only sets the baseline"
    assert mon.window_duty_cycle() == 0.0
    assert mon.sample_once() is False, "a stable fingerprint is no activity"


def test_a_changed_fingerprint_is_activity_and_publishes_memory():
    card = ScriptedCard()
    mon = monitor(card, window_s=10.0, sample_period_s=0.5)
    mon.sample_once()
    before = mon.last_busy()
    time.sleep(0.01)
    card.alloc(0)  # a request served from the cache: bytes unchanged, count moves
    assert mon.sample_once() is True
    assert mon.window_duty_cycle() == pytest.approx(0.05)
    assert mon.last_busy() > before
    assert telemetry.device_memory_bytes.value(device="0") == card.bytes
    assert mon.sample_once() is False


def test_no_reading_before_cuda_is_initialised_is_no_activity():
    readings = [None, None, [(10, 1)], [(10, 1)], [(10, 2)]]
    mon = monitor(lambda: readings.pop(0), window_s=10.0, sample_period_s=1.0)
    assert [mon.sample_once() for _ in range(5)] == [False, False, False, False, True]


def test_the_best_source_wins():
    card = ScriptedCard()
    util = SimpleNamespace(value=None)
    mon = monitor(card, util=lambda: util.value, window_s=10.0, sample_period_s=2.0)
    assert mon.duty_cycle() == 0.0
    mon.sample_once()
    card.alloc()
    mon.sample_once()  # 2 s busy in a 10 s window
    assert mon.duty_cycle() == pytest.approx(0.2)
    util.value = 0.65
    assert mon.duty_cycle() == pytest.approx(0.65)
    util.value = 0.1
    assert mon.duty_cycle() == pytest.approx(0.2)


def test_scraped_runtime_metrics_are_a_source():
    """tests/test_duty_cycle.py::test_scrape_libtpu_metrics_port, port side."""
    payload = b"# TYPE x gauge\ntpu_device_duty_cycle_percent 87.0\n"

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        mon = agent.CudaMonitor(metrics_port=srv.server_address[1], device_reader=ScriptedCard(),
                                utilization_reader=lambda: 0.5)
        assert mon.scrape_runtime_duty_cycle() == pytest.approx(0.87)
        assert mon.duty_cycle() == pytest.approx(0.87)
    finally:
        srv.shutdown()
        srv.server_close()
    dead = agent.CudaMonitor(metrics_port=srv.server_address[1], device_reader=ScriptedCard(),
                             utilization_reader=lambda: None)
    assert dead.scrape_runtime_duty_cycle() is None


def test_warming_until_one_window_of_samples():
    mon = monitor(window_s=0.3, sample_period_s=0.05)
    assert mon.warming(), "no idleness verdict before sampling starts"
    mon.start_sampling()
    try:
        assert mon.warming()
        time.sleep(0.4)
        assert not mon.warming()
    finally:
        mon.stop_sampling()


def test_the_window_drains_once_activity_stops():
    mon = monitor(window_s=0.3, sample_period_s=0.05)
    mon.record_activity(busy_seconds=0.3)
    assert mon.duty_cycle() == pytest.approx(1.0)
    time.sleep(0.4)
    assert mon.duty_cycle() == 0.0


def test_the_sampler_thread_sees_a_busy_card():
    card = ScriptedCard()
    mon = monitor(card, window_s=5.0, sample_period_s=0.02)
    mon.start_sampling()
    try:
        deadline = time.monotonic() + 10
        while mon.window_duty_cycle() == 0.0 and time.monotonic() < deadline:
            card.alloc()
            time.sleep(0.005)
        assert mon.window_duty_cycle() > 0.0
    finally:
        mon.stop_sampling()


def test_env_hosts_division_and_process_id(monkeypatch):
    monkeypatch.setenv("NB_TPU_CHIPS_EXPECTED", "8")
    monkeypatch.setenv("NB_TPU_HOSTS", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    mon = monitor()
    assert mon.chips_expected() == 4 and mon.process_id() == 1
    monkeypatch.setenv("NB_TPU_CHIPS_EXPECTED", "1")
    monkeypatch.setenv("NB_TPU_HOSTS", "4")
    assert monitor().chips_expected() == 1
    monkeypatch.delenv("NB_TPU_CHIPS_EXPECTED")
    monkeypatch.delenv("NB_TPU_HOSTS")
    monkeypatch.delenv("JAX_PROCESS_ID")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mon = monitor()
    assert mon.chips_expected() == 2 and mon.process_id() == 0


@pytest.mark.parametrize("node_rank", [0, 1])
def test_readiness_reports_the_node_rank_under_the_gpu_pod_env(monkeypatch, node_rank):
    """A GPU pod's sidecar gets gpu_env + ordinal_env (PET_NODE_RANK from the
    pod index) and no JAX_PROCESS_ID: the readiness route reports the node
    rank, and one host's cards as expected; JAX_PROCESS_ID still wins."""
    from odh_kubeflow_tpu_torch.gpu import gpu_env, ordinal_env, plan_slice

    shape = plan_slice("h100", topology="2x8")
    for e in gpu_env(shape, "nb", "nb-hosts", "user"):
        monkeypatch.setenv(e["name"], e["value"])
    (rank_env,) = ordinal_env()
    monkeypatch.setenv(rank_env["name"], str(node_rank))  # the downward API's value
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    ready = agent.NotebookAgent(monitor=monitor()).routes("/tpu/readiness")
    assert ready["process_id"] == node_rank
    assert ready["chips_expected"] == 8 and ready["chips_visible"] == 8 and ready["ready"] is True
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    assert agent.NotebookAgent(monitor=monitor()).routes("/tpu/readiness")["process_id"] == 3


def test_the_cpu_is_never_a_chip():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: this machine has chips")
    a = agent.NotebookAgent(monitor=monitor(chips_expected=1))
    ready = a.routes("/tpu/readiness")
    assert ready["chips_visible"] == 0 and ready["ready"] is False
    assert ready["device_health"] == [{"id": 0, "healthy": False}]
    assert ready["chips_failed"] == 1


def test_a_faked_card_is_ready(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    a = agent.NotebookAgent(monitor=monitor(chips_expected=1))
    ready = a.routes("/tpu/readiness")
    assert ready["chips_visible"] == 1 and ready["ready"] is True
    assert ready["device_health"] == [{"id": 0, "healthy": True}]


def test_allocator_reader_reads_nothing_before_cuda_init(monkeypatch):
    calls = []

    def memory_stats(i):
        calls.append(i)
        return {"allocated_bytes.all.current": 512, "allocation.all.allocated": 3}

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert telemetry.read_allocator_stats() is None
    assert telemetry.update_device_memory() == 0
    assert calls == [], "no allocator read before this process initialised CUDA"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert telemetry.read_allocator_stats() == [(512, 3)]
    assert telemetry.update_device_memory() == 1
    assert telemetry.device_memory_bytes.value(device="0") == 512.0


def test_nvidia_smi_reader_matches_cards_by_uuid_and_never_raises(monkeypatch):
    uuids = ["5ab1c7e0-aaaa-bbbb-cccc-000000000001"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(uuids))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(uuid=uuids[i]))
    runs = []

    def fake_run(cmd, **kw):
        runs.append(cmd)
        # nvidia-smi's own order is not CUDA's: the visible card is listed second
        return SimpleNamespace(stdout="GPU-5ab1c7e0-aaaa-bbbb-cccc-000000000000, 97\n"
                                      "GPU-5AB1C7E0-aaaa-bbbb-cccc-000000000001, 42\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    reader = agent.NvidiaSmiUtilization(ttl_s=60.0)
    assert reader() == pytest.approx(0.42)
    assert reader() == pytest.approx(0.42) and len(runs) == 1, "cached for the TTL"
    assert "--query-gpu=uuid,utilization.gpu" in runs[0]

    for error in (FileNotFoundError("nvidia-smi"), subprocess.CalledProcessError(9, "nvidia-smi"),
                  subprocess.TimeoutExpired("nvidia-smi", 5)):
        def failing(cmd, error=error, **kw):
            raise error

        monkeypatch.setattr(subprocess, "run", failing)
        assert agent.NvidiaSmiUtilization(ttl_s=0.0)() is None
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: SimpleNamespace(
        stdout="GPU-5ab1c7e0-aaaa-bbbb-cccc-000000000001, [N/A]\n"))
    assert agent.NvidiaSmiUtilization(ttl_s=0.0)() is None


def test_nvidia_smi_reader_without_a_card_is_none():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: this machine has a card")
    assert agent.NvidiaSmiUtilization()() is None


METRICS_TEXTS = [
    """
# HELP tpu_runtime_duty_cycle_pct Duty cycle percent.
# TYPE tpu_runtime_duty_cycle_pct gauge
tpu_runtime_duty_cycle_pct{chip="0"} 62.5
tpu_runtime_duty_cycle_pct{chip="1"} 41.0
memory_bandwidth_util 0.9
""",
    "tensorcore_duty_cycle 0.25\n",
    "unrelated_metric 5\n",
    "",
    "gpu_duty_cycle{gpu=\"0\"} not-a-number\n",
]


@pytest.mark.parametrize("text", METRICS_TEXTS)
def test_parse_duty_cycle_metrics_equals_the_reference(text):
    assert agent.parse_duty_cycle_metrics(text) == ref.parse_duty_cycle_metrics(text)


def test_parse_duty_cycle_metrics_variants():
    """tests/test_duty_cycle.py::test_parse_duty_cycle_metrics_variants."""
    assert agent.parse_duty_cycle_metrics(METRICS_TEXTS[0]) == pytest.approx(0.625)
    assert agent.parse_duty_cycle_metrics(METRICS_TEXTS[1]) == pytest.approx(0.25)
    assert agent.parse_duty_cycle_metrics(METRICS_TEXTS[2]) is None
    assert agent.parse_duty_cycle_metrics("") is None


def test_device_reads_give_the_reason_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: this machine has a card")
    devices, reason = device.probe_devices()
    assert devices == [] and "CUDA is not available" in reason
    present, reason = device.accelerator_present()
    assert present is False and "CUDA is not available" in reason


def test_device_reads_never_raise(monkeypatch):
    def broken():
        raise RuntimeError("CUDA init failed")

    monkeypatch.setattr(torch.cuda, "is_available", broken)
    assert device.probe_devices() == ([], "CUDA device query failed: RuntimeError('CUDA init failed')")
    assert device.accelerator_present()[0] is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device.probe_devices() == ([torch.device("cuda", 0), torch.device("cuda", 1)], None)
    assert device.accelerator_present() == (True, None)


def test_engine_observes_decode_steps_once_per_burst():
    cfg = TransformerConfig(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                            max_seq=64, dtype=torch.float32, use_flash=True, remat=False)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    engine = ServingEngine(params, cfg, max_slots=2, max_seq=64, decode_burst=4, device="cpu")
    before = telemetry.snapshot()["tpu_decode_step_duration_seconds"]["count"]
    for p in ([1, 2, 3], [4, 5]):
        engine.submit(p, max_new=9)
    assert engine.run_until_idle(timeout=120)
    after = telemetry.snapshot()["tpu_decode_step_duration_seconds"]["count"]
    # 9 tokens: the first from the prefill, 8 in two bursts of 4
    assert after - before == 2
    assert telemetry.tokens_per_second.value(phase="decode") > 0


def test_telemetry_families_keep_the_reference_names():
    from odh_kubeflow_tpu.tpu import telemetry as ref_telemetry

    for family in telemetry.FAMILIES:
        theirs = getattr(ref_telemetry, {
            "tpu_train_step_duration_seconds": "train_step_seconds",
            "tpu_decode_step_duration_seconds": "decode_step_seconds",
            "tpu_tokens_per_second": "tokens_per_second",
            "tpu_mfu": "mfu",
            "tpu_device_memory_bytes": "device_memory_bytes",
        }[family.name])
        assert (family.name, family.help) == (theirs.name, theirs.help)
        if hasattr(family, "buckets"):
            assert tuple(family.buckets) == tuple(theirs.buckets)
        else:
            assert tuple(family.labels) == tuple(theirs.label_names)
    telemetry.observe_train_step(0.5, tokens=1000, mfu_est=0.3)
    assert telemetry.tokens_per_second.value(phase="train") == 2000.0
    assert telemetry.mfu.value(phase="train") == 0.3


def test_the_jax_operator_culls_a_port_notebook_only_once_its_card_is_idle(monkeypatch):
    """tests/test_duty_cycle.py::test_plain_jax_busy_loop_survives_aggressive_culler
    with the port's agent: Jupyter kernels idle for an hour, the culler
    firing every 100 ms with a 1 s idle threshold; a worker advancing the
    scripted card's allocator keeps the notebook alive. Once it stops, the
    same notebook is culled."""
    _culled_only_once_idle(monkeypatch, "odh_kubeflow_tpu", ("v5e", "2x2"))


def test_the_ports_operator_culls_a_port_notebook_only_once_its_card_is_idle(monkeypatch):
    """The same through the port's own `build_manager` on an h100 1x4
    slice: the port's culler keeps the notebook while the card is busy and
    culls it once it is idle."""
    _culled_only_once_idle(monkeypatch, "odh_kubeflow_tpu_torch", ("h100", "1x4"))


def _culled_only_once_idle(monkeypatch, package, slice_):
    import importlib

    Container = importlib.import_module(f"{package}.api.core").Container
    notebook_api = importlib.import_module(f"{package}.api.notebook")
    Notebook, TPUSpec = notebook_api.Notebook, notebook_api.TPUSpec
    SimCluster = importlib.import_module(f"{package}.cluster").SimCluster
    PodDecision = importlib.import_module(f"{package}.cluster.kubelet").PodDecision
    controllers = importlib.import_module(f"{package}.controllers")
    Config, C = controllers.Config, controllers.constants
    build_manager = importlib.import_module(f"{package}.main").build_manager
    accounting = importlib.import_module(f"{package}.runtime.accounting")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)  # the faked device list
    # build_manager installs its chip accountant process-wide
    # (accounting.set_current); put back whatever was there at teardown, or
    # the next test in this process freezes this one's ledger into its
    # flight-recorder bundles
    monkeypatch.setattr(accounting, "_current", accounting.current())
    cluster = SimCluster().start()
    if package == "odh_kubeflow_tpu":
        cluster.add_tpu_pool("v5e", *slice_, slices=2)
    else:
        cluster.add_gpu_pool("h100", *slice_, slices=2)
    card = ScriptedCard()
    agents = {}

    def port_monitor_behavior(pod):
        if not pod.metadata.labels.get(C.NOTEBOOK_NAME_LABEL):
            return None
        key = pod.metadata.name
        if key not in agents:
            kernels = agent.KernelState()
            kernels.set_idle(time.time() - 3600)  # Jupyter says: idle for 1h
            mon = agent.CudaMonitor(chips_expected=4, metrics_port=0, window_s=5.0,
                                    sample_period_s=0.05, device_reader=card,
                                    utilization_reader=lambda: None)
            agents[key] = agent.NotebookAgent(monitor=mon, kernels=kernels)
        return PodDecision(serve=lambda p: agents[key].serve())

    cluster.add_pod_behavior(port_monitor_behavior)
    config = Config(
        enable_culling=True,
        cull_idle_time_min=1.0 / 60.0,  # 1s idle threshold
        idleness_check_period_min=0.1 / 60.0,  # 100ms cadence
        tpu_idle_threshold=0.005,
        readiness_probe_period_s=0.2,
    )
    mgr = build_manager(cluster.store, config, http_get=cluster.http_get)
    mgr.start()
    stop_work = threading.Event()

    def busy_loop():
        while not stop_work.is_set():
            card.alloc()
            time.sleep(0.01)

    worker = threading.Thread(target=busy_loop, daemon=True)
    worker.start()
    try:
        nb = Notebook()
        nb.metadata.name = "busy-nb"
        nb.metadata.namespace = "u"
        nb.spec.template.spec.containers = [Container(name="busy-nb", image="torch:1")]
        nb.spec.tpu = TPUSpec(accelerator=slice_[0], topology=slice_[1])
        cluster.client.create(nb)

        def annotations():
            return cluster.client.get(Notebook, "u", "busy-nb").metadata.annotations

        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if C.STOP_ANNOTATION not in annotations():
                break
            time.sleep(0.1)
        assert C.STOP_ANNOTATION not in annotations(), "lock never removed"

        # phase 1: the card is busy -> survives many cull cycles despite
        # hour-stale Jupyter kernels
        deadline = time.monotonic() + 6
        saw_probe = False
        while time.monotonic() < deadline:
            assert C.STOP_ANNOTATION not in annotations(), "busy notebook culled"
            saw_probe = saw_probe or C.LAST_ACTIVITY_ANNOTATION in annotations()
            time.sleep(0.2)
        assert saw_probe, "culler never probed the notebook"
        assert card.reads > 0, "the port's agent never sampled the card"

        # phase 2: the card goes idle -> culled once the window drains
        stop_work.set()
        worker.join(timeout=5)
        assert not worker.is_alive()
        deadline = time.monotonic() + 30
        culled = False
        while time.monotonic() < deadline:
            if C.STOP_ANNOTATION in annotations():
                culled = True
                break
            time.sleep(0.2)
        assert culled, "notebook with an idle card was never culled"
    finally:
        stop_work.set()
        mgr.stop()
        cluster.stop()
        for a in agents.values():
            a.close()
