"""The port's profiler, hot-region table and guard (odh_kubeflow_tpu_torch.
utils.profiler, utils.hotregions, utils.torchguard) against the JAX
package's (utils/profiler.py, analysis/hotregions.py, utils/jaxguard.py):

- region/phase accounting on an injected fake clock (dyadic steps, so the
  arithmetic is exact): the same scripts give equal snapshots on both sides,
  and phase self times partition the region total exactly;
- the region table declares the reference's regions and budgets;
- the guard: over-budget copies and compiles raise, budgets are per entry
  and per consumer, and the process-wide sync debug switch stays right when
  two threads interleave "error" windows and counted copies (torch's
  get/set_sync_debug_mode replaced by a fake that raises like torch);
- the engines: the JAX engine and the port's run the same tiny f32 model on
  the same requests under PROFILE=1 and give the same region and phase
  names and entry counts, and `inference.request` spans with equal
  attributes apart from times and ids.
"""
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads
from odh_kubeflow_tpu.analysis import hotregions as jax_hotregions
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.serving.engine import ServingEngine as JaxEngine
from odh_kubeflow_tpu.utils import profiler as jax_profiler
from odh_kubeflow_tpu.utils import tracing as jax_tracing
from odh_kubeflow_tpu_torch import telemetry
from odh_kubeflow_tpu_torch.models import TransformerConfig, generate, params_from_numpy
from odh_kubeflow_tpu_torch.serving.engine import ServingEngine
from odh_kubeflow_tpu_torch.utils import hotregions, profiler, torchguard, tracing

torch_threads.cap()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"port": (profiler, tracing), "jax": (jax_profiler, jax_tracing)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PROFILE", "TORCHGUARD"):
        monkeypatch.delenv(var, raising=False)
    for mod in (profiler, jax_profiler, torchguard):
        mod.reset()
    yield
    for mod in (profiler, jax_profiler, torchguard):
        mod.reset()
    profiler.set_clock(None)


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("PROFILE", "1")


@pytest.fixture
def guarded(monkeypatch):
    monkeypatch.setenv("TORCHGUARD", "1")


class FakeClock:
    """Time moves only when a script says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


# ---------------------------------------------------------------------------
# accounting on a fake clock, both profilers
# ---------------------------------------------------------------------------


def _engine_shaped(prof, trc, clk):
    """The engine's step: admit (with a nested prefill phase and region),
    scan (with the burst guard's re-entry), batched_drain, emit."""
    with prof.region("serving.decode_burst", consumer="engine"):
        with prof.phase("admit"):
            clk.advance(0.125)
            with prof.phase("prefill"):
                frame = prof.region_enter("serving.prefill")
                clk.advance(0.5)
                prof.region_exit(frame)
        with prof.phase("scan"):
            inner = prof.region_enter("serving.decode_burst")  # re-entry: inert
            clk.advance(1.0)
            prof.region_exit(inner)
        with prof.phase("batched_drain"):
            clk.advance(0.25)
        clk.advance(0.0625)  # outside every phase
        with prof.phase("emit"):
            clk.advance(0.03125)


def _consumers(prof, trc, clk):
    for consumer, n in (("engine-a", 2), ("engine-b", 3)):
        for _ in range(n):
            with prof.region("serving.decode_burst", consumer=consumer):
                clk.advance(0.25)
    with prof.region("bench.train_step"):
        clk.advance(4.0)


def _nested_regions(prof, trc, clk):
    with prof.region("serving.decode_burst"):
        clk.advance(0.5)
        with prof.region("serving.prefill"):
            clk.advance(2.0)
            with prof.phase("inner"):
                clk.advance(0.25)
    with prof.phase("outside"):  # no region: attributed to "process"
        clk.advance(1.0)


def _memory_and_spans(prof, trc, clk):
    frame = prof.region_enter("serving.decode_burst")
    prof.on_device_memory(5e8)
    prof.on_device_memory(9e8, limit_bytes=16e8)
    prof.on_device_memory(7e8)
    prof.region_exit(frame)
    prof.on_device_memory(11e8)
    prof.on_compile("serving.decode_burst", 0.5)
    prof.on_jit_call("serving.decode_burst", 0.25)
    for start, end in ((1.0, 1.5), (2.0, 2.25)):
        trc.record_span("notebook.resume", start_time=start, end_time=end)


SCRIPTS = {"engine": _engine_shaped, "consumers": _consumers, "nested": _nested_regions,
           "memory-spans": _memory_and_spans}


def _run(side, script, monkeypatch):
    prof, trc = SIDES[side]
    clk = FakeClock()
    if side == "port":
        profiler.set_clock(clk)
    else:
        monkeypatch.setattr(jax_profiler, "_clock", clk)
    SCRIPTS[script](prof, trc, clk)
    return prof.snapshot()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_accounting_matches_reference_on_a_fake_clock(armed, script, monkeypatch):
    got = _run("port", script, monkeypatch)
    want = _run("jax", script, monkeypatch)
    assert got == want
    for limit in (1, 2):
        assert profiler.snapshot(limit=limit) == jax_profiler.snapshot(limit=limit)
    assert profiler.snapshot(region="serving.prefill") == jax_profiler.snapshot(region="serving.prefill")


def test_phase_self_times_partition_the_region_exactly(armed, monkeypatch):
    s = _run("port", "engine", monkeypatch)["regions"]["serving.decode_burst"]
    assert s["count"] == 1  # the re-entered guard did not count twice
    assert s["total_s"] == 1.96875
    phases = s["phases"]
    assert {p: v["self_s"] for p, v in phases.items()} == {
        "admit": 0.125, "prefill": 0.5, "scan": 1.0, "batched_drain": 0.25, "emit": 0.03125}
    assert phases["admit"]["total_s"] == 0.625
    # phases cover the region but the 0.0625 s outside them
    assert sum(v["self_s"] for v in phases.values()) == s["total_s"] - 0.0625
    # the nested region counts on its own and leaves the burst's self time
    assert s["self_s"] == 1.46875
    assert _run("port", "engine", monkeypatch)["regions"]["serving.prefill"]["count"] == 2


def test_disarmed_profiler_touches_no_state():
    with profiler.region("serving.decode_burst"):
        with profiler.phase("admit"):
            pass
    profiler.on_device_memory(1e9, limit_bytes=2e9)
    snap = profiler.snapshot()
    assert snap == {"enabled": False, "regions": {}, "spans": {},
                    "hbm": {"peak_bytes": None, "limit_bytes": None, "headroom_bytes": None}}


def test_telemetry_memory_feed_reaches_the_profiler(armed):
    frame = profiler.region_enter("serving.decode_burst")
    telemetry.record_device_memory([(3e8, 5), (4e8, 7), (None, None)])
    profiler.region_exit(frame)
    assert profiler.snapshot()["regions"]["serving.decode_burst"]["hbm_peak_bytes"] == 4e8
    assert profiler.hbm_stats()["peak_bytes"] == 4e8


def test_profile_families_observe_the_accounting(armed, monkeypatch):
    _run("port", "engine", monkeypatch)
    snap = profiler.profile_phase_seconds.snapshot()
    assert snap["serving.decode_burst,scan"]["count"] >= 1
    assert profiler.profile_region_seconds.snapshot()["serving.prefill"]["count"] >= 1


# ---------------------------------------------------------------------------
# the region table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("region", [r.name for r in jax_hotregions.REGIONS])
def test_region_table_matches_reference(region):
    port, ref = hotregions.get(region), jax_hotregions.get(region)
    assert (port.compile_budget, port.transfer_budget) == (ref.compile_budget, ref.transfer_budget)
    assert port.module.startswith("odh_kubeflow_tpu_torch/")
    assert os.path.exists(os.path.join(REPO, port.module))


def test_unknown_region_names_raise():
    assert [r.name for r in hotregions.REGIONS] == [r.name for r in jax_hotregions.REGIONS]
    for make in (hotregions.get, profiler.region, torchguard.region):
        with pytest.raises(KeyError):
            make("serving.typo")
    with pytest.raises(KeyError):
        torchguard.record_compile("serving.typo")


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

ONE = torch.ones(3)


def test_copy_in_a_zero_budget_region_raises_before_copying(guarded):
    before = torchguard.transfer_count()
    with pytest.raises(torchguard.HostTransferError, match="serving.decode_burst"):
        with torchguard.region("serving.decode_burst"):
            torchguard.to_host(ONE)
    assert torchguard.transfer_count() == before + 1
    # outside any region a copy is counted, never budgeted
    assert torchguard.to_host(ONE).tolist() == [1.0, 1.0, 1.0]


def test_transfer_budget_is_per_entry(guarded):
    guard = torchguard.region("serving.prefill")
    for _ in range(3):
        with guard:
            torchguard.to_host(ONE)  # the one declared copy, every entry
    with pytest.raises(torchguard.HostTransferError):
        with guard:
            torchguard.to_host(ONE)
            torchguard.to_host(ONE)


def test_allow_transfer_is_the_audited_escape(guarded):
    with torchguard.region("serving.decode_burst"):
        with torchguard.allow_transfer():
            torchguard.to_host(ONE)
            torchguard.to_host(ONE)


def test_compile_budget_is_per_consumer_and_raises_at_exit(guarded):
    base = torchguard.compile_count("serving.decode_burst")
    engine_a, engine_b = (torchguard.region("serving.decode_burst") for _ in range(2))
    for guard in (engine_a, engine_a, engine_b):
        with guard:
            torchguard.record_compile("serving.decode_burst")
    assert (engine_a.compiles, engine_b.compiles) == (2, 1)
    assert torchguard.compile_count("serving.decode_burst") == base + 3
    with pytest.raises(torchguard.CompileBudgetError, match="compile budget 2"):
        with engine_a:
            torchguard.record_compile("serving.decode_burst")


def test_unarmed_guard_enforces_nothing_but_counts():
    with torchguard.region("serving.decode_burst"):
        torchguard.to_host(ONE)
        for _ in range(5):
            torchguard.record_compile("serving.decode_burst")
    assert torchguard.transfer_count() == 1
    assert torchguard.compile_count("serving.decode_burst") == 5


def test_transfer_counts_per_thread():
    counts = {}

    def copies(n):
        for _ in range(n):
            torchguard.to_host(ONE)
        counts[n] = torchguard.thread_transfer_count()

    threads = [threading.Thread(target=copies, args=(n,)) for n in (3, 5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert counts == {3: 3, 5: 5}
    assert torchguard.transfer_count() == 8


class FakeSyncMode:
    """torch's process-wide sync debug mode, with a device sync that raises
    in "error" as torch does."""

    MODES = {"default": 0, "warn": 1, "error": 2}

    def __init__(self):
        self.mode = 0

    def get(self):
        return self.mode

    def set(self, mode):
        self.mode = self.MODES.get(mode, mode)

    def sync(self, what):
        if self.mode == 2:
            raise RuntimeError(f"called a synchronizing CUDA operation: {what}")


class DeviceTensor:
    """Stands for a CUDA tensor: its host copy is a device sync."""

    def __init__(self, fake, value):
        self.fake, self.value = fake, value

    def cpu(self):
        self.fake.sync("copy to host")
        return torch.tensor([self.value])


@pytest.fixture
def fake_sync(monkeypatch):
    fake = FakeSyncMode()
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    return fake


@pytest.mark.parametrize("armed_guard", [False, True], ids=["check_syncs", "armed"])
def test_two_engines_share_the_sync_switch(fake_sync, monkeypatch, armed_guard):
    """Two engine-shaped threads, each: a burst under its own guard (the
    "error" window) then its counted post-burst copy. Neither copy may land
    in the other's window, neither restore may end the other's window, and
    the mode is the caller's again at the end."""
    if armed_guard:
        monkeypatch.setenv("TORCHGUARD", "1")
    cuda = torch.device("cuda")
    errors, in_window = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def engine(i):
        guard = torchguard.region("serving.decode_burst", cuda, check_syncs=not armed_guard)
        try:
            for step in range(200):
                with guard:
                    for _ in range(3):
                        in_window.append(fake_sync.mode)
                        time.sleep(0)
                host = torchguard.to_host(DeviceTensor(fake_sync, float(step)))
                assert host.tolist() == [float(step)]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=engine, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert set(in_window) == {2}, "a window ran without the error mode"
    assert fake_sync.mode == 0
    # a hidden sync inside a window is still caught; an audited copy inside
    # it lifts the mode for itself alone
    with torchguard.region("serving.decode_burst", cuda, check_syncs=True):
        with pytest.raises(RuntimeError, match="synchronizing"):
            fake_sync.sync("item")
        with torchguard.allow_transfer():
            assert torchguard.to_host(DeviceTensor(fake_sync, 1.0)).tolist() == [1.0]
        assert fake_sync.mode == 2
    assert fake_sync.mode == 0


def test_cpu_regions_open_no_window(fake_sync, guarded):
    with torchguard.region("serving.decode_burst", torch.device("cpu"), check_syncs=True):
        assert fake_sync.mode == 0


# ---------------------------------------------------------------------------
# the engines, JAX and port, under PROFILE=1
# ---------------------------------------------------------------------------

TINY_JAX = JaxConfig(
    vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq=64, dtype=jnp.float32, use_flash=False, remat=False,
)
TINY = TransformerConfig(
    vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq=64, dtype=torch.float32, use_flash=True, remat=False,
)
T = "4bf92f3577b34da6a3ce929d0e0e4736"


@pytest.fixture(scope="module")
def tiny_model():
    jparams = jax_init_params(jax.random.PRNGKey(0), TINY_JAX)
    return jparams, params_from_numpy(jax.device_get(jparams), torch.float32, device="cpu")


def _episode(engine, trc):
    """Three requests with their own traceparents through 2 slots (one
    waits for a free slot), a max_new 1 request finished at admission and a
    canceled one; the profile's counts and the request spans."""
    trc.set_enabled(True)
    trc.clear()
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12]]
    news = [6, 3, 5, 1]
    handles = [engine.submit(p, n, trc.format_traceparent(T, f"{i + 1:016x}"))
               for i, (p, n) in enumerate(zip(prompts, news))]
    assert engine.run_until_idle(timeout=120)
    doomed = engine.submit([13, 14], 4, trc.format_traceparent(T, f"{9:016x}"))
    doomed.superseded = True
    assert engine.cancel(doomed)
    assert [h.result for h in handles] == ["ok"] * 4
    regions = profiler.snapshot()["regions"] if trc is tracing else jax_profiler.snapshot()["regions"]
    counts = {name: (r["count"], {p: v["count"] for p, v in r["phases"].items()})
              for name, r in regions.items()}
    spans = [(s.parent_id, {k: v for k, v in s.attributes.items() if k != "ttft_s"},
              s.attributes["ttft_s"] is None) for s in trc.global_buffer.spans(name="inference.request")]
    return counts, spans, [h.tokens for h in handles]


def test_engine_profile_and_spans_match_reference(armed, tiny_model):
    jparams, params = tiny_model
    want = _episode(JaxEngine(jparams, TINY_JAX, max_slots=2, max_seq=64, decode_burst=4), jax_tracing)
    got = _episode(ServingEngine(params, TINY, max_slots=2, max_seq=64, decode_burst=4, device="cpu"),
                   tracing)
    assert got == want
    counts, spans, _ = got
    burst = counts["serving.decode_burst"]
    assert set(burst[1]) == {"admit", "prefill", "scan", "batched_drain", "emit"}
    # one serving.prefill entry per admitted request
    assert counts["serving.prefill"][0] == burst[1]["prefill"] == 4
    assert [a["superseded"] for _, a, _ in spans] == [False] * 4 + [True]
    assert spans[-1][1]["result"] == "canceled" and spans[-1][2]


def test_guarded_engine_one_copy_per_burst(guarded, tiny_model):
    _, params = tiny_model
    eng = ServingEngine(params, TINY, max_slots=2, max_seq=64, device="cpu")
    handles = [eng.submit([1, 2, 3], max_new=9) for _ in range(3)]
    before = torchguard.transfer_count()
    assert eng.run_until_idle(timeout=120)
    assert all(h.result == "ok" for h in handles)
    stats = eng.stats()
    assert stats["host_transfers_last_burst"] == stats["host_syncs_last_burst"] == 1
    assert stats["decode_burst_recompiles"] == stats["prefill_recompiles"] == 0
    # a copy per prefill and per burst, none elsewhere
    assert torchguard.transfer_count() - before == 3 + stats["decode_steps"] // eng.decode_burst


def test_guarded_generate_makes_no_copy(guarded, armed, tiny_model):
    _, params = tiny_model
    before = torchguard.transfer_count()
    out = generate(params, [[1, 2, 3]], TINY, max_new=4, device="cpu")
    assert out.shape == (1, 4) and torchguard.transfer_count() == before
    assert profiler.snapshot()["regions"]["models.generate"]["count"] == 1


def test_engine_recompile_stats_read_the_guard(tiny_model):
    _, params = tiny_model
    eng = ServingEngine(params, TINY, max_slots=1, max_seq=64, device="cpu")
    torchguard.record_compile("serving.prefill")
    assert eng.stats()["prefill_recompiles"] == 1
    assert eng.stats()["decode_burst_recompiles"] == 0
    assert np.isscalar(eng.stats()["host_syncs_last_burst"])
