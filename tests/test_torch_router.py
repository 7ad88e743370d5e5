"""The port's token router (odh_kubeflow_tpu_torch.serving.router) and the
control-plane pieces it stands on (flow control, the circuit breaker)
against the JAX package's.

Each scenario of tests/test_router.py runs through both routers with the
same seeded `random.Random`, over a scripted FakeEngine rebuilt against
each side's `QueueFull` and `RequestHandle` (the port's for the port's
router). The two runs must give the same picks, submits, cancels, results,
exceptions, backoff sleeps, spans and metric counts, event for event. Then
routed requests over two port engines on the CPU: one request is one trace
tree, and a hedge loser is canceled, marked superseded in the same trace
and not counted.
"""
import random
import threading
import time
from types import SimpleNamespace

import jax
import pytest
import torch

import torch_threads
from odh_kubeflow_tpu.cluster import flowcontrol as jax_flowcontrol
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.runtime import breaker as jax_breaker
from odh_kubeflow_tpu.runtime import metrics as jax_runtime_metrics
from odh_kubeflow_tpu.serving import engine as jax_engine
from odh_kubeflow_tpu.serving import metrics as jax_serving_metrics
from odh_kubeflow_tpu.serving import router as jax_router
from odh_kubeflow_tpu.utils import tracing as jax_tracing
from odh_kubeflow_tpu_torch.cluster import flowcontrol
from odh_kubeflow_tpu_torch.models import TransformerConfig, params_from_numpy
from odh_kubeflow_tpu_torch.runtime import breaker
from odh_kubeflow_tpu_torch.serving import engine, router
from odh_kubeflow_tpu_torch.serving import metrics as serving_metrics
from odh_kubeflow_tpu_torch.utils import tracing

torch_threads.cap()

SIDES = {
    "port": SimpleNamespace(
        TokenRouter=router.TokenRouter, QueueFull=engine.QueueFull,
        RequestHandle=engine.RequestHandle, M=serving_metrics, tracing=tracing, fc=flowcontrol,
        trips=breaker.breaker_trips_total, CircuitBreaker=breaker.CircuitBreaker),
    "jax": SimpleNamespace(
        TokenRouter=jax_router.TokenRouter, QueueFull=jax_engine.QueueFull, RequestHandle=jax_engine.RequestHandle,
        M=jax_serving_metrics, tracing=jax_tracing, fc=jax_flowcontrol,
        trips=jax_runtime_metrics.breaker_trips_total, CircuitBreaker=jax_breaker.CircuitBreaker),
}
COUNTERS = {
    "inference_router_picks_total": ("result", ("ok", "shed", "error", "no_replica")),
    "inference_router_retries_total": ("reason", ("queue_full", "error", "canceled")),
    "inference_router_hedges_total": ("outcome", ("launched", "primary_won", "hedge_won")),
    "inference_router_ejections_total": ("action", ("eject", "readmit")),
}


class FakeEngine:
    """Engine-like backend with scripted behaviour (tests/test_router.py's,
    built on one side's QueueFull and RequestHandle). mode: ok, hang, error,
    queue_full, canceled. Every call lands in the shared event log."""

    def __init__(self, side, log, name, mode="ok", queued=0, active=0, slots=4, ttft=0.0):
        self.side, self.log, self.name = side, log, name
        self.mode, self.queued, self.active, self.slots, self.ttft = mode, queued, active, slots, ttft
        self.submitted, self.canceled = [], []
        self._n = 0

    def stats(self):
        return {"queued": self.queued, "active_slots": self.active, "max_slots": self.slots}

    def submit(self, prompt, max_new, traceparent=None):
        self.log.append(("submit", self.name, list(prompt), max_new, traceparent is not None))
        if self.mode == "error":
            raise ConnectionError("replica down")
        if self.mode == "queue_full":
            raise self.side.QueueFull("admission queue full")
        self._n += 1
        h = self.side.RequestHandle(id=self._n, prompt=list(prompt), max_new=max_new,
                                    submitted=time.monotonic(), traceparent=traceparent)
        self.submitted.append(h)
        if self.mode == "ok":
            self.complete(h, "ok")
        elif self.mode == "canceled":
            self.complete(h, "canceled")
        return h

    def complete(self, h, result="ok"):
        if result == "ok":
            h.tokens = [1, 2, 3]
            h.ttft_s = self.ttft
        h.result = result
        h.done.set()

    def cancel(self, h):
        self.log.append(("cancel", self.name, h.id, h.superseded))
        if h.done.is_set():
            return False
        self.canceled.append(h)
        self.complete(h, "canceled")
        return True


class FakeClock:
    """Deterministic clock; the router's injected sleep advances it and
    logs the (jittered) delay."""

    def __init__(self, log):
        self.t, self.log = 0.0, log

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.log.append(("sleep", s))
        self.t += s

    def advance(self, s):
        self.t += s


class World:
    def __init__(self, side):
        self.side, self.log = side, []
        self.clk = FakeClock(self.log)

    def engines(self, *modes_kw):
        return [FakeEngine(self.side, self.log, f"e{i}", **kw) for i, kw in enumerate(modes_kw)]

    def router(self, engines, wall=False, **kw):
        kw.setdefault("clock", time.monotonic if wall else self.clk)
        kw.setdefault("sleep", time.sleep if wall else self.clk.sleep)
        kw.setdefault("rng", random.Random(0))
        r = self.side.TokenRouter(endpoint="ep", **kw)
        for i, eng in enumerate(engines):
            r.add_replica(i, eng)
        return r

    def generate(self, r, *args, **kw):
        try:
            res = r.generate(*args, **kw)
        except Exception as e:  # noqa: BLE001 - the outcome is the event
            self.log.append(("raised", type(e).__name__))
            return None
        self.log.append(("result", res.replica, res.retries, res.hedged, res.hedge_won,
                         res.handle.result))
        return res

    def pick(self, r, **kw):
        self.log.append(("pick", r.pick(**kw)))

    def state(self, r):
        self.log.append(("ejected", r.ejected(), "replicas", r.replicas()))


def _wait_for(cond):
    deadline = time.monotonic() + 10.0
    while not cond():
        assert time.monotonic() < deadline, "scenario stalled"
        time.sleep(0.002)


def sc_pick_least_loaded(w):
    busy, idle = w.engines(dict(queued=5, active=4), dict())
    r = w.router([busy, idle])
    w.pick(r)
    w.generate(r, [1, 2], max_new=4)


def sc_ttft_tail(w):
    slow, fast = w.engines(dict(ttft=5.0), dict(ttft=0.001))
    r = w.router([slow, fast])
    for idx, eng in ((0, slow), (1, fast)):
        for _ in range(4):
            r._finish(r._replicas[idx], eng.submit([1], 1))
    w.pick(r)


def sc_eject_readmit(w):
    flaky, steady = w.engines(dict(queued=0), dict(queued=2))
    r = w.router([flaky, steady], breaker_failure_threshold=2, breaker_cooldown_s=10.0)
    r.note_probe_failure(0)
    w.state(r)
    r.note_probe_failure(0)
    w.state(r)
    w.pick(r)
    w.clk.advance(5.0)
    w.pick(r)
    w.clk.advance(6.0)
    w.generate(r, [1], max_new=2)
    w.state(r)


def sc_halfopen_reeject(w):
    dead, ok = w.engines(dict(mode="error"), dict(queued=3))
    r = w.router([dead, ok], breaker_failure_threshold=1, breaker_cooldown_s=2.0, max_retries=1)
    w.generate(r, [1], max_new=2)
    w.state(r)
    w.clk.advance(2.5)
    w.generate(r, [1], max_new=2)
    w.clk.advance(2.5)
    w.pick(r)


def sc_error_retry(w):
    broken, healthy = w.engines(dict(mode="error"), dict(queued=1))
    r = w.router([broken, healthy], breaker_failure_threshold=1)
    w.generate(r, [1, 2], max_new=4, traceparent=w.side.tracing.format_traceparent("a" * 32, "b" * 16))
    w.state(r)


def sc_queue_full_retry(w):
    full, healthy = w.engines(dict(mode="queue_full"), dict(queued=1))
    r = w.router([full, healthy], breaker_failure_threshold=1)
    w.generate(r, [1, 2], max_new=4)
    w.state(r)


def sc_canceled_retry(w):
    torn, healthy = w.engines(dict(mode="canceled"), dict(queued=1))
    r = w.router([torn, healthy], breaker_failure_threshold=3)
    w.generate(r, [1, 2], max_new=4)


def sc_retry_budget(w):
    r = w.router(w.engines(dict(mode="error"), dict(mode="error")), breaker_failure_threshold=100,
                 max_retries=2)
    w.generate(r, [1], max_new=2)


def sc_backoff(w):
    r = w.router(w.engines(dict()), max_retries=3)
    for attempt in (1, 2, 3, 10):
        r._backoff(attempt)


def sc_all_full_sheds(w):
    r = w.router(w.engines(dict(mode="queue_full"), dict(mode="queue_full")), max_retries=2)
    w.generate(r, [1], max_new=2)


def sc_hedge_winner_cancels_loser(w):
    stuck, quick = w.engines(dict(mode="hang"), dict(queued=1))
    r = w.router([stuck, quick], wall=True, hedge_after_s=0.001)
    w.generate(r, [1, 2], max_new=4, wait_timeout_s=5.0,
               traceparent=w.side.tracing.format_traceparent("c" * 32, "d" * 16))


def sc_hedge_primary_wins(w):
    primary, backup = w.engines(dict(mode="hang"), dict(mode="hang", queued=1))
    r = w.router([primary, backup], wall=True, hedge_after_s=0.001)
    th = threading.Thread(target=w.generate, args=(r, [1]), kwargs=dict(max_new=2, wait_timeout_s=5.0))
    th.start()
    _wait_for(lambda: primary.submitted and backup.submitted)
    primary.complete(primary.submitted[0], "ok")
    th.join(10.0)
    assert not th.is_alive()


def sc_drain(w):
    draining, rest = w.engines(dict(mode="hang"), dict(queued=1))
    r = w.router([draining, rest], wall=True)
    th = threading.Thread(target=w.generate, args=(r, [1]), kwargs=dict(max_new=2, wait_timeout_s=5.0))
    th.start()
    _wait_for(lambda: draining.submitted)
    r.set_draining(0)
    w.pick(r)
    w.generate(r, [3], max_new=2)
    draining.complete(draining.submitted[0], "ok")
    th.join(10.0)
    assert not th.is_alive()
    r.set_draining(0, False)
    w.pick(r)


def sc_cold_wake(w):
    r = w.router([], cold_wake=lambda: w.log.append(("wake", w.side.fc.current_flow())))
    w.clk.advance(10.0)
    for advance in (0.0, 0.0, 2.0):
        w.clk.advance(advance)
        w.generate(r, [1], max_new=2)


def sc_all_ejected(w):
    r = w.router(w.engines(dict()), breaker_failure_threshold=1)
    r.note_probe_failure(0)
    w.generate(r, [1], max_new=2)
    r.remove_replica(0)
    w.state(r)


def sc_inflight_bound(w):
    stuck = w.engines(dict(mode="hang"))[0]
    r = w.router([stuck], wall=True, max_inflight=1)
    th = threading.Thread(target=w.generate, args=(r, [1]), kwargs=dict(max_new=2, wait_timeout_s=5.0))
    th.start()
    _wait_for(lambda: stuck.submitted)
    w.generate(r, [2], max_new=2)
    stuck.complete(stuck.submitted[0], "ok")
    th.join(10.0)
    assert not th.is_alive()


def sc_flow_seat(w):
    fc_mod = w.side.fc
    fc = fc_mod.FlowController(
        schemas=[fc_mod.FlowSchema("serving-requests", "serving", kinds=("InferenceRequest",)),
                 fc_mod.FlowSchema("catch-all", "default")],
        levels=[fc_mod.PriorityLevel("serving", seats=1, queue_length=0, queue_timeout_s=0.05),
                fc_mod.PriorityLevel("default", seats=4)],
    )
    w.log.append(("class", fc_mod.FlowController().classify(
        "serving:ep", verb="create", kind="InferenceRequest").name))
    r = w.router(w.engines(dict()), flow_controller=fc)
    w.generate(r, [1], max_new=2)
    hog = fc.admit("serving:other", verb="create", kind="InferenceRequest")
    try:
        w.generate(r, [1], max_new=2)
    finally:
        hog.release()
    summary = fc.summary()["serving"]
    w.log.append(("flow", summary["dispatched"], summary["rejected"], summary["inflight"]))


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_pick_least_loaded, sc_ttft_tail, sc_eject_readmit, sc_halfopen_reeject, sc_error_retry,
    sc_queue_full_retry, sc_canceled_retry, sc_retry_budget, sc_backoff, sc_all_full_sheds,
    sc_hedge_winner_cancels_loser, sc_hedge_primary_wins, sc_drain, sc_cold_wake, sc_all_ejected,
    sc_inflight_bound, sc_flow_seat)}


def _counts(side):
    out = {}
    for name, (label, values) in COUNTERS.items():
        family = getattr(side.M, name)
        out.update({(name, v): family.value(**{label: v}) for v in values})
    out["added_latency_count"] = sum(side.M.inference_router_added_latency_seconds._totals.values())
    out["breaker_trips"] = side.trips.value()
    return out


def _spans(side):
    spans = side.tracing.global_buffer.spans()
    names = {s.span_id: s.name for s in spans}
    traces = {}
    return [(traces.setdefault(s.trace_id, len(traces)), s.name,
             names.get(s.parent_id, "caller" if s.parent_id else None), dict(s.attributes))
            for s in spans]


def _play(name, side_name):
    side = SIDES[side_name]
    side.tracing.set_enabled(True)
    side.tracing.clear()
    before = _counts(side)
    w = World(side)
    SCENARIOS[name](w)
    after = _counts(side)
    deltas = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return w.log, _spans(side), deltas


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_matches_reference_event_for_event(name):
    got = _play(name, "port")
    want = _play(name, "jax")
    assert got[0] == want[0], "events"
    assert got[1] == want[1], "spans"
    assert got[2] == want[2], "metric counts"
    assert got[0], "the scenario did something"


def test_scenarios_do_what_the_reference_tests_assert():
    """A few of tests/test_router.py's own assertions, on the port's run."""
    log, spans, deltas = _play("error_retry", "port")
    assert ("result", 1, 1, False, False, "ok") in log
    assert ("ejected", [0], "replicas", [0, 1]) in log
    envelope = [s for s in spans if s[1] == "router.request"][0]
    assert envelope[2] == "caller"
    assert [s[3]["reason"] for s in spans if s[1] == "router.retry"] == ["error"]
    log, spans, deltas = _play("hedge_winner_cancels_loser", "port")
    assert ("result", 1, 0, True, True, "ok") in log
    assert ("cancel", "e0", 1, True) in log  # superseded before the cancel
    assert deltas[("inference_router_hedges_total", "launched")] == 1
    assert deltas[("inference_router_hedges_total", "hedge_won")] == 1
    log, _, _ = _play("drain", "port")
    assert [e for e in log if e[0] == "pick"] == [("pick", 1), ("pick", 0)]
    log, _, deltas = _play("flow_seat", "port")
    assert ("class", "serving") in log and ("raised", "QueueFull") in log
    assert deltas[("inference_router_picks_total", "shed")] == 1


def test_breaker_matches_reference():
    logs = []
    for side in SIDES.values():
        t = [0.0]
        b = side.CircuitBreaker(failure_threshold=2, cooldown_s=1.0, max_cooldown_s=3.0,
                                clock=lambda: t[0])
        log = []
        for op, arg in [("fail", None), ("allow", None), ("fail", None), ("allow", None),
                        ("tick", 1.5), ("allow", None), ("allow", None), ("fail", None),
                        ("tick", 1.5), ("allow", None), ("tick", 1.0), ("allow", None),
                        ("ok", None), ("allow", None), ("fail", None), ("fail", None), ("tick", 10)]:
            if op == "tick":
                t[0] += arg
                log.append(("retry_after", b.retry_after("k")))
            elif op == "fail":
                log.append(("fail", b.record_failure("k")))
            elif op == "ok":
                b.record_success("k")
            else:
                log.append(("allow", b.allow("k"), b.is_open("k")))
        log.append(("trips", b.trips))
        logs.append(log)
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# routed requests over two port engines on the CPU
# ---------------------------------------------------------------------------

TINY_JAX = JaxConfig(vocab=64, d_model=32, n_layers=1, n_heads=2, d_ff=64, max_seq=32,
                     dtype=jax.numpy.float32, use_flash=False, remat=False)
TINY = TransformerConfig(vocab=64, d_model=32, n_layers=1, n_heads=2, d_ff=64, max_seq=32,
                         dtype=torch.float32, use_flash=True, remat=False)


@pytest.fixture(scope="module")
def tiny_params():
    return params_from_numpy(jax.device_get(jax_init_params(jax.random.PRNGKey(0), TINY_JAX)),
                             torch.float32, device="cpu")


@pytest.fixture
def traced():
    tracing.set_enabled(True)
    tracing.clear()
    yield tracing
    tracing.clear()


def test_routed_request_over_two_port_engines_is_one_trace_tree(traced, tiny_params):
    engines = [engine.ServingEngine(tiny_params, TINY, max_slots=2, max_seq=32, device="cpu").start()
               for _ in range(2)]
    try:
        r = router.TokenRouter(endpoint="ns/ep")
        for i, eng in enumerate(engines):
            r.add_replica(i, eng)
        trace_id, caller = traced.new_trace_id(), traced.new_span_id()
        res = r.generate([1, 2, 3], max_new=2, wait_timeout_s=30,
                         traceparent=traced.format_traceparent(trace_id, caller))
        assert res.handle.result == "ok" and len(res.handle.tokens) == 2
    finally:
        for eng in engines:
            eng.stop()
    spans = {s.name: s for s in traced.global_buffer.spans(trace_id=trace_id)}
    assert {"router.request", "router.pick", "inference.request"} <= set(spans)
    assert all(s.trace_id == trace_id for s in spans.values())
    envelope = spans["router.request"]
    assert envelope.parent_id == caller and envelope.attributes["result"] == "ok"
    assert spans["router.pick"].parent_id == envelope.span_id
    assert spans["inference.request"].parent_id == envelope.span_id
    assert spans["inference.request"].attributes["ttft_s"] is not None
    assert spans["inference.request"].attributes["superseded"] is False
    assert len(traced.global_buffer.spans()) == 3, "no span outside the request's trace"


def test_hedge_over_two_port_engines_supersedes_the_loser(traced, tiny_params):
    """Replica 0 is never stepped, so its request stalls; the hedge on
    replica 1 wins, and the loser is canceled, marked superseded in the same
    trace, and not counted in inference_requests_total."""
    stalled = engine.ServingEngine(tiny_params, TINY, max_slots=2, max_seq=32, device="cpu")
    live = engine.ServingEngine(tiny_params, TINY, max_slots=2, max_seq=32, device="cpu").start()
    counts = serving_metrics.inference_requests_total
    ok0, canceled0 = counts.value(result="ok"), counts.value(result="canceled")
    try:
        r = router.TokenRouter(endpoint="ns/ep", hedge_after_s=0.001)
        r.add_replica(0, stalled)
        r.add_replica(1, live)
        trace_id = traced.new_trace_id()
        res = r.generate([1, 2, 3], max_new=3, wait_timeout_s=30,
                         traceparent=traced.format_traceparent(trace_id, traced.new_span_id()))
    finally:
        live.stop()
        stalled.stop()
    assert res.hedged and res.hedge_won and res.replica == 1 and res.handle.result == "ok"
    assert counts.value(result="ok") == ok0 + 1
    assert counts.value(result="canceled") == canceled0
    requests = traced.global_buffer.spans(trace_id=trace_id, name="inference.request")
    assert sorted((s.attributes["result"], s.attributes["superseded"]) for s in requests) == [
        ("canceled", True), ("ok", False)]
    envelope = traced.global_buffer.spans(trace_id=trace_id, name="router.request")[0]
    assert {s.parent_id for s in requests} == {envelope.span_id}
    assert traced.global_buffer.spans(trace_id=trace_id, name="router.hedge")[0].attributes == {
        "primary": 0, "hedge": 1}


def test_hedge_queued_behind_a_full_replica_is_superseded(traced, tiny_params):
    """Replica 1's slots all hold long requests, so the router picks the idle
    replica 0 and the hedge copy waits in replica 1's queue; replica 0 wins,
    and the queued copy is canceled, superseded and not counted, while the
    long requests stay in their slots. Both engines are stepped by hand
    (replica 1 once, to fill its slots; replica 0's loop only once the hedge
    is out), so the order holds whatever the host's load."""
    engines = [engine.ServingEngine(tiny_params, TINY, max_slots=2, max_seq=32, device="cpu")
               for _ in range(2)]
    counts = serving_metrics.inference_requests_total
    long = [engines[1].submit([1, 2, 3], max_new=29) for _ in range(2)]
    engines[1].step()
    assert engines[1].stats()["active_slots"] == 2 and not engines[1].stats()["queued"]
    r = router.TokenRouter(endpoint="ns/ep", hedge_after_s=1e-6)
    for i, eng in enumerate(engines):
        r.add_replica(i, eng)
    ok0, canceled0 = counts.value(result="ok"), counts.value(result="canceled")
    trace_id = traced.new_trace_id()
    out = {}
    client = threading.Thread(target=lambda: out.update(res=r.generate(
        [4, 5, 6], max_new=2, wait_timeout_s=30,
        traceparent=traced.format_traceparent(trace_id, traced.new_span_id()))))
    try:
        client.start()
        _wait_for(lambda: traced.global_buffer.spans(trace_id=trace_id, name="router.hedge"))
        engines[0].start()
        client.join(timeout=30)
        ok1, canceled1 = counts.value(result="ok"), counts.value(result="canceled")
        busy = sum(not h.done.is_set() for h in long)
    finally:
        for eng in engines:
            eng.stop()
    res = out["res"]
    assert res.hedged and not res.hedge_won and res.replica == 0 and res.handle.result == "ok"
    assert (ok1 - ok0, canceled1 - canceled0) == (1, 0)
    requests = traced.global_buffer.spans(trace_id=trace_id, name="inference.request")
    assert sorted((s.attributes["result"], s.attributes["superseded"], s.attributes["ttft_s"] is None)
                  for s in requests) == [("canceled", True, True), ("ok", False, False)]
    assert traced.global_buffer.spans(trace_id=trace_id, name="router.hedge")[0].attributes == {
        "primary": 0, "hedge": 1}
    assert busy == 2
