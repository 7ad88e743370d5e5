"""The port's SLO-burn replica autoscaler (runtime/autoscaler.py) against the
JAX package's, on the CPU: every case of tests/test_autoscaler.py, each run
with the same inputs and the same fake clock through both packages, the
results compared exactly. `decide()`: each case's sequence of (desired,
action) and the damping windows it leaves; and one seeded random walk of
signals, specs and clocks held equal decision for decision. The
ReplicaAutoscaler: what a tick writes (the desired-replicas annotation
only), the decisions counter's and the desired gauge's deltas, the state
it keeps and drops; the default signals over each package's own registry
and a fake SLO engine; the service lifecycle. And the port's own
PodStatsSignals, which reads the replicas' /stats."""
import random
from types import SimpleNamespace

import odh_kubeflow_tpu.api.inference as j_inference
import odh_kubeflow_tpu.cluster as j_cluster
import odh_kubeflow_tpu.controllers.constants as j_C
import odh_kubeflow_tpu.controllers.inference as j_ctrl_inference
import odh_kubeflow_tpu.runtime.autoscaler as j_autoscaler
import odh_kubeflow_tpu.runtime.metrics as j_rm
import odh_kubeflow_tpu.serving.metrics  # noqa: F401  (the engine gauges the default signals read)
import odh_kubeflow_tpu_torch.api.inference as p_inference
import odh_kubeflow_tpu_torch.cluster as p_cluster
import odh_kubeflow_tpu_torch.controllers.constants as p_C
import odh_kubeflow_tpu_torch.controllers.inference as p_ctrl_inference
import odh_kubeflow_tpu_torch.runtime.autoscaler as p_autoscaler
import odh_kubeflow_tpu_torch.runtime.metrics as p_rm
import odh_kubeflow_tpu_torch.serving.metrics  # noqa: F401

JAX = SimpleNamespace(name="jax", inference=j_inference, cluster=j_cluster, C=j_C, rm=j_rm, a=j_autoscaler,
                      desired=j_ctrl_inference.endpoint_desired_replicas)
PORT = SimpleNamespace(name="port", inference=p_inference, cluster=p_cluster, C=p_C, rm=p_rm, a=p_autoscaler,
                       desired=p_ctrl_inference.endpoint_desired_replicas)
NS = "autoscale"


def both(case):
    """case(side) on each package; asserts the results equal and returns
    the port's."""
    jax, port = case(JAX), case(PORT)
    assert jax == port, (jax, port)
    return port


def auto(side, min_r=1, max_r=4, target=2.0, to_zero=False, stab=30.0, idle=120.0):
    return side.inference.AutoscalingSpec(
        min_replicas=min_r, max_replicas=max_r, target_burn_rate=target, scale_to_zero=to_zero,
        scale_down_stabilization_s=stab, scale_to_zero_idle_s=idle)


def sig(burn=0.0, queued=0.0, occupancy=0.0):
    return {"burn_rate": burn, "queue_depth": queued, "slot_occupancy": occupancy}


def script(steps, **spec):
    """A decide() case: `steps` are (current, signals, now); one state
    across them. Returns each (desired, action) and the state after."""
    def run(side):
        state, out = side.a.EndpointScaleState(), []
        a = auto(side, **spec)
        for current, signals, now in steps:
            out.append(side.a.decide(current, a, signals, now, state))
        return out, (state.below_since, state.idle_since)

    return both(run)


# ---------------------------------------------------------------------------
# decide(): the pure policy
# ---------------------------------------------------------------------------


def test_scale_up_on_burn_one_replica_per_tick():
    out, _ = script([(1, sig(burn=3.0), 0.0), (2, sig(burn=3.0), 5.0)])
    assert out == [(2, "up"), (3, "up")]


def test_scale_up_on_queue_pressure_without_burn():
    assert script([(1, sig(queued=10.0), 0.0)])[0] == [(2, "up")]
    # below the pressure threshold and below target burn: hold
    assert script([(2, sig(burn=1.5, queued=3.0), 5.0)])[0] == [(2, "hold")]


def test_scale_up_capped_at_max_replicas():
    assert script([(4, sig(burn=9.0), 0.0)], max_r=4)[0] == [(4, "hold")]


def test_min_replicas_floor_holds_under_sustained_low_burn():
    out, _ = script([(2, sig(burn=0.0), 60.0 * i) for i in range(20)], min_r=2, max_r=4, stab=30.0)
    assert out == [(2, "hold")] * 20


def test_scale_down_waits_for_the_stabilization_window():
    out, _ = script([(3, sig(burn=0.1), 0.0), (3, sig(burn=0.1), 29.0), (3, sig(burn=0.1), 31.0),
                     (2, sig(burn=0.1), 32.0), (2, sig(burn=0.1), 62.0)], stab=30.0)
    assert out == [(3, "hold"), (3, "hold"), (2, "down"), (2, "hold"), (1, "down")]


def test_hot_tick_resets_the_stabilization_window_flap_damped():
    out, _ = script([(3, sig(burn=0.1), 0.0), (3, sig(burn=5.0), 20.0), (4, sig(burn=0.1), 40.0),
                     (4, sig(burn=0.1), 69.0), (4, sig(burn=0.1), 71.0)], stab=30.0)
    assert out[1:] == [(4, "up"), (4, "hold"), (4, "hold"), (3, "down")]


def test_hysteresis_band_between_half_and_full_target_holds():
    out, (below_since, _) = script([(3, sig(burn=1.5), now) for now in (0.0, 20.0, 40.0)], target=2.0, stab=10.0)
    assert out == [(3, "hold")] * 3 and below_since is None


def test_park_to_zero_only_after_the_idle_window():
    out, _ = script([(1, sig(), 0.0), (1, sig(), 119.0), (1, sig(), 121.0), (0, sig(), 200.0)],
                    to_zero=True, idle=120.0)
    assert out[:3] == [(1, "hold"), (1, "hold"), (0, "park")] and out[3][0] == 0


def test_no_park_without_scale_to_zero():
    out, _ = script([(1, sig(), now) for now in (0.0, 500.0, 5000.0)], to_zero=False, idle=120.0)
    assert all(desired == 1 and action != "park" for desired, action in out)


def test_inflight_work_resets_the_idle_window():
    out, _ = script([(1, sig(), 0.0), (1, sig(queued=1.0), 90.0), (1, sig(), 150.0), (1, sig(), 251.0)],
                    to_zero=True, idle=100.0)
    assert out[2:] == [(1, "hold"), (0, "park")]
    _, (_, idle_since) = script([(1, sig(), 0.0), (1, sig(queued=1.0), 90.0)], to_zero=True, idle=100.0)
    assert idle_since is None


def test_cold_wake_scales_a_parked_fleet_back_up():
    assert script([(0, sig(burn=3.0), 0.0)], min_r=2, to_zero=True)[0] == [(2, "up")]  # straight to the floor


def test_a_seeded_random_walk_of_signals_decides_alike():
    """3000 ticks over 30 endpoints' specs from one seed: each tick's
    signals (burn around and across the target, queue spikes, idle
    stretches), clock and current fleet (the last decision's) go into both
    packages' decide(); every (desired, action) and damping window equal."""
    rng = random.Random(0x5CA1E)
    specs = [dict(min_r=rng.randint(1, 2), max_r=rng.randint(2, 5), target=rng.choice([1.0, 2.0, 4.0]),
                  to_zero=rng.random() < 0.5, stab=rng.choice([5.0, 30.0]), idle=rng.choice([10.0, 60.0]))
             for _ in range(30)]
    ticks = []
    for i in range(3000):
        mode = rng.random()
        if mode < 0.3:
            s = sig()
        elif mode < 0.5:
            s = sig(burn=rng.uniform(0, 10), queued=float(rng.randint(0, 12)), occupancy=rng.random())
        else:
            s = sig(burn=rng.uniform(0, 1.2), occupancy=rng.choice([0.0, 0.25]))
        ticks.append((i % 30, s, (i // 30) * rng.uniform(1.0, 8.0)))

    def run(side):
        states = [side.a.EndpointScaleState() for _ in specs]
        current = [max(1, spec["min_r"]) for spec in specs]
        clock = [0.0] * len(specs)
        out = []
        for k, s, dt in ticks:
            clock[k] += dt / 30.0
            desired, action = side.a.decide(current[k], auto(side, **specs[k]), s, clock[k], states[k])
            current[k] = desired
            out.append((desired, action, states[k].below_since, states[k].idle_since))
        return out

    out = both(run)
    actions = {a for _, a, _, _ in out}
    assert actions == {"up", "down", "park", "hold"}, actions


# ---------------------------------------------------------------------------
# ReplicaAutoscaler: the sweep writes only the annotation
# ---------------------------------------------------------------------------


def mk_ep(side, name, autoscaling=None, replicas=1):
    ep = side.inference.InferenceEndpoint()
    ep.metadata.name = name
    ep.metadata.namespace = NS
    ep.spec.serving = side.inference.ServingSpec(replicas=replicas, autoscaling=autoscaling)
    return ep


def mk_autoscaler(side, client, signals, clock, **kw):
    mgr = SimpleNamespace(client=client)
    return side.a.ReplicaAutoscaler(mgr, period_s=999.0, signals_fn=lambda ep: dict(signals),
                                    clock=lambda: clock[0], **kw)


def decisions(side):
    return {a: side.rm.autoscaler_decisions_total.value(action=a) for a in ("up", "down", "park", "hold")}


def test_tick_patches_only_the_desired_replicas_annotation():
    def run(side):
        client = side.cluster.Client(side.cluster.Store())
        client.create(mk_ep(side, "burning", autoscaling=auto(side, max_r=3)))
        scaler = mk_autoscaler(side, client, sig(burn=5.0), [0.0])
        before = decisions(side)
        out = []
        for _ in range(3):
            scaler.tick()
            ep = client.get(side.inference.InferenceEndpoint, NS, "burning")
            out.append((dict(ep.metadata.annotations), side.desired(ep), ep.spec.serving.replicas,
                        side.rm.endpoint_desired_replicas_gauge.value(endpoint=f"{NS}/burning")))
        return out, {a: v - before[a] for a, v in decisions(side).items()}

    out, delta = both(run)
    key = PORT.C.INFERENCE_DESIRED_REPLICAS_ANNOTATION
    assert [(ann, d, r, g) for ann, d, r, g in out] == [({key: "2"}, 2, 1, 2.0), ({key: "3"}, 3, 1, 3.0),
                                                          ({key: "3"}, 3, 1, 3.0)]
    assert delta == {"up": 2, "down": 0, "park": 0, "hold": 1}


def test_tick_parks_idle_scale_to_zero_endpoint_after_window():
    def run(side):
        client = side.cluster.Client(side.cluster.Store())
        client.create(mk_ep(side, "nightly", autoscaling=auto(side, to_zero=True, idle=60.0)))
        clock = [0.0]
        scaler = mk_autoscaler(side, client, sig(), clock)
        out = []
        for now in (0.0, 61.0):
            clock[0] = now
            scaler.tick()
            ep = client.get(side.inference.InferenceEndpoint, NS, "nightly")
            out.append((dict(ep.metadata.annotations), side.desired(ep)))
        return out

    out = both(run)
    assert out == [({}, 1), ({PORT.C.INFERENCE_DESIRED_REPLICAS_ANNOTATION: "0"}, 0)]


def test_tick_skips_static_and_stopped_endpoints():
    def run(side):
        client = side.cluster.Client(side.cluster.Store())
        client.create(mk_ep(side, "static", autoscaling=None, replicas=2))
        stopped = mk_ep(side, "stopped", autoscaling=auto(side))
        stopped.metadata.annotations[side.C.STOP_ANNOTATION] = "true"
        client.create(stopped)
        mk_autoscaler(side, client, sig(burn=9.0), [0.0]).tick()
        return {name: side.C.INFERENCE_DESIRED_REPLICAS_ANNOTATION in client.get(
            side.inference.InferenceEndpoint, NS, name).metadata.annotations for name in ("static", "stopped")}

    assert both(run) == {"static": False, "stopped": False}


def test_state_gc_for_deleted_endpoints():
    def run(side):
        client = side.cluster.Client(side.cluster.Store())
        client.create(mk_ep(side, "ghost", autoscaling=auto(side)))
        scaler = mk_autoscaler(side, client, sig(burn=0.1), [0.0])
        scaler.tick()
        kept = sorted(scaler._states)
        client.delete(side.inference.InferenceEndpoint, NS, "ghost")
        scaler.tick()
        return kept, sorted(scaler._states)

    assert both(run) == ([f"{NS}/ghost"], [])


def test_default_signals_read_serving_slos_fast_window_and_engine_gauges():
    class FakeSLOEngine:
        windows = {"fast": 300.0, "slow": 3600.0}

        def status(self):
            return {"slos": {
                "token-latency": {"category": "serving",
                                  "windows": {"fast": {"burn_rate": 4.5}, "slow": {"burn_rate": 0.2}}},
                "notebook-readiness": {"category": "workload",  # wrong category: ignored
                                       "windows": {"fast": {"burn_rate": 99.0}}},
            }}

    def run(side):
        queue = side.rm.global_registry.get("inference_queue_depth")
        slots = side.rm.global_registry.get("inference_slot_occupancy_ratio")
        queue.set(3.0)
        slots.set(0.5)
        try:
            mgr = SimpleNamespace(client=None, slo_engine=FakeSLOEngine(), metrics=side.rm.global_registry)
            return side.a.ReplicaAutoscaler(mgr, period_s=999.0)._default_signals(mk_ep(side, "any"))
        finally:
            queue.set(0.0)
            slots.set(0.0)

    assert both(run) == {"burn_rate": 4.5, "queue_depth": 3.0, "slot_occupancy": 0.5}


def test_service_lifecycle_start_stop():
    def run(side):
        client = side.cluster.Client(side.cluster.Store())
        scaler = mk_autoscaler(side, client, sig(), [0.0])
        scaler.start()
        alive = scaler._thread is not None and scaler._thread.is_alive()
        scaler.stop()
        return alive, scaler._thread is None

    assert both(run) == (True, True)


def test_pod_stats_signals_read_each_bound_replica_and_count_an_unreadable_one_busy():
    """The port's signal source for engines that serve in their pods (no
    counterpart in the reference, whose default source reads the
    operator's registry: ROADMAP Queue 3 entry 21): the serving burn as
    the default reads it, the queue summed and the slots' occupancy over
    every bound replica's /stats; an unbound pod or one being deleted is
    not read; a replica that cannot be read, or an endpoint not Serving,
    counts busy (empty queue, full slots). The decisions follow: a busy
    replica holds, the idle fleet parks after its window."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from odh_kubeflow_tpu_torch.api.core import Pod

    served = {}

    class Stats(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(served[self.server.server_address[1]]).encode()
            self.send_response(200 if self.path == "/stats" else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    servers = [ThreadingHTTPServer(("127.0.0.1", 0), Stats) for _ in range(2)]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        client = p_cluster.Client(p_cluster.Store())
        ports = {}
        for i, (node, deleting) in enumerate([("n0", False), ("n1", False), ("", False), ("n2", True)]):
            pod = Pod()
            pod.metadata.name, pod.metadata.namespace = f"ep-{i}", NS
            pod.metadata.labels = {p_C.INFERENCE_NAME_LABEL: "ep"}
            pod.spec.node_name = node
            if deleting:
                pod.metadata.finalizers = ["hold"]
            client.create(pod)
            if deleting:
                client.delete(Pod, NS, pod.metadata.name)
            ports[pod.metadata.name] = servers[i].server_address[1] if i < 2 else None

        class FakeSLOEngine:
            windows = {"fast": 300.0, "slow": 3600.0}

            def status(self):
                return {"slos": {"token-latency": {"category": "serving",
                                                   "windows": {"fast": {"burn_rate": 0.0}}}}}

        read = []

        def address_of(pod):
            read.append(pod.metadata.name)
            port = ports[pod.metadata.name]
            return port and f"http://127.0.0.1:{port}"

        mgr = SimpleNamespace(client=client, api_reader=client, slo_engine=FakeSLOEngine())
        signals = p_autoscaler.PodStatsSignals(mgr, address_of, timeout_s=2.0)
        ep = mk_ep(PORT, "ep", autoscaling=auto(PORT, min_r=1, max_r=2, to_zero=True, idle=1.0))
        ep.metadata.annotations[p_C.INFERENCE_STATE_ANNOTATION] = "serving"
        busy = {"burn_rate": 0.0, "queue_depth": 0.0, "slot_occupancy": 1.0}

        p0, p1 = (srv.server_address[1] for srv in servers)
        served[p0] = {"queued": 2, "active_slots": 1, "max_slots": 4}
        served[p1] = {"queued": 1, "active_slots": 0, "max_slots": 4}
        assert signals(ep) == {"burn_rate": 0.0, "queue_depth": 3.0, "slot_occupancy": 1 / 8}
        assert sorted(read) == ["ep-0", "ep-1"], read
        served[p0] = served[p1] = {"queued": 0, "active_slots": 0, "max_slots": 4}
        idle = signals(ep)
        assert idle == {"burn_rate": 0.0, "queue_depth": 0.0, "slot_occupancy": 0.0}, idle
        ports["ep-1"] = None  # ep-1 has no address
        assert signals(ep) == busy
        servers[1].shutdown()
        servers[1].server_close()
        ports["ep-1"] = p1  # listed again, but its server is gone
        assert signals(ep) == busy
        ep.metadata.annotations[p_C.INFERENCE_STATE_ANNOTATION] = "loading"
        assert signals(ep) == busy

        state, a = p_autoscaler.EndpointScaleState(), ep.spec.serving.autoscaling
        steps = [(1, busy, 0.0), (1, idle, 1.0), (1, idle, 1.5), (1, idle, 2.1)]
        assert [p_autoscaler.decide(c, a, s, now, state)[1] for c, s, now in steps] == \
            ["hold", "hold", "hold", "park"]
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
