"""The park and the cold wake of an InferenceEndpoint whose pod is a real
serving process, on the CPU (tests/torch_operator_flow.py's promotion
episode with `Promotion(idle_s=...)`, `python -m odh_kubeflow_tpu_torch.serving`
on the CPU): the notebook's train loop runs under `torchrun`, is preempted,
repaired, suspended and promoted; once its requests are served, the
ReplicaAutoscaler parks the idle endpoint to zero (Suspended, its pods and
processes gone, its slice warm, its route and url kept); a TokenRouter over
it, with no live replica, sheds the next requests and fires its cold wake;
the woken gang takes back the parked slice, its serving process restores
the checkpoint, the restore is verified again, and the shed requests are
served through the router, with `generate()`'s tokens. The judgement layer
(the SLO engine, the burn-rate alerts, the canary prober) runs over the
whole flow. The same episode runs on the card in chip_smoke.py's phase 15,
and so does the rest of this run, as every run of the flow: the manager is
the port's `main.build_manager`, its debug mux is read at the end with the
control-plane profiler armed (`check_debug_mux`), DEPLOYGUARD holds every
call of the manager's flows to the port's generated RBAC
(`check_deployguard`), and the refused notebook is written over the wire (a TLS ApiServer whose admission calls the HTTPS
webhook) and denied there.

The autoscaler `build_manager` wires reads each replica's /stats (the
port's PodStatsSignals) at the address the pod object gives: its IP and
its serving container's port. The reference's default
signals read the operator's own registry, where an engine that serves in
the pod's own process never shows: replayed through `decide()`, they park
the endpoint while it serves (ROADMAP Queue 3 entry 21)."""
import pytest

import torch_operator_flow
import torch_pod_worker
import torch_threads
from odh_kubeflow_tpu_torch.probe.agent import SimTPUMonitor
from odh_kubeflow_tpu_torch.runtime.autoscaler import EndpointScaleState, decide

torch_threads.cap()

SCENARIO_LIMIT_S = 300.0  # each wait of the flow, and the test's bound on its scenario
IDLE_S = 1.0  # the endpoint's scaleToZeroIdleS
TICK_S = 0.25  # the autoscaler's period
# 64 requests of 8 + 24 tokens (the tiny model's max_seq) on one slot: the
# engine is busy for several of the autoscaler's ticks (about a second)
REQUESTS = [([(7 * i + j) % 64 for j in range(8)], 24) for i in range(64)]


@pytest.fixture(scope="module")
def parked_and_woken(tmp_path_factory):
    """The repair flow on the CPU, its notebook promoted into an endpoint
    with scale-to-zero at IDLE_S, parked by the autoscaler (every 0.25 s)
    and woken by the router; returns the run's directory and what the flow
    saw, checked. The registry's two engine gauges are set to 0 first, as
    in an operator process that runs no engine (another test's in-process
    engine may have left them set)."""
    from odh_kubeflow_tpu_torch.serving import metrics as serving_metrics

    serving_metrics.inference_queue_depth.set(0.0)
    serving_metrics.inference_slot_occupancy_ratio.set(0.0)
    tmp_path = tmp_path_factory.mktemp("autoscale")
    cfg = torch_pod_worker.tiny_cfg()
    promotion = torch_operator_flow.Promotion(
        model_config=torch_operator_flow.model_config(cfg), device="cpu", requests=REQUESTS, slots=1,
        max_seq=cfg.max_seq, drain_s=0.5, idle_s=IDLE_S)
    seen = torch_operator_flow.run(
        tmp_path, torch_operator_flow.pod_worker("cpu"), waves=(("nb-a",),), repair="nb-a", promotion=promotion,
        cfg=dict(torch_operator_flow.CFG, autoscale_period_s=TICK_S, accounting_period_s=0.5),
        timeout=SCENARIO_LIMIT_S,
        monitor=lambda pod, chips, procs: SimTPUMonitor(chips=chips, expected=chips, duty=0.0))
    torch_operator_flow.check(seen, "cpu")
    return tmp_path, seen


def test_an_idle_endpoint_parked_to_zero_and_cold_woken_through_the_router_on_the_cpu(parked_and_woken):
    """The park and the wake with processes on the CPU, past the flow's
    gates (`check_autoscale`, `check_judgement`): one park after the last
    reply, the fleet view at 0 with the url and route kept, the slice
    warm; one cold wake; the woken process restores the saved state,
    verified `ok` once more; the shed requests served through the router
    with the greedy tokens `generate()` gives on the restored params; the
    availability page fired during the repair and resolved, both canaries
    `ok`."""
    import torch

    from odh_kubeflow_tpu_torch.models import adamw, generate, init_params, restore_train_state

    tmp_path, seen = parked_and_woken
    pe = seen["nb-a"]["promotion"]
    ae = pe["autoscale"]
    cfg = torch_pod_worker.tiny_cfg()
    params = init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    state = restore_train_state(str(tmp_path / "out" / "nb-a" / "checkpoints"),
                                {"params": params, "opt_state": adamw().init(params)})
    for (prompt, max_new), first, woken in zip(REQUESTS, pe["replies"], ae["replies"]):
        want = generate(state["params"], [prompt], cfg, max_new, max_seq=cfg.max_seq, device="cpu")[0].tolist()
        assert first[0] == 200 and first[1]["tokens"] == want, (prompt, first, want)
        assert woken[0] == 200 and woken[1]["tokens"] == want, (prompt, woken, want)
    n_tokens = sum(m for _, m in REQUESTS)
    assert pe["exit"]["stats"]["generated_tokens"] == ae["exit"]["stats"]["generated_tokens"] == n_tokens
    judged = seen["judgement"]
    assert judged["decisions"]["park"] == 1 and judged["coalescer"]["writes"] > 0, judged["decisions"]
    assert judged["compliance"]["canary-readiness"]["compliance"] == 1.0, judged["compliance"]


def test_the_reference_default_signals_park_an_endpoint_that_serves_in_its_pod(parked_and_woken):
    """Queue 3 entry 21: the reference's default signals read the
    operator's registry (`inference_queue_depth`,
    `inference_slot_occupancy_ratio`), which an engine in the pod's own
    process never moves. Over the promotion's requests the flow's signals
    (each replica's /stats) read the endpoint busy while the default ones
    read it idle. Replayed through `decide()` from the first tick that read
    it busy, with an idle window of one tick (any window shorter than the
    serving does the same), the default ones park it a tick later, while
    it still serves, and the flow's only after its last reply."""
    _, seen = parked_and_woken
    pe = seen["nb-a"]["promotion"]
    served = [s for s in seen["judgement"]["samples"] if s[1] == "serving" and s[0] <= pe["autoscale"]["card free"]]
    busy = [(t, ours, default) for t, _, ours, default in served if ours["queue_depth"] > 0 or ours["slot_occupancy"] > 0]
    assert busy, "no tick read the replica busy"
    samples = [s for s in served if s[0] >= busy[0][0]]
    for _, _, default in busy:
        assert default["queue_depth"] == default["slot_occupancy"] == 0.0, default
    auto = torch_operator_flow.AutoscalingSpec(min_replicas=1, max_replicas=1, scale_to_zero=True,
                                               scale_to_zero_idle_s=TICK_S)

    def first_park(which):
        state = EndpointScaleState()
        return next((t for t, _, ours, default in samples
                     if decide(1, auto, (ours, default)[which], t, state)[1] == "park"), None)

    served_until = max(done for _, _, _, done in pe["replies"])
    default_park, flow_park = first_park(1), first_park(0)
    assert default_park is not None and default_park < served_until, (default_park, served_until)
    assert flow_park is not None and flow_park >= served_until, (flow_park, served_until)


def test_the_wired_signals_read_each_replica_at_its_pods_address(parked_and_woken):
    """`build_manager` wires `PodStatsSignals` over `serving_address`: each
    endpoint pod's IP (a loopback address of its own, which the kubelet
    wrote and the serving process bound through POD_IP) and its serving
    container's declared port (8000), not a port the serving process
    reported. The flow sent its requests there, and every tick that read
    the replica busy read it there."""
    _, seen = parked_and_woken
    pe = seen["nb-a"]["promotion"]
    for address in (pe["address"], pe["autoscale"]["address"]):
        host, _, port = address.removeprefix("http://").rpartition(":")
        assert host.startswith("127.") and host != "127.0.0.1" and port == "8000", address
    assert pe["address"] != pe["autoscale"]["address"]  # the woken pod is a pod of its own
    assert pe["ready"]["port"] == pe["autoscale"]["ready"]["port"] == 8000
    assert all(r[0] == 200 for r in pe["replies"]), pe["replies"]


def test_the_refused_notebook_is_denied_over_https_and_every_admitted_one_stamped(parked_and_woken):
    """nb-denied written over the wire is admitted as deployed: the
    ApiServer calls the HTTPS webhook through the
    MutatingWebhookConfiguration. Its slice is
    refused with the webhook's message in the Status body, nothing of it is
    stored, the card's state unchanged; the admitted notebook carries the
    lock and its readiness root's traceparent."""
    _, seen = parked_and_woken
    denied = seen["denied"]
    assert "denied the request: spec.tpu invalid: " in denied["error"], denied
    assert denied["left"] == denied["left at the end"] == [] and denied["card"][0] == denied["card"][1], denied
    admitted = seen["nb-a"]["admitted"]
    assert admitted[torch_operator_flow.C.STOP_ANNOTATION] == torch_operator_flow.C.RECONCILIATION_LOCK_VALUE
    assert torch_operator_flow.tracing.parse_traceparent(admitted[torch_operator_flow.C.TRACEPARENT_ANNOTATION])


def test_the_flows_manager_runs_inside_its_generated_rbac(parked_and_woken):
    """DEPLOYGUARD was armed over the whole flow: the manager's flows
    (the controllers, the canary, the autoscaler, the router's wake) made
    no call the port's generated ClusterRole does not grant, and the
    rbac-coverage checker given the recorded surface finds none either
    (`check_deployguard`, the gate phase 15 holds on the card)."""
    tmp_path, seen = parked_and_woken
    torch_operator_flow.check_deployguard(seen, tmp_path / "deploy-surface.json")
    flows = {f for f, _, _, _ in seen["deployguard"]["surface"]}
    assert {"notebook", "culling", "probe-status", "slice-repair", "suspend-resume", "inference-endpoint",
            "endpoint-autoscaler", "token-router", "canary"} <= flows, flows
