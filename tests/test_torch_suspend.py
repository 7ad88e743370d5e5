"""The port's SuspendResumeController (controllers/suspend.py) and the
culler's suspend stamp against the JAX package's, on the CPU: the non-slow
cases of tests/test_suspend.py but its two soaks (which are in
tests/test_torch_suspend_soak.py), and
tests/test_culling.py::test_resume_rearms_idle_clock_no_instant_recull,
each run with one script through both SimClusters at once
(tests/torch_suspend_sides.py: JAX v5e 2x2 ~ port h100 1x4, one host of 4
chips). For each scenario both sides give the same suspend-state values in
the same order, the same events (seconds masked), spans (times masked),
incident reasons, suspend annotations, counter deltas and pool marks.

Also port-only: a resume whose pod is bound but slower to come up than one
attempt window keeps its claim (ROADMAP Queue 3, the port's
`_await_resume`), and the pool-claim and checkpoint-before-suspend
invariants held against the JAX `Monitor` on the same write sequences.
"""
import json
import time

import torch_threads
from torch_sides import JAX, PORT, both, wait_for
from torch_suspend_sides import FAST, NS, TIMEOUT, Env, assert_same

torch_threads.cap()


def run_both(scenario, **kw):
    return both(scenario, lambda side: Env(side, **kw), lambda env: env.stop())


# ---------------------------------------------------------------------------
# cull -> checkpoint -> warm pool release
# ---------------------------------------------------------------------------


def test_cull_checkpoints_and_releases_warm_pool():
    def scenario(env):
        env.notebook("idler")
        wait_for(lambda: env.mesh_ready("idler"), timeout=TIMEOUT, msg="bring-up")
        calls = []
        agent = env.agents["idler-0"]
        agent.checkpoint_hook = lambda: calls.append(1) or {"step": 42}
        # the slice and the kernels both go quiet: the culler fires, its stop
        # patch carrying the checkpointing stamp
        agent.monitor.duty = 0.0
        agent.kernels.set_idle(time.time() - 3600)
        wait_for(lambda: env.state("idler") == "suspended", timeout=TIMEOUT, msg="culled into Suspended")
        warm = env.warm_pools()
        wait_for(lambda: not env.pods("idler"), timeout=TIMEOUT, msg="pods gone")
        out = env.settled("idler", events=[("idler", "NotebookSuspended")])
        out.update(hooked=bool(calls), warm=bool(warm))
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["hooked"] and port["warm"], port
    assert port["sequences"]["idler"] == ["", "checkpointing", "suspended"]
    assert port["annotations"]["idler"]["checkpoint-saved"] == "42" and port["annotations"]["idler"]["stopped"]
    assert ("idler", "NotebookSuspended",
            "suspended after checkpoint (1/1 hosts acked); slice released to the warm pool") in port["events"]["idler"]
    assert port["counters"]["checkpoint saves"] == 1 and port["healthy"]


# ---------------------------------------------------------------------------
# warm-hit resume (+ the idle-clock re-arm)
# ---------------------------------------------------------------------------


def rearmed(env, name, since):
    ts = env.get(name).metadata.annotations.get(env.C.LAST_ACTIVITY_ANNOTATION)
    return bool(ts) and env.side.am.parse_time(ts).timestamp() >= since - 1.0


def test_warm_hit_resume_and_idle_clock_rearm():
    def scenario(env):
        env.notebook("sleeper")
        wait_for(lambda: env.mesh_ready("sleeper"), timeout=TIMEOUT, msg="bring-up")
        env.agents["sleeper-0"].checkpoint_hook = lambda: {"step": 7}
        env.stop_nb("sleeper")
        wait_for(lambda: env.suspended("sleeper"), timeout=TIMEOUT, msg="suspended, slice released")
        warm = env.warm_pools()
        # the preserved pre-suspend last-activity, hours old
        env.patch("sleeper", {env.C.LAST_ACTIVITY_ANNOTATION: "2020-01-01T00:00:00Z"})
        t_unstop = time.time()
        env.unstop("sleeper")
        wait_for(lambda: env.active("sleeper"), timeout=TIMEOUT, msg="resumed to Active")
        wait_for(lambda: rearmed(env, "sleeper", t_unstop), timeout=10, msg="idle clock re-armed from resume time")
        time.sleep(1.5)  # the busy fresh agent keeps it alive: no instant re-cull
        out = env.settled("sleeper", events=[("sleeper", "NotebookResumed")])
        out.update(warm=bool(warm), recull=env.C.STOP_ANNOTATION in env.get("sleeper").metadata.annotations)
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["warm"] and not port["recull"]
    assert port["sequences"]["sleeper"] == ["", "checkpointing", "suspended", "resuming", ""]
    assert port["counters"]["hits"] == 1 and port["counters"]["resumes"] == 1
    assert port["pool"] == [], "pool marks leaked past resume completion"
    assert [n for n, _ in port["spans"]["sleeper"]] == ["notebook.suspend", "notebook.resume"]


# ---------------------------------------------------------------------------
# pool miss -> cold fallback
# ---------------------------------------------------------------------------


def test_pool_miss_falls_back_to_cold_placement():
    def scenario(env):
        env.notebook("cold")
        wait_for(lambda: env.mesh_ready("cold"), timeout=TIMEOUT, msg="bring-up")
        env.stop_nb("cold")
        wait_for(lambda: env.suspended("cold"), timeout=TIMEOUT, msg="suspended")
        # capacity pressure takes the warm slice while the notebook sleeps
        entry = env.reclaim_idle()
        warm = env.warm_pools()
        env.unstop("cold")
        wait_for(lambda: env.active("cold"), timeout=TIMEOUT, msg="cold-fallback resume")
        out = env.settled("cold", events=[("cold", "NotebookResumed")])
        out.update(reclaimed=entry is not None, warm_after_reclaim=warm)
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["reclaimed"] and port["warm_after_reclaim"] == []
    assert port["counters"]["misses"] >= 1 and port["counters"]["reclaims pool-idle"] == 1
    assert port["sequences"]["cold"] == ["", "checkpointing", "suspended", "resuming", ""]


# ---------------------------------------------------------------------------
# suspend aborted by the user returning mid-checkpoint
# ---------------------------------------------------------------------------


def test_user_return_mid_checkpoint_aborts_suspend():
    # a long window with no checkpoint hook: the return lands mid-checkpoint
    cfg = dict(enable_culling=False, suspend_enabled=True, readiness_probe_period_s=0.15,
               suspend_checkpoint_window_s=10.0, resume_timeout_s=8.0, resume_max_attempts=4)

    def scenario(env):
        env.notebook("comeback")
        wait_for(lambda: env.mesh_ready("comeback"), timeout=TIMEOUT, msg="bring-up")
        env.stop_nb("comeback")
        wait_for(lambda: env.state("comeback") == "checkpointing", timeout=TIMEOUT, msg="checkpoint window open")
        env.unstop("comeback")
        wait_for(lambda: env.state("comeback") == "" and env.active("comeback"), timeout=TIMEOUT,
                 msg="suspend aborted, still Active")
        return env.settled("comeback", events=[("comeback", "SuspendAborted")])

    got = run_both(scenario, cfg=cfg)
    assert_same(got)
    port = got["port"]
    assert port["pool"] == [], "an aborted suspend must not release the slice"
    assert port["sequences"]["comeback"] == ["", "checkpointing", ""]


# ---------------------------------------------------------------------------
# checkpoint-hook retries: one transient blip must not abort
# ---------------------------------------------------------------------------


def test_checkpoint_survives_transient_probe_blips():
    blips = {}

    def flaky(env):
        blips[env.side.name] = 0

        def http_get(url, timeout=10.0):
            if "/tpu/checkpoint" in url and blips[env.side.name] < 2:
                blips[env.side.name] += 1  # the first two checkpoint calls die at the transport
                raise ConnectionError("injected transient probe blip")
            return env.cluster.http_get(url, timeout=timeout)

        return http_get

    def scenario(env):
        env.notebook("flaky")
        wait_for(lambda: env.mesh_ready("flaky"), timeout=TIMEOUT, msg="bring-up")
        env.agents["flaky-0"].checkpoint_hook = lambda: {"step": 99}
        env.stop_nb("flaky")
        wait_for(lambda: env.state("flaky") == "suspended", timeout=TIMEOUT, msg="suspended despite blips")
        out = env.settled("flaky")
        out["blips"] = blips[env.side.name]
        return out

    got = run_both(scenario, culling=False, suspend_http_get=flaky)
    assert_same(got)
    port = got["port"]
    assert port["blips"] == 2 and port["annotations"]["flaky"]["checkpoint-saved"] == "99"


# ---------------------------------------------------------------------------
# priority-based reclaim under oversubscription
# ---------------------------------------------------------------------------


def test_priority_reclaim_picks_lowest_and_spares_canary():
    cfg = dict(enable_culling=False, suspend_enabled=True, readiness_probe_period_s=0.15,
               suspend_checkpoint_window_s=1.0, resume_timeout_s=8.0, resume_max_attempts=4,
               reclaim_pending_grace_s=0.3)
    names = ("low", "mid", "canary", "vip")

    def scenario(env):
        env.notebook("low", priority=1)
        env.notebook("mid", priority=5)
        env.notebook("canary", priority=0, labels={env.C.TPU_RECLAIM_EXEMPT_LABEL: "true"})
        for name in ("low", "mid", "canary"):
            wait_for(lambda n=name: env.mesh_ready(n), timeout=TIMEOUT, msg=f"{name} up")
            env.agents[f"{name}-0"].checkpoint_hook = lambda: {"step": 1}
        env.notebook("vip", priority=10)  # into a full cluster
        wait_for(lambda: env.mesh_ready("vip"), timeout=TIMEOUT, msg="vip placed via reclaim")
        wait_for(lambda: env.state("low") == "suspended", timeout=TIMEOUT, msg="low suspended cleanly")
        out = env.settled(*names, events=[("low", "NotebookReclaimed")])
        out.update(active={n: env.active(n) for n in names})
        return out

    got = run_both(scenario, cfg=cfg, slices=3)
    assert_same(got)
    port = got["port"]
    assert port["active"] == {"low": False, "mid": True, "canary": True, "vip": True}
    assert port["annotations"]["low"]["reclaim"] == f"capacity-pressure:{NS}/vip"
    assert port["annotations"]["low"]["checkpoint-saved"] == "1"
    assert port["counters"]["reclaims suspend"] == 1 and port["incidents"]["low"] == ["reclaim"]
    # a reclaim-forced suspend returns the slice to general capacity
    assert port["pool"] == []


# ---------------------------------------------------------------------------
# the webhook's reconciliation lock is not a stop
# ---------------------------------------------------------------------------


def test_reconciliation_lock_does_not_trigger_suspend():
    """The reference drives this through `build_manager`; both sides here
    wire its admission webhook (which stamps the lock at create) and the
    workbench extension (which lifts it) beside the suspend controller."""
    cfg = dict(enable_culling=False, suspend_enabled=True, readiness_probe_period_s=0.15)

    def scenario(env):
        created = env.notebook("fresh")
        wait_for(lambda: env.mesh_ready("fresh"), timeout=TIMEOUT, msg="bring-up")
        time.sleep(0.5)
        out = env.settled("fresh")
        out["locked at create"] = created.metadata.annotations.get(env.C.STOP_ANNOTATION)
        return out

    got = run_both(scenario, cfg=cfg, slices=1, culling=False, webhook=True)
    assert_same(got)
    port = got["port"]
    assert port["locked at create"] == PORT.C.RECONCILIATION_LOCK_VALUE
    assert port["sequences"]["fresh"] == [""], "the reconciliation lock ran a phantom suspend episode"
    assert port["counters"]["resumes"] == 0 and port["counters"]["misses"] == 0


# ---------------------------------------------------------------------------
# ResumeFailed is terminal-but-self-healing
# ---------------------------------------------------------------------------


def test_resume_failed_is_explicit_and_self_heals():
    cfg = dict(enable_culling=False, suspend_enabled=True, readiness_probe_period_s=0.15,
               suspend_checkpoint_window_s=0.5, resume_timeout_s=1.2, resume_max_attempts=2,
               reclaim_pending_grace_s=0.3)

    def scenario(env):
        env.notebook("trapped")
        wait_for(lambda: env.mesh_ready("trapped"), timeout=TIMEOUT, msg="bring-up")
        env.stop_nb("trapped")
        wait_for(lambda: env.suspended("trapped"), timeout=TIMEOUT, msg="suspended")
        # the only slice vanishes while the notebook sleeps
        reclaimed = env.reclaim_idle() is not None
        nodes = [n.metadata.name for n in env.client.list(env.side.core.Node)]
        for node in nodes:
            env.cluster.preempt_node(node, grace_s=0.05)
        env.unstop("trapped")
        wait_for(lambda: env.state("trapped") == "resume-failed", timeout=TIMEOUT, msg="explicit ResumeFailed")
        wait_for(lambda: env.has_event("ResumeFailed", "trapped"), msg="ResumeFailed event")
        wait_for(lambda: env.incidents("trapped"), msg="the resume-failed incident")
        for node in nodes:
            env.cluster.restore_node(node)
        wait_for(lambda: env.active("trapped"), timeout=TIMEOUT, msg="self-healed after capacity returned")
        out = env.settled("trapped", events=[("trapped", "NotebookResumed")])
        out["reclaimed"] = reclaimed
        out["counters"] = {k: v for k, v in out["counters"].items() if k not in ("misses", "hits")}
        return out

    got = run_both(scenario, cfg=cfg, slices=1)
    assert_same(got)
    port = got["port"]
    assert port["reclaimed"] and port["incidents"]["trapped"] == ["resume-failed"]
    assert port["sequences"]["trapped"] == ["", "checkpointing", "suspended", "resuming", "resume-failed", ""]


# ---------------------------------------------------------------------------
# restore-side verification after resume
# ---------------------------------------------------------------------------


def verified_resume(name, saved_checksum, restore_ack):
    """The reference's _drive_verified_resume: a transport that answers
    /tpu/restore with `restore_ack`, a notebook that acks its save with
    `saved_checksum`, suspended and resumed."""

    def transport(env):
        def http_get(url, timeout=10.0):
            if "/tpu/restore" in url:
                return 200, json.dumps(restore_ack).encode()
            return env.cluster.http_get(url, timeout=timeout)

        return http_get

    def scenario(env):
        env.notebook(name)
        wait_for(lambda: env.mesh_ready(name), timeout=TIMEOUT, msg="bring-up")
        env.agents[f"{name}-0"].checkpoint_hook = lambda: {"step": restore_ack.get("step"),
                                                           "checksum": saved_checksum}
        env.stop_nb(name)
        wait_for(lambda: env.suspended(name), timeout=TIMEOUT, msg="suspended")
        durable = env.get(name).metadata.annotations.get(env.C.TPU_CHECKPOINT_CHECKSUM_ANNOTATION)
        env.unstop(name)
        wait_for(lambda: env.active(name), timeout=TIMEOUT, msg="resumed")
        out = env.settled(name, events=[(name, "NotebookResumed")])
        out["durable checksum"] = durable
        return out

    got = run_both(scenario, culling=False, suspend_http_get=transport)
    assert_same(got)
    return got["port"]


def test_resume_verifies_restored_kernel():
    port = verified_resume("verified", "feedface", {"restored": True, "step": 11, "checksum": "feedface"})
    assert port["durable checksum"] == "feedface"
    assert port["counters"]["verifications ok"] == 1 and port["counters"]["verifications mismatch"] == 0
    assert any(r == "RestoreVerified" for _, r, _ in port["events"]["verified"])


def test_resume_restore_mismatch_is_loud():
    port = verified_resume("tainted", "aaaa", {"restored": True, "step": 3, "checksum": "bbbb"})
    assert port["counters"]["verifications mismatch"] == 1
    assert any(r == "RestoreVerifyFailed" for _, r, _ in port["events"]["tainted"])
    # live-but-suspect beats wedged: the resume completed
    assert port["sequences"]["tainted"][-1] == ""


# ---------------------------------------------------------------------------
# the reclaimer and serving endpoints
# ---------------------------------------------------------------------------


def test_reclaimer_treats_endpoints_by_priority_and_spares_draining():
    cfg = dict(enable_culling=False, suspend_enabled=True, readiness_probe_period_s=0.15,
               suspend_checkpoint_window_s=1.0, resume_timeout_s=10.0, resume_max_attempts=4,
               reclaim_pending_grace_s=0.3, serving_loading_window_s=8.0, serving_drain_timeout_s=30.0)

    def scenario(env):
        C, Endpoint = env.C, env.side.inference.InferenceEndpoint

        def ep_ann():
            return env.client.get(Endpoint, NS, "live-traffic").metadata.annotations

        env.endpoint("live-traffic")  # priority unset: the endpoints' default, above interactive
        wait_for(lambda: ep_ann().get(C.INFERENCE_STATE_ANNOTATION) == "serving", timeout=TIMEOUT,
                 msg="endpoint Serving")
        env.notebook("idler", priority=2)
        wait_for(lambda: env.mesh_ready("idler"), timeout=TIMEOUT, msg="notebook up")
        env.agents["idler-0"].checkpoint_hook = lambda: {"step": 1}
        env.notebook("vip", priority=5)
        wait_for(lambda: env.mesh_ready("vip"), timeout=TIMEOUT, msg="vip placed via reclaim")
        idler = env.state("idler")
        first = {"state": ep_ann().get(C.INFERENCE_STATE_ANNOTATION), "stopped": C.STOP_ANNOTATION in ep_ann()}
        wait_for(lambda: env.state("idler") == "suspended", timeout=TIMEOUT, msg="idler parked")
        env.patch("live-traffic", {C.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}, kind=Endpoint)
        wait_for(lambda: ep_ann().get(C.INFERENCE_STATE_ANNOTATION) == "draining", timeout=20,
                 msg="endpoint Draining")
        env.notebook("vip2", priority=9)
        time.sleep(2.0)
        out = env.settled("idler", "vip", "vip2")
        out.update(idler_at_vip=idler in ("checkpointing", "suspended"), endpoint_at_vip=first,
                   draining_reclaim=ep_ann().get(C.TPU_RECLAIM_ANNOTATION, ""))
        return out

    got = run_both(scenario, cfg=cfg, serving=True, culling=False)
    assert_same(got)
    port = got["port"]
    assert port["idler_at_vip"] and port["endpoint_at_vip"] == {"state": "serving", "stopped": False}
    assert port["draining_reclaim"] == "", "a Draining endpoint was re-victimized mid-drain"


# ---------------------------------------------------------------------------
# the culler's suspend stamp and the idle clock across a resume
# ---------------------------------------------------------------------------


def test_resume_rearms_idle_clock_no_instant_recull():
    """tests/test_culling.py's case: a notebook idle from the start is culled
    into suspension by the culler's own stamp; unstopped with a poisoned
    last-activity, it resumes without an instant re-cull (the clock re-armed
    from resume time) and is culled again once genuinely idle."""
    cfg = dict(enable_culling=True, suspend_enabled=True, cull_idle_time_min=4.0 / 60.0,
               idleness_check_period_min=0.1 / 60.0, readiness_probe_period_s=0.1,
               suspend_checkpoint_window_s=0.5, resume_timeout_s=20.0, resume_max_attempts=4)

    def scenario(env):
        C = env.C
        env.notebook("napper")
        wait_for(lambda: env.state("napper") == "suspended", timeout=TIMEOUT, msg="culled into Suspended")
        env.patch("napper", {C.LAST_ACTIVITY_ANNOTATION: "2020-01-01T00:00:00Z"})
        t_unstop = time.time()
        env.unstop("napper")
        wait_for(lambda: not env.state("napper") and env.mesh_ready("napper"), timeout=TIMEOUT, msg="resumed")
        after_resume = C.STOP_ANNOTATION in env.get("napper").metadata.annotations
        wait_for(lambda: rearmed(env, "napper", t_unstop), timeout=10, msg="idle clock re-armed from resume time")
        recull = False
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            recull |= C.STOP_ANNOTATION in env.get("napper").metadata.annotations
            time.sleep(0.1)
        wait_for(lambda: C.STOP_ANNOTATION in env.get("napper").metadata.annotations, timeout=TIMEOUT,
                 msg="culled again once genuinely idle")
        wait_for(lambda: env.state("napper") == "suspended", timeout=TIMEOUT, msg="suspended again")
        out = env.settled("napper")
        out.update(stopped_after_resume=after_resume, instant_recull=recull)
        return out

    got = run_both(scenario, cfg=cfg, slices=1, duty=0.0, kernels_busy=False)
    assert_same(got)
    port = got["port"]
    assert not port["stopped_after_resume"] and not port["instant_recull"]
    assert port["sequences"]["napper"] == ["", "checkpointing", "suspended", "resuming", "", "checkpointing",
                                           "suspended"]


# ---------------------------------------------------------------------------
# port-only: a bound resume slower than its attempt window keeps its claim
# ---------------------------------------------------------------------------


def test_a_resume_bound_but_slower_than_its_attempt_window_keeps_its_claim():
    """A warm-hit resume whose pod needs longer than one attempt window to
    come up (a card pod's start to its CUDA context, 8-16 s, against Config's
    8.5-11.5 s window): once the pod is bound on the claimed slice, the
    window running out neither drops that claim back to warm nor claims
    again. One hit is counted, the slice under the pod stays claimed by the
    notebook until the resume completes, and the resume completes without
    ResumeFailed. The reference's `_await_resume` releases the slice to
    warm at every window and claims it again: three hits, the claim
    written off and back, and the attempts spent before the pod is up."""
    from odh_kubeflow_tpu_torch.cluster.slicepool import POOL_CLAIMED_BY_ANNOTATION, POOL_STATE_ANNOTATION

    cfg = dict(FAST, enable_culling=False, resume_timeout_s=8.0, resume_max_attempts=4)
    # every pod takes 5 s from its bind to ready: two windows of 1.7-2.3 s
    # and more, and the bind well inside the first
    env = Env(PORT, cfg=cfg, slices=1, culling=False, cold_start_s=5.0)
    try:
        env.notebook("slow")
        wait_for(lambda: env.mesh_ready("slow"), timeout=TIMEOUT, msg="bring-up")
        env.stop_nb("slow")
        wait_for(lambda: env.suspended("slow"), timeout=TIMEOUT, msg="suspended, its slice warm")
        watch = env.cluster.store.watch("v1", "Node")
        before = env.counters()
        env.unstop("slow")
        wait_for(lambda: env.active("slow"), timeout=TIMEOUT, msg="resumed")
        events, ev = list(watch.pending), watch.get(timeout=0.2)
        while ev is not None:
            events.append(ev)
            ev = watch.get(timeout=0.2)
        watch.stop()
        marks = []
        for ev in events:
            ann = ev.object["metadata"].get("annotations") or {}
            mark = (ann.get(POOL_STATE_ANNOTATION), ann.get(POOL_CLAIMED_BY_ANNOTATION))
            if not marks or marks[-1] != mark:
                marks.append(mark)
        after = env.counters()
        assert after["hits"] - before["hits"] == 1 and after["misses"] == before["misses"], (before, after)
        assert marks == [("warm", None), ("claimed", f"{NS}/slow"), (None, None)], marks
        assert env.sequences.of("slow")["annotation"][-2:] == ["resuming", ""]
        assert not env.has_event("ResumeFailed", "slow")
    finally:
        env.stop()


# ---------------------------------------------------------------------------
# the pool-claim and checkpoint-before-suspend invariants, against the JAX Monitor
# ---------------------------------------------------------------------------


def invariant_world(side, cfg=None):
    """A stopped store world with one pool and a Monitor that collects: the
    write tier plus checkpoint-before-suspend, as the reference's explorer
    arms it."""
    from importlib import import_module

    inv = import_module(f"{'odh_kubeflow_tpu' if side is JAX else 'odh_kubeflow_tpu_torch'}.utils.invcheck")
    cluster = side.cluster.SimCluster()
    accelerator, topology = side.slices["one-host"]
    side.add_pool(cluster, "pool", accelerator, topology, slices=1)
    monitor = inv.Monitor(extra={"checkpoint-before-suspend": inv.check_checkpoint_before_suspend}, collect=True,
                          chip_budget=0)
    cluster.store.invariants = monitor
    return cluster, monitor


def pool_writes(side, cluster, steal):
    """Claim the pool's node warm -> claimed by a, then either release it
    back to warm and let b claim it (legal), or write b's claim straight
    over a's (the stolen claim)."""
    sp, Node = side.slicepool, side.core.Node
    (node,) = [n.metadata.name for n in cluster.client.list(Node)]

    def mark(state, owner):
        n = cluster.client.get(Node, "", node)
        ann = n.metadata.annotations
        ann[sp.POOL_STATE_ANNOTATION] = state
        if owner:
            ann[sp.POOL_CLAIMED_BY_ANNOTATION] = owner
        else:
            ann.pop(sp.POOL_CLAIMED_BY_ANNOTATION, None)
        cluster.client.update(n)

    mark("warm", "")
    mark("claimed", "ns/a")
    if not steal:
        mark("warm", "")
    mark("claimed", "ns/b")


def suspend_writes(side, cluster, saved):
    """A notebook with a ready pod goes checkpointing -> suspended, with a
    checkpoint-saved step or without one (the skipped window)."""
    C, core = side.C, side.core
    nb = side.nb.Notebook()
    nb.metadata.name, nb.metadata.namespace = "nb", NS
    nb.spec.template.spec.containers = [core.Container(name="nb", image="jax:1")]
    cluster.client.create(nb)
    pod = core.Pod()
    pod.metadata.name, pod.metadata.namespace = "nb-0", NS
    pod.metadata.labels[C.NOTEBOOK_NAME_LABEL] = "nb"
    pod.spec.containers = [core.Container(name="nb", image="jax:1")]
    pod = cluster.client.create(pod)
    pod.status.conditions = [side.am.Condition(type="Ready", status="True")]
    cluster.client.update_status(pod)

    def stamp(annotations):
        cluster.client.patch(side.nb.Notebook, NS, "nb", {"metadata": {"annotations": annotations}})

    stamp({C.STOP_ANNOTATION: "2026-01-01T00:00:00Z", C.TPU_SUSPEND_STATE_ANNOTATION: "checkpointing"})
    stamp({C.TPU_SUSPEND_STATE_ANNOTATION: "suspended",
           **({C.TPU_CHECKPOINT_SAVED_ANNOTATION: "3"} if saved else {})})


def test_the_pool_claim_and_checkpoint_before_suspend_invariants_judge_as_the_jax_monitor():
    got = {}
    for side in (JAX, PORT):
        seen = {}
        for case, writes in (("claim handed over", lambda c: pool_writes(side, c, steal=False)),
                             ("claim stolen", lambda c: pool_writes(side, c, steal=True)),
                             ("suspend with its save", lambda c: suspend_writes(side, c, saved=True)),
                             ("suspend without a save", lambda c: suspend_writes(side, c, saved=False))):
            cluster, monitor = invariant_world(side)
            writes(cluster)
            seen[case] = sorted((v.invariant, v.detail) for v in monitor.violations)
        got[side.name] = seen
    assert got["jax"] == got["port"], got
    port = got["port"]
    assert port["claim handed over"] == [] and port["suspend with its save"] == []
    assert [i for i, _ in port["claim stolen"]] == ["pool-claim-cas"], port["claim stolen"]
    assert [i for i, _ in port["suspend without a save"]] == ["checkpoint-before-suspend"], \
        port["suspend without a save"]
