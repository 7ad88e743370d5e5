"""The port's judgement layer (runtime/slo.py, runtime/alerts.py,
runtime/prober.py) against the JAX package's, on the CPU: the engine and
indicator cases, the alert cases, the canary round trip, the default
rules' feasibility and the seeded slice bad day of tests/test_slo.py, each
run with the same inputs and the same fake clock through both packages
(each side its own registry, store and flight recorder), the results
compared exactly: the status dicts each tick gives, the alert history
(fires and resolves, in order, with their burn rates and times), the
shipped SLOs and rules. Also one seeded stream of observations judged by
both engines and alert managers tick for tick, and the layer's Config
fields read from the same env.

The SLOs' descriptions are not compared: the port's name the GPU where
the reference's name the TPU and `jax.devices()`. The bad day reads its
incidents, a bundle, the judgement layer and the degraded notebook's spans
over each side's manager debug mux (/debug/incidents, /debug/slo,
/debug/traces), as the reference's does. The definition lint
(`analysis/metric_rules.py` `check_slo_definitions`) holds each package's
shipped definitions against its live registry, and flags the same seeded
bad definitions with the same texts on both. Left out: the wall-clock
overhead case (`tests/test_accounting.py`'s overhead case is left out for
the same reason: it fails under load)."""
import random
import time
from types import SimpleNamespace

import pytest

import odh_kubeflow_tpu.analysis.metric_rules as j_rules
import odh_kubeflow_tpu.controllers.metrics as j_cmetrics
import odh_kubeflow_tpu.runtime.alerts as j_alerts
import odh_kubeflow_tpu.runtime.metrics as j_rm
import odh_kubeflow_tpu.runtime.prober as j_prober
import odh_kubeflow_tpu.runtime.slo as j_slo
import odh_kubeflow_tpu_torch.analysis.metric_rules as p_rules
import odh_kubeflow_tpu_torch.controllers.metrics as p_cmetrics
import odh_kubeflow_tpu_torch.runtime.alerts as p_alerts
import odh_kubeflow_tpu_torch.runtime.metrics as p_rm
import odh_kubeflow_tpu_torch.runtime.prober as p_prober
import odh_kubeflow_tpu_torch.runtime.slo as p_slo
import torch_threads
from torch_sides import JAX as JAX_SIDE, PORT as PORT_SIDE, both as both_at_once, wait_for

torch_threads.cap()

JAX = SimpleNamespace(name="jax", slo=j_slo, alerts=j_alerts, prober=j_prober, rm=j_rm, side=JAX_SIDE,
                      rules=j_rules, cmetrics=j_cmetrics)
PORT = SimpleNamespace(name="port", slo=p_slo, alerts=p_alerts, prober=p_prober, rm=p_rm, side=PORT_SIDE,
                       rules=p_rules, cmetrics=p_cmetrics)


def both(case):
    """case(side) on each package, one after the other; asserts the results
    equal and returns the port's."""
    jax, port = case(JAX), case(PORT)
    assert jax == port, (jax, port)
    return port


def engine(side, reg, slos, t, scale=1.0):
    return side.slo.SLOEngine(registry=reg, slos=slos, clock=lambda: t[0], window_scale=scale, eval_period_s=1.0)


# ---------------------------------------------------------------------------
# burn-rate math (fake clock, private registry)
# ---------------------------------------------------------------------------


def test_latency_slo_windowed_compliance_and_burn():
    def run(side):
        reg = side.rm.Registry()
        hist = reg.histogram("lat_seconds", "h", buckets=(1, 5, 10))
        slo = side.slo.SLO("lat", objective=0.9, indicator=side.slo.LatencyIndicator("lat_seconds", 1.0))
        t = [1000.0]
        eng = engine(side, reg, [slo], t)
        out = [eng.evaluate()["lat"]]  # the baseline before any event
        for _ in range(9):
            hist.observe(0.5)
        hist.observe(7.0)
        t[0] += 10
        out.append(eng.evaluate()["lat"])
        t[0] += 60  # a burst of pure failures
        for _ in range(10):
            hist.observe(7.0)
        out.append(eng.evaluate()["lat"])
        t[0] += 301  # the outage ages out of the fast window, not the slow one
        out.append(eng.evaluate()["lat"])
        return out, eng.status()

    out, status = both(run)
    assert out[1]["windows"]["5m"] == {"compliance": 0.9, "burn_rate": 1.0}
    assert out[2]["windows"]["5m"]["compliance"] == pytest.approx(9 / 20)
    assert out[2]["windows"]["5m"]["burn_rate"] == pytest.approx((1 - 9 / 20) / 0.1, rel=1e-4)
    assert out[3]["windows"]["5m"] == {"compliance": 1.0, "burn_rate": 0.0}
    assert out[3]["windows"]["6h"]["compliance"] == pytest.approx(9 / 20)
    assert status["slos"]["lat"] == out[3]


def test_event_ratio_indicator_good_labels():
    def run(side):
        reg = side.rm.Registry()
        probes = reg.counter("probes_total", "p", labels=("result",))
        slo = side.slo.SLO("canary", objective=0.9,
                           indicator=side.slo.EventRatioIndicator("probes_total", (("result", "ok"),)))
        t = [0.0]
        eng = engine(side, reg, [slo], t)
        eng.evaluate()
        probes.inc(8, result="ok")
        probes.inc(2, result="timeout")
        t[0] += 10
        return eng.evaluate()["canary"]

    status = both(run)
    assert status["windows"]["5m"] == {"compliance": 0.8, "burn_rate": 2.0}
    assert status["events"] == {"good": 8.0, "total": 10.0}


def test_gauge_indicator_time_weighted_and_unset_gauge_is_compliant():
    def run(side):
        reg = side.rm.Registry()
        avail = reg.gauge("avail_ratio", "a")
        slo = side.slo.SLO("avail", objective=0.99, indicator=side.slo.GaugeIndicator("avail_ratio"))
        t = [0.0]
        eng = engine(side, reg, [slo], t)
        out = [eng.evaluate()["avail"]]  # never set: no burn
        avail.set(1.0)
        eng.evaluate()  # the integration's anchor
        t[0] += 10
        eng.evaluate()  # 10 s at 1.0
        avail.set(0.5)
        t[0] += 10
        out.append(eng.evaluate()["avail"])  # 10 s more at 0.5
        return out

    out = both(run)
    assert out[0]["windows"]["5m"]["compliance"] == 1.0
    assert out[1]["windows"]["5m"]["compliance"] == pytest.approx(0.75)
    assert out[1]["windows"]["5m"]["burn_rate"] == pytest.approx(0.25 / 0.01, rel=1e-4)


def test_window_scale_shrinks_real_windows_keeps_names():
    def run(side):
        eng = side.slo.SLOEngine(registry=side.rm.Registry(), slos=side.slo.default_slos(), window_scale=0.002)
        return eng.windows, eng.eval_period_s

    windows, period = both(run)
    assert windows["5m"] == pytest.approx(0.6) and windows["6h"] == pytest.approx(43.2)
    assert set(windows) == {"5m", "30m", "1h", "6h"} and period == pytest.approx(0.05)


def test_a_seeded_stream_judged_alike():
    """One seeded stream of observations (a latency histogram, a good/total
    counter, a ratio gauge) over 600 ticks of a fake clock, judged by both
    engines at the bad day's window scale and by both alert managers with
    the default pairs of rules: every tick's statuses and every fire and
    resolve equal."""
    rng = random.Random(0x510)
    ticks = []
    for i in range(600):
        bad = 200 <= i < 260 or 420 <= i < 430  # two outages
        ticks.append(([rng.choice([0.2, 0.4, 3.0] if bad else [0.1, 0.2, 0.4, 0.9]) for _ in range(rng.randint(0, 3))],
                      (rng.randint(0, 3), rng.randint(0, 2) if bad else 0),
                      0.0 if bad and rng.random() < 0.8 else 1.0, rng.uniform(0.02, 0.08)))

    def run(side):
        reg = side.rm.Registry()
        hist = reg.histogram("lat_seconds", "h", buckets=(0.25, 0.5, 1, 5))
        probes = reg.counter("probes_total", "p", labels=("result",))
        avail = reg.gauge("avail_ratio", "a")
        slos = [side.slo.SLO("lat", 0.9, side.slo.LatencyIndicator("lat_seconds", 0.5), category="readiness"),
                side.slo.SLO("probe", 0.99, side.slo.EventRatioIndicator("probes_total", (("result", "ok"),)),
                             category="readiness"),
                side.slo.SLO("avail", 0.999, side.slo.GaugeIndicator("avail_ratio"), category="availability")]
        t = [0.0]
        eng = side.slo.SLOEngine(registry=reg, slos=slos, clock=lambda: t[0], window_scale=0.002,
                                 eval_period_s=0.05)
        am = side.alerts.AlertManager(rules=side.alerts.default_rules(slos), clock=lambda: t[0])
        eng.add_listener(am.evaluate)
        statuses = []
        for lats, (ok, failed), up, dt in ticks:
            for x in lats:
                hist.observe(x)
            probes.inc(ok, result="ok")
            probes.inc(failed, result="timeout")
            avail.set(up)
            t[0] += dt
            statuses.append(eng.evaluate())
        return statuses, am.history, sorted(am.firing)

    statuses, history, firing = both(run)
    fired = {h["rule"] for h in history if h["event"] == "fired"}
    assert {"avail-fast-burn", "lat-fast-burn"} <= fired and any(h["event"] == "resolved" for h in history), history


# ---------------------------------------------------------------------------
# alert lifecycle: fire / dedup / resolve / inhibition
# ---------------------------------------------------------------------------


def _status(category="readiness", burn_long=0.0, burn_short=0.0):
    return {"s": {"category": category,
                  "windows": {"1h": {"burn_rate": burn_long, "compliance": 1.0},
                              "5m": {"burn_rate": burn_short, "compliance": 1.0}}}}


def test_alert_fires_dedups_and_resolves_on_long_window():
    def run(side):
        t = [100.0]
        rule = side.alerts.AlertRule("s-fast-burn", "s", "1h", "5m", 14.4)
        am = side.alerts.AlertManager(rules=[rule], clock=lambda: t[0])
        firing = []
        steps = [(0, 1.0, 99.0), (0, 99.0, 1.0), (0, 20.0, 20.0), (5, 21.0, 21.0), (0, 20.0, 0.5), (5, 2.0, 0.5)]
        for dt, long_burn, short_burn in steps:
            t[0] += dt
            am.evaluate(_status(burn_long=long_burn, burn_short=short_burn))
            firing.append(sorted(am.firing))
        return firing, am.history

    firing, history = both(run)
    # the short window alone never fires; the long alone neither; a resolve
    # keys off the long window only
    assert firing == [[], [], ["s-fast-burn"], ["s-fast-burn"], ["s-fast-burn"], []]
    assert [h["event"] for h in history] == ["fired", "resolved"]
    assert history[1]["resolved_at"] - history[1]["since"] == pytest.approx(10.0)


def test_slice_repair_inhibits_readiness_but_not_availability():
    def run(side):
        repair_active = [True]
        am = side.alerts.AlertManager(rules=[side.alerts.AlertRule("ready-fast", "s", "1h", "5m", 14.4)],
                                      clock=lambda: 0.0)
        am.register_inhibitor("readiness", lambda: repair_active[0], name="slice-repair-in-progress")
        out = []
        am.evaluate(_status(category="readiness", burn_long=50, burn_short=50))
        out.append(sorted(am.firing))  # inhibited mid-repair
        am.evaluate(_status(category="availability", burn_long=50, burn_short=50))
        out.append(sorted(am.firing))  # the availability page pages right through
        del am.firing["ready-fast"]
        repair_active[0] = False
        am.evaluate(_status(category="readiness", burn_long=50, burn_short=50))
        out.append(sorted(am.firing))
        return out, am.status()["inhibitors"]

    out, inhibitors = both(run)
    assert out == [[], ["ready-fast"], ["ready-fast"]]
    assert inhibitors == {"readiness": ["slice-repair-in-progress"]}


# ---------------------------------------------------------------------------
# the shipped definitions
# ---------------------------------------------------------------------------


def _definitions(side):
    slos = side.slo.default_slos()
    return ([(s.name, s.objective, type(s.indicator).__name__, s.indicator.metric_names(),
              getattr(s.indicator, "threshold_s", None), getattr(s.indicator, "good_labels", None), s.category)
             for s in slos],
            [(r.name, r.slo, r.long_window, r.short_window, r.burn_threshold, r.severity)
             for r in side.alerts.default_rules()])


def test_default_rules_are_always_feasible():
    """Burn is capped at 1/error_budget: the shipped rules clamp their
    thresholds under the cap, or the low-objective SLOs (p50 at 0.50)
    would ship pages that can never fire. Both packages ship the same
    objectives over the same families and the same rules."""
    slos, rules = both(_definitions)
    budget = {name: 1.0 - objective for name, objective, *_ in slos}
    for name, slo, _, _, threshold, _ in rules:
        assert threshold <= 1.0 / max(1e-9, budget[slo]), (name, threshold)
    by_name = {r[0]: r for r in rules}
    assert by_name["notebook-availability-fast-burn"][4] == 14.4
    assert by_name["readiness-latency-p50-fast-burn"][4] < 2.0
    assert len(slos) == 11 and len(rules) == 22


def test_every_shipped_slo_reads_a_family_the_port_registers():
    """Each referenced family exists in the port's registry once the
    judgement layer and the notebook controllers' metrics are loaded, with
    the type its indicator reads, and a latency threshold sits on a
    bucket boundary."""
    from odh_kubeflow_tpu_torch.controllers.metrics import NotebookMetrics
    from odh_kubeflow_tpu_torch.utils.metrics import Counter, Gauge, Histogram

    NotebookMetrics(p_rm.global_registry)
    for slo in p_slo.default_slos():
        (name,) = slo.metric_names()
        family = p_rm.global_registry.get(name)
        want = {"LatencyIndicator": Histogram, "EventRatioIndicator": Counter,
                "GaugeIndicator": Gauge}[type(slo.indicator).__name__]
        assert isinstance(family, want), (slo.name, name, family)
        if isinstance(family, Histogram):
            assert slo.indicator.threshold_s in family.buckets, (slo.name, family.buckets)


# ---------------------------------------------------------------------------
# the definition lint (analysis/metric_rules.py check_slo_definitions)
# ---------------------------------------------------------------------------


def test_slo_lint_default_definitions_clean_on_both():
    """Each package's shipped SLOs and rules against its own live
    registry, once the canary and the notebook controllers' families are
    registered: no violation."""
    def case(side):
        side.cmetrics.NotebookMetrics(side.rm.global_registry)
        slos = side.slo.default_slos()
        return side.rules.check_slo_definitions(slos, side.alerts.default_rules(slos), side.rm.global_registry)

    assert both(case) == []


def test_slo_lint_flags_bad_definitions_on_both():
    """The reference's seeded bad definitions (an unregistered family, a
    threshold off the buckets, an objective outside (0, 1), a rule of no
    SLO, an unknown window, a threshold above the burn cap), each flagged
    with the same text by both packages."""
    def case(side):
        reg = side.rm.Registry()
        reg.histogram("real_seconds", "h", buckets=(1, 5))
        slo = side.slo
        bad_slos = [
            slo.SLO("ghost", 0.9, slo.LatencyIndicator("no_such_metric_seconds", 1.0)),
            slo.SLO("offgrid", 0.9, slo.LatencyIndicator("real_seconds", 2.5)),
            slo.SLO("outside", 1.5, slo.GaugeIndicator("nope_ratio")),
        ]
        rule = side.alerts.AlertRule
        bad_rules = [
            rule("dangling", "no-such-slo", "1h", "5m", 14.4),
            rule("badwin", "ghost", "2h", "5m", 14.4),
            rule("deadrule", "ghost", "1h", "5m", 14.4),
        ]
        return side.rules.check_slo_definitions(bad_slos, bad_rules, reg)

    text = "\n".join(both(case))
    assert "unregistered metric 'no_such_metric_seconds'" in text
    assert "not a bucket boundary" in text
    assert "objective 1.5 outside" in text
    assert "undefined SLO 'no-such-slo'" in text
    assert "unknown window '2h'" in text
    assert "deadrule" in text and "can never fire" in text


# ---------------------------------------------------------------------------
# the black-box canary prober, on a hand-wired manager
# ---------------------------------------------------------------------------


def test_canary_probe_full_roundtrip_and_cleanup():
    """A CPU canary through each side's admission webhook, workbench
    extension, notebook reconciler and readiness gate on one CPU node: `ok`,
    counted once, its CR and pods gone afterwards on both sides."""
    def scenario(env):
        side, cluster, mgr = env
        prober = (JAX if side is JAX_SIDE else PORT).prober
        ok0 = prober.canary_probes_total.value(result="ok")
        canary = prober.CanaryProber(mgr, period_s=60.0, timeout_s=20.0)
        result, latency = canary.probe_once()

        def gone():
            try:
                cluster.client.get(side.nb.Notebook, canary.namespace, "canary-1")
                return False
            except side.am.NotFoundError:
                return not cluster.client.list(side.core.Pod, namespace=canary.namespace)

        wait_for(gone, msg="canary CR and its pods cleaned up")
        return {"result": result, "latency positive": latency > 0,
                "counted": prober.canary_probes_total.value(result="ok") - ok0, "runs": canary.probes_run,
                "exempt label": side.C.TPU_RECLAIM_EXEMPT_LABEL in canary._make_canary("x").metadata.labels}

    def make_env(side):
        cluster = side.cluster.SimCluster().start()
        cluster.add_cpu_pool("cpu", nodes=1)
        mgr = side.runtime.Manager(cluster.store)
        config = side.ctrl.Config()
        side.ctrl.NotebookWebhook(mgr.client, config).register(cluster.store)
        side.ctrl.NotebookReconciler(mgr, config).setup()
        side.ctrl.TPUWorkbenchReconciler(mgr, config).setup()
        side.ctrl.ProbeStatusController(mgr, config, http_get=cluster.http_get).setup()
        mgr.start()
        return side, cluster, mgr

    def stop_env(env):
        _, cluster, mgr = env
        mgr.stop()
        cluster.stop()

    got = both_at_once(scenario, make_env, stop_env)
    assert got["jax"] == got["port"] == {"result": "ok", "latency positive": True, "counted": 1, "runs": 1,
                                         "exempt label": True}, got


# ---------------------------------------------------------------------------
# acceptance: the seeded slice bad day through the judgement layer
# ---------------------------------------------------------------------------

NS = "repair"
BAD_DAY = (("a-pod-0", "multi-host"), ("a-pod-1", "multi-host"), ("a-nb-0", "one-host"), ("a-nb-1", "one-host"))


class BadDay:
    """One side's cluster for the bad day: two pools of the multi-host
    slice, three of the one-host slice, the reference test's notebook
    reconciler, gate and repair controller with sim agents, and the
    judgement layer on scaled windows (5m -> 0.6 s, 1h -> 7.2 s): the
    availability SLO, its fast page, an AlertManager mirroring onto the
    notebooks and snapshotting this side's flight recorder."""

    def __init__(self, side):
        self.side, self.C = side, side.C
        pkg = JAX if side is JAX_SIDE else PORT
        self.cluster = side.cluster.SimCluster().start()
        for which, slices in (("multi-host", 2), ("one-host", 3)):
            accelerator, topology = side.slices[which]
            side.add_pool(self.cluster, which, accelerator, topology, slices=slices)
        self.client = self.cluster.client
        self.mgr = side.runtime.Manager(self.cluster.store)
        fast = side.ctrl.Config(readiness_probe_period_s=0.15, checkpoint_window_s=1.0, repair_max_attempts=4,
                                repair_backoff_s=0.3, repair_backoff_max_s=1.0)
        side.ctrl.NotebookReconciler(self.mgr, fast).setup()
        side.ctrl.ProbeStatusController(self.mgr, fast, http_get=self.cluster.http_get).setup()
        repair = side.ctrl.SliceRepairController(self.mgr, fast, http_get=self.cluster.http_get)
        repair.unreachable_dwell_s = 0.6
        repair.setup()
        self.agents = {}
        self.cluster.add_pod_behavior(side.behavior(self.agents, duty=0.9, kernels_busy=True))
        slo = pkg.slo.SLO("notebook-availability", objective=0.999,
                          indicator=pkg.slo.GaugeIndicator("notebook_available_ratio"), category="availability")
        self.engine = pkg.slo.SLOEngine(registry=self.mgr.metrics, slos=[slo], window_scale=0.002,
                                        eval_period_s=0.05)
        self.rule = pkg.alerts.AlertRule("availability-fast-burn", "notebook-availability", "1h", "5m", 14.4)
        self.alerts = pkg.alerts.AlertManager(rules=[self.rule], manager=self.mgr, recorder=side.recorder)
        self.engine.add_listener(self.alerts.evaluate)
        self.mgr.slo_engine, self.mgr.alert_manager, self.mgr.flight_recorder = self.engine, self.alerts, side.recorder
        self.mgr.add_service(self.engine)
        self.mgr.start()
        self.endpoints = self.mgr.serve_endpoints(metrics_port=0, health_port=0, host="127.0.0.1")

    def debug(self, path):
        """A JSON read of this side's debug mux."""
        import json
        import urllib.request

        host, port = self.endpoints.metrics_address
        with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=5) as r:
            return json.loads(r.read())

    def stop(self):
        try:
            self.endpoints.stop()
            self.mgr.stop()
        finally:
            self.cluster.stop()
            self.cluster.faults.clear()

    def get(self, name):
        return self.client.get(self.side.nb.Notebook, NS, name)

    def mesh_ready(self, name):
        nb = self.get(name)
        return nb.status.tpu is not None and nb.status.tpu.mesh_ready

    def condition(self, name, ctype):
        return next((c for c in self.get(name).status.conditions if c.type == ctype), None)

    def events(self, reason):
        return {e.involved_object.name for e in self.client.list(self.side.core.Event, namespace=NS)
                if e.reason == reason}


def test_bad_day_fires_alert_mirrors_condition_and_bundles_incidents():
    """The acceptance path on both packages at once: the seeded slice bad
    day -> the availability page fires within the fast pair's long window
    -> an SLOBurnRate event and DegradedSLO on the affected notebook -> it
    resolves after the repairs -> DegradedSLO False (Recovered) -> exactly
    the expected incident bundles (one per degraded notebook, one per
    RepairFailed, one per firing), each carrying the recorder's ring and
    the notebook's state. Compared: the plan, the rules that fired and
    resolved, the mirrored condition's end, each side's bundles against
    what its own bad day degraded, and the bundles' reasons (which
    notebooks a host's unreachability degrades, and whether a repair runs
    out of attempts, turn on each side's timing: the slice-repair parity
    soak compares its end state too)."""
    def scenario(env):
        side, C = env.side, env.C
        retry = (side.am.ConflictError, side.am.TooManyRequestsError)
        for name, which in BAD_DAY:
            accelerator, topology = side.slices[which]
            nb = side.nb.Notebook()
            nb.metadata.name, nb.metadata.namespace = name, NS
            nb.spec.template.spec.containers = [side.core.Container(name=name, image="img:1")]
            nb.spec.tpu = side.nb.TPUSpec(accelerator=accelerator, topology=topology)
            env.client.create(nb)
        for name, _ in BAD_DAY:
            wait_for(lambda n=name: env.mesh_ready(n), msg=f"{name} up")
        wait_for(lambda: env.engine.evaluate()["notebook-availability"]["windows"]["1h"]["burn_rate"]
                 < env.rule.burn_threshold and not env.alerts.firing, msg="a calm baseline before the faults")
        side.recorder.clear()
        env.alerts.history.clear()
        pod_nodes = {p.metadata.name: p.spec.node_name for p in env.client.list(side.core.Pod, namespace=NS)
                     if p.spec.node_name and p.metadata.labels.get(C.NOTEBOOK_NAME_LABEL)}
        fault_t0 = time.monotonic()
        plan = side.cluster.seeded_slice_bad_day(env.cluster, seed=0x51CE, pod_nodes=pod_nodes, agents=env.agents,
                                                 grace_s=0.4)
        fired = wait_for(lambda: next((h for h in env.alerts.history if h["event"] == "fired"), None),
                         timeout=20, msg="the availability page fired")
        fired_within = time.monotonic() - fault_t0 < env.engine.windows["1h"] + 5.0
        _, _, mirrored = fired["notebooks"][0].partition("/")
        wait_for(lambda: mirrored in env.events("SLOBurnRate"), msg="the SLOBurnRate event", retry=retry)
        wait_for(lambda: (c := env.condition(mirrored, C.SLO_DEGRADED_CONDITION)) is not None and (
            c.status == "True" or (c.status, c.reason) == ("False", "Recovered")), msg="DegradedSLO mirrored",
            retry=retry)
        time.sleep(1.5)  # maintenance ends: capacity returns
        for node in plan["preempted"]:
            env.cluster.restore_node(node)

        def settled(name):
            nb = env.get(name)
            state = nb.metadata.annotations.get(C.TPU_REPAIR_STATE_ANNOTATION, "")
            if state == "failed":
                return name in env.events("RepairFailed")
            if state:
                return False
            c = env.condition(name, C.TPU_DEGRADED_CONDITION)
            return env.mesh_ready(name) and (c is None or c.status == "False")

        for name, _ in BAD_DAY:
            wait_for(lambda n=name: settled(n), timeout=60, retry=retry,
                     msg=f"{name} neither repaired nor RepairFailed")
        wait_for(lambda: not env.alerts.firing, timeout=40, msg="the page resolved after the repairs")
        wait_for(lambda: (c := env.condition(mirrored, C.SLO_DEGRADED_CONDITION)) is not None
                 and (c.status, c.reason) == ("False", "Recovered"), msg="DegradedSLO Recovered", retry=retry)
        expected = {("slice-degraded", f"{NS}/{n}") for n in env.events("SliceDegraded")}
        expected |= {("repair-failed", f"{NS}/{n}") for n in env.events("RepairFailed")}
        expected |= {(f"alert:{h['rule']}", h["slo"]) for h in env.alerts.history if h["event"] == "fired"}
        incidents = env.debug("/debug/incidents")["incidents"]
        observed = {(i["reason"], i["subject"]) for i in incidents}
        some = next(i for i in incidents if i["reason"] == "slice-degraded")
        bundle = env.debug(f"/debug/incidents?id={some['id']}")
        nb_state = next(iter(bundle["state"].values()))
        served = env.debug("/debug/slo")
        _, _, degraded = some["subject"].partition("/")
        traced = env.debug(f"/debug/traces?notebook={NS}/{degraded}")["spans"]
        return {"plan": {"preempted pods": sorted(p for p, n in pod_nodes.items() if n in plan["preempted"]),
                         "chip_loss": plan["chip_loss"], "ici": plan["ici"]},
                "fired within the window": fired_within, "rule": fired["rule"], "named notebooks": bool(fired["notebooks"]),
                "transitions": [(h["event"], h["rule"]) for h in env.alerts.history][:2],
                "incidents as expected": observed == expected,
                "bundled": sorted({reason for reason, _ in observed} - {"repair-failed"}),
                "bundle": (bool(bundle["records"]), "notebook" in nb_state and "pods" in nb_state),
                "served": {"slos": sorted(served["engine"]["slos"]), "firing": served["alerts"]["firing"],
                           "rules": [r["name"] for r in served["alerts"]["rules"]],
                           "incidents match the recorder": incidents == side.recorder.incidents()},
                "traced": bool(traced) and all(sp["attributes"].get("notebook") == degraded for sp in traced),
                "healthy": env.mgr.healthz()}

    got = both_at_once(scenario, BadDay, lambda env: env.stop())
    assert got["jax"] == got["port"], got
    port = got["port"]
    assert port["plan"]["preempted pods"] and port["fired within the window"] and port["named notebooks"]
    assert port["rule"] == "availability-fast-burn" and port["transitions"] == [
        ("fired", "availability-fast-burn"), ("resolved", "availability-fast-burn")]
    assert port["incidents as expected"] and port["bundle"] == (True, True) and port["healthy"]
    assert port["bundled"] == ["alert:availability-fast-burn", "slice-degraded"], port["bundled"]
    assert port["served"] == {"slos": ["notebook-availability"], "firing": [], "rules": ["availability-fast-burn"],
                              "incidents match the recorder": True} and port["traced"], port


JUDGEMENT_FIELDS = ("slo_window_scale", "slo_eval_period_s", "canary_timeout_s", "canary_namespace",
                    "canary_accelerator", "canary_topology", "autoscale_period_s", "autoscale_stabilization_s",
                    "autoscale_idle_s", "status_coalesce_window_s")


@pytest.mark.parametrize("env", [
    {},
    {"SLO_WINDOW_SCALE": "0.002", "SLO_EVAL_PERIOD_S": "0.05", "CANARY_TIMEOUT_S": "30",
     "CANARY_NAMESPACE": "probes", "CANARY_ACCELERATOR": "h100", "CANARY_TOPOLOGY": "1x1",
     "AUTOSCALE_PERIOD_S": "0.25", "AUTOSCALE_STABILIZATION_S": "10", "AUTOSCALE_IDLE_S": "1",
     "STATUS_COALESCE_WINDOW_S": "0"},
    {"SLO_WINDOW_SCALE": "-1", "SLO_EVAL_PERIOD_S": "-2", "CANARY_TIMEOUT_S": "0", "AUTOSCALE_PERIOD_S": "-1",
     "AUTOSCALE_STABILIZATION_S": "-3", "AUTOSCALE_IDLE_S": "-4", "STATUS_COALESCE_WINDOW_S": "-0.5"},
])
def test_the_judgement_knobs_read_the_reference_env(monkeypatch, env):
    """The judgement layer's fields of Config: the reference's defaults,
    env names and clamps (a window scale above 0, a canary timeout of at
    least 1 s, the periods and windows at least 0)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jax, port = JAX_SIDE.ctrl.Config.from_env(), PORT_SIDE.ctrl.Config.from_env()
    assert {k: getattr(jax, k) for k in JUDGEMENT_FIELDS} == {k: getattr(port, k) for k in JUDGEMENT_FIELDS}
