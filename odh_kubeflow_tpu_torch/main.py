"""Composition root: wire the full notebook operator onto a store (the
port's copy of odh_kubeflow_tpu/main.py, on GPU slices).

Single manager, single binary — SURVEY §7's deliberate simplification of the
reference's two-process split (notebook-controller/main.go:58-148 + odh
main.go:117-245 watch the same CR from two managers; here one manager hosts
all the controllers and the webhook registers into the store's admission
chain).

One deliberate difference from the reference: the replica autoscaler reads
each endpoint's replicas through `PodStatsSignals`, at the address the pod
object gives (its IP and its serving container's port), never the
reference's default signals. Those read the operator's own registry, which
an engine serving in its pod's process never moves, so they park an
endpoint while it serves (ROADMAP Queue 3 entry 21)."""
from __future__ import annotations

import logging
from typing import Optional

from .cluster.store import Store
from .controllers import (
    Config,
    CullingReconciler,
    EventMirrorController,
    InferenceEndpointReconciler,
    NotebookReconciler,
    NotebookWebhook,
    ProbeStatusController,
    SliceRepairController,
    SuspendResumeController,
    TPUJobReconciler,
    TPUWorkbenchReconciler,
)
from .controllers.metrics import NotebookMetrics
from .runtime.manager import Manager

log = logging.getLogger(__name__)


def build_manager(
    store: Store,
    config: Optional[Config] = None,
    leader_election: bool = False,
    http_get=None,
    shard=None,
    lease_duration: float = 15.0,
    renew_period: float = 5.0,
    register_webhook: bool = True,
) -> Manager:
    """Everything the two reference managers run, on one Manager.

    `store` is either the in-process Store (sim / single-binary mode: the
    webhook registers straight into its admission chain) or a RemoteStore
    speaking to an API server over the wire — in that mode admission runs
    server-side via MutatingWebhookConfiguration + the HTTPS webhook server
    (runtime/webhook_server.py; see serve_webhook), exactly the reference's
    deployment shape (odh main.go:213-227).

    `shard` (runtime/manager.py ShardSpec) partitions the reconcile keyspace:
    run one build_manager per shard (plus standbys with leader_election=True)
    and each manager reconciles only the objects its shard owns, under its
    own per-shard lease. In that wiring pass `register_webhook=False` for
    every replica but one — the in-process admission chain is store-global,
    and mutation must run once per request, not once per manager."""
    config = config or Config.from_env()
    mgr = Manager(
        store,
        leader_election=leader_election,
        leader_election_id="tpu-notebook-controller",
        shard=shard,
        lease_duration=lease_duration,
        renew_period=renew_period,
    )
    # status-write coalescing (runtime/coalesce.py): the notebook/endpoint/
    # job mirrors route their patch_status through this, batching adjacent
    # patches per object per window; rides the manager lifecycle so stop()
    # flushes whatever is parked
    from .runtime.coalesce import StatusCoalescer

    mgr.status_coalescer = StatusCoalescer(
        mgr.client, window_s=config.status_coalesce_window_s
    )
    mgr.add_service(mgr.status_coalescer)
    metrics = NotebookMetrics(mgr.metrics, mgr.client)

    if register_webhook and hasattr(store, "register_webhook"):
        NotebookWebhook(mgr.client, config).register(store)
    NotebookReconciler(mgr, config, metrics=metrics).setup()
    EventMirrorController(mgr).setup()
    TPUWorkbenchReconciler(mgr, config).setup()
    ProbeStatusController(mgr, config, http_get=http_get, metrics=metrics).setup()
    CullingReconciler(mgr, config, http_get=http_get, metrics=metrics).setup()
    SliceRepairController(mgr, config, http_get=http_get).setup()
    SuspendResumeController(mgr, config, http_get=http_get).setup()
    InferenceEndpointReconciler(mgr, config, http_get=http_get).setup()
    TPUJobReconciler(mgr, config, http_get=http_get).setup()
    # POOL_PREWARM: a PoolPrewarmer of the slice gpu.plan_slice plans
    from .cluster.slicepool import add_prewarmer

    add_prewarmer(mgr, config)
    if config.slo_enabled:
        _wire_observability(mgr, config)
    return mgr


def _wire_observability(mgr: Manager, config: Config) -> None:
    """SLO engine -> alert manager -> flight recorder -> canary prober ->
    replica autoscaler -> chip accountant: the judgement layer over the raw
    telemetry. All of it rides the manager lifecycle (add_service) and the
    debug mux (/debug/slo, /debug/incidents, /debug/accounting) finds it
    through the named manager attributes.

    The autoscaler's signals are `PodStatsSignals` over each bound
    replica's /stats at `serving_address(pod)` (the pod's IP and its
    serving container's port), not the reference's default signals, which
    read the operator's registry and so park an endpoint whose engine
    serves in its pod (ROADMAP Queue 3 entry 21)."""
    from . import telemetry
    from .runtime.alerts import AlertManager, default_rules
    from .runtime.flightrecorder import recorder
    from .runtime.slo import SLOEngine, default_slos

    slos = default_slos()
    engine = SLOEngine(
        registry=mgr.metrics,
        slos=slos,
        window_scale=config.slo_window_scale,
        eval_period_s=config.slo_eval_period_s or None,
    )
    alert_mgr = AlertManager(
        rules=default_rules(slos), manager=mgr, recorder=recorder
    )
    # THE inhibition contract (ARCHITECTURE.md): an active repair episode
    # already explains degraded readiness — suppress the symptom alerts,
    # keep the availability page live
    alert_mgr.register_inhibitor(
        "readiness",
        lambda: telemetry.slice_repairs_in_progress.value() > 0,
        name="slice-repair-in-progress",
    )
    engine.add_listener(alert_mgr.evaluate)
    mgr.slo_engine = engine
    mgr.alert_manager = alert_mgr
    mgr.flight_recorder = recorder
    mgr.add_service(engine)
    if config.canary_period_s > 0:
        from .runtime.prober import CanaryProber

        prober = CanaryProber(
            mgr,
            period_s=config.canary_period_s,
            timeout_s=config.canary_timeout_s,
            namespace=config.canary_namespace,
            accelerator=config.canary_accelerator,
            topology=config.canary_topology,
        )
        mgr.prober = prober
        mgr.add_service(prober)
    if config.autoscale_period_s > 0:
        from .runtime.autoscaler import PodStatsSignals, ReplicaAutoscaler, serving_address

        autoscaler = ReplicaAutoscaler(
            mgr,
            period_s=config.autoscale_period_s,
            stabilization_s=config.autoscale_stabilization_s,
            idle_s=config.autoscale_idle_s,
            signals_fn=PodStatsSignals(mgr, address_of=serving_address),
        )
        mgr.autoscaler = autoscaler
        mgr.add_service(autoscaler)
    if config.accounting_period_s > 0:
        from .runtime import accounting

        accountant = accounting.ChipAccountant(
            mgr.client,
            period_s=config.accounting_period_s,
            idle_after_s=config.accounting_idle_after_s,
        )
        # module handle: the flight recorder freezes this accountant's
        # snapshot into incident bundles; /debug/accounting reads it via
        # the named manager attribute
        accounting.set_current(accountant)
        mgr.accountant = accountant
        mgr.add_service(accountant)


def serve_webhook(client, config: Config, cert_dir: str, port: int = 8443):
    """Serve the mutating webhook over HTTPS from a cert dir (tls.crt/tls.key,
    the kubernetes.io/tls Secret layout) — the remote-mode admission path."""
    import os

    from .runtime.cached_client import TTLReadClient
    from .runtime.webhook_server import WebhookServer

    server = WebhookServer(
        host="0.0.0.0",
        port=port,
        certfile=os.path.join(cert_dir, "tls.crt"),
        keyfile=os.path.join(cert_dir, "tls.key"),
    )
    # TTL read memo over the webhook's dedicated client: admission reads the
    # same per-ns ConfigMaps every review; see TTLReadClient
    server.register(
        "/mutate-notebook-v1", NotebookWebhook(TTLReadClient(client), config).handle
    )
    return server.start()


def main() -> None:
    """Entrypoint, resolved like ctrl.GetConfigOrDie:

    - in a pod (KUBERNETES_SERVICE_HOST set): in-cluster config — SA token +
      CA from the ServiceAccount mount; the deployed shape,
    - KUBECONFIG set: connect via kubeconfig (remote dev shape),
    - otherwise: boot the in-process SimCluster (demo shape).
    In both real modes the mutating webhook serves over HTTPS from
    WEBHOOK_CERT_DIR and all controllers run against the real cluster.
    /metrics and /debug/* serve on METRICS_PORT (8080), /healthz and
    /readyz on HEALTH_PORT (8081); SIGTERM or SIGINT stops the manager.
    """
    import os

    # structured JSON logs by default (every record carries trace/span ids +
    # notebook identity via utils/logging.py); LOG_FORMAT=text opts out
    if os.environ.get("LOG_FORMAT", "json") == "json":
        from .utils.logging import setup_json_logging

        setup_json_logging(level=logging.INFO)
    else:
        logging.basicConfig(level=logging.INFO)
    # warnings+ also land in the flight-recorder ring, so incident bundles
    # carry the log lines around the failure
    from .runtime.flightrecorder import recorder as _recorder

    logging.getLogger().addHandler(_recorder.log_handler(level=logging.WARNING))
    config = Config.from_env()
    cluster = None
    webhook_server = None
    # explicit signals only: a merely-existing ~/.kube/config must never flip
    # a demo run into mutating whatever cluster current-context points at
    if os.environ.get("KUBERNETES_SERVICE_HOST") or os.environ.get("KUBECONFIG"):
        from .cluster.remote import RemoteStore

        # --qps/--burst analog (reference notebook-controller/main.go:65-85
        # overrides the rest config the same way): 0/unset keeps the client
        # defaults (20/30), negative means unlimited (rest.Config's -1
        # convention), junk falls back to the default rather than crashing
        # the manager at boot
        def _env_num(name, default, cast):
            try:
                val = cast(os.environ.get(name, "") or default)
            except ValueError:
                logging.getLogger(__name__).warning(
                    "ignoring non-numeric %s=%r", name, os.environ.get(name)
                )
                return default
            return val if val else default

        qps = _env_num("KUBE_API_QPS", 20.0, float)
        burst = _env_num("KUBE_API_BURST", 30, int)
        if qps < 0:
            qps = 0.0  # RemoteStore treats qps<=0 as unthrottled

        # KUBECONFIG first (GetConfig precedence): an explicit override must
        # win over the auto-injected pod env, or a manager run inside ANY pod
        # would silently target the host cluster
        if os.environ.get("KUBECONFIG"):
            store = RemoteStore.from_kubeconfig(qps=qps, burst=burst)
        else:
            store = RemoteStore.in_cluster(qps=qps, burst=burst)
        cert_dir = os.environ.get("WEBHOOK_CERT_DIR", "/tmp/k8s-webhook-server/serving-certs")
        if os.path.exists(os.path.join(cert_dir, "tls.crt")):
            from .cluster.client import Client

            webhook_server = serve_webhook(
                Client(store),
                config,
                cert_dir,
                # the webhook Service targets 9443 (controller-runtime's
                # default serving port)
                port=int(os.environ.get("WEBHOOK_PORT", "9443")),
            )
            log.info("mutating webhook serving on :%s", webhook_server.httpd.server_address[1])
        elif os.environ.get("KUBERNETES_SERVICE_HOST") and not os.environ.get(
            "KUBECONFIG"
        ):
            # (an explicit KUBECONFIG override may legitimately run in a pod
            # without webhook certs — only the DEPLOYED shape must fail hard)
            # deployed shape: a MutatingWebhookConfiguration points at this
            # pod — starting without the webhook would silently bypass
            # admission (Ignore) or hard-fail every Notebook write (Fail)
            raise RuntimeError(
                f"webhook serving certs missing at {cert_dir} "
                "(is the webhook-server-cert secret mounted?)"
            )
        else:
            log.warning(
                "WEBHOOK_CERT_DIR %s has no tls.crt: mutating webhook NOT "
                "served (admission runs only if the cluster calls it)",
                cert_dir,
            )
        mgr = build_manager(store, config, leader_election=True)
        log.info("tpu-notebook-controller running (kubeconfig: %s)", store.base_url)
    else:
        from .cluster.sim import SimCluster

        cluster = SimCluster().start()
        # somewhere for the CPU canary (and demo notebooks) to land
        cluster.add_cpu_pool("default", nodes=2)
        if config.canary_period_s <= 0 and "CANARY_PERIOD_S" not in os.environ:
            # demo shape: the black-box canary is on by default against the
            # sim — but an EXPLICIT CANARY_PERIOD_S=0 stays off (the env knob
            # documents 0 as disabled; only the unset default is upgraded)
            config.canary_period_s = 60.0
        mgr = build_manager(cluster.store, config, http_get=cluster.http_get)
        log.info("tpu-notebook-controller running (in-process cluster)")
    # /metrics on :8080, /healthz + /readyz on :8081 (reference
    # notebook-controller/main.go:125-133; deploy probes point here).
    # MUST bind before start(): with leader election, start() blocks waiting
    # out the old lease, and a standby that doesn't answer its liveness
    # probe would be killed into CrashLoopBackOff
    endpoints = mgr.serve_endpoints(
        metrics_port=int(os.environ.get("METRICS_PORT", "8080")),
        health_port=int(os.environ.get("HEALTH_PORT", "8081")),
    )
    mgr.start()
    try:
        import signal
        import threading

        stop = threading.Event()
        signal.signal(signal.SIGINT, lambda *a: stop.set())
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        stop.wait()
    finally:
        mgr.stop()
        endpoints.stop()
        if webhook_server is not None:
            webhook_server.stop()
        if cluster is not None:
            cluster.stop()


if __name__ == "__main__":
    main()
