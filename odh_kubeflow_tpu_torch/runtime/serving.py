"""Manager serving endpoints: /metrics, /healthz, /readyz over HTTP (the
port's copy of odh_kubeflow_tpu/runtime/serving.py).

Both reference managers bind these (reference notebook-controller
main.go:87-94,125-133: metrics on :8080 via controller-runtime's registry,
health/ready pings on :8081; the ODH manager likewise, main.go:117-245), and
the deploy manifests point kubelet probes at them
(odh config/manager/manager.yaml:37-47 — mirrored by our
deploy/manifests.py manager Deployment). This module gives the Manager the
same surface: Prometheus text exposition from the in-tree Registry, and
health/readiness checks that reflect actual controller/informer liveness
rather than returning a constant.
"""
from __future__ import annotations

from http.server import BaseHTTPRequestHandler
from typing import Tuple

from ..utils.httpserve import ThreadedHTTPServer, respond, serve_in_thread, shutdown
from .metrics import Registry


class ServingEndpoints:
    """One listener per concern, like the reference (metrics :8080, probes
    :8081); port 0 picks free ports for tests."""

    def __init__(
        self,
        manager,
        metrics_port: int = 8080,
        health_port: int = 8081,
        host: str = "0.0.0.0",
    ):
        self.manager = manager
        registry: Registry = manager.metrics

        serving = self

        class MetricsHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                import json

                from urllib.parse import parse_qs, urlparse

                parsed = urlparse(self.path)
                path = parsed.path
                query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}

                def respond_json(payload, code: int = 200) -> None:
                    serving._respond(
                        self, code, json.dumps(payload).encode(),
                        content_type="application/json",
                    )

                if path == "/metrics":
                    body = registry.render().encode()
                    serving._respond(
                        self, 200, body, content_type="text/plain; version=0.0.4"
                    )
                elif path in ("/debug", "/debug/"):
                    # tiny index so a responder lands somewhere navigable
                    serving._respond(
                        self, 200, serving._index_page(), content_type="text/html"
                    )
                elif path == "/debug/traces":
                    # recent completed spans as JSON; ?trace_id= narrows to
                    # one trace (a notebook's readiness decomposition),
                    # ?notebook= to one notebook's spans, ?limit= to the
                    # newest N (the full ring is thousands of spans)
                    from ..utils import tracing

                    spans = tracing.recent_spans(
                        trace_id=query.get("trace_id"), name=query.get("name")
                    )
                    notebook = query.get("notebook")
                    if notebook:
                        # controller spans carry notebook=<bare name> with
                        # namespace separate; accept both that and the
                        # "ns/name" form the docs use
                        def matches(attrs: dict) -> bool:
                            name = attrs.get("notebook")
                            if name == notebook:
                                return True
                            return (
                                name is not None
                                and f"{attrs.get('namespace', '')}/{name}"
                                == notebook
                            )

                        spans = [s for s in spans if matches(s["attributes"])]
                    if "limit" in query:
                        try:
                            limit = int(query["limit"])
                        except ValueError:
                            respond_json({"error": "limit must be an integer"}, 400)
                            return
                        if limit < 0:
                            respond_json({"error": "limit must be >= 0"}, 400)
                            return
                        spans = spans[-limit:] if limit else []
                    respond_json({"spans": spans})
                elif path == "/debug/slo":
                    engine = getattr(serving.manager, "slo_engine", None)
                    alert_mgr = getattr(serving.manager, "alert_manager", None)
                    respond_json({
                        "engine": engine.status() if engine is not None else None,
                        "alerts": alert_mgr.status() if alert_mgr is not None else None,
                    })
                elif path == "/debug/flowcontrol":
                    # API priority & fairness state: the FlowController the
                    # manager's store carries (sim mode) — per-level seats,
                    # inflight, queue depth, shed counts, p99 wait
                    fc = getattr(
                        getattr(serving.manager, "store", None), "flowcontrol", None
                    )
                    respond_json(
                        {"levels": fc.summary() if fc is not None else None}
                    )
                elif path == "/debug/profile":
                    # PROFILE=1 continuous-profiler snapshot:
                    # per-region self/total + compile/run split + phases +
                    # per-consumer attribution + HBM watermarks. ?region=
                    # narrows to one declared hot region, ?limit= to the
                    # top-N by self time; bad args are a 400, same contract
                    # as /debug/traces
                    from ..utils import hotregions
                    from ..utils import profiler

                    region = query.get("region")
                    if region is not None:
                        try:
                            hotregions.get(region)
                        except KeyError:
                            declared = sorted(r.name for r in hotregions.REGIONS)
                            respond_json(
                                {"error": f"unknown region {region!r}; "
                                          f"declared: {declared}"},
                                400,
                            )
                            return
                    limit = None
                    if "limit" in query:
                        try:
                            limit = int(query["limit"])
                        except ValueError:
                            respond_json({"error": "limit must be an integer"}, 400)
                            return
                        if limit < 0:
                            respond_json({"error": "limit must be >= 0"}, 400)
                            return
                    respond_json(profiler.snapshot(region=region, limit=limit))
                elif path == "/debug/reconciles":
                    # CPPROFILE=1 control-plane profiler:
                    # per-controller reconcile-cause mix, queue-wait/work
                    # totals, cache-scan accounting, recent samples, sweep
                    # table and takeover decompositions. ?controller=
                    # narrows to one controller with recorded reconciles,
                    # ?limit= caps the sample rows; bad args are a 400,
                    # same contract as /debug/profile
                    from . import cpprofile

                    ctrl = query.get("controller")
                    if ctrl is not None:
                        known = sorted(cpprofile.snapshot(limit=0)["controllers"])
                        if ctrl not in known:
                            respond_json(
                                {"error": f"unknown controller {ctrl!r}; "
                                          f"known: {known}"},
                                400,
                            )
                            return
                    limit = None
                    if "limit" in query:
                        try:
                            limit = int(query["limit"])
                        except ValueError:
                            respond_json({"error": "limit must be an integer"}, 400)
                            return
                        if limit < 0:
                            respond_json({"error": "limit must be >= 0"}, 400)
                            return
                    respond_json(cpprofile.snapshot(controller=ctrl, limit=limit))
                elif path == "/debug/accounting":
                    # fleet chip-time ledger: the conservation
                    # arithmetic, per-phase/per-class chip-seconds, and the
                    # per-object detail. ?class= filters by workload class,
                    # ?object= by ns/name, ?limit= caps the object rows;
                    # bad args are a 400, same contract as /debug/traces
                    from . import accounting as acct_mod

                    acct = getattr(serving.manager, "accountant", None)
                    if acct is None:
                        acct = acct_mod.current()
                    if acct is None:
                        respond_json(
                            {"error": "accounting disabled "
                                      "(ACCOUNTING_PERIOD_S=0)"},
                            404,
                        )
                        return
                    cls = query.get("class")
                    if cls is not None and cls not in acct_mod.CLASSES:
                        respond_json(
                            {"error": f"unknown class {cls!r}; known: "
                                      f"{sorted(acct_mod.CLASSES)}"},
                            400,
                        )
                        return
                    limit = None
                    if "limit" in query:
                        try:
                            limit = int(query["limit"])
                        except ValueError:
                            respond_json({"error": "limit must be an integer"}, 400)
                            return
                        if limit < 0:
                            respond_json({"error": "limit must be >= 0"}, 400)
                            return
                    respond_json(
                        acct.snapshot(
                            workload_class=cls,
                            obj=query.get("object"),
                            limit=limit,
                        )
                    )
                elif path == "/debug/incidents":
                    rec = serving._recorder()
                    if "id" in query:
                        bundle = rec.get(query["id"])
                        if bundle is None:
                            respond_json({"error": f"no incident {query['id']}"}, 404)
                        else:
                            respond_json(bundle)
                    else:
                        respond_json({"incidents": rec.incidents()})
                elif path == "/healthz":
                    # mirrored here so one port serves the whole debug mux
                    ok = serving.manager.healthz()
                    serving._respond(
                        self, 200 if ok else 500, b"ok\n" if ok else b"unhealthy\n"
                    )
                else:
                    serving._respond(self, 404, b"not found\n")

        class HealthHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/healthz":
                    ok = serving.manager.healthz()
                elif path == "/readyz":
                    ok = serving.manager.readyz()
                else:
                    serving._respond(self, 404, b"not found\n")
                    return
                serving._respond(self, 200 if ok else 500, b"ok\n" if ok else b"unhealthy\n")

        self.metrics_httpd = ThreadedHTTPServer((host, metrics_port), MetricsHandler)
        self.health_httpd = ThreadedHTTPServer((host, health_port), HealthHandler)
        self._threads: list = []

    @staticmethod
    def _respond(h: BaseHTTPRequestHandler, code: int, body: bytes,
                 content_type: str = "text/plain") -> None:
        respond(h, code, body, content_type)

    def _recorder(self):
        """The manager's wired flight recorder, falling back to the
        process-wide one (slice repair feeds that even without full SLO
        wiring)."""
        rec = getattr(self.manager, "flight_recorder", None)
        if rec is not None:
            return rec
        from .flightrecorder import recorder

        return recorder

    @staticmethod
    def _index_page() -> bytes:
        return (
            b"<html><head><title>tpu-notebook-operator debug</title></head>"
            b"<body><h1>tpu-notebook-operator</h1><ul>"
            b'<li><a href="/metrics">/metrics</a> &mdash; Prometheus exposition</li>'
            b'<li><a href="/debug/traces?limit=100">/debug/traces</a> &mdash; '
            b"recent spans (?trace_id=, ?notebook=, ?name=, ?limit=)</li>"
            b'<li><a href="/debug/slo">/debug/slo</a> &mdash; SLO compliance, '
            b"burn rates, alert state</li>"
            b'<li><a href="/debug/incidents">/debug/incidents</a> &mdash; '
            b"flight-recorder incident bundles (?id=)</li>"
            b'<li><a href="/debug/flowcontrol">/debug/flowcontrol</a> &mdash; '
            b"API priority &amp; fairness levels (seats, queue, shed)</li>"
            b'<li><a href="/debug/profile">/debug/profile</a> &mdash; '
            b"PROFILE=1 hot-region timings (?region=, ?limit=)</li>"
            b'<li><a href="/debug/accounting">/debug/accounting</a> &mdash; '
            b"fleet chip-time ledger (?class=, ?object=, ?limit=)</li>"
            b'<li><a href="/debug/reconciles">/debug/reconciles</a> &mdash; '
            b"CPPROFILE=1 reconcile causes, cache scans, takeover phases "
            b"(?controller=, ?limit=)</li>"
            b'<li><a href="/healthz">/healthz</a></li>'
            b"</ul></body></html>\n"
        )

    @property
    def metrics_address(self) -> Tuple[str, int]:
        return self.metrics_httpd.server_address[:2]

    @property
    def health_address(self) -> Tuple[str, int]:
        return self.health_httpd.server_address[:2]

    def start(self) -> "ServingEndpoints":
        for httpd, name in ((self.metrics_httpd, "metrics"), (self.health_httpd, "health")):
            self._threads.append(serve_in_thread(httpd, f"serving-{name}"))
        return self

    def stop(self) -> None:
        for httpd in (self.metrics_httpd, self.health_httpd):
            shutdown(httpd)
