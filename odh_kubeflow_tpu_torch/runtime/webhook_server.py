"""HTTPS admission webhook server — AdmissionReview v1 over TLS (the port's
copy of odh_kubeflow_tpu/runtime/webhook_server.py).

The reference serves its mutating webhook with controller-runtime's webhook
server (odh main.go:213-227: port 8443 + cert dir; envtest drives it over
local TLS in controllers/suite_test.go:120-124,183-246). This is that
capability for this build: decode AdmissionReview v1, run the registered
handler (the same `AdmissionRequest -> mutated object` handlers the
in-process store chain uses, so NotebookWebhook plugs in unchanged), respond
with an RFC 6902 JSONPatch — the exact wire contract
admission.PatchResponseFromRaw produces in the reference
(notebook_webhook.go:493-498).
"""
from __future__ import annotations

import base64
import copy
import json
import logging
import ssl
import threading
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, Optional

from ..apimachinery import json_patch_diff
from ..cluster.store import AdmissionRequest
from ..utils.httpserve import ThreadedHTTPServer, respond, serve_in_thread, shutdown

log = logging.getLogger(__name__)

# handler: AdmissionRequest -> mutated object dict (or None = unchanged)
AdmissionHandler = Callable[[AdmissionRequest], Optional[Dict]]


class WebhookServer:
    """Serve admission handlers over HTTPS (or HTTP in tests without certs)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
    ):
        self._handlers: Dict[str, AdmissionHandler] = {}
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                server._handle(self)

        self.httpd = ThreadedHTTPServer((host, port), Handler)
        self.tls = bool(certfile)
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket, server_side=True)
        self._thread: Optional[threading.Thread] = None

    def register(self, path: str, handler: AdmissionHandler) -> None:
        """Register a handler at a URL path (e.g. /mutate-notebook-v1 — the
        reference's path, odh main.go:227)."""
        self._handlers[path.rstrip("/") or "/"] = handler

    @property
    def base_url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"{'https' if self.tls else 'http'}://{host}:{port}"

    def start(self) -> "WebhookServer":
        self._thread = serve_in_thread(self.httpd, "webhook-server")
        return self

    def stop(self) -> None:
        shutdown(self.httpd)

    # -- request handling --

    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        # join the apiserver's trace (it forwards the client's traceparent on
        # the callout) so webhook spans connect across the wire
        from ..utils.tracing import attach

        with attach(h.headers.get("traceparent")):
            self._handle_traced(h)

    def _handle_traced(self, h: BaseHTTPRequestHandler) -> None:
        try:
            handler = self._handlers.get(h.path.split("?")[0].rstrip("/") or "/")
            if handler is None:
                self._respond_raw(h, 404, {"message": f"no webhook at {h.path!r}"})
                return
            length = int(h.headers.get("Content-Length", "0"))
            review = json.loads(h.rfile.read(length))
            request = review.get("request", {})
            response = self._review(handler, request)
            self._respond_raw(
                h,
                200,
                {
                    "apiVersion": "admission.k8s.io/v1",
                    "kind": "AdmissionReview",
                    "response": response,
                },
            )
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:
            log.exception("webhook request failed")
            try:
                self._respond_raw(h, 500, {"message": repr(e)})
            except OSError:
                pass

    @staticmethod
    def _review(handler: AdmissionHandler, request: Dict) -> Dict:
        uid = request.get("uid", "")
        # the parsed request dict is request-local: it serves as the pristine
        # diff baseline, and one copy isolates the handler's mutations from it
        obj = request.get("object") or {}
        try:
            req = AdmissionRequest(
                operation=request.get("operation", ""),
                object=copy.deepcopy(obj),
                old_object=request.get("oldObject"),
                dry_run=bool(request.get("dryRun")),
            )
            mutated = handler(req)
            if mutated is None:
                mutated = req.object
        except Exception as e:
            # denial (AdmissionDeniedError/InvalidError/anything): allowed=false
            # with the reason — failurePolicy decides what the apiserver does
            return {
                "uid": uid,
                "allowed": False,
                "status": {"message": str(e) or repr(e)},
            }
        ops = json_patch_diff(obj, mutated)
        response = {"uid": uid, "allowed": True}
        if ops:
            response["patchType"] = "JSONPatch"
            response["patch"] = base64.b64encode(json.dumps(ops).encode()).decode()
        return response

    def _respond_raw(self, h: BaseHTTPRequestHandler, code: int, body: Dict) -> None:
        respond(h, code, json.dumps(body).encode())
