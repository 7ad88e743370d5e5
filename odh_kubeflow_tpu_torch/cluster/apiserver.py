"""HTTP API server: the Kubernetes wire protocol over the Store (the port's
copy of odh_kubeflow_tpu/cluster/apiserver.py).

The reference's managers talk to a real kube-apiserver over HTTPS
(reference components/notebook-controller/main.go:79-94 ctrl.GetConfigOrDie;
odh main.go:117-245). This module is the other half of that seam for the GPU
build: it serves the standard Kubernetes REST protocol — resource paths,
verbs, Status errors, label selectors, the status subresource, merge patch,
and streaming `?watch=true` with resourceVersion resume — on top of the
Store. The RemoteStore client (cluster/remote.py) speaks exactly this
protocol, so the same client works against a real kube-apiserver; and this
server doubles as the envtest-style fixture (reference odh
controllers/suite_test.go:91-275 boots kube-apiserver+etcd for tests; here
the suite boots ApiServer over a Store).

Wire compatibility notes:
- paths: /api/v1/... (legacy core group) and /apis/{group}/{version}/...,
  with /namespaces/{ns}/ for namespaced resources and bare collection paths
  for cluster scope / all-namespaces lists,
- GET collection -> {kind}List with listMeta.resourceVersion (atomic with the
  item snapshot), GET ?watch=true -> chunked JSON-lines stream of
  {"type","object"} events; resourceVersion=N resumes strictly after N and
  answers 410 Expired past the retained window,
- POST/PUT/DELETE with Status error bodies; PATCH accepts both
  application/merge-patch+json (RFC 7386) and application/json-patch+json
  (RFC 6902),
- PUT .../status hits the status subresource,
- authentication: static bearer token (ServiceAccount-token analog), TLS via
  certfile/keyfile.
"""
from __future__ import annotations

import json
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

from ..utils.httpserve import ThreadedHTTPServer, respond, serve_in_thread, shutdown

from ..apimachinery import (
    ApiError,
    GoneError,
    InvalidError,
    NotFoundError,
    RESTMapper,
    Scheme,
    UnauthorizedError,
    default_scheme,
    json_patch_apply,
    match_labels,
)
from .store import Store, Watch
from ..utils import racecheck

# admission callout hook: (operation, object, old_object) -> mutated object.
# Task of the webhook dispatcher (webhook/dispatch.py); None = store-only
# admission (whatever handlers are registered in-process on the Store).
AdmissionCallout = Callable[[str, Dict[str, Any], Optional[Dict[str, Any]]], Dict[str, Any]]


class _Route:
    __slots__ = ("api_version", "kind", "namespace", "name", "subresource", "namespaced")

    def __init__(self, api_version, kind, namespace, name, subresource, namespaced):
        self.api_version = api_version
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.subresource = subresource
        self.namespaced = namespaced


def _status_body(
    code: int, reason: str, message: str, retry_after: Optional[float] = None
) -> bytes:
    body: Dict[str, Any] = {
        "kind": "Status",
        "apiVersion": "v1",
        "metadata": {},
        "status": "Failure",
        "message": message,
        "reason": reason,
        "code": code,
    }
    if retry_after is not None:
        # kube-apiserver's throttling shape: Status.details.retryAfterSeconds
        # (clients honor it like the Retry-After header)
        body["details"] = {"retryAfterSeconds": retry_after}
    return json.dumps(body).encode()


def parse_label_selector(raw: str) -> Optional[Dict[str, str]]:
    """`k=v,k2=v2` (also `k==v`) -> dict; empty -> None."""
    if not raw:
        return None
    out: Dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "==" in part:
            k, v = part.split("==", 1)
        elif "=" in part:
            k, v = part.split("=", 1)
        else:
            raise InvalidError(f"unsupported label selector {part!r}")
        out[k.strip()] = v.strip()
    return out or None


class ApiServer:
    """Serve a Store over the Kubernetes REST protocol."""

    def __init__(
        self,
        store: Store,
        scheme: Scheme = default_scheme,
        host: str = "127.0.0.1",
        port: int = 0,
        bearer_token: Optional[str] = None,
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
        admission: Optional[AdmissionCallout] = None,
        heartbeat_polls: int = 30,
        audit_path: Optional[str] = None,
        flowcontrol: Optional[Any] = None,
    ):
        # API priority & fairness (cluster/flowcontrol.py FlowController):
        # when set, every request takes a seat at its priority level before
        # verb dispatch, classified by the client-stamped X-Flow-Schema header
        self.flowcontrol = flowcontrol
        # idle 0.5s polls before a watch heartbeat/BOOKMARK (30 -> ~15s,
        # roughly kube-apiserver's bookmark cadence; tests dial it down)
        self.heartbeat_polls = heartbeat_polls
        # debug escape (envtest's audit-log dump analog, reference odh
        # controllers/suite_test.go:125-155): JSON-lines request log
        self.audit_path = audit_path
        self._audit_lock = racecheck.make_lock("ApiServer._audit_lock")
        self.store = store
        self.scheme = scheme
        self.mapper = RESTMapper()
        self.mapper.populate_from_scheme(scheme)
        self.bearer_token = bearer_token
        self.admission = admission
        self._stopping = threading.Event()
        self._active_watches: List[Watch] = []
        self._watch_lock = racecheck.make_lock("ApiServer._watch_lock")

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def do_GET(self):
                server._dispatch(self, "GET")

            def do_POST(self):
                server._dispatch(self, "POST")

            def do_PUT(self):
                server._dispatch(self, "PUT")

            def do_PATCH(self):
                server._dispatch(self, "PATCH")

            def do_DELETE(self):
                server._dispatch(self, "DELETE")

        self.httpd = ThreadedHTTPServer((host, port), Handler)
        self.tls = bool(certfile)
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket, server_side=True)
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def base_url(self) -> str:
        host, port = self.address
        return f"{'https' if self.tls else 'http'}://{host}:{port}"

    def start(self) -> "ApiServer":
        self._thread = serve_in_thread(self.httpd, "apiserver")
        return self

    def stop(self) -> None:
        self._stopping.set()
        with self._watch_lock:
            for w in self._active_watches:
                w.stop()
            self._active_watches.clear()
        shutdown(self.httpd)

    # -- request plumbing --

    def _audit(self, method: str, path: str, outcome: str) -> None:
        if not self.audit_path:
            return
        import time as _time

        line = json.dumps(
            {"ts": _time.time(), "method": method, "path": path, "outcome": outcome}
        )
        with self._audit_lock:
            try:
                with open(self.audit_path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass

    def _dispatch(self, h: BaseHTTPRequestHandler, method: str) -> None:
        # Audit ORDERING contract: the record is written BEFORE the response
        # bytes are flushed to the client, so a client that reads the audit
        # log immediately after receiving a response always finds its own
        # request recorded (the debug escape exists so operators can trust
        # the log reflects completed requests). Verb handlers therefore
        # RETURN (code, body) instead of writing to the socket; the one
        # streaming verb (watch) audits at stream start.
        h._body_consumed = False  # per-request: handlers persist on keep-alive
        # adopt the caller's W3C trace context for this request thread, so
        # server-side work (admission webhook callouts included) propagates it
        from ..utils.tracing import attach

        with attach(h.headers.get("traceparent")):
            self._dispatch_traced(h, method)

    def _dispatch_traced(self, h: BaseHTTPRequestHandler, method: str) -> None:
        try:
            if not self._authorized(h):
                raise UnauthorizedError("missing or invalid bearer token")
            faults = getattr(self.store, "faults", None)
            if faults is not None:
                # injected overload rejection point: a matching rule answers
                # 429 + Retry-After before any dispatch work; a "delay"
                # action rule injects request latency (apiserver_overload)
                faults.check("apiserver.request", method=method, path=h.path)
                delay = faults.decide("apiserver.request", method=method, path=h.path)
                if delay is not None and delay.action == "delay" and delay.param > 0:
                    time.sleep(delay.param)
            parsed = urlparse(h.path)
            query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
            route = self._parse_path(parsed.path)
            if route is None:
                raise NotFoundError(f"the server could not find the requested resource {parsed.path!r}")
            # API priority & fairness: take a seat at the level matched by
            # the caller's flow identity before any verb work; a full queue
            # sheds 429 + Retry-After through the ApiError path below
            ticket = None
            if self.flowcontrol is not None:
                ticket = self.flowcontrol.admit(
                    h.headers.get("X-Flow-Schema", ""),
                    verb=method.lower(),
                    kind=route.kind,
                )
            try:
                if method == "GET":
                    if route.name:
                        code, body = self._get(h, route)
                    elif query.get("watch") in ("true", "1"):
                        # a watch holds its connection for the stream's whole
                        # lifetime — release the seat before streaming so
                        # long-lived watches never pin the concurrency budget
                        if ticket is not None:
                            ticket.release()
                            ticket = None
                        self._watch(h, route, query, method)
                        return
                    else:
                        code, body = self._list(h, route, query)
                elif method == "POST" and not route.name:
                    code, body = self._create(h, route)
                elif method == "PUT" and route.name:
                    code, body = self._update(h, route)
                elif method == "PATCH" and route.name:
                    code, body = self._patch(h, route)
                elif method == "DELETE" and route.name:
                    code, body = self._delete(h, route)
                else:
                    raise InvalidError(f"unsupported {method} on {parsed.path!r}")
            finally:
                if ticket is not None:
                    ticket.release()
            # serialize INSIDE the try: an unserializable value (bad
            # admission-hook output) must take the 500 path below, not
            # escape after an "ok" audit record
            payload = json.dumps(body).encode()
        except ApiError as e:
            self._audit(method, h.path, f"{e.code} {e.reason}")
            self._send_status_error(h, e)
            return
        except (BrokenPipeError, ConnectionResetError):
            self._audit(method, h.path, "client-gone")
            return
        except Exception as e:  # never leak a stack trace into the connection
            self._audit(method, h.path, f"internal: {e!r}")
            err = ApiError(f"internal error: {e!r}")
            try:
                self._send_status_error(h, err)
            except OSError:
                pass
            return
        self._audit(method, h.path, "ok")
        try:
            respond(h, code, payload)
        except OSError:  # client gone mid-send (incl. TLS aborts)
            pass

    def _authorized(self, h: BaseHTTPRequestHandler) -> bool:
        if self.bearer_token is None:
            return True
        auth = h.headers.get("Authorization", "")
        return auth == f"Bearer {self.bearer_token}"

    def _parse_path(self, path: str) -> Optional[_Route]:
        parts = [unquote(p) for p in path.strip("/").split("/") if p]
        if not parts:
            return None
        if parts[0] == "api":
            if len(parts) < 2 or parts[1] != "v1":
                return None
            api_version, rest = "v1", parts[2:]
        elif parts[0] == "apis":
            if len(parts) < 3:
                return None
            api_version, rest = f"{parts[1]}/{parts[2]}", parts[3:]
        else:
            return None
        namespace = ""
        namespaced_path = False
        if len(rest) >= 2 and rest[0] == "namespaces":
            # /namespaces/{ns}/{plural}/... — but bare /api/v1/namespaces[/name]
            # is the Namespace resource itself
            if len(rest) >= 3:
                namespace, rest = rest[1], rest[2:]
                namespaced_path = True
        if not rest:
            return None
        plural, rest = rest[0], rest[1:]
        gvk = self.mapper.kind_for(api_version, plural)
        if gvk is None:
            return None
        _, kind = gvk
        name = rest[0] if rest else ""
        subresource = rest[1] if len(rest) > 1 else ""
        if len(rest) > 2:
            return None
        return _Route(api_version, kind, namespace, name, subresource, namespaced_path)

    def _read_body(self, h: BaseHTTPRequestHandler) -> Dict[str, Any]:
        length = int(h.headers.get("Content-Length", "0"))
        raw = h.rfile.read(length) if length else b""
        h._body_consumed = True
        if not raw:
            raise InvalidError("request body required")
        try:
            body = json.loads(raw)
        except ValueError as e:
            raise InvalidError(f"invalid JSON body: {e}")
        if not isinstance(body, (dict, list)):
            raise InvalidError("JSON body must be an object")
        return body

    def _send_json(self, h: BaseHTTPRequestHandler, code: int, obj: Dict[str, Any]) -> None:
        respond(h, code, json.dumps(obj).encode())

    def _send_status_error(self, h: BaseHTTPRequestHandler, e: ApiError) -> None:
        retry_after = getattr(e, "retry_after", None)
        body = _status_body(e.code, e.reason, str(e), retry_after=retry_after)
        # An error raised BEFORE the verb handler read the request body
        # (auth failure, injected 429) leaves those bytes on the socket; on
        # a keep-alive connection the next request parse would start inside
        # them. Close the connection and say so — http.client sees the
        # header and transparently reopens for the retry.
        unread_body = (
            h.command in ("POST", "PUT", "PATCH")
            and int(h.headers.get("Content-Length") or 0) > 0
            and not getattr(h, "_body_consumed", False)
        )
        if retry_after is None and not unread_body:
            respond(h, e.code, body)
            return
        # manual framing to add the extra headers (respond() owns only the
        # framing headers)
        h.send_response(e.code)
        h.send_header("Content-Type", "application/json")
        if retry_after is not None:
            h.send_header("Retry-After", str(max(1, int(retry_after))))
        if unread_body:
            h.send_header("Connection", "close")
            h.close_connection = True
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    # -- verbs --

    def _admit(
        self, operation: str, obj: Dict[str, Any], old: Optional[Dict[str, Any]]
    ) -> Dict[str, Any]:
        if self.admission is not None:
            return self.admission(operation, obj, old)
        return obj

    def _get(self, h, route: _Route) -> Tuple[int, Dict[str, Any]]:
        obj = self.store.get_raw(route.api_version, route.kind, route.namespace, route.name)
        return 200, obj

    def _list(self, h, route: _Route, query: Dict[str, str]) -> Tuple[int, Dict[str, Any]]:
        selector = parse_label_selector(query.get("labelSelector", ""))
        items, rv = self.store.list_raw_with_rv(
            route.api_version,
            route.kind,
            namespace=route.namespace if route.namespaced else None,
            label_selector=selector,
        )
        return 200, {
            "apiVersion": route.api_version,
            "kind": f"{route.kind}List",
            "metadata": {"resourceVersion": rv},
            "items": items,
        }

    def _create(self, h, route: _Route) -> Tuple[int, Dict[str, Any]]:
        obj = self._read_body(h)
        meta = obj.setdefault("metadata", {})
        if route.namespaced:
            meta["namespace"] = route.namespace
        obj.setdefault("apiVersion", route.api_version)
        obj.setdefault("kind", route.kind)
        obj = self._admit("CREATE", obj, None)
        out = self.store.create_raw(obj)
        return 201, out

    def _update(self, h, route: _Route) -> Tuple[int, Dict[str, Any]]:
        obj = self._read_body(h)
        if route.subresource not in ("", "status"):
            raise InvalidError(f"unsupported subresource {route.subresource!r}")
        if route.subresource != "status":
            try:
                old = self.store.get_raw(
                    route.api_version, route.kind, route.namespace, route.name
                )
            except NotFoundError:
                old = None
            obj = self._admit("UPDATE", obj, old)
        out = self.store.update_raw(obj, subresource=route.subresource)
        return 200, out

    def _patch(self, h, route: _Route) -> Tuple[int, Dict[str, Any]]:
        patch = self._read_body(h)
        ctype = h.headers.get("Content-Type", "application/merge-patch+json")
        if route.subresource not in ("", "status"):
            raise InvalidError(f"unsupported subresource {route.subresource!r}")
        if "json-patch" in ctype:
            if not isinstance(patch, list):
                raise InvalidError("json-patch body must be an op list")
            current = self.store.get_raw(
                route.api_version, route.kind, route.namespace, route.name
            )
            patched = json_patch_apply(current, patch)
            # only DEFAULT the RV: a patch that explicitly set one is
            # expressing optimistic concurrency and store.update_raw must see
            # (and 409 on) a mismatch, like the real apiserver
            patched.setdefault("metadata", {}).setdefault(
                "resourceVersion", current["metadata"]["resourceVersion"]
            )
            if route.subresource != "status":
                patched = self._admit("UPDATE", patched, current)
            out = self.store.update_raw(patched, subresource=route.subresource)
        else:
            if not isinstance(patch, dict):
                raise InvalidError("merge-patch body must be an object")
            admission_applies = (
                self.admission is not None
                and route.subresource != "status"
                and getattr(self.admission, "matches_kind", lambda av, k: True)(
                    route.api_version, route.kind
                )
            )
            if admission_applies:
                from ..apimachinery import json_merge_patch

                current = self.store.get_raw(
                    route.api_version, route.kind, route.namespace, route.name
                )
                patched = json_merge_patch(current, patch)
                patched = self._admit("UPDATE", patched, current)
                # default-only, as in the json-patch branch: a patch-set RV
                # expresses optimistic concurrency and must reach the
                # store's conflict check intact
                patched.setdefault("metadata", {}).setdefault(
                    "resourceVersion", current["metadata"]["resourceVersion"]
                )
                out = self.store.update_raw(patched, subresource=route.subresource)
            else:
                out = self.store.patch_raw(
                    route.api_version,
                    route.kind,
                    route.namespace,
                    route.name,
                    patch,
                    subresource=route.subresource,
                )
        return 200, out

    def _delete(self, h, route: _Route) -> Tuple[int, Dict[str, Any]]:
        self.store.delete_raw(route.api_version, route.kind, route.namespace, route.name)
        return 200, {"kind": "Status", "apiVersion": "v1", "status": "Success"}

    # -- watch streaming --

    def _watch(self, h, route: _Route, query: Dict[str, str], method: str = "GET") -> None:
        since_rv = query.get("resourceVersion") or None
        bookmarks = query.get("allowWatchBookmarks") in ("true", "1")
        selector = parse_label_selector(query.get("labelSelector", ""))
        w = self.store.watch(
            route.api_version,
            route.kind,
            namespace=route.namespace if route.namespaced else None,
            send_initial=since_rv is None,
            since_rv=since_rv,
        )
        # audit only once the watch is established (a 410/invalid-RV raise
        # above flows to _dispatch's ApiError record instead) and before the
        # stream's first bytes flush — the ordering contract
        self._audit(method, h.path, "watch")
        with self._watch_lock:
            self._active_watches.append(w)
        try:
            h.send_response(200)
            h.send_header("Content-Type", "application/json")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()

            def send_chunk(payload: bytes) -> None:
                h.wfile.write(f"{len(payload):x}\r\n".encode() + payload + b"\r\n")
                h.wfile.flush()

            idle_polls = 0
            while not self._stopping.is_set():
                ev = w.get(timeout=0.5)
                if ev is None:
                    if self._stopping.is_set() or w.stopped:
                        break  # server shutdown or stream severed: end cleanly
                    idle_polls += 1
                    if idle_polls >= self.heartbeat_polls:
                        # heartbeat: a quiet kind would otherwise never touch
                        # the socket, so a client gone away would leak this
                        # handler thread + store watch. With
                        # allowWatchBookmarks requested, ask the STORE to
                        # enqueue a BOOKMARK through this watch's queue —
                        # RV read and enqueue are atomic with event emission,
                        # so a bookmark can never claim progress past an
                        # event still queued behind it (reading current_rv
                        # here instead would race exactly that way)
                        if bookmarks and hasattr(w, "request_bookmark"):
                            w.request_bookmark()
                        else:
                            send_chunk(b"\n")
                        idle_polls = 0
                    continue
                idle_polls = 0
                if ev.type == "DROPPED":
                    # injected stream severing: end the chunked response so
                    # the remote reflector reconnects from its last RV —
                    # exactly what a dropped apiserver connection looks like
                    break
                if ev.type == "BOOKMARK":
                    if not bookmarks:
                        continue
                    bm = {
                        "type": "BOOKMARK",
                        "object": {
                            "kind": route.kind,
                            "apiVersion": route.api_version,
                            "metadata": ev.object.get("metadata", {}),
                        },
                    }
                    send_chunk((json.dumps(bm) + "\n").encode())
                    continue
                if selector is not None and not match_labels(
                    selector, ev.object.get("metadata", {}).get("labels")
                ):
                    continue
                line = json.dumps({"type": ev.type, "object": ev.object}) + "\n"
                send_chunk(line.encode())
            try:
                h.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            w.stop()
            with self._watch_lock:
                try:
                    self._active_watches.remove(w)
                except ValueError:
                    pass
            h.close_connection = True
