"""RemoteStore: the real-cluster transport — a Store-compatible backend that
speaks the Kubernetes REST protocol over HTTP(S) (the port's copy of
odh_kubeflow_tpu/cluster/remote.py).

This is the piece that turns the operator from "manages its in-process sim"
into "manages the cluster it is pointed at": `build_manager(RemoteStore(...))`
runs the identical controllers against any server speaking the standard wire
protocol — the in-tree ApiServer (cluster/apiserver.py) or a real
kube-apiserver via kubeconfig (the reference's managers bootstrap exactly so:
ctrl.GetConfigOrDie() in components/notebook-controller/main.go:79-94).

Implements the Store surface the Client and informers consume:
  create_raw / get_raw / list_raw / list_raw_with_rv / update_raw /
  patch_raw / delete_raw / watch
`watch` is a full reflector: atomic list+RV snapshot for the initial state,
then a streaming `?watch=true&resourceVersion=N` connection, reconnecting
from the last seen RV on drops and degrading to relist+diff on 410 Expired —
client-go's ListWatch/Reflector contract re-derived.

Deliberately absent: register_webhook. Remote admission runs server-side
(MutatingWebhookConfiguration + the HTTPS webhook server,
runtime/webhook_server.py);
build_manager keys off this attribute's absence.
"""
from __future__ import annotations

import base64
import json
import logging
import os
import queue
import socket
import ssl
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..apimachinery import (
    AdmissionDeniedError,
    AlreadyExistsError,
    ApiError,
    ConflictError,
    ForbiddenError,
    GoneError,
    InvalidError,
    NotFoundError,
    RESTMapper,
    Scheme,
    TooManyRequestsError,
    UnauthorizedError,
    default_scheme,
)
from .store import ADDED, DELETED, MODIFIED, WatchEvent

log = logging.getLogger(__name__)

_ERROR_BY_REASON = {
    "NotFound": NotFoundError,
    "AlreadyExists": AlreadyExistsError,
    "Conflict": ConflictError,
    "Invalid": InvalidError,
    "Forbidden": ForbiddenError,
    "Expired": GoneError,
    "Gone": GoneError,
    "AdmissionDenied": AdmissionDeniedError,
    "Unauthorized": UnauthorizedError,
    "TooManyRequests": TooManyRequestsError,
}


def _error_from_response(code: int, raw: bytes) -> ApiError:
    reason, message = "", ""
    retry_after: Optional[float] = None
    try:
        body = json.loads(raw)
        reason = body.get("reason", "")
        message = body.get("message", "")
        details = body.get("details") or {}
        if isinstance(details, dict) and details.get("retryAfterSeconds") is not None:
            try:
                retry_after = float(details["retryAfterSeconds"])
            except (TypeError, ValueError):
                retry_after = None
    except ValueError:
        message = raw.decode(errors="replace")[:500]
    cls = _ERROR_BY_REASON.get(reason)
    if cls is None:
        cls = {
            404: NotFoundError,
            409: ConflictError,
            410: GoneError,
            401: UnauthorizedError,
            403: ForbiddenError,
            422: InvalidError,
            429: TooManyRequestsError,
        }.get(code, ApiError)
    if cls is TooManyRequestsError:
        return TooManyRequestsError(
            message or f"HTTP {code}", retry_after=retry_after or 1.0
        )
    return cls(message or f"HTTP {code}")


def _unlink_all(paths: List[str]) -> None:
    """Drain `paths` IN PLACE, unlinking each — shared between close() and
    the atexit backstop so whichever runs first empties the same list."""
    while paths:
        try:
            os.unlink(paths.pop())
        except OSError:
            pass


def _tcp_nodelay(conn) -> None:
    """Disable Nagle on a (connected) http.client connection: paired with
    delayed ACKs it costs ~40ms per request on kept-alive sockets."""
    sock = getattr(conn, "sock", None)
    if sock is not None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


class HostPool:
    """Per-thread keep-alive HTTP(S) connection to one host — the shared
    pooled transport for RemoteStore and the webhook dispatcher (a fresh
    TCP + TLS handshake per request costs more than most requests).

    Retry discipline for stale keep-alive sockets, chosen so a request the
    server may have EXECUTED is never silently re-sent:
    - send-phase failure (conn.request raises): the server never parsed the
      request on this connection — safe to retry once for any method;
    - response-phase failure: retry once for idempotent GETs only;
    - timeouts NEVER retry — the server may still be executing the call
      (a re-sent POST would double-create; the caller sees the timeout).
    """

    def __init__(self, scheme: str, host: str, port, timeout: float, context=None):
        self.scheme = scheme
        self.host = host
        self.port = port
        self.timeout = timeout
        self.context = context
        self._local = threading.local()

    def _conn(self):
        import http.client

        conn = getattr(self._local, "conn", None)
        if conn is None:
            if self.scheme == "https":
                conn = http.client.HTTPSConnection(
                    self.host, self.port, timeout=self.timeout, context=self.context
                )
            else:
                conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout
                )
            conn.connect()
            _tcp_nodelay(conn)  # request writes must not wait on delayed ACKs
            self._local.conn = conn
        return conn

    def drop(self) -> None:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def request(self, method: str, path: str, body, headers) -> Tuple[int, bytes]:
        import http.client

        retryable = (http.client.HTTPException, ConnectionError, OSError)
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request(method, path, body=body, headers=headers)
            except socket.timeout:
                self.drop()
                raise
            except retryable:
                # send phase: the request never reached the server's parser
                # on this (stale) connection
                self.drop()
                if attempt:
                    raise
                continue
            try:
                resp = conn.getresponse()
                data = resp.read()  # drain fully so the conn is reusable
            except socket.timeout:
                self.drop()
                raise
            except retryable:
                self.drop()
                if attempt or method != "GET":
                    raise  # the server may have executed a non-idempotent call
                continue
            return resp.status, data
        raise ConnectionError("unreachable")  # pragma: no cover


class _TokenBucket:
    """Client-side API throttling — the client-go rate.Limiter the reference
    wires through --kube-api-qps/--kube-api-burst
    (notebook-controller/main.go:65-72,79-85). Without it a hot reconcile
    loop hammers a production apiserver unthrottled. Standard token bucket:
    `burst` tokens refill at `qps`/s; acquire() blocks until one is free."""

    def __init__(self, qps: float, burst: int):
        self.qps = float(qps)
        # burst <= 0 would cap tokens below 1.0 forever and hang every
        # request; unthrottled is expressed as qps<=0 (no bucket), so clamp
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst  # the CLAMPED burst: raw burst<=0 here
        # would start the bucket in debt and stall the first request
        self._stamp = time.monotonic()
        self._lock = threading.Lock()
        self.waits = 0  # observability: REQUESTS that had to sleep (each
        self.waited_s = 0.0  # counted once, however many retry loops it took)

    def acquire(self) -> None:
        t_start = None
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._stamp) * self.qps
                )
                self._stamp = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    if t_start is not None:
                        self.waits += 1
                        self.waited_s += now - t_start
                    return
                wait = (1.0 - self._tokens) / self.qps
                if t_start is None:
                    t_start = now
            time.sleep(wait)


def _abort_stream(resp) -> None:
    """Abort an in-flight chunked response.

    resp.close() alone deadlocks: it waits on the buffered reader's lock,
    which the reader thread holds while blocked in readline(). Shutting the
    underlying socket down first forces that read to return EOF, then close
    is safe."""
    try:
        sock = getattr(getattr(resp, "fp", None), "raw", None)
        sock = getattr(sock, "_sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
    except Exception:
        pass
    try:
        resp.close()
    except Exception:
        pass


class RemoteWatch:
    """Watch-compatible reflector over the HTTP watch stream."""

    def __init__(
        self,
        store: "RemoteStore",
        api_version: str,
        kind: str,
        namespace: Optional[str],
        send_initial: bool,
    ):
        self._store = store
        self._api_version = api_version
        self._kind = kind
        self._namespace = namespace
        self._q: "queue.Queue[Optional[WatchEvent]]" = queue.Queue()
        self._stopped = threading.Event()
        self._resp = None
        self._resp_lock = threading.Lock()

        items, rv = store.list_raw_with_rv(api_version, kind, namespace=namespace)
        self.pending: List[WatchEvent] = (
            [WatchEvent(ADDED, o) for o in items] if send_initial else []
        )
        # keys this watch has surfaced — needed to synthesize DELETEDs when a
        # 410 forces a relist
        self._keys = {self._key(o) for o in items}
        self._rv = rv
        self._thread = threading.Thread(
            target=self._run, name=f"remote-watch-{kind}", daemon=True
        )
        self._thread.start()

    @staticmethod
    def _key(obj: Dict[str, Any]) -> str:
        m = obj.get("metadata", {})
        ns = m.get("namespace", "")
        return f"{ns}/{m.get('name', '')}" if ns else m.get("name", "")

    # -- Watch interface --

    def get(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        if self.pending:
            return self.pending.pop(0)
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self) -> None:
        self._stopped.set()
        with self._resp_lock:
            resp = self._resp
        if resp is not None:
            _abort_stream(resp)
        self._q.put(None)

    def __iter__(self):
        while True:
            ev = self.get()
            if ev is None:
                return
            yield ev

    # -- reflector loop --

    def _run(self) -> None:
        backoff = 0.05
        while not self._stopped.is_set():
            try:
                self._stream_once()
                backoff = 0.05  # clean EOF: reconnect immediately-ish
            except GoneError:
                try:
                    self._relist()
                    backoff = 0.05
                except Exception as e:
                    log.debug("watch relist failed (%s/%s): %r", self._kind, self._namespace, e)
            except Exception as e:
                if not self._stopped.is_set():
                    log.debug("watch stream error (%s/%s): %r", self._kind, self._namespace, e)
            if self._stopped.is_set():
                return
            from ..runtime.metrics import watch_restarts_total

            watch_restarts_total.inc(kind=self._kind)
            time.sleep(backoff)
            backoff = min(backoff * 2, 2.0)

    def _stream_once(self) -> None:
        if not self._rv:
            # no RV to resume from (initial LIST returned no
            # listMeta.resourceVersion): streaming without one would make the
            # server replay full initial ADDEDs, duplicating the snapshot
            # already delivered — relist to establish an RV first
            self._relist()
        path = self._store._collection_path(self._api_version, self._kind, self._namespace)
        url = f"{path}?watch=true&allowWatchBookmarks=true"
        if self._rv:
            url += f"&resourceVersion={self._rv}"
        resp = self._store._open(url, timeout=self._store.watch_timeout)
        with self._resp_lock:
            if self._stopped.is_set():
                resp.close()
                return
            self._resp = resp
        try:
            for line in resp:
                if self._stopped.is_set():
                    return
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                if ev.get("type") == "ERROR":
                    code = ev.get("object", {}).get("code")
                    if code == 410:
                        raise GoneError("watch window expired mid-stream")
                    continue
                if ev.get("type") == "BOOKMARK":
                    # progress marker only: advance the resume RV (so quiet /
                    # selector-filtered watches don't resume from an expired
                    # window) but surface no event
                    rv = ev.get("object", {}).get("metadata", {}).get(
                        "resourceVersion"
                    )
                    if rv:
                        self._rv = rv
                    continue
                obj = ev["object"]
                rv = obj.get("metadata", {}).get("resourceVersion")
                if rv:
                    self._rv = rv
                key = self._key(obj)
                if ev["type"] == DELETED:
                    self._keys.discard(key)
                else:
                    self._keys.add(key)
                self._q.put(WatchEvent(ev["type"], obj))
        finally:
            with self._resp_lock:
                self._resp = None
            _abort_stream(resp)

    def _relist(self) -> None:
        """410 recovery: replace state via a fresh list, synthesizing the diff
        (DELETED for vanished keys; ADDED/MODIFIED pass through as ADDED —
        informer caches upsert either way, level-triggered handlers re-run)."""
        from ..runtime.metrics import relists_total

        relists_total.inc(kind=self._kind)
        items, rv = self._store.list_raw_with_rv(
            self._api_version, self._kind, namespace=self._namespace
        )
        fresh = {self._key(o): o for o in items}
        for key in list(self._keys):
            if key not in fresh:
                ns, _, name = key.rpartition("/")
                self._q.put(
                    WatchEvent(
                        DELETED,
                        {
                            "apiVersion": self._api_version,
                            "kind": self._kind,
                            "metadata": {"namespace": ns, "name": name},
                        },
                    )
                )
                self._keys.discard(key)
        for key, obj in fresh.items():
            self._q.put(WatchEvent(ADDED, obj))
            self._keys.add(key)
        self._rv = rv


class RemoteStore:
    """Store-compatible backend over the Kubernetes REST protocol."""

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        client_cert: Optional[Tuple[str, str]] = None,
        insecure_skip_tls_verify: bool = False,
        scheme: Scheme = default_scheme,
        timeout: float = 30.0,
        watch_timeout: float = 300.0,
        qps: float = 20.0,
        burst: int = 30,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.ca_file = ca_file
        self.scheme = scheme
        self.timeout = timeout
        # client-go's default rate limits (QPS 20 / Burst 30); the reference
        # exposes them as flags and overrides the rest config the same way
        self.throttle = _TokenBucket(qps, burst) if qps > 0 else None
        self._owned_tmpfiles: List[str] = []
        # read timeout on watch streams: a partition that dies without a FIN
        # must not hang the reflector forever — on expiry the stream is torn
        # down and resumed from the last seen RV (client-go restarts watches
        # periodically for the same reason)
        self.watch_timeout = watch_timeout
        self.mapper = RESTMapper()
        self.mapper.populate_from_scheme(scheme)
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            if insecure_skip_tls_verify:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            else:
                ctx = ssl.create_default_context(cafile=ca_file)
            if client_cert is not None:
                ctx.load_cert_chain(client_cert[0], client_cert[1])
            self._ssl_ctx = ctx

    # -- in-cluster bootstrap (rest.InClusterConfig analog) --

    SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    @classmethod
    def in_cluster(
        cls,
        scheme: Scheme = default_scheme,
        sa_dir: Optional[str] = None,
        qps: float = 20.0,
        burst: int = 30,
    ) -> "RemoteStore":
        """Bootstrap from the pod environment: apiserver address from
        KUBERNETES_SERVICE_HOST/PORT, bearer token + CA from the
        ServiceAccount projection — how the deployed manager authenticates
        (the reference's ctrl.GetConfigOrDie resolves the same way in-pod)."""
        sa_dir = sa_dir or cls.SERVICEACCOUNT_DIR
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError(
                "not in a cluster: KUBERNETES_SERVICE_HOST unset "
                "(use from_kubeconfig outside a pod)"
            )
        token_path = os.path.join(sa_dir, "token")
        ca_path = os.path.join(sa_dir, "ca.crt")
        with open(token_path) as f:
            token = f.read().strip()
        if not os.path.exists(ca_path):
            # fail loudly like the missing token does: falling back to the
            # system trust store would surface as an opaque TLS error later
            raise FileNotFoundError(f"in-cluster CA bundle missing: {ca_path}")
        if ":" in host and not host.startswith("["):
            host = f"[{host}]"  # IPv6 service address
        store = cls(
            base_url=f"https://{host}:{port}",
            token=token,
            ca_file=ca_path,
            scheme=scheme,
            qps=qps,
            burst=burst,
        )
        # bound SA tokens rotate (~1h); re-read the projection per request
        # like client-go, or every call 401s after the first expiry
        store.token_file = token_path
        return store

    # -- kubeconfig bootstrap (ctrl.GetConfigOrDie analog) --

    @classmethod
    def from_kubeconfig(
        cls,
        path: Optional[str] = None,
        context: Optional[str] = None,
        scheme: Scheme = default_scheme,
        qps: float = 20.0,
        burst: int = 30,
    ) -> "RemoteStore":
        import yaml

        path = path or os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = context or cfg.get("current-context", "")
        ctx = next(
            (c["context"] for c in cfg.get("contexts", []) if c["name"] == ctx_name),
            None,
        )
        if ctx is None:
            raise ValueError(f"kubeconfig context {ctx_name!r} not found in {path}")
        cluster = next(
            c["cluster"] for c in cfg.get("clusters", []) if c["name"] == ctx["cluster"]
        )
        user = next(
            (u["user"] for u in cfg.get("users", []) if u["name"] == ctx.get("user")),
            {},
        )

        owned: List[str] = []

        def materialize(inline_key: str, file_key: str, source: Dict[str, Any]) -> Optional[str]:
            if source.get(file_key):
                return source[file_key]
            data = source.get(inline_key)
            if not data:
                return None
            f = tempfile.NamedTemporaryFile("wb", delete=False, suffix=".pem")
            f.write(base64.b64decode(data))
            f.close()
            owned.append(f.name)
            return f.name

        ca = materialize("certificate-authority-data", "certificate-authority", cluster)
        cert = materialize("client-certificate-data", "client-certificate", user)
        key = materialize("client-key-data", "client-key", user)
        try:
            store = cls(
                base_url=cluster["server"],
                token=user.get("token"),
                ca_file=ca,
                client_cert=(cert, key) if cert and key else None,
                insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify")),
                scheme=scheme,
                qps=qps,
                burst=burst,
            )
        except Exception:
            _unlink_all(owned)  # don't leak key material when construction fails
            raise
        # inline CA/cert/key were materialized to disk for the ssl API; they
        # hold private key material and must not outlive the store. atexit
        # holds only the PATH LIST (close() drains it in place), not the
        # store — long-lived processes building stores repeatedly must not
        # accumulate unreclaimable objects in the atexit registry
        store._owned_tmpfiles = owned
        if owned:
            import atexit

            atexit.register(_unlink_all, owned)
        return store

    def close(self) -> None:
        """Remove any key material this store materialized to disk."""
        _unlink_all(self._owned_tmpfiles)

    # -- HTTP plumbing --

    token_file: Optional[str] = None  # set by in_cluster(): rotating SA token

    def _headers(self, content_type: Optional[str] = None) -> Dict[str, str]:
        headers = {"Accept": "application/json"}
        if content_type:
            headers["Content-Type"] = content_type
        # flow identity for API priority & fairness: the server's
        # FlowController classifies this request by the controller identity
        # the calling thread carries (cluster/flowcontrol.py flow_context)
        from .flowcontrol import current_flow

        flow = current_flow()
        if flow:
            headers["X-Flow-Schema"] = flow
        # W3C trace propagation: API calls made under an active span carry
        # its context, so server-side traces join the caller's
        from ..utils.tracing import current_traceparent

        traceparent = current_traceparent()
        if traceparent:
            headers["traceparent"] = traceparent
        token = self.token
        if self.token_file:
            try:
                with open(self.token_file) as f:
                    token = f.read().strip() or self.token
                self.token = token  # cache the last good read: a mid-refresh
                # failure must fall back to the freshest token, not boot-time
            except OSError:
                token = self.token
        if token:
            headers["Authorization"] = f"Bearer {token}"
        return headers

    def _open(self, path: str, method: str = "GET", body: Optional[bytes] = None,
              content_type: Optional[str] = None, timeout: Optional[float] = None):
        if self.throttle is not None:
            self.throttle.acquire()
        req = urllib.request.Request(
            self.base_url + path,
            data=body,
            method=method,
            headers=self._headers(content_type),
        )
        try:
            return urllib.request.urlopen(
                req, timeout=timeout, context=self._ssl_ctx
            )
        except urllib.error.HTTPError as e:
            raise _error_from_response(e.code, e.read()) from None

    def _pool(self) -> HostPool:
        """Keep-alive pooled transport (HostPool). Watch streams
        deliberately do NOT use the pool: they hold their connection open
        for the stream's lifetime (_open)."""
        pool = getattr(self, "_host_pool", None)
        if pool is None:
            from urllib.parse import urlsplit

            u = urlsplit(self.base_url)
            pool = self._host_pool = HostPool(
                u.scheme, u.hostname, u.port, self.timeout, context=self._ssl_ctx
            )
        return pool

    # server-side 429 handling: bounded retries honoring the Status body's
    # retryAfterSeconds (capped — a hostile Retry-After must not park a
    # reconcile worker), then surface TooManyRequestsError to the caller.
    # Client._call sees the flag and does NOT add its own retry layer.
    handles_throttle_retries = True
    MAX_THROTTLE_RETRIES = 4
    MAX_RETRY_AFTER_S = 2.0

    def _request(self, path: str, method: str = "GET",
                 body: Optional[Dict[str, Any]] = None,
                 content_type: str = "application/json") -> Dict[str, Any]:
        payload = json.dumps(body).encode() if body is not None else None
        for attempt in range(self.MAX_THROTTLE_RETRIES + 1):
            if self.throttle is not None:
                self.throttle.acquire()
            headers = self._headers(content_type if payload else None)
            status, data = self._pool().request(method, path, payload, headers)
            if status == 429 and attempt < self.MAX_THROTTLE_RETRIES:
                err = _error_from_response(status, data)
                from ..runtime.metrics import client_retries_total

                client_retries_total.inc(cause="throttle")
                time.sleep(
                    min(max(getattr(err, "retry_after", 1.0), 0.0),
                        self.MAX_RETRY_AFTER_S)
                )
                continue
            if status >= 400:
                raise _error_from_response(status, data)
            return json.loads(data) if data else {}
        raise AssertionError("unreachable")  # pragma: no cover

    def _mapping(self, api_version: str, kind: str):
        return self.mapper.mapping_for(api_version, kind)

    def _collection_path(self, api_version: str, kind: str, namespace: Optional[str]) -> str:
        return self._mapping(api_version, kind).path(namespace=namespace or "")

    def _object_path(self, api_version: str, kind: str, namespace: str, name: str,
                     subresource: str = "") -> str:
        return self._mapping(api_version, kind).path(
            namespace=namespace, name=name, subresource=subresource
        )

    # -- Store surface --

    def create_raw(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        if not av or not kind:
            raise InvalidError("object missing apiVersion/kind")
        ns = obj.get("metadata", {}).get("namespace", "")
        return self._request(self._collection_path(av, kind, ns), "POST", obj)

    def get_raw(self, api_version: str, kind: str, namespace: str, name: str) -> Dict[str, Any]:
        return self._request(self._object_path(api_version, kind, namespace, name))

    def list_raw(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict[str, Any]]:
        return self.list_raw_with_rv(api_version, kind, namespace, label_selector)[0]

    def list_raw_with_rv(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> Tuple[List[Dict[str, Any]], str]:
        path = self._collection_path(api_version, kind, namespace)
        if label_selector:
            from urllib.parse import quote

            sel = ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))
            path += f"?labelSelector={quote(sel)}"
        body = self._request(path)
        return body.get("items", []), body.get("metadata", {}).get("resourceVersion", "")

    def update_raw(self, obj: Dict[str, Any], subresource: str = "") -> Dict[str, Any]:
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        meta = obj.get("metadata", {})
        return self._request(
            self._object_path(av, kind, meta.get("namespace", ""), meta.get("name", ""),
                              subresource),
            "PUT",
            obj,
        )

    def patch_raw(
        self,
        api_version: str,
        kind: str,
        namespace: str,
        name: str,
        patch: Dict[str, Any],
        subresource: str = "",
    ) -> Dict[str, Any]:
        return self._request(
            self._object_path(api_version, kind, namespace, name, subresource),
            "PATCH",
            patch,
            content_type="application/merge-patch+json",
        )

    def delete_raw(self, api_version: str, kind: str, namespace: str, name: str) -> None:
        self._request(self._object_path(api_version, kind, namespace, name), "DELETE",
                      body=None)

    def watch(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
    ) -> RemoteWatch:
        # no since_rv parameter on purpose: RemoteWatch is a full reflector
        # (reconnect-from-last-RV and relist-on-410 live inside it), so the
        # informer's resume path detects the absence and relist+diffs instead
        return RemoteWatch(self, api_version, kind, namespace, send_initial)
