"""The pooled HTTP(S) transport of the real-cluster client (the port's copy
of `HostPool` and `_tcp_nodelay` from odh_kubeflow_tpu/cluster/remote.py):
the webhook dispatcher's callouts go through it. The reference's
`RemoteStore`, `ApiServer` and their fixture are not ported yet.
"""
from __future__ import annotations

import socket
import threading
from typing import Tuple


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
