"""Threaded HTTP server scaffolding for the port's serving front (own copy
of odh_kubeflow_tpu/utils/httpserve.py): daemon handler threads, a listen
backlog sized for bursts, Nagle off on every connection, and
Content-Length-framed responses that keep HTTP/1.1 keep-alive correct.
"""
from __future__ import annotations

import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ThreadedHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128

    def get_request(self):
        # Nagle OFF: the handler's unbuffered wfile sends a framed response
        # as several small writes, and with Nagle on the later ones wait for
        # the peer's delayed ACK (~40 ms per request on kept-alive
        # connections)
        sock, addr = super().get_request()
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        return sock, addr


def respond(
    h: BaseHTTPRequestHandler,
    code: int,
    body: bytes,
    content_type: str = "application/json",
) -> None:
    """Framed response (explicit Content-Length so keep-alive stays sound)."""
    h.send_response(code)
    h.send_header("Content-Type", content_type)
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    h.wfile.write(body)


def serve_in_thread(httpd: ThreadingHTTPServer, name: str) -> threading.Thread:
    t = threading.Thread(target=httpd.serve_forever, name=name, daemon=True)
    t.start()
    return t


def shutdown(httpd: ThreadingHTTPServer) -> None:
    httpd.shutdown()
    httpd.server_close()
