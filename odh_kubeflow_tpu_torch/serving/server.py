"""In-pod HTTP front of the continuous-batching engine (counterpart of
odh_kubeflow_tpu/serving/server.py): `python -m odh_kubeflow_tpu_torch.serving`.

- ``POST /generate`` ``{"prompt": [ints], "max_new": n}`` -> blocks until
  the sequence completes -> ``{"tokens": [...], "ttft_s": ..., "result":
  "ok"}``. A full admission queue is an explicit **429**; a request the
  engine canceled or failed is a **503**. A ``traceparent`` header is kept
  on the request's engine handle.
- ``GET /healthz`` -> 200 once the server is up.
- ``GET /stats`` -> the engine's live counters.

The engine shape comes from the same ``SERVING_*`` env as the JAX server;
the model comes from ``SERVING_CHECKPOINT`` (a directory saved by
`models.checkpoint.save_train_state`, the promotion lineage) through
`build_engine_from_env`.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler
from typing import Optional, Tuple

from ..device import DeviceLike
from ..utils.httpserve import ThreadedHTTPServer, respond, serve_in_thread, shutdown

log = logging.getLogger(__name__)

REQUEST_TIMEOUT_S = 120.0


def build_engine_from_env(environ=None, device: DeviceLike = "cuda"):
    """Engine + model from the pod env (SERVING_* set by the controller).
    SERVING_CHECKPOINT names a checkpoint directory whose latest step holds
    {"params": ...} of the model SERVING_MODEL_CONFIG describes (the
    TransformerConfig fields as JSON, dtype by name); it is restored onto
    `device` and served. A checkpoint that does not load raises. Without
    SERVING_CHECKPOINT a tiny random-weight demo model serves (the smoke
    shape)."""
    import os

    import torch

    from ..models import TransformerConfig, init_params, restore_train_state
    from .engine import ServingEngine

    env = environ if environ is not None else os.environ
    max_slots = int(env.get("SERVING_MAX_SLOTS", "8"))
    max_seq = int(env.get("SERVING_MAX_SEQ", "512"))
    max_queue = int(env.get("SERVING_MAX_QUEUE", "64"))
    burst = int(env.get("SERVING_DECODE_BURST", "8"))
    ckpt = env.get("SERVING_CHECKPOINT", "")
    if ckpt:
        if not env.get("SERVING_MODEL_CONFIG"):
            raise RuntimeError(
                "SERVING_CHECKPOINT set without SERVING_MODEL_CONFIG: the "
                "restore needs the model shape to allocate against"
            )
        cfg = TransformerConfig(**json.loads(env["SERVING_MODEL_CONFIG"]))
        like = init_params(torch.Generator().manual_seed(0), cfg, device=device)
        params = restore_train_state(ckpt, {"params": like})["params"]
    else:
        # the JAX demo model's shape; attention through the flash kernel so
        # the demo's prefill runs the same kernel as a real model on the card
        cfg = TransformerConfig(
            vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=max_seq, dtype=torch.float32, use_flash=True,
            remat=False,
        )
        params = init_params(torch.Generator().manual_seed(0), cfg, device=device)
        log.warning("no SERVING_CHECKPOINT: serving a demo model (random weights)")
    return ServingEngine(
        params, cfg, max_slots=max_slots, max_seq=max_seq,
        max_queue_depth=max_queue, decode_burst=burst, device=device,
    )


class ServingHTTPServer:
    """The threaded HTTP front. `start()` binds and runs the handler pool;
    the engine's own loop (engine.start()) does the decoding. Handlers touch
    only the engine's host-side API (submit/wait/stats), never a tensor."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 8000):
        self.engine = engine
        self._requested = (host, port)
        self.httpd: Optional[ThreadedHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> Tuple[str, int]:
        from .engine import QueueFull

        engine = self.engine

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("serving http: " + fmt, *args)

            def do_GET(self):
                if self.path == "/healthz":
                    respond(self, 200, b'{"ok": true}')
                elif self.path == "/stats":
                    respond(self, 200, json.dumps(engine.stats()).encode())
                else:
                    respond(self, 404, b'{"error": "not found"}')

            def do_POST(self):
                if self.path != "/generate":
                    respond(self, 404, b'{"error": "not found"}')
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    prompt = [int(t) for t in body["prompt"]]
                    max_new = int(body.get("max_new", 16))
                except (KeyError, TypeError, ValueError) as e:
                    respond(self, 400, json.dumps({"error": f"bad request: {e}"}).encode())
                    return
                try:
                    handle = engine.submit(prompt, max_new=max_new,
                                           traceparent=self.headers.get("traceparent"))
                except QueueFull as e:
                    respond(self, 429, json.dumps(
                        {"error": str(e), "result": "rejected"}
                    ).encode())
                    return
                except ValueError as e:
                    respond(self, 400, json.dumps({"error": str(e)}).encode())
                    return
                if not handle.wait(timeout=REQUEST_TIMEOUT_S):
                    respond(self, 503, json.dumps(
                        {"error": "generation timed out", "result": "error"}
                    ).encode())
                    return
                if handle.result != "ok":
                    respond(self, 503, json.dumps({"result": handle.result}).encode())
                    return
                respond(self, 200, json.dumps({
                    "tokens": handle.tokens,
                    "ttft_s": handle.ttft_s,
                    "result": handle.result,
                }).encode())

        self.httpd = ThreadedHTTPServer(self._requested, Handler)
        self._thread = serve_in_thread(self.httpd, "serving-http")
        bound = self.httpd.server_address
        log.info("serving engine HTTP on %s:%s", bound[0], bound[1])
        return bound[0], bound[1]

    def stop(self, drain_timeout_s: float = 0.0) -> None:
        if self.httpd is not None:
            shutdown(self.httpd)
            self.httpd = None
        self.engine.stop(drain_timeout_s=drain_timeout_s)
