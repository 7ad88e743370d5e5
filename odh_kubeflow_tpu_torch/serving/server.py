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
`load_model_from_env`, which restores the whole saved train state and acks
its checksum, and `build_engine_from_env`.
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


# the prompt of `logit_fingerprint` a serving process reports for the model
# it serves (and a notebook's worker for the state it saved): the model as
# served is compared with the model trained through it
FINGERPRINT_PROMPT = tuple(range(1, 17))


def load_model_from_env(environ=None, device: DeviceLike = "cuda"):
    """(params, cfg, ack) of the model the pod env names. SERVING_CHECKPOINT
    names a checkpoint directory whose latest step holds a train state of
    the model SERVING_MODEL_CONFIG describes (the TransformerConfig fields
    as JSON, dtype by name): {"params"} alone, or with the AdamW state of
    `make_train_step` ("opt_state"). The whole state is restored onto
    `device`, as the source saved it; `ack` is {"restored", "step",
    "checksum", "seconds", "bytes"} of what was loaded, its checksum
    recomputed from the loaded state (`state_checksum`: the save's own
    digest when the restore is exact), and only its params are kept. A
    checkpoint that does not load raises. Without SERVING_CHECKPOINT a tiny
    random-weight demo model is returned (the smoke shape) and `ack` is
    None."""
    import os
    import time

    import torch

    from ..models import (TransformerConfig, adamw, init_params, latest_step, restore_train_state, saved_keys,
                          state_checksum)
    from ..models.tree import tree_leaves

    env = environ if environ is not None else os.environ
    ckpt = env.get("SERVING_CHECKPOINT", "")
    if not ckpt:
        # the JAX demo model's shape; attention through the flash kernel so
        # the demo's prefill runs the same kernel as a real model on the card
        cfg = TransformerConfig(
            vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=int(env.get("SERVING_MAX_SEQ", "512")), dtype=torch.float32,
            use_flash=True, remat=False,
        )
        log.warning("no SERVING_CHECKPOINT: serving a demo model (random weights)")
        return init_params(torch.Generator().manual_seed(0), cfg, device=device), cfg, None
    if not env.get("SERVING_MODEL_CONFIG"):
        raise RuntimeError(
            "SERVING_CHECKPOINT set without SERVING_MODEL_CONFIG: the "
            "restore needs the model shape to allocate against"
        )
    cfg = TransformerConfig(**json.loads(env["SERVING_MODEL_CONFIG"]))
    step = latest_step(ckpt)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt!r}")
    t0 = time.time()
    params = init_params(torch.Generator().manual_seed(0), cfg, device=device)
    like = {"params": params}
    if "opt_state" in saved_keys(ckpt, step):
        like["opt_state"] = adamw().init(params)
    state = restore_train_state(ckpt, like, step=step)
    ack = {"restored": True, "step": int(step), "checksum": state_checksum(state), "seconds": time.time() - t0,
           "bytes": sum(t.numel() * t.element_size() for t in tree_leaves(state))}
    return state["params"], cfg, ack


def build_engine_from_env(environ=None, device: DeviceLike = "cuda", model=None):
    """Engine from the pod env (SERVING_* set by the controller), serving
    `model` ((params, cfg, ack) of `load_model_from_env`), or the model the
    env names."""
    import os

    from .engine import ServingEngine

    env = environ if environ is not None else os.environ
    params, cfg, _ = model if model is not None else load_model_from_env(env, device)
    return ServingEngine(
        params, cfg, max_slots=int(env.get("SERVING_MAX_SLOTS", "8")),
        max_seq=int(env.get("SERVING_MAX_SEQ", "512")),
        max_queue_depth=int(env.get("SERVING_MAX_QUEUE", "64")),
        decode_burst=int(env.get("SERVING_DECODE_BURST", "8")), device=device,
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
