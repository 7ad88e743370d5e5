"""Standalone serving entrypoint: `python -m odh_kubeflow_tpu_torch.serving`.

Builds the continuous-batching engine on the card from the SERVING_* env,
starts its decode loop, and serves POST /generate + /healthz + /stats on
SERVING_PORT (default 8000).
"""
import logging
import os
import signal
import threading

from .server import ServingHTTPServer, build_engine_from_env

log = logging.getLogger("odh_kubeflow_tpu_torch.serving")


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    port = int(os.environ.get("SERVING_PORT", "8000"))
    engine = build_engine_from_env().start()
    server = ServingHTTPServer(engine, host="0.0.0.0", port=port)
    host, bound_port = server.start()
    log.info("serving on %s:%s", host, bound_port)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait()
    server.stop(drain_timeout_s=float(os.environ.get("SERVING_DRAIN_TIMEOUT_S", "5")))


if __name__ == "__main__":
    main()
