"""Standalone serving entrypoint: `python -m odh_kubeflow_tpu_torch.serving`.

Builds the continuous-batching engine from the SERVING_* env (the model from
SERVING_CHECKPOINT, the promotion lineage, on SERVING_DEVICE, the card by
default), starts its decode loop, and serves POST /generate + /healthz +
/stats on SERVING_PORT (default 8000; 0 takes a free port), at the pod's
address when POD_IP names one (else every address). SIGTERM stops
it: in-flight requests get SERVING_DRAIN_TIMEOUT_S (default 5) to finish,
and what is left fails fast.

When the pod names a control directory (`probe.behavior.CONTROL_DIR_ENV`),
the process writes there, once it has restored its checkpoint and listens,
the report its pod's agent waits for before it reports ready
(`probe.behavior.SERVING_READY`): the restore's ack, the port, the logit
fingerprint of the served params and its times; it then answers the
restore requests the agent forwards (`probe.behavior.answer_restore`) with
that ack, and at its stop writes the flash launches of the requests it
served (`probe.behavior.SERVING_EXIT`).
"""
import logging
import os
import signal
import threading
import time

STARTED = time.time()  # before torch is imported

from .server import FINGERPRINT_PROMPT, ServingHTTPServer, build_engine_from_env, load_model_from_env  # noqa: E402

log = logging.getLogger("odh_kubeflow_tpu_torch.serving")


def main() -> None:
    import torch

    from ..models import logit_fingerprint
    from ..ops import attention
    from ..probe.behavior import CONTROL_DIR_ENV, SERVING_EXIT, SERVING_READY, answer_restore, write_json

    logging.basicConfig(level=logging.INFO)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    device = torch.device(os.environ.get("SERVING_DEVICE", "cuda"))
    control = os.environ.get(CONTROL_DIR_ENV, "")
    times = {"started": STARTED}
    torch.empty(1, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times["context"] = time.time()
    model = load_model_from_env(device=device)
    times["restored"] = time.time()
    engine = build_engine_from_env(device=device, model=model).start()
    server = ServingHTTPServer(engine, host=os.environ.get("POD_IP") or "0.0.0.0",
                               port=int(os.environ.get("SERVING_PORT", "8000")))
    host, port = server.start()
    log.info("serving on %s:%s", host, port)
    if control:
        params, cfg, ack = model
        fingerprint = logit_fingerprint(params, cfg, FINGERPRINT_PROMPT)
        attention.reset_launch_counts()  # from here on, the served requests' launches
        times["listening"] = time.time()
        write_json(os.path.join(control, SERVING_READY), {
            "pid": os.getpid(), "port": port, "device": str(device), "restore": ack,
            "logit_fingerprint": fingerprint, "times": times})
        answered = set()
        while not stop.wait(0.02):
            answer_restore(control, lambda: ack or {"restored": False, "reason": "no SERVING_CHECKPOINT"},
                           answered)
    else:
        stop.wait()
    server.stop(drain_timeout_s=float(os.environ.get("SERVING_DRAIN_TIMEOUT_S", "5")))
    if control:
        write_json(os.path.join(control, SERVING_EXIT), {
            "launches": dict(attention.launch_counts), "stats": engine.stats(), "stopped": time.time()})


if __name__ == "__main__":
    main()
