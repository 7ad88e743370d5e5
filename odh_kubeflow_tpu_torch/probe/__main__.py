"""Standalone probe agent entrypoint: `python -m odh_kubeflow_tpu_torch.probe`.

Runs next to the notebook process in the workbench image, serving
/tpu/readiness and /tpu/utilization (and Jupyter-compatible stubs where no
real Jupyter answers) on NB_PROBE_PORT (default 8889). Duty cycle is
measured: the card's utilization counter from nvidia-smi, the
runtime-metrics scrape, and, once this process has initialised CUDA, the
caching allocator (see CudaMonitor).
"""
import logging
import os
import signal
import threading

from .agent import CudaMonitor, NotebookAgent

log = logging.getLogger("odh_kubeflow_tpu_torch.probe")


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    port = int(os.environ.get("NB_PROBE_PORT", "8889"))
    agent = NotebookAgent(CudaMonitor())
    host, bound_port, close = agent.serve(host="0.0.0.0", port=port)
    log.info("probe agent serving on %s:%s", host, bound_port)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait()
    close()
    # a sidecar must exit promptly on SIGTERM or it delays pod teardown: the
    # CUDA runtime may hold non-daemon threads that would block a clean
    # interpreter exit
    os._exit(0)


if __name__ == "__main__":
    main()
