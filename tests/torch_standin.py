"""A stand-in for the suspend controller's completed suspend of a notebook
(the reference's `SuspendResumeController`, odh_kubeflow_tpu/controllers/
suspend.py:425-460, which the port has not got yet): the parity tests run it
on both packages, and tests/torch_operator_flow.py runs it on the port's
cluster before a promotion. Imports no jax.

`suspend` writes what a successful suspend writes, in the same order: the
stop, then once the notebook's pods are gone the slice's pool released
warm through `SlicePool.release(pool, nodes, priority)`, and then
`suspend-state: suspended`, `suspended-at`, `checkpoint-saved` and ordinal
0's `checkpoint-checksum` (from the ack its agent's /tpu/checkpoint gave):
a promotion that reads the notebook suspended finds its pool warm.

`pkg` is a namespace of one package's modules: `nb` (the Notebook API),
`core` (Pod, Node), `am` (apimachinery), `C` (the controllers' constants),
`ctrl` (the controllers), `slicepool` (cluster.slicepool) and `pool_label`
(the GKE node-pool label).
"""
import json
import time

PROBE_PORT = 8889  # Config's default probe port, both packages


def checkpoint(pkg, http_get, namespace, name, cluster_domain="cluster.local", timeout=60.0):
    """GET ordinal 0's /tpu/checkpoint through its agent (the save the
    suspend controller drives before the scale-down); returns the ack, which
    must say saved."""
    svc = pkg.ctrl.hosts_service_name(name)
    url = f"http://{name}-0.{svc}.{namespace}.svc.{cluster_domain}:{PROBE_PORT}/tpu/checkpoint"
    status, body = http_get(url, timeout=timeout)
    ack = json.loads(body.decode() or "null") or {}
    if status != 200 or not ack.get("saved"):
        raise AssertionError(f"{namespace}/{name}'s checkpoint was not saved: {status} {ack}")
    return ack


def suspend(pkg, client, namespace, name, ack, gone=lambda: True, timeout=60.0):
    """Stops the notebook, waits until its pods are gone and `gone()` holds
    (the caller's check that its processes are), then releases the slice's
    pool warm at the notebook's priority and writes the suspend's
    annotations with `ack`'s step and checksum. Returns the pool's name."""
    C, Notebook, Pod, Node = pkg.C, pkg.nb.Notebook, pkg.core.Pod, pkg.core.Node
    pods = client.list(Pod, namespace=namespace, labels={C.NOTEBOOK_NAME_LABEL: name})
    (node,) = {p.spec.node_name for p in pods if p.spec.node_name}
    pool = client.get(Node, "", node).metadata.labels[pkg.pool_label]
    _patch(pkg, client, namespace, name, {C.STOP_ANNOTATION: pkg.am.rfc3339_precise(time.time())})
    deadline = time.monotonic() + timeout
    while client.list(Pod, namespace=namespace, labels={C.NOTEBOOK_NAME_LABEL: name}) or not gone():
        if time.monotonic() > deadline:
            raise AssertionError(f"{namespace}/{name}'s pods did not go after its stop")
        time.sleep(0.02)
    nb = client.get(Notebook, namespace, name)
    nodes = [n.metadata.name for n in client.list(Node) if n.metadata.labels.get(pkg.pool_label) == pool]
    priority = int(nb.spec.tpu.priority) if nb.spec.tpu is not None else 0
    if not pkg.slicepool.SlicePool(client).release(pool, nodes, priority=priority):
        raise AssertionError(f"{namespace}/{name}'s pool {pool} was not released warm")
    _patch(pkg, client, namespace, name, {
        C.TPU_SUSPEND_STATE_ANNOTATION: "suspended",
        C.TPU_SUSPENDED_AT_ANNOTATION: pkg.am.rfc3339_precise(time.time()),
        C.TPU_CHECKPOINT_SAVED_ANNOTATION: str(ack["step"]),
        C.TPU_CHECKPOINT_CHECKSUM_ANNOTATION: str(ack["checksum"]),
    })
    return pool


def _patch(pkg, client, namespace, name, annotations, attempts=40):
    """A merge patch of the notebook's annotations, retried over write
    conflicts with its controllers."""
    for i in range(attempts):
        try:
            return client.patch(pkg.nb.Notebook, namespace, name, {"metadata": {"annotations": annotations}})
        except (pkg.am.ConflictError, pkg.am.TooManyRequestsError):
            if i == attempts - 1:
                raise
            time.sleep(0.02)
