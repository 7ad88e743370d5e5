"""Shared wire-protocol stack builder: TLS ApiServer + HTTPS admission
webhook + RemoteStore around an existing Store (the port's copy of
odh_kubeflow_tpu/cluster/remote_fixture.py).

One definition for every consumer that needs "the deployed shape without a
cluster" — the remote tests and the operator flow's wire writes — so the
admission path they exercise can never drift apart. Returns the RemoteStore
the manager should run on; appends cleanup callables to `teardown` (run them
in reverse) as each piece starts, so a partially-built stack still tears
down when a later step fails.
"""
from __future__ import annotations

import base64
import os
import shutil
import tempfile
from typing import Any, Callable, List, Tuple

from .store import Store


def build_remote_stack(
    store: Store,
    config,
    teardown: List[Callable[[], None]],
    token: str = "wire-token",
    qps: float = 0.0,
    burst: int = 0,
    flowcontrol: Any = None,
) -> Tuple[Any, Any, Any]:
    """Returns (api_server, remote_store, webhook_server). qps=0 (default)
    leaves the client unthrottled — timing-sensitive e2e suites must not
    absorb rate-limiter sleeps they never asked for; a load test opts in
    explicitly. `flowcontrol` (a cluster.flowcontrol.FlowController) puts
    API priority & fairness in front of the apiserver's dispatch."""
    from ..api.admission import (
        MutatingWebhook,
        MutatingWebhookConfiguration,
        RuleWithOperations,
        WebhookClientConfig,
    )
    from ..controllers import NotebookWebhook
    from ..runtime.webhook_server import WebhookServer
    from ..utils.certs import generate_cert_dir
    from .apiserver import ApiServer
    from .client import Client
    from .remote import RemoteStore
    from .webhook_dispatch import WebhookDispatcher

    pki = tempfile.mkdtemp(prefix="remote-stack-pki-")
    teardown.append(lambda: shutil.rmtree(pki, ignore_errors=True))
    ca, crt, key = generate_cert_dir(pki)
    with open(ca, "rb") as f:
        ca_b64 = base64.b64encode(f.read()).decode()

    # debug escapes (reference envtest fixture's audit-log dump + kubeconfig
    # export, odh controllers/suite_test.go:125-155): point
    # ODH_WIRE_DEBUG_DIR at a directory and the fixture writes an apiserver
    # request audit log plus a kubeconfig any kubectl-shaped client (or a
    # second RemoteStore) can use to poke the live stack mid-test
    debug_dir = os.environ.get("ODH_WIRE_DEBUG_DIR", "")
    audit_path = os.path.join(debug_dir, "apiserver-audit.jsonl") if debug_dir else None

    api = ApiServer(
        store,
        bearer_token=token,
        certfile=crt,
        keyfile=key,
        admission=WebhookDispatcher(store),
        audit_path=audit_path,
        flowcontrol=flowcontrol,
    ).start()
    teardown.append(api.stop)
    if debug_dir:
        os.makedirs(debug_dir, exist_ok=True)
        kubeconfig = {
            "apiVersion": "v1",
            "kind": "Config",
            "current-context": "wire-fixture",
            "contexts": [{"name": "wire-fixture",
                          "context": {"cluster": "wire-fixture", "user": "fixture"}}],
            "clusters": [{"name": "wire-fixture",
                          "cluster": {"server": api.base_url,
                                      "certificate-authority": ca}}],
            "users": [{"name": "fixture", "user": {"token": token}}],
        }
        import yaml

        with open(os.path.join(debug_dir, "kubeconfig"), "w") as f:
            yaml.safe_dump(kubeconfig, f)
    remote = RemoteStore(
        api.base_url, token=token, ca_file=ca, timeout=30, qps=qps, burst=burst
    )

    webhook_server = WebhookServer(certfile=crt, keyfile=key).start()
    teardown.append(webhook_server.stop)
    # The webhook gets its OWN client, like the reference's separate webhook
    # manager process with its own client-go instance: admission latency
    # must not queue behind the reconcilers' rate-limiter bucket (a create
    # storm drains the manager's QPS budget exactly when admission runs).
    # qps=0: admission latency rides the caller's request; the webhook's
    # 2-3 reads per review must not queue on a client-side rate limiter
    # (the default 20/30 bucket added ~100ms per read under a storm)
    webhook_remote = RemoteStore(
        api.base_url, token=token, ca_file=ca, timeout=30, qps=0
    )
    # TTL read memo: the chain's 3-4 per-ns ConfigMap lookups (mostly 404s)
    # must not cost wire round-trips per AdmissionReview under a storm
    from ..runtime.cached_client import TTLReadClient

    webhook_server.register(
        "/mutate-notebook-v1",
        NotebookWebhook(TTLReadClient(Client(webhook_remote)), config).handle,
    )
    cfg = MutatingWebhookConfiguration()
    cfg.metadata.name = "notebook-mutator"
    cfg.webhooks = [
        MutatingWebhook(
            name="notebooks.kubeflow.org",
            client_config=WebhookClientConfig(
                url=f"{webhook_server.base_url}/mutate-notebook-v1",
                ca_bundle=ca_b64,
            ),
            rules=[
                RuleWithOperations(
                    operations=["CREATE", "UPDATE"],
                    api_groups=["kubeflow.org"],
                    api_versions=["*"],
                    resources=["notebooks"],
                )
            ],
        )
    ]
    Client(remote).create(cfg)
    return api, remote, webhook_server
