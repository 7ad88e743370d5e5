"""Webhook dispatcher: the API server's MutatingWebhookConfiguration callout
(the port's copy of odh_kubeflow_tpu/cluster/webhook_dispatch.py).

kube-apiserver's MutatingAdmissionWebhook plugin re-derived: on CREATE/UPDATE
of a matching resource, POST an AdmissionReview v1 to each configured
webhook's clientConfig.url (TLS-verified against caBundle), apply the
returned base64 JSONPatch, and honor failurePolicy — Fail rejects the write
when the webhook is down (the reference relies on exactly this to guarantee
the reconciliation lock is present from birth: config/webhook/manifests.yaml
failurePolicy + notebook_webhook.go:105-114).

Wired into ApiServer via its `admission` hook, making the flow identical to
the reference's: client -> apiserver -> HTTPS webhook -> patched object ->
storage. The port has no ApiServer yet; a caller invokes the dispatcher
directly (`dispatcher(operation, obj, old)`), over HTTPS callouts through
`cluster.remote.HostPool`.
"""
from __future__ import annotations

import base64
import json
import logging
import ssl
import urllib.request
from typing import Any, Dict, Optional

from ..apimachinery import (
    AdmissionDeniedError,
    RESTMapper,
    Scheme,
    default_scheme,
    json_patch_apply,
)
from .store import Store
from ..utils import racecheck

log = logging.getLogger(__name__)

WEBHOOK_CONFIG_API_VERSION = "admissionregistration.k8s.io/v1"
WEBHOOK_CONFIG_KIND = "MutatingWebhookConfiguration"


class WebhookDispatcher:
    """Callable admission hook for ApiServer."""

    def __init__(self, store: Store, scheme: Scheme = default_scheme):
        self.store = store
        self.mapper = RESTMapper()
        self.mapper.populate_from_scheme(scheme)
        self._ssl_cache: Dict[str, ssl.SSLContext] = {}
        # keep-alive pooled transports by webhook host (cluster/remote.py
        # HostPool — per-thread connections, safe stale-conn retry):
        # admission sits on every matching CREATE/UPDATE, so a fresh TLS
        # handshake per callout would tax exactly the hot path
        # (kube-apiserver pools its webhook transports the same way)
        self._pools: Dict[tuple, Any] = {}
        self._pools_lock = racecheck.make_lock("WebhookDispatcher._pools_lock")

    def _post_pooled(self, url: str, payload: bytes, ctx, timeout: float) -> dict:
        from urllib.parse import urlsplit

        from .remote import HostPool

        u = urlsplit(url)
        key = (u.scheme, u.hostname, u.port, id(ctx))
        with self._pools_lock:
            pool = self._pools.get(key)
            if pool is None:
                pool = self._pools[key] = HostPool(
                    u.scheme, u.hostname, u.port, timeout, context=ctx
                )
        headers = {"Content-Type": "application/json"}
        from ..utils.tracing import current_traceparent

        traceparent = current_traceparent()
        if traceparent:
            headers["traceparent"] = traceparent
        status, data = pool.request("POST", u.path or "/", payload, headers)
        if status >= 400:
            raise ConnectionError(f"webhook POST {url} -> {status}")
        return json.loads(data)

    # -- ApiServer admission hook --

    def matches_kind(self, api_version: str, kind: str) -> bool:
        """Cheap precheck the API server uses to keep the atomic patch path
        for kinds no webhook rule matches (a read-modify-write detour would
        add a GET and spurious 409s to every unrelated patch)."""
        group, _, version = api_version.rpartition("/")
        plural = self.mapper.mapping_for(api_version, kind).plural
        for cfg in self.store.list_raw(WEBHOOK_CONFIG_API_VERSION, WEBHOOK_CONFIG_KIND):
            for wh in cfg.get("webhooks", []):
                for op in ("CREATE", "UPDATE"):
                    if self._matches(wh, op, group, version, plural):
                        return True
        return False

    def __call__(
        self, operation: str, obj: Dict[str, Any], old: Optional[Dict[str, Any]]
    ) -> Dict[str, Any]:
        av = obj.get("apiVersion", "")
        kind = obj.get("kind", "")
        group, _, version = av.rpartition("/")  # core group -> ("", "v1")
        plural = self.mapper.mapping_for(av, kind).plural
        for cfg in self.store.list_raw(WEBHOOK_CONFIG_API_VERSION, WEBHOOK_CONFIG_KIND):
            for wh in cfg.get("webhooks", []):
                if not self._matches(wh, operation, group, version, plural):
                    continue
                obj = self._call_webhook(cfg, wh, operation, obj, old)
        return obj

    @staticmethod
    def _matches(
        wh: Dict[str, Any], operation: str, group: str, version: str, plural: str
    ) -> bool:
        for rule in wh.get("rules", []):
            ops = rule.get("operations", [])
            if "*" not in ops and operation not in ops:
                continue
            groups = rule.get("apiGroups", [])
            if "*" not in groups and group not in groups:
                continue
            versions = rule.get("apiVersions", [])
            if "*" not in versions and version not in versions:
                continue
            resources = rule.get("resources", [])
            if "*" not in resources and plural not in resources:
                continue
            return True
        return False

    def _ssl_context(self, ca_bundle_b64: str) -> Optional[ssl.SSLContext]:
        if not ca_bundle_b64:
            return None
        ctx = self._ssl_cache.get(ca_bundle_b64)
        if ctx is None:
            pem = base64.b64decode(ca_bundle_b64).decode()
            ctx = ssl.create_default_context(cadata=pem)
            # serving certs carry SANs for service DNS names; hostname checks
            # stay ON — the cert generator (utils/certs.py) issues proper SANs
            self._ssl_cache[ca_bundle_b64] = ctx
        return ctx

    def _call_webhook(
        self,
        cfg: Dict[str, Any],
        wh: Dict[str, Any],
        operation: str,
        obj: Dict[str, Any],
        old: Optional[Dict[str, Any]],
    ) -> Dict[str, Any]:
        name = wh.get("name", cfg.get("metadata", {}).get("name", "webhook"))
        failure_policy = wh.get("failurePolicy", "Fail")
        timeout = wh.get("timeoutSeconds", 10)
        client_config = wh.get("clientConfig", {})
        url = client_config.get("url", "")
        if not url and client_config.get("service"):
            # service-style config resolves through cluster DNS, exactly as
            # kube-apiserver does (the deploy manifests ship this form)
            svc = client_config["service"]
            url = (
                f"https://{svc.get('name')}.{svc.get('namespace')}.svc"
                f":{svc.get('port', 443)}{svc.get('path', '/')}"
            )
        av = obj.get("apiVersion", "")
        group, _, version = av.rpartition("/")
        review = {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "uid": obj.get("metadata", {}).get("uid", ""),
                "kind": {"group": group, "version": version, "kind": obj.get("kind", "")},
                "name": obj.get("metadata", {}).get("name", ""),
                "namespace": obj.get("metadata", {}).get("namespace", ""),
                "operation": operation,
                "object": obj,
                "oldObject": old,
                "dryRun": False,
            },
        }
        try:
            faults = getattr(self.store, "faults", None)
            if faults is not None:
                # injected callout failure (timeout / refused connection)
                # BEFORE the POST: the webhook never sees the review, exactly
                # like a network-partitioned webhook service
                faults.check("webhook.call", name=name, url=url)
            ctx = self._ssl_context(client_config.get("caBundle", ""))
            body = self._post_pooled(url, json.dumps(review).encode(), ctx, timeout)
        except AdmissionDeniedError:
            raise
        except Exception as e:
            from ..runtime.metrics import webhook_dispatch_failures_total

            webhook_dispatch_failures_total.inc(policy=failure_policy)
            if failure_policy == "Ignore":
                log.warning("webhook %s unreachable (failurePolicy=Ignore): %r", name, e)
                return obj
            raise AdmissionDeniedError(
                f'failed calling webhook "{name}": {e!r}'
            ) from None
        response = body.get("response", {})
        if not response.get("allowed", False):
            message = response.get("status", {}).get("message", "denied")
            raise AdmissionDeniedError(f'admission webhook "{name}" denied the request: {message}')
        patch_b64 = response.get("patch")
        if patch_b64:
            ops = json.loads(base64.b64decode(patch_b64))
            obj = json_patch_apply(obj, ops)
        return obj
