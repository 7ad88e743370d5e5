"""Mutating admission webhook for Notebooks (the port's copy of
odh_kubeflow_tpu/controllers/webhook.py, validating `spec.tpu` through the
port's H100 slice planner, `gpu.plan_slice`).

TPU-native re-design of the reference's NotebookWebhook (reference
odh-notebook-controller/controllers/notebook_webhook.go): runs in the store's
admission chain (failurePolicy=Fail) on CREATE/UPDATE of every served Notebook
version. Responsibilities, in handler order (mirroring Handle :352-499):

- CREATE: inject the reconciliation lock (`kubeflow-resource-stopped` =
  "odh-notebook-controller-lock") so the StatefulSet starts at replicas 0
  until the extension controller finishes satellite setup (:105-114),
- validate `spec.tpu` (fail-closed: a slice `gpu.plan_slice` cannot plan
  never reaches etcd — the accelerator-native replacement for image-stream
  validation),
- resolve the image from the workbench image catalog ConfigMap when the
  `last-image-selection` annotation is present (ImageStream analog :787-894),
- mount the CA bundle ConfigMap when present (:618-781),
- mount/unmount the Feast client config by label (:432-444),
- inject the auth proxy sidecar when `inject-auth` is set, with
  annotation-tunable, validated resources (:177-326, :126-173),
- inject cluster egress-proxy env when enabled (:566-615),
- update-blocking: if only webhook-caused podspec drift would restart a
  running notebook, revert the podspec and set `update-pending` (:505-564).
"""
from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, Optional

from ..api.core import (
    ConfigMap,
    Container,
    ContainerPort,
    EnvVar,
    ResourceRequirements,
    Volume,
    VolumeMount,
)
from ..api.notebook import Notebook
from ..apimachinery import AdmissionDeniedError, InvalidError, NotFoundError, default_scheme
from ..cluster.client import Client
from ..cluster.store import AdmissionRequest, Store
from ..gpu import plan_slice
from ..utils import parse_quantity
from ..utils.diff import first_difference
from ..utils import tracing
from ..utils.tracing import webhook_tracer
from . import constants as C
from .config import Config

log = logging.getLogger(__name__)

CA_BUNDLE_CONFIGMAP = "workbench-trusted-ca-bundle"
CA_BUNDLE_MOUNT_PATH = "/etc/pki/tls/custom-certs"
CA_BUNDLE_VOLUME = "trusted-ca"
IMAGE_CATALOG_CONFIGMAP = "notebook-images"
PROXY_CONFIGMAP = "cluster-proxy-config"
AUTH_PROXY_CONTAINER = "kube-rbac-proxy"
AUTH_PROXY_PORT = 8443
# Distinctive prefixed name (reference notebook_feast_config.go:27) so
# unmount can never collide with a user-defined volume.
FEAST_VOLUME = "odh-feast-config"
FEAST_MOUNT_PATH = "/opt/app-root/src/feast-config"
# pipeline-runtimes catalog mount (reference notebook_runtime.go:216-285)
RUNTIME_IMAGES_VOLUME = "pipeline-runtime-images"
RUNTIME_IMAGES_MOUNT_PATH = "/opt/app-root/pipeline-runtimes/"
# Elyra runtime config mount (reference notebook_dspa_secret.go:375-449)
ELYRA_VOLUME = "elyra-dsp-details"
ELYRA_MOUNT_PATH = "/opt/app-root/runtimes"


class NotebookWebhook:
    def __init__(self, client: Client, config: Optional[Config] = None):
        self.client = client
        self.config = config or Config()

    def register(self, store: Store) -> None:
        store.register_webhook(
            "notebook-mutator",
            "kubeflow.org/v1beta1",
            "Notebook",
            ["CREATE", "UPDATE"],
            self.handle,
        )

    # ---------- entrypoint ----------

    def handle(self, req: AdmissionRequest) -> Dict[str, Any]:
        nb = default_scheme.decode({**req.object, "kind": "Notebook"})
        assert isinstance(nb, Notebook)
        # readiness trace root: CREATE opens `notebook.ready` (closed by the
        # probe-status gate at first mesh-ready) and stamps its traceparent
        # on the CR — every later actor joins this trace via the annotation
        root = None
        if (
            req.operation == "CREATE"
            and C.TRACEPARENT_ANNOTATION not in nb.metadata.annotations
        ):
            root = tracing.begin_root(
                "notebook.ready",
                key=nb.key(),  # re-admission of a retried CREATE replaces
                # the stale root the failed attempt stranded
                notebook=nb.metadata.name,
                namespace=nb.metadata.namespace,
            )
            if root is not None:
                nb.metadata.annotations[C.TRACEPARENT_ANNOTATION] = root.traceparent
        traceparent = nb.metadata.annotations.get(C.TRACEPARENT_ANNOTATION)
        try:
            return self._handle_traced(req, nb, traceparent)
        except Exception:
            # denied CREATE: the notebook never existed — drop its open root
            if root is not None:
                tracing.discard_root(root.trace_id)
            raise

    def _handle_traced(
        self, req: AdmissionRequest, nb: Notebook, traceparent: Optional[str]
    ) -> Dict[str, Any]:
        with webhook_tracer.start_span(
            "webhook.mutate",
            traceparent=traceparent,
            notebook=nb.metadata.name,
            namespace=nb.metadata.namespace,
            operation=req.operation,
        ) as span:
            user_podspec = copy.deepcopy(nb.spec.template.spec.to_dict())

            if req.operation == "CREATE":
                self.validate_name(nb)
                self.inject_reconciliation_lock(nb)

            self.validate_tpu(nb, span)
            self.set_container_image_from_catalog(nb, span)
            self.check_and_mount_ca_bundle(nb)
            self.sync_and_mount_runtime_images(nb)
            if self.config.set_pipeline_secret:
                self.sync_and_mount_elyra_config(nb)
            if nb.metadata.labels.get(C.FEAST_LABEL) == "true":
                self.mount_feast_config(nb)
            else:
                self.unmount_feast_config(nb)
            if nb.metadata.annotations.get(C.INJECT_AUTH_ANNOTATION) == "true":
                self.inject_auth_proxy(nb)
            else:
                self.remove_auth_proxy(nb)
            if self.config.inject_cluster_proxy_env:
                self.inject_proxy_env(nb)

            if req.operation == "UPDATE" and req.old_object is not None:
                self.maybe_block_restart(nb, user_podspec, req.old_object, span)

            return nb.to_dict()

    # ---------- mutations ----------

    @staticmethod
    def _remove_volume_and_mounts(podspec, name: str) -> None:
        podspec.volumes = [v for v in podspec.volumes if v.name != name]
        for container in podspec.containers:
            container.volume_mounts = [
                m for m in container.volume_mounts if m.name != name
            ]

    def _strip_legacy_feast_volume(self, nb: Notebook) -> Optional[dict]:
        """Migrate specs admitted under the pre-rename volume name
        'feast-config' — but only when the volume is identifiably ours
        (backed by the `{name}-feast-config` ConfigMap), so a user volume
        that happens to share the generic name is never touched. Returns the
        legacy volume's configMap source so the re-mount can preserve its
        optionality for workloads that relied on it."""
        podspec = nb.spec.template.spec
        legacy = podspec.volume("feast-config")
        if legacy is None or (legacy.config_map or {}).get("name") != (
            f"{nb.metadata.name}-feast-config"
        ):
            return None
        self._remove_volume_and_mounts(podspec, "feast-config")
        return legacy.config_map

    def mount_feast_config(self, nb: Notebook) -> None:
        """Label `opendatahub.io/feast-integration=true` mounts the
        `{name}-feast-config` ConfigMap at the Feast client path in the
        primary container (reference notebook_feast_config.go:53-117)."""
        legacy_source = self._strip_legacy_feast_volume(nb)
        container = self._primary_container(nb)
        if container is None:
            return
        podspec = nb.spec.template.spec
        if podspec.volume(FEAST_VOLUME) is None:
            # required, like the reference: a missing ConfigMap should hold
            # the pod at ContainerCreating, not start without it. Migrated
            # legacy volumes keep their source verbatim (incl. optional:true)
            # so previously-working pods are never retroactively wedged.
            source = legacy_source or {"name": f"{nb.metadata.name}-feast-config"}
            podspec.volumes.append(Volume(name=FEAST_VOLUME, config_map=source))
        if not any(m.name == FEAST_VOLUME for m in container.volume_mounts):
            container.volume_mounts.append(
                VolumeMount(
                    name=FEAST_VOLUME, mount_path=FEAST_MOUNT_PATH, read_only=True
                )
            )

    def unmount_feast_config(self, nb: Notebook) -> None:
        """Label removed ⇒ volume + mounts go away (reference :120-146)."""
        self._strip_legacy_feast_volume(nb)
        self._remove_volume_and_mounts(nb.spec.template.spec, FEAST_VOLUME)

    def _mount_into_all_containers(
        self, nb: Notebook, volume: Volume, mount_path: str
    ) -> None:
        """Idempotently add a volume + a mount in EVERY container (both
        pipeline mounts apply to all containers in the reference:
        notebook_runtime.go:216-285, notebook_dspa_secret.go:375-449)."""
        podspec = nb.spec.template.spec
        if podspec.volume(volume.name) is None:
            podspec.volumes.append(volume)
        for container in podspec.containers:
            if not any(m.name == volume.name for m in container.volume_mounts):
                container.volume_mounts.append(
                    VolumeMount(name=volume.name, mount_path=mount_path, read_only=True)
                )

    def sync_and_mount_runtime_images(self, nb: Notebook) -> None:
        """Sync the per-namespace `pipeline-runtime-images` catalog, then
        mount it at the pipeline-runtimes path in all containers (reference
        notebook_webhook.go:400-410 + notebook_runtime.go:216-285). Syncing
        at admission means the FIRST pod already sees its runtimes — no
        blocked-update cycle later."""
        from .extension import RUNTIME_IMAGES_CONFIGMAP, sync_runtime_images

        try:
            have_catalog = sync_runtime_images(
                self.client, self.config, nb.metadata.namespace
            )
        except Exception as e:  # sync problems must not reject the write
            log.warning("runtime-images sync failed for %s: %r", nb.key(), e)
            have_catalog = nb.spec.template.spec.volume(RUNTIME_IMAGES_VOLUME) is not None
        if not have_catalog:
            self._remove_volume_and_mounts(
                nb.spec.template.spec, RUNTIME_IMAGES_VOLUME
            )
            return
        self._mount_into_all_containers(
            nb,
            Volume(
                name=RUNTIME_IMAGES_VOLUME,
                config_map={"name": RUNTIME_IMAGES_CONFIGMAP},
            ),
            RUNTIME_IMAGES_MOUNT_PATH,
        )

    def sync_and_mount_elyra_config(self, nb: Notebook) -> None:
        """Sync the `ds-pipeline-config` Secret (DSPA-derived Elyra runtime
        config), then mount it at /opt/app-root/runtimes in all containers
        (reference notebook_webhook.go:413-429 + notebook_dspa_secret.go
        :375-449)."""
        from .extension import ELYRA_SECRET_NAME, sync_elyra_secret

        try:
            have_secret = sync_elyra_secret(
                self.client, self.config, nb.metadata.namespace
            )
        except Exception as e:
            log.warning("elyra-config sync failed for %s: %r", nb.key(), e)
            have_secret = nb.spec.template.spec.volume(ELYRA_VOLUME) is not None
        if not have_secret:
            self._remove_volume_and_mounts(nb.spec.template.spec, ELYRA_VOLUME)
            return
        self._mount_into_all_containers(
            nb,
            Volume(name=ELYRA_VOLUME, secret={"secretName": ELYRA_SECRET_NAME}),
            ELYRA_MOUNT_PATH,
        )

    def inject_reconciliation_lock(self, nb: Notebook) -> None:
        """The webhook<->extension-controller handshake: replicas stay 0 until
        the extension controller removes this annotation (SURVEY §1 coupling)."""
        nb.metadata.annotations.setdefault(
            C.STOP_ANNOTATION, C.RECONCILIATION_LOCK_VALUE
        )

    def validate_name(self, nb: Notebook) -> None:
        """Names longer than a DNS label cannot materialize: the ClusterIP
        Service shares the notebook's name (reference generateService
        :525-552 — same constraint there) and pod DNS addressing rides it.
        Fail at admission with a clear message instead of letting the
        reconciler crash-loop on Service creation."""
        if len(nb.metadata.name) > 63:
            raise AdmissionDeniedError(
                f"metadata.name {nb.metadata.name!r} is {len(nb.metadata.name)} "
                "chars; notebook names must be <= 63 (DNS label: the Service "
                "and per-pod DNS share the name)"
            )

    def validate_tpu(self, nb: Notebook, span) -> None:
        """`spec.tpu` planned by `gpu.plan_slice`: a slice it cannot plan is
        denied. The accepted `runtime` values are the JAX package's, so a
        CR is denied here exactly when the JAX operator denies it; the
        port's pod env (`gpu/env.py`) renders torchrun's contract for
        either value."""
        if nb.spec.tpu is None or not nb.spec.tpu.accelerator:
            return
        try:
            shape = plan_slice(
                nb.spec.tpu.accelerator, nb.spec.tpu.topology, nb.spec.tpu.chips
            )
        except InvalidError as e:
            span.add_event("tpu-spec-rejected", error=str(e))
            raise AdmissionDeniedError(f"spec.tpu invalid: {e}") from e
        runtime = nb.spec.tpu.runtime
        if runtime and runtime not in ("jax", "pytorch-xla"):
            raise AdmissionDeniedError(
                f"spec.tpu.runtime {runtime!r} not supported (jax | pytorch-xla)"
            )
        span.set_attribute("tpu.accelerator_type", shape.accelerator_type)
        span.set_attribute("tpu.hosts", shape.hosts)

    def _primary_container(self, nb: Notebook) -> Optional[Container]:
        podspec = nb.spec.template.spec
        for c in podspec.containers:
            if c.name == nb.metadata.name:
                return c
        return podspec.containers[0] if podspec.containers else None

    def set_container_image_from_catalog(self, nb: Notebook, span) -> None:
        """Workbench image catalog: `last-image-selection: name:tag` resolves
        through the `notebook-images` ConfigMap (data: "name:tag" -> image
        ref) in the image namespace (annotation) or controller namespace —
        the ImageStream-lookup analog (reference :787-894)."""
        selection = nb.metadata.annotations.get(C.IMAGE_SELECTION_ANNOTATION, "")
        if not selection or ":" not in selection:
            return
        ns = (
            nb.metadata.annotations.get(C.IMAGE_NAMESPACE_ANNOTATION)
            or self.config.controller_namespace
        )
        try:
            catalog = self.client.get(ConfigMap, ns, IMAGE_CATALOG_CONFIGMAP)
        except NotFoundError:
            span.add_event("imagecatalog-miss", namespace=ns)
            return
        image = catalog.data.get(selection)
        if not image:
            span.add_event("imagecatalog-selection-missing", selection=selection)
            return
        container = self._primary_container(nb)
        if container is not None and container.image != image:
            container.image = image

    def check_and_mount_ca_bundle(self, nb: Notebook) -> None:
        """Mount `workbench-trusted-ca-bundle` (assembled by the extension
        controller) into every container, with the usual TLS env contract."""
        try:
            cm = self.client.get(
                ConfigMap, nb.metadata.namespace, CA_BUNDLE_CONFIGMAP
            )
        except NotFoundError:
            return
        if "ca-bundle.crt" not in cm.data:
            return
        podspec = nb.spec.template.spec
        if podspec.volume(CA_BUNDLE_VOLUME) is None:
            podspec.volumes.append(
                Volume(
                    name=CA_BUNDLE_VOLUME,
                    config_map={
                        "name": CA_BUNDLE_CONFIGMAP,
                        "optional": True,
                        "items": [
                            {"key": "ca-bundle.crt", "path": "ca-bundle.crt"}
                        ],
                    },
                )
            )
        bundle_path = f"{CA_BUNDLE_MOUNT_PATH}/ca-bundle.crt"
        for container in podspec.containers:
            if container.name == AUTH_PROXY_CONTAINER:
                continue
            if not any(m.name == CA_BUNDLE_VOLUME for m in container.volume_mounts):
                container.volume_mounts.append(
                    VolumeMount(name=CA_BUNDLE_VOLUME, mount_path=CA_BUNDLE_MOUNT_PATH)
                )
            for env_name in ("PIP_CERT", "REQUESTS_CA_BUNDLE", "SSL_CERT_FILE",
                             "PIPELINES_SSL_SA_CERTS", "GIT_SSL_CAINFO"):
                if not container.get_env(env_name):
                    container.set_env(env_name, bundle_path)

    def parse_auth_sidecar_resources(self, nb: Notebook) -> ResourceRequirements:
        """Annotation-tunable sidecar resources with validation (reference
        parseAndValidateAuthSidecarResources :126-173); invalid -> deny."""
        defaults = {
            C.AUTH_SIDECAR_CPU_REQUEST_ANNOTATION: "100m",
            C.AUTH_SIDECAR_MEMORY_REQUEST_ANNOTATION: "64Mi",
            C.AUTH_SIDECAR_CPU_LIMIT_ANNOTATION: "100m",
            C.AUTH_SIDECAR_MEMORY_LIMIT_ANNOTATION: "64Mi",
        }
        values: Dict[str, str] = {}
        for ann, default in defaults.items():
            raw = nb.metadata.annotations.get(ann, default)
            try:
                parse_quantity(raw)
            except InvalidError:
                raise AdmissionDeniedError(
                    f"invalid resource quantity {raw!r} in annotation {ann}"
                )
            values[ann] = raw
        return ResourceRequirements(
            requests={
                "cpu": values[C.AUTH_SIDECAR_CPU_REQUEST_ANNOTATION],
                "memory": values[C.AUTH_SIDECAR_MEMORY_REQUEST_ANNOTATION],
            },
            limits={
                "cpu": values[C.AUTH_SIDECAR_CPU_LIMIT_ANNOTATION],
                "memory": values[C.AUTH_SIDECAR_MEMORY_LIMIT_ANNOTATION],
            },
        )

    def inject_auth_proxy(self, nb: Notebook) -> None:
        """kube-rbac-proxy-style sidecar: fronts the notebook on :8443, doing
        a SubjectAccessReview against `get notebooks/{name}` (reference
        InjectKubeRbacProxy :177-326; config objects come from the extension
        controller)."""
        resources = self.parse_auth_sidecar_resources(nb)
        podspec = nb.spec.template.spec
        sidecar = podspec.container(AUTH_PROXY_CONTAINER)
        desired = Container(
            name=AUTH_PROXY_CONTAINER,
            image=self.config.auth_proxy_image,
            args=[
                f"--secure-listen-address=0.0.0.0:{AUTH_PROXY_PORT}",
                f"--upstream=http://127.0.0.1:{C.NOTEBOOK_PORT}/",
                "--config-file=/etc/kube-rbac-proxy/config-file.yaml",
                "--tls-cert-file=/etc/tls/private/tls.crt",
                "--tls-private-key-file=/etc/tls/private/tls.key",
                "--v=2",
            ],
            ports=[ContainerPort(name="https", container_port=AUTH_PROXY_PORT, protocol="TCP")],
            resources=resources,
            volume_mounts=[
                VolumeMount(name="kube-rbac-proxy-config", mount_path="/etc/kube-rbac-proxy"),
                VolumeMount(name="kube-rbac-proxy-tls", mount_path="/etc/tls/private"),
            ],
        )
        if sidecar is None:
            podspec.containers.append(desired)
        else:
            sidecar.image = desired.image
            sidecar.args = desired.args
            sidecar.resources = desired.resources
            sidecar.ports = desired.ports
            sidecar.volume_mounts = desired.volume_mounts
        for vol_name, source in (
            (
                "kube-rbac-proxy-config",
                {"config_map": {"name": f"{nb.metadata.name}-kube-rbac-proxy-config"}},
            ),
            (
                "kube-rbac-proxy-tls",
                {"secret": {"secretName": f"{nb.metadata.name}-tls"}},
            ),
        ):
            if podspec.volume(vol_name) is None:
                podspec.volumes.append(Volume(name=vol_name, **source))

    def remove_auth_proxy(self, nb: Notebook) -> None:
        podspec = nb.spec.template.spec
        podspec.containers = [
            c for c in podspec.containers if c.name != AUTH_PROXY_CONTAINER
        ]
        podspec.volumes = [
            v
            for v in podspec.volumes
            if v.name not in ("kube-rbac-proxy-config", "kube-rbac-proxy-tls")
        ]

    def inject_proxy_env(self, nb: Notebook) -> None:
        """Cluster egress proxy env from the `cluster-proxy-config` ConfigMap
        (the cluster Proxy CR analog, reference :566-615)."""
        try:
            cm = self.client.get(
                ConfigMap, self.config.controller_namespace, PROXY_CONFIGMAP
            )
        except NotFoundError:
            return
        mapping = {
            "HTTP_PROXY": cm.data.get("httpProxy", ""),
            "HTTPS_PROXY": cm.data.get("httpsProxy", ""),
            "NO_PROXY": cm.data.get("noProxy", ""),
        }
        for container in nb.spec.template.spec.containers:
            if container.name == AUTH_PROXY_CONTAINER:
                continue
            for name, value in mapping.items():
                # user wins if EITHER case is set: set_env matches the
                # existing var, so writing one case would clobber the other
                if value and not container.get_env(name) and not container.get_env(
                    name.lower()
                ):
                    container.set_env(name, value)
                    container.set_env(name.lower(), value)

    # ---------- update blocking ----------

    def maybe_block_restart(
        self,
        nb: Notebook,
        user_podspec: Dict[str, Any],
        old_object: Dict[str, Any],
        span,
    ) -> None:
        """Don't restart a RUNNING notebook for webhook-only drift: an 8-host
        training slice must not bounce because a sidecar image was rebumped
        (reference maybeRestartRunningNotebook :505-564; SURVEY §7 hard
        part (b))."""
        with webhook_tracer.start_span(
            "notebook-webhook.maybe-restart", notebook=nb.metadata.name
        ) as inner:
            old_nb = default_scheme.decode({**old_object, "kind": "Notebook"})
            old_annotations = old_nb.metadata.annotations
            # stopped or being restarted: updates apply freely
            if C.STOP_ANNOTATION in old_annotations:
                self._clear_update_pending(nb)
                return
            if old_annotations.get(C.NOTEBOOK_RESTART_ANNOTATION) == "true":
                self._clear_update_pending(nb)
                return

            old_podspec = old_nb.spec.template.spec.to_dict()
            mutated_podspec = nb.spec.template.spec.to_dict()

            if first_difference(old_podspec, user_podspec) is not None:
                # the USER changed the podspec: they asked for the restart
                self._clear_update_pending(nb)
                return
            reason = first_difference(old_podspec, mutated_podspec)
            if reason is None:
                self._clear_update_pending(nb)
                return
            # webhook-only drift: revert and mark pending
            from ..api.core import PodSpec

            nb.spec.template.spec = PodSpec.from_dict(old_podspec)
            nb.metadata.annotations[C.UPDATE_PENDING_ANNOTATION] = reason
            inner.set_attribute("update.pending", reason)

    def _clear_update_pending(self, nb: Notebook) -> None:
        nb.metadata.annotations.pop(C.UPDATE_PENDING_ANNOTATION, None)
