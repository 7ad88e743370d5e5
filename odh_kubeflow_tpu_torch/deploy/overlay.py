"""Overlay engine: params.env substitution + strategic merge, kustomize-style.

The reference pins images with kustomize `replacements` driven by
`config/base/params.env` (reference odh config/base/kustomization.yaml:5-41)
and layers platform overlays (`overlays/kubeflow`, `overlays/openshift`,
`overlays/standalone` — notebook-controller/config/overlays/). kustomize is
not available here, so this is a small, honest reimplementation of the two
mechanisms the reference actually uses: params.env key=value substitution and
JSON-merge-style patches keyed by (kind, name).

`render_yaml` needs no YAML library: the manifests hold only dicts, lists,
strings, ints, floats, bools and None, and a small block-style emitter
writes those (a string that YAML would read as another type is quoted).
`load_yaml` reads that form back, so the lint's crd-schema-drift check can
read the committed tree where PyYAML is not installed.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Callable, Dict, List, Optional

from .manifests import base_manifests


def load_params(text: str) -> Dict[str, str]:
    """params.env parser: KEY=VALUE lines, # comments (reference
    odh config/base/params.env)."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "=" not in line:
            raise ValueError(f"params.env line without '=': {line!r}")
        k, v = line.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def merge_patch(target: Any, patch: Any) -> Any:
    """RFC 7386 JSON merge patch (what the reference's delete-patches and
    ConfigMap overlays amount to). null deletes; dicts merge; rest replaces."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k), v)
    return out


def apply_patches(
    manifests: List[Dict[str, Any]], patches: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Each patch targets (kind, metadata.name); unmatched patches error the
    build, same as kustomize."""
    out = [dict(m) for m in manifests]
    for p in patches:
        key = (p.get("kind"), p.get("metadata", {}).get("name"))
        matched = False
        for i, m in enumerate(out):
            if (m.get("kind"), m.get("metadata", {}).get("name")) == key:
                out[i] = merge_patch(m, p)
                matched = True
        if not matched:
            raise ValueError(f"overlay patch matched no manifest: {key}")
    return out


# the manager image is the port's own (Dockerfile.torch at the repo root,
# entrypoint `python -m odh_kubeflow_tpu_torch.main`), not the reference's
DEFAULT_PARAMS = {
    "odh-notebook-controller-image": "ghcr.io/odh-kubeflow-tpu/controller-torch:latest",
    "odh-kube-rbac-proxy-image": "gcr.io/kubebuilder/kube-rbac-proxy:v0.15.0",
    "namespace": "tpu-notebooks-system",
}


class Overlay:
    def __init__(
        self,
        name: str,
        params: Optional[Dict[str, str]] = None,
        patcher: Optional[Callable[[Dict[str, str]], List[Dict[str, Any]]]] = None,
        extra: Optional[Callable[[Dict[str, str]], List[Dict[str, Any]]]] = None,
    ):
        self.name = name
        self.params = params or {}
        self.patcher = patcher
        self.extra = extra

    def build(self, params: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
        p = {**DEFAULT_PARAMS, **self.params, **(params or {})}
        ns = p["namespace"]
        manifests = base_manifests(
            ns, p["odh-notebook-controller-image"], p["odh-kube-rbac-proxy-image"]
        )
        if self.extra:
            manifests = manifests + self.extra(p)
        if self.patcher:
            manifests = apply_patches(manifests, self.patcher(p))
        return manifests


def _standalone_patches(p: Dict[str, str]) -> List[Dict[str, Any]]:
    """Culling on with the reference CI cadence (60 min idle / 5 min period —
    reference integration workflow :146-155); no gateway."""
    return [
        {
            "kind": "ConfigMap",
            "metadata": {"name": "notebook-controller-culler-config"},
            "data": {"ENABLE_CULLING": "true", "CULL_IDLE_TIME": "60",
                     "IDLENESS_CHECK_PERIOD": "5"},
        }
    ]


def _gke_extra(p: Dict[str, str]) -> List[Dict[str, Any]]:
    from .manifests import gateway

    return [gateway(p["namespace"], class_name="gke-l7-regional-external-managed")]


def _gke_patches(p: Dict[str, str]) -> List[Dict[str, Any]]:
    """cert-manager injects the webhook CA (the OpenShift serving-cert
    annotation has no GKE counterpart — SURVEY §7 step 6); the manager
    runs in the default node pool, by the label the slice pool reads
    (gpu.GKE_NODEPOOL_LABEL)."""
    from ..gpu import GKE_NODEPOOL_LABEL

    ns = p["namespace"]
    return [
        {
            "kind": "MutatingWebhookConfiguration",
            "metadata": {
                "name": "tpu-notebook-mutating-webhook",
                "annotations": {
                    "cert-manager.io/inject-ca-from": f"{ns}/webhook-server-cert"
                },
            },
        },
        {
            "kind": "Deployment",
            "metadata": {"name": "tpu-notebook-controller-manager"},
            "spec": {
                "template": {
                    "spec": {
                        "nodeSelector": {GKE_NODEPOOL_LABEL: "default-pool"}
                    }
                }
            },
        },
    ]


def _dev_patches(p: Dict[str, str]) -> List[Dict[str, Any]]:
    # culler cadence only: a Deployment merge-patch would replace the
    # containers list wholesale, so dev mode never patches the manager pod
    return [
        {
            "kind": "ConfigMap",
            "metadata": {"name": "notebook-controller-culler-config"},
            "data": {"ENABLE_CULLING": "true", "CULL_IDLE_TIME": "5",
                     "IDLENESS_CHECK_PERIOD": "1"},
        },
    ]


OVERLAYS: Dict[str, Overlay] = {
    "base": Overlay("base"),
    "standalone": Overlay("standalone", patcher=_standalone_patches),
    "gke": Overlay("gke", patcher=_gke_patches, extra=_gke_extra),
    "dev": Overlay(
        "dev",
        params={"namespace": "tpu-notebooks-dev"},
        patcher=_dev_patches,
    ),
}


def build(overlay: str = "base", params: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
    if overlay not in OVERLAYS:
        raise ValueError(f"unknown overlay {overlay!r}; have {sorted(OVERLAYS)}")
    return OVERLAYS[overlay].build(params)


def render_yaml(manifests: List[Dict[str, Any]]) -> str:
    """The manifests as a stream of YAML documents, each after a `---`
    line, in block style with the keys in their dicts' order."""
    out: List[str] = []
    for m in manifests:
        out.append("---")
        out.extend(_block(m, 0))
    return "\n".join(out) + "\n"


# a string YAML reads back as a string when written plain: starts with a
# letter, `_` or `/`, holds no character with a meaning in YAML, and is
# none of the YAML 1.1 words for a bool or null
_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*")
_WORDS = {"y", "n", "yes", "no", "true", "false", "on", "off", "null", "nan", "inf"}


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        # YAML 1.1 reads an exponent without a dot (1e-06) as a string
        if "." not in text:
            mantissa, _, exponent = text.partition("e")
            text = f"{mantissa}.0" + (f"e{exponent}" if exponent else "")
        return text
    if isinstance(v, str):
        if _PLAIN.fullmatch(v) and v.lower() not in _WORDS:
            return v
        return json.dumps(v)  # a JSON string is a YAML double-quoted scalar
    raise TypeError(f"render_yaml: no YAML form for {type(v).__name__}")


def _block(v: Any, indent: int) -> List[str]:
    """The lines of a non-empty dict or list at `indent` spaces (a list's
    items at its key's indent, as PyYAML writes them)."""
    pad = " " * indent
    lines: List[str] = []
    if isinstance(v, dict):
        for k, item in v.items():
            key = f"{pad}{_scalar(str(k))}:"
            if isinstance(item, dict) and item:
                lines.append(key)
                lines.extend(_block(item, indent + 2))
            elif isinstance(item, list) and item:
                lines.append(key)
                lines.extend(_block(item, indent))
            else:
                lines.append(f"{key} {_inline(item)}")
        return lines
    for item in v:
        if isinstance(item, dict) and item:
            sub = _block(item, indent + 2)
            lines.append(f"{pad}- {sub[0][indent + 2:]}")
            lines.extend(sub[1:])
        elif isinstance(item, list) and item:
            lines.append(f"{pad}-")
            lines.extend(_block(item, indent + 2))
        else:
            lines.append(f"{pad}- {_inline(item)}")
    return lines


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar(v)


def load_yaml(text: str) -> List[Any]:
    """The documents of a stream in the form `render_yaml` writes (block
    style, two-space indents, a list's items at its key's indent, scalars
    plain or JSON-quoted), as YAML reads them. Raises ValueError on a line
    outside that form."""
    docs: List[Any] = []
    lines: List[str] = []
    for line in text.splitlines() + ["---"]:
        if line.rstrip() == "---":
            if lines:
                value, end = _load_block(lines, 0, 0)
                if end != len(lines):
                    raise ValueError(f"load_yaml: unexpected line {lines[end]!r}")
                docs.append(value)
            lines = []
        elif line.strip() and not line.lstrip().startswith("#"):
            lines.append(line.rstrip())
    return docs


def _indent_of(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _is_item(line: str, indent: int) -> bool:
    return _indent_of(line) == indent and (line[indent:] == "-" or line[indent:].startswith("- "))


def _split_key(text: str) -> Optional[tuple]:
    """(key, rest) of a `key: value` or `key:` text, None for a scalar."""
    if text.startswith('"'):
        key, end = json.JSONDecoder().raw_decode(text)
        rest = text[end:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if text.endswith(":") and ": " not in text:
        return text[:-1], ""
    if ": " in text:
        key, rest = text.split(": ", 1)
        return key, rest.strip()
    return None


def _load_scalar(text: str) -> Any:
    if text.startswith('"'):
        return json.loads(text)
    if text == "{}":
        return {}
    if text == "[]":
        return []
    named = {"null": None, "~": None, "true": True, "false": False,
             ".nan": math.nan, ".inf": math.inf, "-.inf": -math.inf}
    if text in named:
        return named[text]
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def _load_block(lines: List[str], i: int, indent: int) -> tuple:
    """(value, next line) of the dict or list whose lines start at
    `lines[i]`, at `indent` spaces."""
    if _is_item(lines[i], indent):
        out_list: List[Any] = []
        while i < len(lines) and _is_item(lines[i], indent):
            rest = lines[i][indent + 1:].strip()
            if not rest:
                value, i = _load_block(lines, i + 1, indent + 2)
            elif _split_key(rest) is not None:
                # `- key: value` opens a dict whose keys sit at indent + 2
                lines[i] = " " * (indent + 2) + rest
                value, i = _load_block(lines, i, indent + 2)
            else:
                value, i = _load_scalar(rest), i + 1
            out_list.append(value)
        return out_list, i
    out: Dict[str, Any] = {}
    while i < len(lines) and _indent_of(lines[i]) == indent and not _is_item(lines[i], indent):
        split = _split_key(lines[i][indent:])
        if split is None:
            raise ValueError(f"load_yaml: expected a key at line {lines[i]!r}")
        key, rest = split
        i += 1
        if rest:
            out[key] = _load_scalar(rest)
        elif i < len(lines) and _is_item(lines[i], indent):
            out[key], i = _load_block(lines, i, indent)
        elif i < len(lines) and _indent_of(lines[i]) > indent:
            out[key], i = _load_block(lines, i, _indent_of(lines[i]))
        else:
            out[key] = None
    return out, i
