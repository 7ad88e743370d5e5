"""JSON merge patch (RFC 7386) + helpers.

The reference uses JSON-merge-patch to atomically clear the reconciliation-lock
annotation (odh notebook_controller.go RemoveReconciliationLock: patches the
stop annotation to null); this implements the same semantics against our store.
"""
from __future__ import annotations

import copy
from typing import Any, Dict


def json_merge_patch(target: Any, patch: Any) -> Any:
    """Apply RFC 7386: dict keys merge recursively, None deletes, scalars/lists replace."""
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    if not isinstance(target, dict):
        target = {}
    result = copy.deepcopy(target)
    for k, v in patch.items():
        if v is None:
            result.pop(k, None)
        else:
            result[k] = json_merge_patch(result.get(k), v)
    return result


def annotation_patch(annotations: Dict[str, Any]) -> Dict[str, Any]:
    """Build a merge patch touching only metadata.annotations (None value deletes)."""
    return {"metadata": {"annotations": dict(annotations)}}


# ---------------------------------------------------------------------------
# RFC 6902 JSON Patch — the wire format of AdmissionReview responses
# (the reference's webhook returns admission.PatchResponseFromRaw, which
# serializes exactly this op list: odh notebook_webhook.go:493-498).
# ---------------------------------------------------------------------------


def _escape_pointer(token: str) -> str:
    return token.replace("~", "~0").replace("/", "~1")


def _unescape_pointer(token: str) -> str:
    return token.replace("~1", "/").replace("~0", "~")


def _resolve(doc: Any, pointer: str) -> tuple:
    """Walk to the parent of the pointed-at location; returns (parent, key)."""
    if pointer == "":
        raise ValueError("empty pointer has no parent")
    tokens = [_unescape_pointer(t) for t in pointer.lstrip("/").split("/")]
    parent = doc
    for t in tokens[:-1]:
        parent = parent[int(t)] if isinstance(parent, list) else parent[t]
    return parent, tokens[-1]


def json_patch_apply(doc: Any, ops: list) -> Any:
    """Apply an RFC 6902 op list; returns a new document."""
    doc = copy.deepcopy(doc)
    for op in ops:
        kind, path = op["op"], op["path"]
        if kind in ("add", "replace", "test"):
            value = copy.deepcopy(op["value"])
        if kind in ("copy", "move"):
            src_parent, src_key = _resolve(doc, op["from"])
            src_val = src_parent[int(src_key) if isinstance(src_parent, list) else src_key]
            value = copy.deepcopy(src_val)
            if kind == "move":
                if isinstance(src_parent, list):
                    src_parent.pop(int(src_key))
                else:
                    del src_parent[src_key]
        if path == "":
            if kind in ("add", "replace", "copy", "move"):
                doc = value
            elif kind == "test" and doc != value:
                raise ValueError("test op failed at root")
            continue
        parent, key = _resolve(doc, path)
        if isinstance(parent, list):
            if kind in ("add", "copy", "move"):
                idx = len(parent) if key == "-" else int(key)
                parent.insert(idx, value)
            elif kind == "replace":
                parent[int(key)] = value
            elif kind == "remove":
                parent.pop(int(key))
            elif kind == "test":
                if parent[int(key)] != value:
                    raise ValueError(f"test op failed at {path}")
        else:
            if kind in ("add", "replace", "copy", "move"):
                parent[key] = value
            elif kind == "remove":
                if key not in parent:
                    raise ValueError(f"remove: {path} not present")
                del parent[key]
            elif kind == "test":
                if parent.get(key) != value:
                    raise ValueError(f"test op failed at {path}")
    return doc


def json_patch_diff(old: Any, new: Any, path: str = "") -> list:
    """Produce an RFC 6902 op list transforming old -> new.

    Dicts diff per key; lists replace wholesale when unequal (matches how
    admission patches treat container/volume lists — positional list diffs
    are fragile across concurrent mutators)."""
    if isinstance(old, dict) and isinstance(new, dict):
        ops = []
        for k in old:
            if k not in new:
                ops.append({"op": "remove", "path": f"{path}/{_escape_pointer(k)}"})
        for k, v in new.items():
            sub = f"{path}/{_escape_pointer(k)}"
            if k not in old:
                ops.append({"op": "add", "path": sub, "value": copy.deepcopy(v)})
            elif old[k] != v:
                ops.extend(json_patch_diff(old[k], v, sub))
        return ops
    if old != new:
        return [{"op": "replace", "path": path, "value": copy.deepcopy(new)}]
    return []
