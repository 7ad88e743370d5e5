"""Typed object model <-> camelCase JSON, from scratch.

The reference expresses its API types as Go structs with `json:"...,omitempty"`
tags (e.g. reference components/notebook-controller/api/v1beta1/notebook_types.go).
This module provides the equivalent for Python dataclasses:

- snake_case field names serialize as camelCase (override with
  ``field(metadata={"json": "name"})``),
- ``None`` and empty containers are omitted (omitempty semantics),
- deserialization is driven by type hints (Optional[X], List[X], Dict[str, X],
  nested KubeModel subclasses),
- unknown JSON keys round-trip losslessly via ``_extra`` so objects written by
  newer/foreign clients are not corrupted on update.
"""
from __future__ import annotations

import copy
import dataclasses
import typing
from typing import Any, Dict, List, Optional, Type, TypeVar, get_args, get_origin

T = TypeVar("T", bound="KubeModel")

_HINTS_CACHE: Dict[type, Dict[str, Any]] = {}
_JSON_NAME_CACHE: Dict[type, Dict[str, str]] = {}
_OPTIONAL_CACHE: Dict[type, set] = {}


def snake_to_camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def _type_hints(cls: type) -> Dict[str, Any]:
    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        hints = typing.get_type_hints(cls)
        _HINTS_CACHE[cls] = hints
    return hints


def _json_names(cls: type) -> Dict[str, str]:
    """field name -> json key."""
    names = _JSON_NAME_CACHE.get(cls)
    if names is None:
        names = {}
        for f in dataclasses.fields(cls):
            names[f.name] = f.metadata.get("json", snake_to_camel(f.name))
        _JSON_NAME_CACHE[cls] = names
    return names


def _optional_fields(cls: type) -> set:
    """Fields hinted Optional[...] behave like Go pointers: only None is empty
    (so e.g. StatefulSetSpec.replicas=0 — the stop-annotation scale-down —
    serializes instead of vanishing)."""
    opt = _OPTIONAL_CACHE.get(cls)
    if opt is None:
        opt = set()
        for fname, hint in _type_hints(cls).items():
            if get_origin(hint) is typing.Union and type(None) in get_args(hint):
                opt.add(fname)
        _OPTIONAL_CACHE[cls] = opt
    return opt


def _serialize_value(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _dataclass_to_dict(v)
    if isinstance(v, list):
        return [_serialize_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _serialize_value(x) for k, x in v.items()}
    return v


def _dataclass_to_dict(obj: Any) -> Dict[str, Any]:
    """Shared serializer with Go `encoding/json` fidelity:

    - scalar/list/dict fields: omitempty (zero values dropped),
    - Optional[...] fields: Go-pointer semantics (only None dropped, so
      replicas=0 survives),
    - non-Optional nested struct fields: ALWAYS emitted, even as ``{}`` —
      Go never omits struct values (required fields like
      NetworkPolicySpec.podSelector depend on this).
    """
    cls = type(obj)
    out: Dict[str, Any] = {}
    extra = getattr(obj, "_extra", None)
    if extra:
        out.update(copy.deepcopy(extra))
    optional = _optional_fields(cls)
    json_names = _json_names(cls)
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if v is None:
            continue
        is_struct = dataclasses.is_dataclass(v) and not isinstance(v, type)
        if f.name not in optional and not is_struct and _is_empty(v):
            continue
        out[json_names[f.name]] = _serialize_value(v)
    return out


def _is_empty(v: Any) -> bool:
    """Go `json:",omitempty"` semantics: omit zero values of every kind."""
    if v is None:
        return True
    if isinstance(v, bool):
        return v is False
    if isinstance(v, (int, float)):
        return v == 0
    if isinstance(v, (list, dict, str)) and len(v) == 0:
        return True
    return False


def _unwrap_optional(hint: Any) -> Any:
    if get_origin(hint) is typing.Union:
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return hint


def _deserialize_value(hint: Any, v: Any) -> Any:
    if v is None:
        return None
    hint = _unwrap_optional(hint)
    origin = get_origin(hint)
    if origin in (list, List):
        (item_t,) = get_args(hint) or (Any,)
        return [_deserialize_value(item_t, x) for x in v]
    if origin in (dict, Dict):
        args = get_args(hint)
        val_t = args[1] if len(args) == 2 else Any
        return {k: _deserialize_value(val_t, x) for k, x in v.items()}
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        if not isinstance(v, dict):
            raise TypeError(
                f"cannot decode {hint.__name__} from {type(v).__name__} ({v!r})"
            )
        return _from_dict(hint, v)
    return v


def _from_dict(cls: type, data: Dict[str, Any]) -> Any:
    hints = _type_hints(cls)
    json_names = _json_names(cls)
    optional = _optional_fields(cls)
    kwargs: Dict[str, Any] = {}
    consumed = set()
    for fname, jname in json_names.items():
        if jname in data:
            consumed.add(jname)
            v = _deserialize_value(hints.get(fname, Any), data[jname])
            if v is None and fname not in optional:
                # explicit JSON null on a non-pointer field (kubectl emits
                # e.g. `creationTimestamp: null`, `labels: null`): fall back
                # to the field default instead of storing None
                continue
            kwargs[fname] = v
    obj = cls(**kwargs)
    extra = {k: copy.deepcopy(v) for k, v in data.items() if k not in consumed}
    if extra and isinstance(obj, KubeModel):
        obj._extra = extra
    return obj


class KubeModel:
    """Mixin for dataclass API types: camelCase/omitempty round-tripping."""

    _extra: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return _dataclass_to_dict(self)

    @classmethod
    def from_dict(cls: Type[T], data: Optional[Dict[str, Any]]) -> T:
        if data is None:
            data = {}
        return _from_dict(cls, data)

    def deepcopy(self: T) -> T:
        return copy.deepcopy(self)


def jfield(json_name: str, **kw: Any) -> Any:
    """dataclasses.field with an explicit JSON key."""
    meta = dict(kw.pop("metadata", {}) or {})
    meta["json"] = json_name
    return dataclasses.field(metadata=meta, **kw)
