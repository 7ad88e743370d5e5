"""Scheme: (apiVersion, kind) <-> Python class registry.

Equivalent of runtime.Scheme that both reference managers populate in main()
(reference notebook-controller/main.go:44-56, odh main.go:70-101). The store,
clients and informers use it to decode JSON into typed objects.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

from .meta import GroupVersionKind, KubeObject


class Scheme:
    def __init__(self) -> None:
        self._by_gvk: Dict[Tuple[str, str], Type[KubeObject]] = {}
        self._by_cls: Dict[Type[KubeObject], GroupVersionKind] = {}

    def register(self, api_version: str, kind: str, cls: Type[KubeObject]) -> Type[KubeObject]:
        self._by_gvk[(api_version, kind)] = cls
        if "/" in api_version:
            g, v = api_version.split("/", 1)
        else:
            g, v = "", api_version
        # First registration wins for class->GVK so spoke versions sharing the
        # hub class (api/notebook/conversion.py) don't re-stamp the hub GVK.
        self._by_cls.setdefault(cls, GroupVersionKind(g, v, kind))
        return cls

    def class_for(self, api_version: str, kind: str) -> Optional[Type[KubeObject]]:
        return self._by_gvk.get((api_version, kind))

    def registrations(self) -> Dict[Tuple[str, str], Type[KubeObject]]:
        """All registered (apiVersion, kind) pairs — discovery's data source."""
        return dict(self._by_gvk)

    def gvk_for(self, cls: Type[KubeObject]) -> GroupVersionKind:
        for klass in cls.__mro__:
            if klass in self._by_cls:
                return self._by_cls[klass]
        raise KeyError(f"{cls.__name__} is not registered in the scheme")

    def new(self, api_version: str, kind: str) -> KubeObject:
        cls = self.class_for(api_version, kind)
        if cls is None:
            raise KeyError(f"no type registered for {api_version}/{kind}")
        obj = cls()
        obj.api_version = api_version
        obj.kind = kind
        return obj

    def decode(self, data: dict) -> KubeObject:
        av, kind = data.get("apiVersion", ""), data.get("kind", "")
        cls = self.class_for(av, kind)
        if cls is None:
            raise KeyError(f"no type registered for {av}/{kind}")
        return cls.from_dict(data)

    def fill_type_meta(self, obj: KubeObject) -> KubeObject:
        if not obj.api_version or not obj.kind:
            gvk = self.gvk_for(type(obj))
            obj.api_version = gvk.api_version
            obj.kind = gvk.kind
        return obj


# The default scheme all in-tree types register against at import time
# (mirrors clientgoscheme.AddToScheme + per-API AddToScheme calls).
default_scheme = Scheme()
