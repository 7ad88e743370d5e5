"""First-difference reporter for human-readable update-pending reasons.

Equivalent of the reference's go-cmp FirstDifferenceReporter
(odh controllers/notebook_webhook_utils.go:61-80): walk two JSON-ish values
and describe the first leaf where they diverge."""
from __future__ import annotations

from typing import Any, Optional


def first_difference(a: Any, b: Any, path: str = "") -> Optional[str]:
    """None if deep-equal, else 'path: x != y' for the first differing leaf."""
    if type(a) is not type(b):
        return f"{path or '.'}: {_short(a)} != {_short(b)}"
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b)):
            p = f"{path}.{k}" if path else k
            if k not in a:
                return f"{p}: <absent> != {_short(b[k])}"
            if k not in b:
                return f"{p}: {_short(a[k])} != <absent>"
            d = first_difference(a[k], b[k], p)
            if d:
                return d
        return None
    if isinstance(a, list):
        for i in range(max(len(a), len(b))):
            p = f"{path}[{i}]"
            if i >= len(a):
                return f"{p}: <absent> != {_short(b[i])}"
            if i >= len(b):
                return f"{p}: {_short(a[i])} != <absent>"
            d = first_difference(a[i], b[i], p)
            if d:
                return d
        return None
    if a != b:
        return f"{path or '.'}: {_short(a)} != {_short(b)}"
    return None


def _short(v: Any, limit: int = 64) -> str:
    s = repr(v)
    return s if len(s) <= limit else s[: limit - 3] + "..."
