"""Kubernetes resource-quantity parsing ("500m" CPU, "4Gi" memory), from
scratch — needed by the scheduler's capacity accounting and by the webhook's
sidecar-resource validation (reference parseAndValidateAuthSidecarResources,
odh notebook_webhook.go:126-173)."""
from __future__ import annotations

from ..apimachinery import InvalidError

_SUFFIX = {
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
}


def parse_quantity(s: object) -> float:
    """Quantity -> float (CPU cores or bytes). Accepts int/float directly."""
    if isinstance(s, (int, float)):
        return float(s)
    if not isinstance(s, str) or not s:
        raise InvalidError(f"invalid quantity {s!r}")
    text = s.strip()
    for suffix in sorted(_SUFFIX, key=len, reverse=True):
        if text.endswith(suffix):
            num = text[: -len(suffix)]
            try:
                return float(num) * _SUFFIX[suffix]
            except ValueError:
                raise InvalidError(f"invalid quantity {s!r}")
    if text.endswith("m"):  # millis (CPU)
        try:
            return float(text[:-1]) / 1000.0
        except ValueError:
            raise InvalidError(f"invalid quantity {s!r}")
    try:
        return float(text)
    except ValueError:
        raise InvalidError(f"invalid quantity {s!r}")
