from .v1beta1 import (
    API_VERSION,
    GROUP,
    KIND,
    LAYOUT_ANAKIN,
    LAYOUT_SEBULBA,
    TPUJob,
    TPUJobSpec,
    TPUJobStatus,
)

__all__ = [
    "API_VERSION",
    "GROUP",
    "KIND",
    "LAYOUT_ANAKIN",
    "LAYOUT_SEBULBA",
    "TPUJob",
    "TPUJobSpec",
    "TPUJobStatus",
]
