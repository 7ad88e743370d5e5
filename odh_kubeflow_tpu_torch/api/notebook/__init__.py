from .v1beta1 import (
    API_VERSION,
    GROUP,
    KIND,
    Notebook,
    NotebookSpec,
    NotebookStatus,
    NotebookTemplateSpec,
    TPUSpec,
    TPUStatus,
)
from .conversion import SERVED_VERSIONS, convert_from_hub, convert_to_hub
