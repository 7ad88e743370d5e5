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
