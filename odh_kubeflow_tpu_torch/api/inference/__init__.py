from .v1beta1 import (
    API_VERSION,
    GROUP,
    KIND,
    AutoscalingSpec,
    InferenceEndpoint,
    InferenceEndpointSpec,
    InferenceEndpointStatus,
    NotebookRef,
    ServingSpec,
)
