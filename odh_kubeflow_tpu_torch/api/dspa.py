"""DataSciencePipelinesApplication — the pipeline server CR the Elyra
runtime config is derived from.

Minimal model of the fields the reference consumes
(odh controllers/notebook_dspa_secret.go:189-273: spec.objectStorage.
externalStorage {host, scheme, bucket, s3CredentialsSecret{secretName,
accessKey, secretKey}} plus the CR's existence/name for endpoints and
ownership).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..apimachinery import KubeModel, KubeObject, default_scheme

DSPA_API_VERSION = "datasciencepipelinesapplications.opendatahub.io/v1"
DSPA_NAME = "dspa"  # the reference hard-codes this instance name


@dataclass
class S3CredentialsSecret(KubeModel):
    secret_name: str = ""
    access_key: str = ""  # key inside the secret holding the access key id
    secret_key: str = ""  # key inside the secret holding the secret key


@dataclass
class ExternalStorage(KubeModel):
    host: str = ""
    scheme: str = "https"
    bucket: str = ""
    region: str = ""
    s3_credentials_secret: Optional[S3CredentialsSecret] = None


@dataclass
class ObjectStorage(KubeModel):
    external_storage: Optional[ExternalStorage] = None


@dataclass
class DSPASpec(KubeModel):
    object_storage: Optional[ObjectStorage] = None
    dsp_version: str = ""


@dataclass
class DataSciencePipelinesApplication(KubeObject):
    spec: DSPASpec = field(default_factory=DSPASpec)
    status: Dict[str, Any] = field(default_factory=dict)


default_scheme.register(
    DSPA_API_VERSION, "DataSciencePipelinesApplication", DataSciencePipelinesApplication
)
