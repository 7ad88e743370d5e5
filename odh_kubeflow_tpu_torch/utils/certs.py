"""Self-signed TLS material for the API server and webhook server.

The reference gets certs from OpenShift's serving-cert operator in prod and
self-signs with openssl in CI (reference
odh_notebook_controller_integration_test.yaml:193-201); envtest generates a
local CA + serving certs for the webhook (odh controllers/suite_test.go:120-124).
This is the same capability as a library: a throwaway CA plus a server cert
with SANs, written to a directory as tls.crt / tls.key / ca.crt (the standard
kubernetes.io/tls Secret layout a cert-dir consumer expects).

The port's copy of odh_kubeflow_tpu/utils/certs.py. `cryptography` is
imported inside `generate_cert_dir` only: a machine without it imports
every module of the port and lacks only this function.
"""
from __future__ import annotations

import datetime
import ipaddress
import os
from typing import Iterable, Optional, Tuple


def generate_cert_dir(
    cert_dir: str,
    common_name: str = "localhost",
    dns_names: Iterable[str] = ("localhost",),
    ip_addresses: Iterable[str] = ("127.0.0.1",),
    days: int = 365,
) -> Tuple[str, str, str]:
    """Create ca.crt, tls.crt, tls.key under cert_dir; returns their paths."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    os.makedirs(cert_dir, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    not_after = now + datetime.timedelta(days=days)

    ca_key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "tpu-notebook-ca")])
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .sign(ca_key, hashes.SHA256())
    )

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    sans = [x509.DNSName(d) for d in dns_names] + [
        x509.IPAddress(ipaddress.ip_address(ip)) for ip in ip_addresses
    ]
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)]))
        .issuer_name(ca_name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(not_after)
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(ca_key, hashes.SHA256())
    )

    ca_path = os.path.join(cert_dir, "ca.crt")
    crt_path = os.path.join(cert_dir, "tls.crt")
    key_path = os.path.join(cert_dir, "tls.key")
    with open(ca_path, "wb") as f:
        f.write(ca_cert.public_bytes(serialization.Encoding.PEM))
    with open(crt_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_path, "wb") as f:
        f.write(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.TraditionalOpenSSL,
                serialization.NoEncryption(),
            )
        )
    return ca_path, crt_path, key_path
