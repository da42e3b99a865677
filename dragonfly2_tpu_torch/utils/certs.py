"""Port of dragonfly2_tpu/utils/certs.py, whole. ``cryptography`` is
imported behind the same gate as the reference's: loading material that
is already in place (``TLSMaterial`` and its SSL contexts) needs only the
standard library's ``ssl``; generating or signing raises without it.

Cluster PKI: CA, CSR-based issuance, and mTLS socket contexts.

Capability parity with the reference's manager-issued certificates
(pkg/issuer/ DragonflyIssuer signing CSRs, scheduler/scheduler.go:180-219
wiring optional TLS+mutual-auth into every gRPC server/client, and the
security client that sends a CSR to the manager and installs the returned
chain): the manager process holds (or generates) a cluster CA; services
generate a keypair + CSR, call the manager's IssueCertificate RPC, and
speak mTLS on the cluster edge. Everything is optional — plaintext remains
the default, exactly like the reference's `security.enable` switch.

Built on `cryptography`; imports are gated so the
rest of the framework works without it — only constructing TLS artifacts
raises when it is absent.
"""

from __future__ import annotations

import datetime
import ipaddress
import pathlib
import ssl

try:  # gated: TLS is optional, the library might not ship everywhere
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    _HAVE_CRYPTO = True
except ImportError:  # material already in place still loads (TLSMaterial)
    _HAVE_CRYPTO = False

DEFAULT_VALIDITY_DAYS = 365
_KEY_SIZE = 2048


def _require_crypto() -> None:
    if not _HAVE_CRYPTO:
        raise RuntimeError(
            "TLS support needs the 'cryptography' package; run plaintext or install it"
        )


def _new_key():
    return rsa.generate_private_key(public_exponent=65537, key_size=_KEY_SIZE)


def _key_pem(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )


def generate_ca(common_name: str = "dragonfly2-tpu-ca") -> tuple[bytes, bytes]:
    """Self-signed cluster CA -> (cert_pem, key_pem) (pkg/issuer roots)."""
    _require_crypto()
    key = _new_key()
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=10 * 365))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False,
            ),
            critical=True,
        )
        .sign(key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.PEM), _key_pem(key)


def generate_csr(common_name: str, san_hosts: list[str] | None = None) -> tuple[bytes, bytes]:
    """Keypair + CSR -> (csr_pem, key_pem). `san_hosts` mixes DNS names and
    IP literals (the reference's certify client puts the host's addrs in
    the CSR SANs)."""
    _require_crypto()
    key = _new_key()
    sans: list[x509.GeneralName] = []
    for h in san_hosts or []:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            sans.append(x509.DNSName(h))
    builder = x509.CertificateSigningRequestBuilder().subject_name(
        x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    )
    if sans:
        builder = builder.add_extension(x509.SubjectAlternativeName(sans), critical=False)
    csr = builder.sign(key, hashes.SHA256())
    return csr.public_bytes(serialization.Encoding.PEM), _key_pem(key)


def csr_identity(csr_pem: bytes) -> tuple[str, list[str]]:
    """(common name, SAN strings) a CSR asks for — the identity the CA is
    about to vouch for, surfaced so issuance can be audited."""
    _require_crypto()
    csr = x509.load_pem_x509_csr(csr_pem)
    cn_attrs = csr.subject.get_attributes_for_oid(x509.NameOID.COMMON_NAME)
    cn = cn_attrs[0].value if cn_attrs else ""
    try:
        ext = csr.extensions.get_extension_for_class(x509.SubjectAlternativeName)
        sans = [str(g.value) for g in ext.value]
    except x509.ExtensionNotFound:
        sans = []
    return str(cn), sans


def sign_csr(
    ca_cert_pem: bytes,
    ca_key_pem: bytes,
    csr_pem: bytes,
    validity_days: int = DEFAULT_VALIDITY_DAYS,
) -> bytes:
    """Manager-side issuance: sign a CSR with the cluster CA, preserving
    its SANs (pkg/issuer DragonflyIssuer.Sign)."""
    _require_crypto()
    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem)
    ca_key = serialization.load_pem_private_key(ca_key_pem, password=None)
    csr = x509.load_pem_x509_csr(csr_pem)
    if not csr.is_signature_valid:
        raise ValueError("CSR signature invalid")
    now = datetime.datetime.now(datetime.timezone.utc)
    builder = (
        x509.CertificateBuilder()
        .subject_name(csr.subject)
        .issuer_name(ca_cert.subject)
        .public_key(csr.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=validity_days))
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
        .add_extension(
            x509.ExtendedKeyUsage(
                [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH,
                 x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]
            ),
            critical=False,
        )
    )
    try:
        sans = csr.extensions.get_extension_for_class(x509.SubjectAlternativeName)
        builder = builder.add_extension(sans.value, critical=False)
    except x509.ExtensionNotFound:
        pass
    cert = builder.sign(ca_key, hashes.SHA256())
    return cert.public_bytes(serialization.Encoding.PEM)


# ------------------------------------------------------------ ssl contexts


class TLSMaterial:
    """PEM bundle (cert, key, ca) living in files, ready for SSLContexts.
    asyncio's ssl support loads from paths, so the bundle owns a dir."""

    def __init__(self, directory: str | pathlib.Path):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cert_path = self.dir / "cert.pem"
        self.key_path = self.dir / "key.pem"
        self.ca_path = self.dir / "ca.pem"

    def write(self, cert_pem: bytes, key_pem: bytes, ca_pem: bytes) -> "TLSMaterial":
        self.cert_path.write_bytes(cert_pem)
        self.key_path.write_bytes(key_pem)
        self.ca_path.write_bytes(ca_pem)
        self.key_path.chmod(0o600)
        return self

    @property
    def ready(self) -> bool:
        return self.cert_path.exists() and self.key_path.exists() and self.ca_path.exists()

    def server_context(self, require_client_cert: bool = True) -> ssl.SSLContext:
        """mTLS server side: presents the issued cert, verifies peers
        against the cluster CA (scheduler.go:189-207 mutual TLS)."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        ctx.load_verify_locations(self.ca_path)
        if require_client_cert:
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def client_context(self, server_hostname_check: bool = False) -> ssl.SSLContext:
        """mTLS client side: presents the issued cert, trusts only the
        cluster CA. Hostname checks default off — cluster members are
        addressed by pooled ip:port, identity comes from the CA."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        ctx.load_verify_locations(self.ca_path)
        ctx.check_hostname = server_hostname_check
        return ctx


def self_signed_material(
    directory: str | pathlib.Path, common_name: str, san_hosts: list[str] | None = None
) -> TLSMaterial:
    """One-process convenience: CA + leaf in one call (tests, single-node
    clusters, and the manager itself — which signs its own serving cert)."""
    ca_cert, ca_key = generate_ca()
    csr, key = generate_csr(common_name, san_hosts or ["127.0.0.1", "localhost"])
    cert = sign_csr(ca_cert, ca_key, csr)
    mat = TLSMaterial(directory)
    mat.write(cert, key, ca_cert)
    (mat.dir / "ca_key.pem").write_bytes(ca_key)
    (mat.dir / "ca_key.pem").chmod(0o600)
    return mat
