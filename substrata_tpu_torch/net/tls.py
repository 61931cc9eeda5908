"""TLS for both planes (reference parity).

The reference TLS-wraps every game-protocol connection after accept
(server/ListenerThread.cpp: accept -> TLSSocket handshake) and serves the
website over HTTPS on 443 (server/Server.cpp:519-522, webserver TLS
config).  Here:

- ``make_server_context`` / ``make_client_context`` build ``ssl`` contexts
  for the game listener (net/server.py), the game client (net/client.py),
  and the webserver (server_side/webserver.py).
- ``generate_self_signed_cert`` creates a throwaway cert/key pair for tests
  and dev servers (the reference ships a similar dev fallback; production
  points at real cert files).

Uses the stdlib ``ssl`` module; cert generation prefers the ``cryptography``
package and falls back to the ``openssl`` CLI, so nothing here adds a hard
dependency.

A copy of ``substrata_tpu/net/tls.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
The dev certificate lives under ``tempfile.gettempdir()`` (the reference
names /tmp).  ``DuplexTLS`` is the port's: it lets one thread read a TLS
connection while others write it (the reference's read/write race).
"""

from __future__ import annotations

import datetime
import functools
import os
import select
import shutil
import socket
import ssl
import subprocess
import tempfile
import time

# Sentinel default for Server/Client ``tls_context``: "wrap with the
# auto-generated dev certificate".  The reference TLS-wraps every game
# connection unconditionally (ListenerThread.cpp), so TLS is the DEFAULT
# here and plaintext is the explicit opt-out (``tls_context=None``).
DEV_TLS = "dev"


def generate_self_signed_cert(common_name: str = "localhost",
                              out_dir: str | None = None):
    """Create (cert_path, key_path) for a throwaway self-signed cert.

    Uses an EC P-256 key: generation is instant (RSA-2048 keygen took
    ~0.5 s per test process) and the handshake is faster too."""
    out_dir = out_dir or tempfile.mkdtemp(prefix="substrata_tls_")
    cert_path = os.path.join(out_dir, "cert.pem")
    key_path = os.path.join(out_dir, "key.pem")
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID

        key = ec.generate_private_key(ec.SECP256R1())
        name = x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (x509.CertificateBuilder()
                .subject_name(name).issuer_name(name)
                .public_key(key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=5))
                .not_valid_after(now + datetime.timedelta(days=365))
                .add_extension(x509.SubjectAlternativeName(
                    [x509.DNSName(common_name),
                     x509.DNSName("localhost"),
                     x509.IPAddress(__import__("ipaddress").ip_address(
                         "127.0.0.1"))]), critical=False)
                .sign(key, hashes.SHA256()))
        with open(key_path, "wb") as f:
            f.write(key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.TraditionalOpenSSL,
                serialization.NoEncryption()))
        with open(cert_path, "wb") as f:
            f.write(cert.public_bytes(serialization.Encoding.PEM))
    except ImportError:
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
             "ec_paramgen_curve:prime256v1", "-nodes",
             "-keyout", key_path, "-out", cert_path, "-days", "365",
             "-subj", f"/CN={common_name}",
             "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
            check=True, capture_output=True)
    return cert_path, key_path


# ---------------------------------------------------------------------------
# Dev certificate: generated once, shared by every process on the machine so
# a dev server in one process and clients/bots in others verify each other.

_DEV_CERT_DIR = os.environ.get(
    "SUBSTRATA_DEV_CERT_DIR", os.path.join(tempfile.gettempdir(), "substrata_dev_cert"))


def dev_cert_paths():
    """(cert, key) of the machine-wide dev certificate, creating it on first
    use.  Creation is atomic (generate into a temp dir, rename into place)
    so concurrent processes never see a half-written pair."""
    cert = os.path.join(_DEV_CERT_DIR, "cert.pem")
    key = os.path.join(_DEV_CERT_DIR, "key.pem")
    if not (os.path.exists(cert) and os.path.exists(key)):
        tmp = tempfile.mkdtemp(prefix="substrata_dev_cert_",
                               dir=os.path.dirname(_DEV_CERT_DIR) or None)
        generate_self_signed_cert("localhost", out_dir=tmp)
        try:
            os.rename(tmp, _DEV_CERT_DIR)
        except OSError:        # another process won the race
            shutil.rmtree(tmp, ignore_errors=True)
    return cert, key


@functools.lru_cache(maxsize=None)
def dev_server_context() -> ssl.SSLContext:
    cert, key = dev_cert_paths()
    return make_server_context(cert, key)


@functools.lru_cache(maxsize=None)
def dev_client_context() -> ssl.SSLContext:
    """Client context that VERIFIES against the dev cert (its SANs cover
    localhost and 127.0.0.1, so default loopback connections get real
    certificate validation, not a verify-none shortcut)."""
    cert, _ = dev_cert_paths()
    return make_client_context(cafile=cert)


def resolve_server_context(tls_context):
    """Map a Server ``tls_context`` argument to an ssl context or None:
    DEV_TLS (the default) -> the shared dev certificate; None -> explicit
    plaintext opt-out; anything else is used as-is."""
    return dev_server_context() if tls_context is DEV_TLS else tls_context


def resolve_client_context(tls_context):
    return dev_client_context() if tls_context is DEV_TLS else tls_context


def make_server_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


def make_client_context(cafile: str | None = None,
                        insecure: bool = False) -> ssl.SSLContext:
    """Client context; ``insecure=True`` skips verification (dev servers
    with self-signed certs, like the reference client's allow-insecure
    connection option)."""
    ctx = ssl.create_default_context(cafile=cafile)
    if insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


class DuplexTLS:
    """One TLS connection read by one thread and written by others.

    OpenSSL does not allow an SSL_read and an SSL_write on one connection at
    the same time.  The reference's worker reads its TLS socket
    (``substrata_tpu/net/server.py:265-280``) while the tick thread's
    broadcasts write it (``send_message``, :244-248, whose ``send_lock``
    guards only the writes), and its client does the same
    (``net/client.py:438-460`` against ``send_message``); under load the read
    ends in ``SSLEOFError`` and the connection closes (a 12,000-object
    world stops replicating after a few hundred objects).  Here the socket
    is non-blocking and every SSL call, read or write, runs under ``lock``;
    the waits for readiness (``select``) run outside it, so a writer that
    waits for the peer never holds up the reader.  The bytes on the wire
    are unchanged."""

    def __init__(self, sock: ssl.SSLSocket, lock):
        self.sock = sock
        self.lock = lock
        with lock:
            sock.setblocking(False)

    def recv(self, n: int, timeout: float) -> bytes:
        """Up to ``n`` bytes (b"" at the end of the stream); raises
        ``socket.timeout`` when nothing arrives within ``timeout`` s."""
        deadline = time.monotonic() + timeout
        while True:
            with self.lock:
                try:
                    return self.sock.recv(n)
                except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
                    pass
            left = deadline - time.monotonic()
            if left <= 0:
                raise socket.timeout("timed out")
            select.select([self.sock], [], [], left)

    def sendall(self, data: bytes, timeout: float = 30.0):
        """All of ``data``; a write the peer has not drained within
        ``timeout`` s raises ``socket.timeout``.  A write OpenSSL could not
        finish is retried with the same bytes, as it requires."""
        view = memoryview(data)
        deadline = time.monotonic() + timeout
        while len(view):
            with self.lock:
                try:
                    sent = self.sock.send(view)
                except ssl.SSLWantWriteError:
                    sent, wait = 0, ([], [self.sock])
                except ssl.SSLWantReadError:
                    sent, wait = 0, ([self.sock], [])
            if sent:
                view = view[sent:]
                continue
            left = deadline - time.monotonic()
            if left <= 0:
                raise socket.timeout("timed out")
            select.select(wait[0], wait[1], [], min(left, 0.05))
