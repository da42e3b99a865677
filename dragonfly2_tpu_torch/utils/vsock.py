"""Port of dragonfly2_tpu/utils/vsock.py, whole.

AF_VSOCK transport helpers — VM-guest addressing for the cluster edge.

Capability parity with pkg/rpc/vsock.go (`VsockDialer` parsing
`vsock://<cid>:<port>` targets + `IsVsock`) and pkg/dfnet's VSOCK network
type: a guest VM reaches the host daemon over a vsock instead of TCP.
Helpers return plain sockets / asyncio streams so every existing wire
server and client can ride them — including TLS: both ends accept an
`ssl_context`, so `--tls-dir` clusters keep mutual auth on the vsock
listener too (a plaintext side door would negate the mTLS boundary).
AF_VSOCK needs kernel support, so `available()` gates tests and callers
degrade with a clear error rather than an AttributeError on platforms
without it.
"""

from __future__ import annotations

import asyncio
import socket
import urllib.parse

VSOCK_SCHEME = "vsock"

# socket.VMADDR_CID_* only exist where the platform defines AF_VSOCK
VMADDR_CID_ANY = getattr(socket, "VMADDR_CID_ANY", -1)
VMADDR_CID_LOCAL = getattr(socket, "VMADDR_CID_LOCAL", 1)

# TLS-over-vsock has no DNS name; contexts are built with
# check_hostname=False (utils/certs.py client_context), and asyncio just
# needs a non-empty server_hostname to satisfy the SSL plumbing.
_TLS_PSEUDO_HOSTNAME = "vsock"


def available() -> bool:
    return hasattr(socket, "AF_VSOCK")


def is_vsock(target: str) -> bool:
    """pkg/rpc/vsock.go IsVsock: does the target use the vsock scheme?"""
    return target.startswith(f"{VSOCK_SCHEME}://")


def parse_target(target: str) -> tuple[int, int]:
    """`vsock://<cid>:<port>` -> (cid, port) (VsockDialer's parse).

    Parsed by hand rather than urlsplit().port: AF_VSOCK ports are 32-bit,
    and urllib enforces the TCP 0-65535 range."""
    u = urllib.parse.urlsplit(target)
    if u.scheme != VSOCK_SCHEME or not u.netloc:
        raise ValueError(f"vsock target must be vsock://<cid>:<port>, got {target!r}")
    cid_s, sep, port_s = u.netloc.partition(":")
    if not sep or not cid_s.isdigit() or not port_s.isdigit():
        raise ValueError(f"vsock target must be vsock://<cid>:<port>, got {target!r}")
    return int(cid_s), int(port_s)


def listen_socket(port: int, cid: int = VMADDR_CID_ANY) -> socket.socket:
    """Bound+listening AF_VSOCK socket, ready for asyncio.start_server(sock=...)."""
    if not available():
        raise RuntimeError("AF_VSOCK is not supported on this platform")
    sock = socket.socket(socket.AF_VSOCK, socket.SOCK_STREAM)  # type: ignore[attr-defined]
    try:
        sock.bind((cid, port))
        sock.listen()
        sock.setblocking(False)
    except OSError:
        sock.close()
        raise
    return sock


async def start_server(handler, port: int, cid: int = VMADDR_CID_ANY, ssl_context=None):
    """asyncio server speaking the wire protocol over a vsock listener;
    `handler` is any `async (reader, writer)` (e.g. a ConnTracker-wrapped
    SchedulerRPCServer._serve_conn). `ssl_context` applies the same mTLS
    the TCP listener enforces."""
    return await asyncio.start_server(
        handler, sock=listen_socket(port, cid), ssl=ssl_context
    )


async def open_connection(target: str, ssl_context=None):
    """Dial a `vsock://<cid>:<port>` target -> (reader, writer)
    (VsockDialer + grpc.WithContextDialer equivalent). With `ssl_context`
    the stream is wrapped in TLS after connect, so mutual-auth clusters
    keep their boundary over vsock too."""
    cid, port = parse_target(target)
    if not available():
        raise RuntimeError("AF_VSOCK is not supported on this platform")
    sock = socket.socket(socket.AF_VSOCK, socket.SOCK_STREAM)  # type: ignore[attr-defined]
    sock.setblocking(False)
    loop = asyncio.get_running_loop()
    try:
        await loop.sock_connect(sock, (cid, port))
    except BaseException:
        # sock_connect failure (scheduler down, CancelledError) must not
        # leak one fd per retry of the pool's reconnect loop
        sock.close()
        raise
    kwargs = {}
    if ssl_context is not None:
        kwargs = {"ssl": ssl_context, "server_hostname": _TLS_PSEUDO_HOSTNAME}
    try:
        return await asyncio.open_connection(sock=sock, **kwargs)
    except BaseException:
        sock.close()
        raise
