"""HTTP forward proxy with per-rule P2P hijack.

Capability parity with client/daemon/proxy (proxy.go:62-187 request path,
proxy_manager.go rules/white-list/basic-auth, registry-mirror reverse
proxy): an asyncio HTTP proxy; absolute-URI GETs matching a hijack rule
are served from the P2P mesh via the daemon, others are fetched direct;
CONNECT is tunneled byte-for-byte (the SNI/mitm path in the reference —
hijacking TLS requires cert minting, which stays out of scope, matching
proxy.go's default non-mitm behavior). A registry-mirror base URL turns
relative requests into reverse-proxied image-layer fetches.

Port of dragonfly2_tpu/client/proxy.py, whole: the forward proxy with
its registry mirror, the ClientHello SNI parse and the SNI passthrough
(which refuses every host unless an allowlist or resolver is given).
"""

from __future__ import annotations

import asyncio
import base64
import logging

from dragonfly2_tpu_torch.client.transport import P2PTransport, ProxyRule
from dragonfly2_tpu_torch.telemetry import default_registry
from dragonfly2_tpu_torch.telemetry.series import daemon_series
from dragonfly2_tpu_torch.utils.conntrack import ConnTracker

logger = logging.getLogger(__name__)

# Hop-by-hop headers never forwarded upstream (RFC 7230 §6.1), plus the
# proxy's own credentials — forwarding proxy-authorization would leak the
# proxy password to every origin.
_HOP_BY_HOP = {
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization",
    "te", "trailers", "transfer-encoding", "upgrade", "host", "content-length",
}


def _forwardable(headers: dict) -> dict:
    return {k: v for k, v in headers.items() if k.lower() not in _HOP_BY_HOP}



async def _pump(src: asyncio.StreamReader, dst: asyncio.StreamWriter) -> None:
    """One direction of a byte shovel. EOF is PROPAGATED with write_eof()
    rather than closing dst — a client that half-closes after sending its
    request must still receive the rest of the response; the caller closes
    both writers after BOTH directions finish."""
    try:
        while True:
            data = await src.read(64 * 1024)
            if not data:
                break
            dst.write(data)
            await dst.drain()
    except (ConnectionError, RuntimeError, asyncio.TimeoutError):
        pass
    try:
        dst.write_eof()
    except (OSError, RuntimeError):
        pass


class ProxyServer:
    def __init__(
        self,
        transport: P2PTransport,
        host: str = "127.0.0.1",
        port: int = 0,
        registry_mirror: str = "",
        whitelist_hosts: list[str] | None = None,
        basic_auth: tuple[str, str] | None = None,
    ):
        self.transport = transport
        self.host = host
        self.port = port
        self.registry_mirror = registry_mirror.rstrip("/")
        self.whitelist_hosts = whitelist_hosts
        self.basic_auth = basic_auth
        self._server: asyncio.AbstractServer | None = None
        self._tracker = ConnTracker()
        self.stats = {"p2p": 0, "direct": 0, "tunnel": 0, "denied": 0}
        self.metrics = daemon_series(default_registry())

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._tracker.tracked(self._handle), self.host, self.port
        )
        self.host, self.port = self._server.sockets[0].getsockname()[:2]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._tracker.cancel_all()
            await self._server.wait_closed()

    # ------------------------------------------------------------- handler

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request_line = (await reader.readline()).decode("latin1").strip()
            if not request_line:
                return
            method, target, _ = request_line.split(" ", 2)
            self.metrics.proxy_request.labels(method).inc()
            headers = {}
            while True:
                line = (await reader.readline()).decode("latin1").strip()
                if not line:
                    break
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()

            if not self._authorized(headers):
                self.stats["denied"] += 1
                await self._respond(writer, 407, b"proxy auth required",
                                    extra="Proxy-Authenticate: Basic realm=dragonfly\r\n")
                return
            if method == "CONNECT":
                # the whitelist must gate tunnels too, or a configured
                # whitelist only protects plain HTTP while CONNECT relays
                # to any host:port
                if not self._host_allowed("https://" + target):
                    self.stats["denied"] += 1
                    await self._respond(writer, 403, b"host not in white list")
                    return
                await self._tunnel(target, reader, writer)
                return
            url = target
            if url.startswith("/"):
                if not self.registry_mirror:
                    await self._respond(writer, 404, b"no registry mirror configured")
                    return
                url = self.registry_mirror + url  # reverse-proxy mode
            if not self._host_allowed(url):
                self.stats["denied"] += 1
                await self._respond(writer, 403, b"host not in white list")
                return
            request_body = b""
            length = int(headers.get("content-length") or 0)
            if length:
                request_body = await reader.readexactly(length)
            upstream_headers = _forwardable(headers)
            if method != "GET":
                try:
                    body = await self.transport._direct(
                        url, upstream_headers, method=method, body=request_body or None
                    )
                except Exception as e:  # noqa: BLE001 - proxy reports, never dies
                    await self._respond(writer, 502, str(e).encode())
                    return
                await self._respond(writer, 200, body)
                self.stats["direct"] += 1
                return
            try:
                result = await self.transport.fetch(url, upstream_headers)
            except Exception as e:  # noqa: BLE001 - proxy reports, never dies
                await self._respond(writer, 502, str(e).encode())
                return
            self.stats[result.via] += 1
            if result.via == "p2p":
                self.metrics.proxy_request_via.labels().inc()
            else:
                self.metrics.proxy_request_not_via.labels().inc()
            extra = f"X-Dragonfly-Via: {result.via}\r\n"
            if result.content_range:
                extra += f"Content-Range: {result.content_range}\r\n"
            await self._respond(writer, result.status, result.body, extra=extra)
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            writer.close()

    async def _tunnel(self, target: str, reader, writer):
        """CONNECT passthrough (proxy_sni-style byte shovel, no mitm)."""
        host, _, port = target.partition(":")
        try:
            upstream_r, upstream_w = await asyncio.open_connection(host, int(port or 443))
        except OSError as e:
            await self._respond(writer, 502, str(e).encode())
            return
        writer.write(b"HTTP/1.1 200 Connection established\r\n\r\n")
        await writer.drain()
        self.stats["tunnel"] += 1
        try:
            await asyncio.gather(
                _pump(reader, upstream_w), _pump(upstream_r, writer)
            )
        finally:
            upstream_w.close()

    # ------------------------------------------------------------- helpers

    def _authorized(self, headers: dict) -> bool:
        if self.basic_auth is None:
            return True
        expected = base64.b64encode(
            f"{self.basic_auth[0]}:{self.basic_auth[1]}".encode()
        ).decode()
        got = headers.get("proxy-authorization", "")
        return got == f"Basic {expected}"

    def _host_allowed(self, url: str) -> bool:
        if self.whitelist_hosts is None:
            return True
        import urllib.parse

        host = urllib.parse.urlsplit(url).hostname or ""
        return any(host == h or host.endswith("." + h) for h in self.whitelist_hosts)

    async def _respond(self, writer, status: int, body: bytes, extra: str = ""):
        reason = {200: "OK", 206: "Partial Content", 403: "Forbidden", 404: "Not Found",
                  407: "Proxy Authentication Required", 502: "Bad Gateway"}.get(status, "")
        head = (
            f"HTTP/1.1 {status} {reason}\r\nContent-Length: {len(body)}\r\n"
            f"{extra}Connection: close\r\n\r\n"
        )
        writer.write(head.encode() + body)
        await writer.drain()


# ------------------------------------------------------------------ SNI


def parse_client_hello_sni(data: bytes) -> str | None:
    """Extract the server_name from a TLS ClientHello, or None.

    The reference's SNI proxy (client/daemon/proxy/proxy_sni.go:140)
    routes raw TLS connections by the SNI extension without terminating
    TLS; this is the same parse: TLS record header -> handshake header ->
    skip version/random/session/ciphers/compression -> walk extensions
    for type 0 (server_name)."""
    try:
        if len(data) < 5 or data[0] != 0x16:  # handshake record
            return None
        record_len = int.from_bytes(data[3:5], "big")
        body = data[5 : 5 + record_len]
        if len(body) < 4 or body[0] != 0x01:  # ClientHello
            return None
        hs_len = int.from_bytes(body[1:4], "big")
        hello = body[4 : 4 + hs_len]
        pos = 2 + 32  # client_version + random
        sid_len = hello[pos]
        pos += 1 + sid_len
        cs_len = int.from_bytes(hello[pos : pos + 2], "big")
        pos += 2 + cs_len
        comp_len = hello[pos]
        pos += 1 + comp_len
        if pos + 2 > len(hello):
            return None  # no extensions
        ext_total = int.from_bytes(hello[pos : pos + 2], "big")
        pos += 2
        end = min(pos + ext_total, len(hello))
        while pos + 4 <= end:
            ext_type = int.from_bytes(hello[pos : pos + 2], "big")
            ext_len = int.from_bytes(hello[pos + 2 : pos + 4], "big")
            pos += 4
            if ext_type == 0x0000:  # server_name
                lst = hello[pos : pos + ext_len]
                if len(lst) < 5 or lst[2] != 0x00:  # host_name entry
                    return None
                name_len = int.from_bytes(lst[3:5], "big")
                raw = lst[5 : 5 + name_len]
                try:
                    return raw.decode("idna")  # strict-only codec
                except UnicodeError:
                    return raw.decode("ascii", "replace")
            pos += ext_len
        return None
    except (IndexError, UnicodeError):
        return None


class SNIProxy:
    """Raw-TLS passthrough router (proxy_sni.go): accept a TCP
    connection, peek the ClientHello, resolve the SNI hostname to an
    upstream, replay the peeked bytes, and shovel bytes both ways — TLS
    is never terminated, so no cert minting is involved.

    `resolver(host) -> (addr, port)` decides the upstream (the reference
    maps SNI proxies onto registry-mirror-style host rules). Without a
    resolver, `allowed_hosts` gates which SNI names may be dialed on 443
    — and with NEITHER configured every connection is refused: a
    relay-anywhere default would make the listener an unauthenticated
    SSRF hop to any host an attacker names in the ClientHello."""

    def __init__(self, resolver=None, allowed_hosts: list[str] | None = None,
                 host: str = "127.0.0.1", port: int = 0, timeout: float = 30.0):
        self.resolver = resolver
        self.allowed_hosts = allowed_hosts
        self.host = host
        self.port = port
        self.timeout = timeout
        self._server: asyncio.AbstractServer | None = None
        self._tracker = ConnTracker()

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._tracker.tracked(self._handle), self.host, self.port
        )
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._tracker.cancel_all()
            await self._server.wait_closed()

    def _resolve(self, name: str) -> tuple[str, int] | None:
        if self.resolver is not None:
            try:
                return self.resolver(name)
            except Exception as e:  # noqa: BLE001 - a table-miss KeyError
                # must be a clean refusal, not an unhandled-task traceback
                logger.warning("sni proxy: resolver refused %r (%s)", name, e)
                return None
        if self.allowed_hosts is not None and any(
            name == h or name.endswith("." + h) for h in self.allowed_hosts
        ):
            return name, 443
        logger.warning("sni proxy: %r not in allowed hosts; refusing", name)
        return None

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            # Read until the full first record is in hand (ClientHello can
            # arrive across several TCP segments).
            buf = b""
            while len(buf) < 5:
                chunk = await asyncio.wait_for(reader.read(4096), self.timeout)
                if not chunk:
                    return
                buf += chunk
            need = 5 + int.from_bytes(buf[3:5], "big")
            while len(buf) < need:
                chunk = await asyncio.wait_for(reader.read(4096), self.timeout)
                if not chunk:
                    break
                buf += chunk
            name = parse_client_hello_sni(buf)
            if not name:
                logger.warning("sni proxy: no server_name in ClientHello")
                return
            upstream = self._resolve(name)
            if upstream is None:
                return
            up_reader, up_writer = await asyncio.wait_for(
                asyncio.open_connection(*upstream), self.timeout
            )
            try:
                up_writer.write(buf)  # replay the peeked ClientHello
                await up_writer.drain()
                await asyncio.gather(
                    _pump(reader, up_writer), _pump(up_reader, writer),
                    return_exceptions=True,
                )
            finally:
                up_writer.close()
        except (ConnectionError, asyncio.TimeoutError, OSError) as e:
            logger.warning("sni proxy connection failed: %s", e)
        finally:
            writer.close()
