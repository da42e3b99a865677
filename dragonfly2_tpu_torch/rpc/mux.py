"""Single-port multiplexing of the wire protocol and plain HTTP.

Port of dragonfly2_tpu/rpc/mux.py, whole.

Capability parity with pkg/rpc's mux listener (mux.go — one TCP port
serving both gRPC and HTTP health/debug traffic) and pkg/rpc/health (the
grpc health-checking protocol every service registers): the first bytes
of a connection decide the protocol. HTTP methods are ASCII ("GET ",
"POST"...), while a wire frame starts with a 4-byte big-endian length
whose first byte is 0x00 for any frame under 16 MiB — the two are
disjoint, so a 4-byte peek routes with no ambiguity (frames ≥16 MiB only
occur on the trainer upload path, which never fronts a mux).

HTTP side serves `/healthz` (liveness — the health RPC's HTTP twin),
`/metrics` (Prometheus text), `/debug/health` (telemetry/slo.py's health
verdict) and `/debug/flight` (the process's flight-recorder dump,
telemetry/flight.py, with `parse_flight_query`'s sections and max_bytes). The wire
side also answers `HealthCheckRequest` → SERVING on every server that
registers it.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging

from dragonfly2_tpu_torch.rpc import resilience, wire
from dragonfly2_tpu_torch.telemetry.tracing import default_tracer
from dragonfly2_tpu_torch.utils.conntrack import ConnTracker

logger = logging.getLogger(__name__)

_HTTP_PREFIXES = (b"GET ", b"POST", b"HEAD", b"PUT ", b"DELE", b"OPTI", b"PATC")

# The mux enforces its own frame ceiling, far below wire.MAX_FRAME
# (256 MiB, sized for trainer dataset chunks that never front a mux): the
# relay is frame-aware, so an oversized length prefix is rejected loudly
# instead of either deadlocking (a back-pressure bound below the frame
# size starves read_frame's readexactly) or letting every untrusted
# connection buffer a quarter-gigabyte.
MUX_MAX_FRAME = 16 << 20
_RELAY_HIGH_WATER = 2 * MUX_MAX_FRAME

SERVING = "SERVING"
NOT_SERVING = "NOT_SERVING"


class _CountedReader(asyncio.StreamReader):
    """Detached StreamReader that tracks its own buffered byte count.

    A detached reader has no transport, so feed_data never back-pressures;
    the relay bounds memory by polling `buffered` instead of probing
    CPython's private `_buffer` (which a future CPython could rename,
    silently turning the high-water check into a no-op)."""

    def __init__(self):
        super().__init__()
        self.buffered = 0

    def feed_data(self, data):
        self.buffered += len(data)
        super().feed_data(data)

    async def read(self, n=-1):
        if n < 0:
            # StreamReader.read(-1) loops over self.read(limit) — those
            # inner calls hit this override and already decrement; doing
            # it again here would double-count and wedge `buffered`
            # negative, silently disabling the high-water check.
            return await super().read(n)
        data = await super().read(n)
        self.buffered -= len(data)
        return data

    async def readexactly(self, n):
        data = await super().readexactly(n)
        self.buffered -= len(data)
        return data

    async def readuntil(self, separator=b"\n"):
        data = await super().readuntil(separator)
        self.buffered -= len(data)
        return data

    async def readline(self):
        data = await super().readline()
        self.buffered -= len(data)
        return data


@dataclasses.dataclass
class HealthCheckRequest:
    """pkg/rpc/health: the standard health v1 Check, per-service."""

    service: str = ""


@dataclasses.dataclass
class HealthCheckResponse:
    status: str = SERVING


wire.register_messages(HealthCheckRequest, HealthCheckResponse)


class MuxServer:
    """Accepts on one port; routes each connection to `rpc_handler`
    (an `async (reader, writer)` — e.g. SchedulerRPCServer._serve_conn)
    or to the built-in HTTP handler by protocol sniffing."""

    def __init__(
        self,
        rpc_handler,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics_registry=None,
        health_check=None,  # () -> bool; liveness beyond "process is up"
        ssl_context=None,
    ):
        self.rpc_handler = rpc_handler
        self.ssl_context = ssl_context
        self.host = host
        self.port = port
        self.metrics_registry = metrics_registry
        self.health_check = health_check
        self._server: asyncio.AbstractServer | None = None
        self._tracker = ConnTracker()

    def _healthy(self) -> bool:
        return True if self.health_check is None else bool(self.health_check())

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._tracker.tracked(self._handle), self.host, self.port,
            ssl=self.ssl_context,
        )
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # long-lived wire streams would hang 3.12's wait_closed()
            await self._tracker.cancel_all()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            peek = await reader.readexactly(4)
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        if peek in _HTTP_PREFIXES:
            await self._handle_http(peek, reader, writer)
            return
        # Wire protocol: hand the consumed prefix back through a fresh
        # reader fed by a frame-aware relay task (StreamReader has no
        # un-read).
        relayed = _CountedReader()

        async def relay():
            prefix = peek
            try:
                while True:
                    # Pause on a high-water mark (above the frame ceiling,
                    # so readexactly always completes).
                    while relayed.buffered > _RELAY_HIGH_WATER:
                        await asyncio.sleep(0.01)
                    if prefix is None:
                        prefix = await reader.readexactly(4)
                    frame_len = int.from_bytes(prefix, "big")
                    if frame_len > MUX_MAX_FRAME:
                        logger.warning(
                            "mux: rejecting %d-byte frame (> %d ceiling)",
                            frame_len, MUX_MAX_FRAME,
                        )
                        relayed.feed_eof()
                        return
                    payload = await reader.readexactly(frame_len)
                    relayed.feed_data(prefix + payload)
                    prefix = None
            except (ConnectionError, asyncio.IncompleteReadError,
                    asyncio.CancelledError):
                relayed.feed_eof()

        relay_task = asyncio.create_task(relay())
        try:
            await self.rpc_handler(relayed, writer)
        finally:
            relay_task.cancel()

    async def _handle_http(self, peek: bytes, reader, writer):
        try:
            try:
                # readline converts LimitOverrunError into ValueError for
                # over-long request lines/headers — drop those quietly
                # WITHOUT catching ValueError around the handler bodies
                # below (a real bug in expose() must stay loud)
                line = peek + await asyncio.wait_for(reader.readline(), 10)
                parts = line.decode("latin1").split()
                path = parts[1] if len(parts) > 1 else "/"
                # drain headers
                while True:
                    header = await asyncio.wait_for(reader.readline(), 10)
                    if header in (b"\r\n", b"\n", b""):
                        break
            except ValueError:
                return
            path, _, query = path.partition("?")
            path = path.rstrip("/") or "/"
            if path == "/healthz":
                ok = self._healthy()
                status, body = (200, b"ok") if ok else (503, b"not serving")
            elif path == "/metrics" and self.metrics_registry is not None:
                status, body = 200, self.metrics_registry.expose().encode()
            elif path == "/debug/flight":
                import json

                from dragonfly2_tpu_torch.telemetry import flight

                try:
                    kwargs = flight.parse_flight_query(query)
                except ValueError as e:
                    status, body = 400, str(e).encode()
                else:
                    doc = flight.dump(**kwargs)
                    # compact separators: the dump's max_bytes cap is
                    # measured against compact JSON — default separators
                    # would overshoot the promised bound by ~20%
                    status, body = 200, json.dumps(
                        doc, separators=(",", ":"), default=str
                    ).encode()
            elif path == "/debug/health":
                import json

                from dragonfly2_tpu_torch.telemetry import slo as _slo

                try:
                    kwargs = _slo.parse_health_query(query)
                except ValueError as e:
                    status, body = 400, str(e).encode()
                else:
                    # the machine-readable health verdict plane
                    # (telemetry/slo.health_verdict): every live SLO
                    # engine merged worst-wins. 503 on `critical` so a
                    # load balancer can act on the same answer an
                    # operator reads; compact JSON — the max_bytes cap
                    # is measured against the bytes actually shipped.
                    doc = _slo.health_verdict(**kwargs)
                    status = (
                        503 if doc["state"] == _slo.VERDICT_CRITICAL else 200
                    )
                    body = json.dumps(
                        doc, separators=(",", ":"), default=str
                    ).encode()
            else:
                status, body = 404, b"not found"
            reason = {
                200: "OK", 400: "Bad Request", 404: "Not Found",
                503: "Service Unavailable",
            }[status]
            writer.write(
                f"HTTP/1.1 {status} {reason}\r\nContent-Length: {len(body)}\r\n"
                "Content-Type: text/plain\r\nConnection: close\r\n\r\n".encode() + body
            )
            await writer.drain()
        except (ConnectionError, asyncio.TimeoutError, UnicodeDecodeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()


def dispatch_anchored(dispatch, request, span_prefix: str):
    """Run one decoded frame through ``dispatch`` with the wire envelope
    re-anchored (the "dl" contract): the frame's
    remaining deadline budget restarts on this host's clock so onward
    frames carry what is left, and the caller's trace context continues
    through a ``{span_prefix}.<Type>`` span. The ONE implementation
    every request/response serve loop shares, so a new RPC server routes
    through here instead of hand-rolling the scopes."""
    budget = getattr(request, "deadline_s", None)
    remote_ctx = getattr(request, "trace_context", None)
    with contextlib.ExitStack() as stack:
        if remote_ctx is not None:
            stack.enter_context(default_tracer().span(
                f"{span_prefix}.{type(request).__name__}",
                remote_parent=remote_ctx,
            ))
        if budget is not None:
            stack.enter_context(resilience.deadline(budget))
        return dispatch(request)


def handle_health_request(request, health_check=None):
    """Shared wire-side health answer — servers call this first in their
    dispatch: returns a response for HealthCheckRequest, else None. The
    optional `health_check` callable (the server's own) decides
    SERVING/NOT_SERVING — a draining server must not tell its load
    balancer SERVING. The null-check lives HERE so the four dispatch
    sites can all pass `self.health_check` verbatim."""
    if isinstance(request, HealthCheckRequest):
        healthy = True if health_check is None else bool(health_check())
        return HealthCheckResponse(status=SERVING if healthy else NOT_SERVING)
    return None
