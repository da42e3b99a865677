"""Manager service-facing RPC: the gRPC surface schedulers and daemons use.

Port of dragonfly2_tpu/manager/rpc.py, whole: the same message names and fields on the
wire, so either package's client calls the other's server.

Capability parity with manager/rpcserver (manager_server_v1.go):
GetScheduler/ListSchedulers for joining daemons, scheduler/seed-peer
registration (UpdateScheduler/UpdateSeedPeer upserts), the KeepAlive
client-stream (manager_server_v1.go:955-1000) that flips instances
active/inactive, CreateModel (:802-952) streaming trained params into the
registry, and the dynconfig fetch schedulers poll. Same length-prefixed
msgpack wire protocol as the scheduler edge (rpc/wire.py); params ride as
msgpack-serializable nested lists produced by the trainer's checkpoint
codec.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging

from dragonfly2_tpu_torch.rpc import mux, wire
from dragonfly2_tpu_torch.utils.conntrack import ConnTracker

logger = logging.getLogger(__name__)


# ------------------------------------------------------------------ messages


@dataclasses.dataclass
class GetSchedulersRequest:
    ip: str
    hostname: str
    idc: str = ""
    location: str = ""


@dataclasses.dataclass
class SchedulerEntry:
    id: int
    host_name: str
    ip: str
    port: int
    state: str
    scheduler_cluster_id: int


@dataclasses.dataclass
class GetSchedulersResponse:
    schedulers: list[SchedulerEntry]


@dataclasses.dataclass
class RegisterInstanceRequest:
    source_type: str  # "scheduler" | "seed_peer"
    host_name: str
    ip: str
    port: int
    cluster_id: int
    idc: str = ""
    location: str = ""


@dataclasses.dataclass
class RegisterInstanceResponse:
    id: int
    cluster_id: int


@dataclasses.dataclass
class KeepAliveRequest:
    source_type: str
    host_name: str
    ip: str
    cluster_id: int


@dataclasses.dataclass
class CreateModelRequest:
    name: str
    type: str
    scheduler_host_id: str
    params_blob: bytes
    evaluation: dict


@dataclasses.dataclass
class CreateModelResponse:
    model_id: str
    version: int


@dataclasses.dataclass
class GetDynconfigRequest:
    scheduler_cluster_id: int


@dataclasses.dataclass
class DynconfigResponse:
    data: dict


@dataclasses.dataclass
class IssueCertificateRequest:
    """CSR-based cert issuance (pkg/issuer DragonflyIssuer + the security
    client every service runs when mTLS is on, scheduler.go:180-219)."""

    csr_pem: bytes
    validity_days: int = 365
    # Shared enrollment secret: required when the manager was started with
    # one, so CA issuance is not granted by mere network reachability.
    token: str = ""


@dataclasses.dataclass
class IssueCertificateResponse:
    # leaf first, then the CA — the chain order ssl.load_cert_chain wants
    certificate_chain: list[bytes]


@dataclasses.dataclass
class Ack:
    ok: bool = True
    error: str = ""


wire.register_messages(
    IssueCertificateRequest,
    IssueCertificateResponse,
    GetSchedulersRequest,
    SchedulerEntry,
    GetSchedulersResponse,
    RegisterInstanceRequest,
    RegisterInstanceResponse,
    KeepAliveRequest,
    CreateModelRequest,
    CreateModelResponse,
    GetDynconfigRequest,
    DynconfigResponse,
    Ack,
)


# -------------------------------------------------------------------- server


class ManagerRPCServer:
    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 health_check=None, ssl_context=None):
        self.service = service
        self.health_check = health_check
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self._server: asyncio.AbstractServer | None = None
        self._tracker = ConnTracker()

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._tracker.tracked(self._serve_conn), self.host, self.port,
            ssl=self.ssl_context,
        )
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        logger.info("manager rpc listening on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # Cancel in-flight handlers first: keepalive clients hold their
            # connection open forever, and 3.12's wait_closed() waits for
            # every live handler (utils/conntrack.py).
            await self._tracker.cancel_all()
            await self._server.wait_closed()

    async def _serve_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                request = await wire.read_frame(reader)
                if request is None:
                    return
                # Wire-envelope propagation (dflint WIRE003) via the
                # shared mux.dispatch_anchored: a preheat job's budget
                # now bounds the manager-side work it triggers and its
                # trace continues across this hop. Replies always go out
                # — the manager edge is strict request/response
                # (keepalive loops, certify flows) and a dropped Ack
                # would wedge the caller on a shared connection.
                response = await asyncio.to_thread(
                    mux.dispatch_anchored, self._dispatch, request,
                    "manager.rpc",
                )
                if response is not None:
                    wire.write_frame(writer, response)
                    await writer.drain()
        except Exception:  # noqa: BLE001 - one bad conn must not kill the server
            logger.exception("manager connection handler failed")
        finally:
            writer.close()

    def _dispatch(self, request):
        health = mux.handle_health_request(request, self.health_check)
        if health is not None:
            return health
        svc = self.service
        try:
            if isinstance(request, GetSchedulersRequest):
                conditions = {"idc": request.idc, "location": request.location}
                rows = svc.list_schedulers(request.ip, request.hostname, conditions)
                return GetSchedulersResponse(
                    schedulers=[
                        SchedulerEntry(
                            id=r["id"],
                            host_name=r["host_name"],
                            ip=r["ip"],
                            port=r.get("port", 0),
                            state=r["state"],
                            scheduler_cluster_id=r["scheduler_cluster_id"],
                        )
                        for r in rows
                    ]
                )
            if isinstance(request, RegisterInstanceRequest):
                body = {
                    "host_name": request.host_name,
                    "ip": request.ip,
                    "port": request.port,
                    "idc": request.idc,
                    "location": request.location,
                }
                if request.source_type == "scheduler":
                    body["scheduler_cluster_id"] = request.cluster_id
                    record = svc.register_scheduler(body)
                else:
                    body["seed_peer_cluster_id"] = request.cluster_id
                    record = svc.register_seed_peer(body)
                return RegisterInstanceResponse(id=record["id"], cluster_id=request.cluster_id)
            if isinstance(request, KeepAliveRequest):
                svc.keepalive(request.source_type, request.host_name, request.ip, request.cluster_id)
                return Ack()
            if isinstance(request, CreateModelRequest):
                from dragonfly2_tpu_torch.registry.registry import ModelEvaluation
                from dragonfly2_tpu_torch.training.checkpoint import params_from_bytes

                params = params_from_bytes(request.params_blob)
                record = svc.create_model(
                    request.name,
                    request.type,
                    request.scheduler_host_id,
                    params,
                    ModelEvaluation(**request.evaluation),
                )
                return CreateModelResponse(model_id=record["model_id"], version=record["version"])
            if isinstance(request, GetDynconfigRequest):
                return DynconfigResponse(data=svc.scheduler_dynconfig(request.scheduler_cluster_id))
            if isinstance(request, IssueCertificateRequest):
                chain = svc.issue_certificate(
                    request.csr_pem, request.validity_days, token=request.token
                )
                return IssueCertificateResponse(certificate_chain=chain)
        except Exception as e:  # noqa: BLE001 - errors cross the wire as acks
            return Ack(ok=False, error=f"{type(e).__name__}: {e}")
        return Ack(ok=False, error=f"unknown request {type(request).__name__}")


# -------------------------------------------------------------------- client


class ManagerClient:
    """Typed client with one connection, used by schedulers/daemons
    (pkg/rpc/manager/client surface)."""

    def __init__(self, host: str, port: int, ssl_context=None):
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._lock = asyncio.Lock()

    async def connect(self) -> "ManagerClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, ssl=self.ssl_context
        )
        return self

    async def close(self) -> None:
        if self._writer:
            self._writer.close()

    async def call(self, request):
        async with self._lock:
            assert self._writer is not None and self._reader is not None
            wire.write_frame(self._writer, request)
            await self._writer.drain()
            response = await wire.read_frame(self._reader)
        if isinstance(response, Ack) and not response.ok:
            raise RuntimeError(response.error)
        return response

    async def keepalive_loop(self, request: KeepAliveRequest, interval: float = 5.0) -> None:
        """The KeepAlive stream: fire until cancelled."""
        while True:
            try:
                await self.call(request)
            except (ConnectionError, RuntimeError) as e:
                logger.warning("keepalive failed: %s", e)
            await asyncio.sleep(interval)


async def obtain_certificate(
    manager_host: str,
    manager_port: int,
    common_name: str,
    cert_dir,
    san_hosts: list[str] | None = None,
    ssl_context=None,
    validity_days: int = 365,
    enrollment_token: str = "",
):
    """Service-side certify flow (the reference's security client: generate
    keypair + CSR locally, IssueCertificate against the manager, install
    the returned chain). Returns a ready `utils.certs.TLSMaterial` whose
    server/client contexts speak cluster mTLS. `ssl_context` lets the
    issuance call itself ride TLS (server-auth-only bootstrap) when the
    manager already serves it."""
    from dragonfly2_tpu_torch.utils import certs

    csr_pem, key_pem = certs.generate_csr(
        common_name, san_hosts or ["127.0.0.1", "localhost"]
    )
    client = await ManagerClient(manager_host, manager_port, ssl_context=ssl_context).connect()
    try:
        resp = await client.call(
            IssueCertificateRequest(
                csr_pem=csr_pem, validity_days=validity_days, token=enrollment_token
            )
        )
    finally:
        await client.close()
    chain = resp.certificate_chain
    if not chain or len(chain) < 2:
        raise RuntimeError("manager returned an incomplete certificate chain")
    mat = certs.TLSMaterial(cert_dir)
    mat.write(cert_pem=chain[0], key_pem=key_pem, ca_pem=chain[-1])
    return mat
