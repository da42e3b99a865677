"""Over-the-wire model inference — the KServe-v2 surface, served natively.

Capability parity with pkg/rpc/inference (client_v1.go:83-123 wraps
Triton's `GRPCInferenceService` ModelInfer/ModelReady/ServerLive against
an *external* Triton sidecar). Here the same RPC surface is served by the
framework itself: an `InferenceRPCServer` fronts `registry.serving
.ModelServer`s (params hot-swapped on activation flips),
so anything that could talk to the reference's Triton endpoint — a remote
scheduler, a debugging CLI, an evaluation harness — can call this instead,
and the compute runs on the GPU this process owns.

Port of dragonfly2_tpu/rpc/inference.py with the same messages, contracts
and error surfaces; frames interoperate with the reference in both
directions. The attention, gnn and mlp model types are served.

Tensors travel as raw little-endian bytes + dtype + shape (KServe v2's
`raw_input_contents` convention) over the same length-prefixed msgpack
framing as every other cluster edge.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time

import numpy as np

from dragonfly2_tpu_torch.registry import serving
from dragonfly2_tpu_torch.rpc import mux, wire
from dragonfly2_tpu_torch.utils import dferrors
from dragonfly2_tpu_torch.utils.conntrack import ConnTracker

logger = logging.getLogger(__name__)

# retry cadence after a failed registry refresh (seconds)
FAILURE_BACKOFF_S = 0.1


# ------------------------------------------------------------------ messages


@dataclasses.dataclass
class InferTensor:
    """KServe-v2 tensor: name + datatype (numpy dtype string) + shape +
    raw little-endian contents."""

    name: str
    datatype: str
    shape: list[int]
    contents: bytes

    @staticmethod
    def from_numpy(name: str, array: np.ndarray) -> "InferTensor":
        array = np.ascontiguousarray(array)
        return InferTensor(
            name=name,
            datatype=array.dtype.str.lstrip("<>|="),
            shape=list(array.shape),
            contents=array.astype(array.dtype.newbyteorder("<"), copy=False).tobytes(),
        )

    def to_numpy(self) -> np.ndarray:
        dtype = np.dtype(self.datatype).newbyteorder("<")
        return np.frombuffer(self.contents, dtype=dtype).reshape(self.shape)


@dataclasses.dataclass
class ServerLiveRequest:
    pass


@dataclasses.dataclass
class ServerLiveResponse:
    live: bool


@dataclasses.dataclass
class ModelReadyRequest:
    name: str
    version: str = ""


@dataclasses.dataclass
class ModelReadyResponse:
    ready: bool


@dataclasses.dataclass
class ModelMetadataRequest:
    name: str
    version: str = ""


@dataclasses.dataclass
class ModelMetadataResponse:
    name: str
    versions: list[str]
    platform: str
    inputs: list[str]
    outputs: list[str]


@dataclasses.dataclass
class ModelInferRequest:
    model_name: str
    inputs: list[InferTensor]
    model_version: str = ""
    id: str = ""


@dataclasses.dataclass
class ModelInferResponse:
    model_name: str
    model_version: str
    outputs: list[InferTensor]
    id: str = ""
    error: str = ""


wire.register_messages(
    InferTensor,
    ServerLiveRequest,
    ServerLiveResponse,
    ModelReadyRequest,
    ModelReadyResponse,
    ModelMetadataRequest,
    ModelMetadataResponse,
    ModelInferRequest,
    ModelInferResponse,
)


# The per-model-type IO contracts (what the reference would have encoded
# in each model's Triton config.pbtxt, manager/types/model.go:23-37).
_CONTRACTS = {
    "mlp": (["features"], ["rtt"]),
    "attention": (["child_feats", "parent_feats", "pair_feats", "mask"], ["scores"]),
    "gnn": (["host_emb", "child_host", "cand_host", "pair_feats"], ["scores"]),
}


# -------------------------------------------------------------------- server


class InferenceRPCServer:
    """Serves ModelInfer/ModelReady/ServerLive for a set of ModelServers
    keyed by model name (the scheduler registers its gnn/mlp/attention
    servers; remote callers score through them)."""

    def __init__(
        self,
        servers: dict[str, object],
        host: str = "127.0.0.1",
        port: int = 0,
        refresh_ttl_s: float = 0.5,
        health_check=None,
        ssl_context=None,
    ):
        self.health_check = health_check
        self.ssl_context = ssl_context
        self.servers = servers
        self.host = host
        self.port = port
        self.refresh_ttl_s = refresh_ttl_s
        self._server: asyncio.AbstractServer | None = None
        # refresh() swaps .model and .params non-atomically and infer
        # reads them; dispatches run on to_thread workers, so each model
        # gets a lock serializing refresh+infer (a reader between the two
        # writes would apply new-module params... to the old module).
        self._model_locks = {name: threading.Lock() for name in servers}
        self._last_refresh = {name: float("-inf") for name in servers}
        self._tracker = ConnTracker()

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._tracker.tracked(self._serve_conn), self.host, self.port,
            ssl=self.ssl_context,
        )
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        logger.info("inference rpc listening on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # InferenceClient holds a persistent connection by design; on
            # 3.12 wait_closed() would wait for it forever unless the
            # handler tasks are cancelled first (utils/conntrack.py).
            await self._tracker.cancel_all()
            await self._server.wait_closed()

    async def _serve_conn(self, reader, writer):
        try:
            while True:
                request = await wire.read_frame(reader)
                if request is None:
                    return
                # Wire-envelope propagation (dflint WIRE003) via the
                # shared mux.dispatch_anchored: a remote scorer's budget
                # bounds the device call and its trace continues through
                # this hop. The response is ALWAYS written even when the
                # budget expired mid-infer — inference is strict
                # request/response on a shared connection, so dropping a
                # reply would wedge the caller forever (unlike the
                # scheduler's stream edge, where shedding is safe).
                # torch releases the GIL in its kernels and device waits;
                # off-loop keeps one slow infer from stalling other conns
                response = await asyncio.to_thread(
                    mux.dispatch_anchored, self._dispatch, request,
                    "inference.rpc",
                )
                if response is not None:
                    wire.write_frame(writer, response)
                    await writer.drain()
        except Exception:  # noqa: BLE001 - one bad conn must not kill the server
            logger.exception("inference connection handler failed")
        finally:
            writer.close()

    def _refresh(self, name: str, server) -> None:
        """refresh() re-reads version manifests from disk; bound it to
        once per refresh_ttl_s so the per-request hot path doesn't pay
        two file reads per call (the active pointer flips rarely). The
        timestamp is only advanced on success — a transient read failure
        (registry being rewritten) must not suppress retries for a full
        TTL — and a raise degrades to serving the current state rather
        than propagating (which would close the caller's connection)."""
        now = time.monotonic()
        if now - self._last_refresh[name] < self.refresh_ttl_s:
            return
        try:
            server.refresh()
        except Exception as e:  # noqa: BLE001
            # Short backoff instead of the full TTL (a transient mid-write
            # read should retry soon) but NOT per-request (a persistently
            # dead registry must not cost every request a failed disk read
            # and a log line).
            self._last_refresh[name] = now - self.refresh_ttl_s + FAILURE_BACKOFF_S
            logger.warning(
                "refresh of model %s failed (%s: %s); serving previous state",
                name, type(e).__name__, e,
            )
            return
        self._last_refresh[name] = now

    def _dispatch(self, request):
        health = mux.handle_health_request(request, self.health_check)
        if health is not None:
            return health
        if isinstance(request, ServerLiveRequest):
            return ServerLiveResponse(live=True)
        if isinstance(request, ModelReadyRequest):
            server = self.servers.get(request.name)
            if server is not None:
                with self._model_locks[request.name]:
                    self._refresh(request.name, server)
            return ModelReadyResponse(ready=bool(server is not None and server.ready))
        if isinstance(request, ModelMetadataRequest):
            server = self.servers.get(request.name)
            if server is None:
                return ModelMetadataResponse(
                    name=request.name, versions=[], platform="", inputs=[], outputs=[]
                )
            inputs, outputs = _CONTRACTS[server.model_type]
            with self._model_locks[request.name]:
                self._refresh(request.name, server)
            return ModelMetadataResponse(
                name=request.name,
                versions=[str(server.version)] if server.version is not None else [],
                platform=f"torch-{server.model_type}",
                inputs=inputs,
                outputs=outputs,
            )
        if isinstance(request, ModelInferRequest):
            try:
                return self._infer(request)
            except Exception as e:  # noqa: BLE001 - a bad infer (shape
                # mismatch, bad params, stale checkpoint) must come
                # back as an error *response*; killing the connection would
                # take down every other in-flight caller on it
                return ModelInferResponse(
                    model_name=request.model_name, model_version="",
                    outputs=[], id=request.id, error=f"{type(e).__name__}: {e}",
                )
        # An unhandled-but-decodable type (version skew, wrong port): fail
        # the connection loudly — returning None would write no response
        # frame and leave the peer awaiting one forever.
        raise dferrors.InvalidArgument(
            f"inference server cannot handle {type(request).__name__}"
        )

    def _infer(self, request: ModelInferRequest) -> ModelInferResponse:
        server = self.servers.get(request.model_name)
        if server is None:
            raise dferrors.NotFound(f"no model {request.model_name!r}")
        # Snapshot (model, params, version) under the lock so a concurrent
        # refresh can't swap the module between reads — but run the pure
        # apply OUTSIDE it, otherwise concurrent inference for one model
        # serializes on the device call and the to_thread offload buys
        # nothing.
        with self._model_locks[request.model_name]:
            self._refresh(request.model_name, server)
            model, params, version = server.snapshot()
        if params is None:
            raise dferrors.FailedPrecondition(
                f"model {request.model_name!r} has no active version"
            )
        tensors = {t.name: t.to_numpy() for t in request.inputs}
        want, out_names = _CONTRACTS[server.model_type]
        missing = [n for n in want if n not in tensors]
        if missing:
            raise dferrors.InvalidArgument(
                f"model {request.model_name!r} needs inputs {want}, missing {missing}"
            )
        if server.model_type == "mlp":
            out = serving.mlp_apply(model, tensors["features"])
        elif server.model_type == "attention":
            out = serving.attention_score(
                model, params, tensors["child_feats"], tensors["parent_feats"],
                tensors["pair_feats"], tensors["mask"],
            )
        else:  # gnn candidate scoring against caller-supplied embeddings
            out = serving.gnn_score(
                model, tensors["host_emb"], tensors["child_host"],
                tensors["cand_host"], tensors["pair_feats"],
            )
        return ModelInferResponse(
            model_name=request.model_name,
            model_version=str(version),
            outputs=[InferTensor.from_numpy(out_names[0], out.cpu().numpy())],
            id=request.id,
        )


# -------------------------------------------------------------------- client


class InferenceClient:
    """Typed client mirroring pkg/rpc/inference/client/client_v1.go's
    surface (ModelInfer / ModelReady / ServerLive) over one connection."""

    def __init__(self, host: str, port: int, ssl_context=None):
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self._reader = None
        self._writer = None
        self._lock = asyncio.Lock()

    async def connect(self) -> "InferenceClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, ssl=self.ssl_context
        )
        return self

    async def close(self) -> None:
        if self._writer:
            self._writer.close()

    async def _call(self, request):
        async with self._lock:  # one in-flight request per connection
            wire.write_frame(self._writer, request)
            await self._writer.drain()
            response = await wire.read_frame(self._reader)
        if response is None:
            raise dferrors.Unavailable("inference server closed the connection")
        return response

    async def server_live(self) -> bool:
        return (await self._call(ServerLiveRequest())).live

    async def model_ready(self, name: str) -> bool:
        return (await self._call(ModelReadyRequest(name=name))).ready

    async def model_metadata(self, name: str) -> ModelMetadataResponse:
        return await self._call(ModelMetadataRequest(name=name))

    async def model_infer(
        self, name: str, inputs: dict[str, np.ndarray], request_id: str = ""
    ) -> dict[str, np.ndarray]:
        request = ModelInferRequest(
            model_name=name,
            inputs=[InferTensor.from_numpy(k, v) for k, v in inputs.items()],
            id=request_id,
        )
        response = await self._call(request)
        if response.error:
            raise dferrors.Unavailable(f"ModelInfer {name}: {response.error}")
        return {t.name: t.to_numpy() for t in response.outputs}
