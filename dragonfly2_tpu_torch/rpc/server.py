"""Scheduler RPC server: the asyncio cluster edge.

Port of dragonfly2_tpu/rpc/server.py, whole: the same frames, dispatch,
deadline shedding, v1 conversion and tick loop, over the port's
SchedulerService and TrainerService. What differs:

- ``_probe_targets`` keys the probe picks with utils/prng.key, which gives
  the same bits as the reference's ``jax.random.key`` for the same seed,
  so one ``time.time_ns()`` picks the same targets in both packages;
- every thread that runs service work (the tick's and the dispatches'
  pool threads, the warmup thread, the gc sweep) makes the service's
  device its current device first (``_on_device``); the service names
  its device on every tensor it makes, and each thread uses its own
  current stream;
- ``stop()`` joins the warmup threads for CUDA's sake: a thread still
  launching when the interpreter finalizes would turn a SIGTERM into a
  crash;
- ``topology_collect_interval`` (off by default, as the reference has no
  such loop) runs the Go scheduler's networkTopology collect ticker
  (network_topology.go:124-138): every that many seconds the probe graph
  is written to the trace storage (``SchedulerService.snapshot_topology``),
  the rows the trainer's MLP trains on.

Capability parity with scheduler/rpcserver (scheduler_server_v2.go:56-166):
one long-lived connection per daemon carrying AnnouncePeer oneof messages,
AnnounceHost, SyncProbes, Stat/Leave — dispatched into SchedulerService.
The TPU-first part is the tick loop: handlers only enqueue; every
`tick_interval` the service batches ALL pending peers into one device call
(cluster/scheduler.py tick) and the responses fan back out over whichever
connections own those peers.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import threading
import time

import torch

from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.rpc import mux, resilience, wire
from dragonfly2_tpu_torch.telemetry import default_registry
from dragonfly2_tpu_torch.telemetry.tracing import default_tracer
from dragonfly2_tpu_torch.telemetry.series import (
    HOST_TRAFFIC_DOWNLOAD,
    HOST_TRAFFIC_UPLOAD,
    TRAFFIC_BACK_TO_SOURCE,
    TRAFFIC_P2P,
    register_version,
    resilience_series,
    scheduler_series,
    trainer_series,
)
from dragonfly2_tpu_torch.utils import prng
from dragonfly2_tpu_torch.utils.conntrack import ConnTracker

from dragonfly2_tpu_torch.cluster import service_v1 as sv1

wire.register_module(msg)
wire.register_module(sv1)

logger = logging.getLogger(__name__)

# How long a seed trigger waits for *any* seed daemon to connect before it
# is declared undeliverable (preheat racing the seed's announce).
SEED_TRIGGER_TTL_S = 60.0

# Per-PIECE report types arrive at the cluster's aggregate piece rate —
# orders of magnitude above every other message. A handler span per piece
# report (token_hex + exporter fan-out) buys no diagnostic value, so these
# keep their wire trace context but are never span-wrapped server-side.
_UNTRACED_RPC_TYPES = (
    msg.DownloadPieceFinishedRequest,
    msg.DownloadPieceFailedRequest,
    msg.ProbeFinishedRequest,
    sv1.V1PieceResult,
)

# Requests eligible for deadline shedding: work someone is WAITING on,
# where a caller past its budget has stopped listening. Lifecycle
# mutations (Leave*/AnnounceHost) and progress reports are NEVER shed —
# dropping a LeavePeer because its frame arrived late would leak peer
# state, which is strictly worse than doing cheap work nobody awaits.
_SHEDDABLE_RPC_TYPES = (
    msg.RegisterPeerRequest,
    msg.RescheduleRequest,
    msg.StatPeerRequest,
    msg.StatTaskRequest,
    msg.ProbeStartedRequest,
    msg.JobTriggerSeedRequest,
    msg.TaskStatesRequest,
    msg.SchedulerInfoRequest,
    msg.FlightRecorderRequest,
)

# Of those, the types whose callers expect a per-peer scheduling verdict:
# they get an explicit DeadlineExceeded ScheduleFailure so the conductor
# fails fast instead of waiting out its schedule timeout. Stat/info
# droppers get silence — their caller aborts on its own expired budget,
# and a ScheduleFailure would be misrouted into the peer's response queue.
_SHED_WITH_FAILURE_TYPES = (msg.RegisterPeerRequest, msg.RescheduleRequest)


def _on_device(service):
    """The service's CUDA device as the calling thread's current device
    (a no-op on the CPU): pool threads start on device 0 whatever the
    service was given."""
    device = getattr(service, "device", None)
    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class SchedulerRPCServer:
    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 tick_interval: float = 0.005, health_check=None, ssl_context=None,
                 vsock_port: int | None = None, topology_collect_interval: float = 0.0):
        self.service = service
        self.topology_collect_interval = topology_collect_interval
        self.health_check = health_check
        self.host = host
        self.port = port
        self.tick_interval = tick_interval
        self.ssl_context = ssl_context  # server SSLContext for mTLS; None = plaintext
        # optional AF_VSOCK listener alongside TCP (pkg/rpc/vsock.go /
        # pkg/dfnet VSOCK network type — VM guests dialing the host)
        self.vsock_port = vsock_port
        self._vsock_server: asyncio.AbstractServer | None = None
        self._server: asyncio.AbstractServer | None = None
        self._peer_conn: dict[str, asyncio.StreamWriter] = {}
        self._host_conn: dict[str, asyncio.StreamWriter] = {}
        self._writers: set[asyncio.StreamWriter] = set()
        self._tick_task: asyncio.Task | None = None
        self._topology_task: asyncio.Task | None = None
        self._warmup_thread: threading.Thread | None = None
        self._trigger_deadline: dict[str, float] = {}
        self._pending_triggers: list = []
        self._lock = asyncio.Lock()
        self._tracker = ConnTracker()
        # Adaptive tick: set whenever a dispatched message may have enqueued
        # scheduling work, so a lone request is served at kernel latency
        # instead of waiting out the full tick_interval (SURVEY §7 hard
        # part (b); the interval remains the RETRY cadence for peers that
        # stay pending with no eligible parents).
        self._tick_wake = asyncio.Event()
        # v1 compat surface (cluster/service_v1.py): peers that registered
        # through the v1 dialect get their scheduling responses converted
        # to PeerPacket frames (the reference serves both generations off
        # one resource layer, service_v1.go + service_v2.go).
        self.v1 = sv1.SchedulerServiceV1(service)
        # _v1_mu guards every _v1_peers mutation AND the tick thread's
        # snapshot copy: adds happen on dispatch threads (under
        # service.mu), but the connection-close discard runs on the event
        # loop where taking service.mu would stall the loop for a whole
        # tick — a dedicated lock held only across set ops costs nothing
        # and stops set(...) from racing a concurrent discard
        # (RuntimeError: set changed size during iteration).
        self._v1_mu = threading.Lock()
        self._v1_peers: set[str] = set()
        reg = default_registry()
        self.metrics = scheduler_series(reg)
        self.resilience_metrics = resilience_series(reg, "scheduler")
        register_version(reg, "scheduler")
        self._m_requests = self.metrics.announce_peer
        self._m_tick = self.metrics.schedule_tick
        self._m_batch = self.metrics.schedule_batch

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._tracker.tracked(self._serve_conn), self.host, self.port,
            ssl=self.ssl_context,
        )
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        if self.vsock_port is not None:
            from dragonfly2_tpu_torch.utils import vsock as vsock_mod

            # same ssl_context as the TCP listener: a plaintext vsock side
            # door would silently negate the cluster's mTLS boundary
            self._vsock_server = await vsock_mod.start_server(
                self._tracker.tracked(self._serve_conn), self.vsock_port,
                ssl_context=self.ssl_context,
            )
            logger.info("scheduler rpc also on vsock port %d", self.vsock_port)
        self._tick_task = asyncio.create_task(self._tick_loop())
        if self.topology_collect_interval > 0:
            self._topology_task = asyncio.create_task(self._topology_loop())
        # Run the per-bucket serving programs once off-loop so the first
        # real peers don't pay the card's first-use costs; READY is not
        # delayed (warmup touches no service state — scheduler.py).
        self._warmup_thread = threading.Thread(
            target=self._safe_warmup, name="eval-warmup", daemon=True
        )
        self._warmup_thread.start()
        logger.info("scheduler rpc listening on %s:%d", self.host, self.port)
        return self.host, self.port

    def _safe_warmup(self) -> None:
        try:
            with _on_device(self.service):
                self.service.warmup()
        except Exception:  # noqa: BLE001 - warmup is best-effort
            logger.exception("evaluator warmup failed")

    async def stop(self) -> None:
        for task in (self._tick_task, self._topology_task):
            if task:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        if self._vsock_server:
            self._vsock_server.close()
        if self._server:
            self._server.close()
            # Announce streams are long-lived; cancel their handler tasks
            # before wait_closed() or 3.12 shutdown hangs (utils/conntrack.py).
            await self._tracker.cancel_all()
            await self._server.wait_closed()
        if self._vsock_server:
            await self._vsock_server.wait_closed()
        for w in list(self._writers):
            w.close()
        # Join any in-flight warmup before the interpreter can finalize:
        # a daemon thread still launching on the card when CUDA's and
        # torch's static destructors run can abort the whole process — a
        # SIGTERM inside the cold-start window would exit -6, not 0.
        warm = getattr(self.service, "_shadow_warm_thread", None)
        for t in (self._warmup_thread, warm):
            if t is not None and t.is_alive():
                await asyncio.to_thread(t.join)

    # ---------------------------------------------------------- connection

    async def _serve_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._writers.add(writer)
        owned_peers: set[str] = set()
        owned_hosts: set[str] = set()
        try:
            while True:
                request = await wire.read_frame(reader)
                if request is None:
                    return
                self._m_requests.labels(type(request).__name__).inc()
                health = mux.handle_health_request(request, self.health_check)
                if health is not None:
                    wire.write_frame(writer, health)
                    await writer.drain()
                    continue
                if isinstance(request, msg.AnnounceHostRequest):
                    async with self._lock:
                        self._host_conn[request.host.host_id] = writer
                        owned_hosts.add(request.host.host_id)
                # Propagated deadline budget (rpc/wire.py "dl"): awaited
                # work whose budget is already spent is SHED before it
                # touches the service — the caller stopped waiting, so
                # scheduling it only burns tick capacity (the grpc-timeout
                # contract the reference inherits from its interceptors).
                # Only _SHEDDABLE_RPC_TYPES qualify; lifecycle mutations
                # always execute.
                budget = getattr(request, "deadline_s", None)
                if (
                    budget is not None and budget <= 0
                    and isinstance(request, _SHEDDABLE_RPC_TYPES)
                ):
                    self.resilience_metrics.deadline_shed.labels(
                        type(request).__name__
                    ).inc()
                    if isinstance(request, _SHED_WITH_FAILURE_TYPES):
                        wire.write_frame(writer, msg.ScheduleFailure(
                            peer_id=request.peer_id, code="DeadlineExceeded",
                            description="deadline expired before dispatch",
                        ))
                        await writer.drain()
                    continue
                was_empty = not self.service._pending
                if budget is not None:
                    # re-anchor the remaining budget on this host's clock:
                    # dispatch time decrements it, and any frame the handler
                    # sends onward carries what is left (wire.encode reads
                    # the ambient scope)
                    with resilience.deadline(budget):
                        response = await self._dispatch_locked(
                            request, writer, owned_peers
                        )
                        if response is not None and resilience.expired():
                            self.resilience_metrics.deadline_shed.labels(
                                type(request).__name__
                            ).inc()
                            response = None  # nobody is waiting for this
                else:
                    response = await self._dispatch_locked(request, writer, owned_peers)
                if response is not None:
                    wire.write_frame(writer, response)
                    await writer.drain()
                # Wake ONLY on the empty->nonempty transition: waking while
                # work is already pending would let one unschedulable peer
                # (retrying on the interval cadence by design) turn a busy
                # message stream into back-to-back device scheduling calls.
                if was_empty and self.service._pending:
                    self._tick_wake.set()
                await self._drain_seed_triggers()
        except Exception:  # noqa: BLE001 - one bad conn must not kill the server
            logger.exception("connection handler failed")
        finally:
            self._writers.discard(writer)
            async with self._lock:
                for peer_id in owned_peers:
                    self._peer_conn.pop(peer_id, None)
                    # v1 marking follows the route entry's lifetime, or the
                    # set grows one string per v1 download forever
                    with self._v1_mu:
                        self._v1_peers.discard(peer_id)
                for host_id in owned_hosts:
                    self._host_conn.pop(host_id, None)
            writer.close()

    async def _drain_seed_triggers(self) -> None:
        """Push queued TriggerSeedRequests to their seed hosts' announce
        connections (the scheduler->seed-peer ObtainSeeds edge).

        Triggers that cannot be delivered yet — no seed connected (preheat
        racing the seed's announce), or the write failed mid-flight — are
        held in a server-side pending list and retried on later drains
        until SEED_TRIGGER_TTL_S, NOT silently dropped. The pending list
        lives here (not back in svc.seed_triggers) so the 5ms tick doesn't
        pay two thread hops per tick just to shuttle the same trigger."""
        svc = self.service
        if not svc.seed_triggers and not self._pending_triggers:
            return
        if not self._host_conn and not svc.seed_triggers:
            # nothing can be delivered; just expire long-waiting triggers
            now = time.monotonic()
            still = []
            for trigger in self._pending_triggers:
                if now < self._trigger_deadline.get(trigger.task_id, now + 1):
                    still.append(trigger)
                else:
                    self._trigger_deadline.pop(trigger.task_id, None)
                    logger.warning(
                        "seed trigger for task %s expired after %.0fs with no "
                        "connected seed host", trigger.task_id, SEED_TRIGGER_TTL_S,
                    )
            self._pending_triggers = still
            return

        def pop_triggers():
            # svc.mu may be held by the tick thread through a device call;
            # never block the event loop on it.
            with svc.mu:
                triggers, svc.seed_triggers = svc.seed_triggers, []
                return triggers, list(svc._seed_hosts)

        if svc.seed_triggers:
            triggers, seed_hosts = await asyncio.to_thread(pop_triggers)
        else:
            triggers, seed_hosts = [], list(svc._seed_hosts)
        triggers = self._pending_triggers + triggers
        self._pending_triggers = []
        undeliverable: list = []
        now = time.monotonic()
        for trigger in triggers:
            # Fall back to any connected seed host when the chosen host
            # has no live connection (crashed seed without LeaveHost): a
            # dropped trigger strands no-back-source peers.
            async with self._lock:
                writer = self._host_conn.get(trigger.host_id)
                if writer is None:
                    candidates = [h for h in seed_hosts if h in self._host_conn]
                    if candidates:
                        trigger.host_id = candidates[0]
                        writer = self._host_conn[trigger.host_id]
            delivered = False
            if writer is not None:
                try:
                    wire.write_frame(writer, trigger)
                    await writer.drain()
                    delivered = True
                except (ConnectionError, RuntimeError):
                    logger.warning(
                        "seed trigger to %s failed, will retry", trigger.host_id
                    )
            if delivered:
                self._trigger_deadline.pop(trigger.task_id, None)
                continue
            deadline = self._trigger_deadline.setdefault(
                trigger.task_id, now + SEED_TRIGGER_TTL_S
            )
            if now < deadline:
                undeliverable.append(trigger)
            else:
                self._trigger_deadline.pop(trigger.task_id, None)
                logger.warning(
                    "seed trigger for task %s expired undelivered after %.0fs",
                    trigger.task_id, SEED_TRIGGER_TTL_S,
                )
        self._pending_triggers = undeliverable

    async def _dispatch_locked(self, request, writer, owned_peers: set[str]):
        """Service mutations run off-loop under service.mu so they never
        race the batched tick thread or stall the event loop."""
        # route bookkeeping must happen on-loop (touches asyncio state)
        peer_id = getattr(request, "peer_id", None)
        if peer_id is not None and not isinstance(
            request, (msg.StatPeerRequest, msg.LeavePeerRequest, sv1.V1PeerTarget)
        ):
            async with self._lock:
                self._peer_conn[peer_id] = writer
                owned_peers.add(peer_id)

        # wire-propagated trace context (rpc/wire.py envelope): the
        # handler span continues the CALLER's trace. Untraced traffic and
        # per-piece report types pay nothing — no span, no token_hex, no
        # exporter fan-out. The span wraps service.mu (its duration shows
        # lock contention) and exporters fire only AFTER the lock drops.
        remote_ctx = getattr(request, "trace_context", None)
        traced = remote_ctx is not None and not isinstance(
            request, _UNTRACED_RPC_TYPES
        )

        def run():
            if not traced:
                with self.service.mu, _on_device(self.service):
                    return self._dispatch(request, owned_peers)
            with default_tracer().span(
                f"scheduler.rpc.{type(request).__name__}",
                remote_parent=remote_ctx,
            ):
                with self.service.mu, _on_device(self.service):
                    return self._dispatch(request, owned_peers)

        return await asyncio.to_thread(run)

    def _dispatch(self, request, owned_peers: set[str]):
        svc = self.service
        self._observe_request(request)
        if isinstance(request, msg.AnnounceHostRequest):
            svc.announce_host(request.host)
            return None
        if isinstance(request, msg.LeaveHostRequest):
            svc.leave_host(request.host_id)
            return None
        if isinstance(request, msg.LeavePeerRequest):
            svc.leave_peer(request.peer_id)
            owned_peers.discard(request.peer_id)
            return None
        if isinstance(request, msg.ProbeStartedRequest):
            return self._probe_targets(request)
        if isinstance(request, msg.ProbeFinishedRequest):
            self._probe_finished(request)
            return None
        if isinstance(request, msg.StatPeerRequest):
            return self._stat_peer(request.peer_id)
        if isinstance(request, msg.StatTaskRequest):
            return self._stat_task(request.task_id)
        # manager job edge (cross-process preheat/sync_peers; the
        # machinery hops manager/job/preheat.go:90-286 + job.go:224)
        if isinstance(request, msg.JobTriggerSeedRequest):
            ok = svc.trigger_seed_download(
                task_id=request.task_id, url=request.url,
                piece_length=request.piece_length, tag=request.tag,
                application=request.application, host_id=request.host_id,
                headers=request.headers or None,
            )
            return msg.JobTriggerSeedResponse(
                ok=ok, description="" if ok else "trigger queue full or no seed hosts"
            )
        if isinstance(request, msg.TaskStatesRequest):
            return msg.TaskStatesResponse(states=[
                -1 if s is None else int(s)
                for s in svc.task_states(request.task_ids)
            ])
        if isinstance(request, msg.SchedulerInfoRequest):
            return msg.SchedulerInfoResponse(
                counts=svc.counts(), hosts=svc.list_hosts()
            )
        if isinstance(request, msg.FlightRecorderRequest):
            return msg.FlightRecorderResponse(
                dump=svc.flight_dump(last_n=request.last_n)
            )
        if isinstance(request, sv1.V1_REQUEST_TYPES):
            return self._dispatch_v1(request, owned_peers)
        # announce-stream oneof (routing already recorded on-loop)
        return svc.handle(request)

    def _dispatch_v1(self, request, owned_peers: set[str]):
        """v1-dialect requests (cluster/service_v1.py) translated onto the
        service; immediate v2-shaped answers convert to PeerPacket here,
        tick-delivered ones convert inside the tick thread (under
        service.mu) via the _v1_peers snapshot in _tick_once."""
        v1 = self.v1
        if isinstance(request, sv1.V1PeerTaskRequest):
            with self._v1_mu:
                self._v1_peers.add(request.peer_id)
            return v1.register_peer_task(request)
        if isinstance(request, sv1.V1PieceResult):
            with self._v1_mu:
                self._v1_peers.add(request.src_pid)
            response = v1.report_piece_result(request)
            return v1.to_peer_packet(response) if response is not None else None
        if isinstance(request, sv1.V1PeerResult):
            return v1.report_peer_result(request)
        if isinstance(request, sv1.V1AnnounceTaskRequest):
            v1.announce_task(request)
            return None
        if isinstance(request, sv1.V1PeerTarget):
            v1.leave_task(request)
            owned_peers.discard(request.peer_id)
            with self._v1_mu:
                self._v1_peers.discard(request.peer_id)
            return None
        return None

    def _observe_request(self, request) -> None:
        """Per-RPC totals + traffic/duration series (scheduler/metrics/
        metrics.go:44-454). Runs under service.mu (called from _dispatch),
        so reading _peer_meta/_host_info is race-free."""
        m = self.metrics
        svc = self.service

        def peer_labels(peer_id: str) -> tuple[str, str, str]:
            meta = svc._peer_meta.get(peer_id)
            if meta is None:
                return "", "", "normal"
            info = svc._host_info.get(meta.host_id)
            return meta.tag, meta.application, info.host_type if info else "normal"

        if isinstance(request, msg.RegisterPeerRequest):
            m.register_peer.labels(
                str(request.priority), "STANDARD", request.tag, request.application
            ).inc()
        elif isinstance(request, msg.DownloadPieceFinishedRequest):
            tag, app, host_type = peer_labels(request.peer_id)
            ttype = TRAFFIC_P2P if request.parent_peer_id else TRAFFIC_BACK_TO_SOURCE
            m.download_piece_finished.labels(ttype, "STANDARD", tag, app).inc()
            m.traffic.labels(ttype, "STANDARD", tag, app, host_type).inc(request.length)
            meta = svc._peer_meta.get(request.peer_id)
            if meta is not None:
                m.host_traffic.labels(
                    HOST_TRAFFIC_DOWNLOAD, host_type, meta.host_id
                ).inc(request.length)
            pmeta = svc._peer_meta.get(request.parent_peer_id)
            if pmeta is not None:
                pinfo = svc._host_info.get(pmeta.host_id)
                m.host_traffic.labels(
                    HOST_TRAFFIC_UPLOAD,
                    pinfo.host_type if pinfo else "normal",
                    pmeta.host_id,
                ).inc(request.length)
        elif isinstance(request, msg.DownloadPieceFailedRequest):
            tag, app, _ = peer_labels(request.peer_id)
            m.download_piece_finished_failure.labels(
                TRAFFIC_P2P, "STANDARD", tag, app
            ).inc()
        elif isinstance(
            request,
            (msg.DownloadPeerFinishedRequest, msg.DownloadPeerBackToSourceFinishedRequest),
        ):
            tag, app, _ = peer_labels(request.peer_id)
            m.download_peer_finished.labels("0", "STANDARD", tag, app).inc()
            meta = svc._peer_meta.get(request.peer_id)
            if meta is not None and getattr(meta, "registered_at", 0.0):
                scope = msg.SizeScope.of(request.content_length).name
                m.download_peer_duration.labels(scope).observe(
                    (time.monotonic() - meta.registered_at) * 1e3
                )
        elif isinstance(
            request,
            (msg.DownloadPeerFailedRequest, msg.DownloadPeerBackToSourceFailedRequest),
        ):
            tag, app, _ = peer_labels(request.peer_id)
            m.download_peer_finished_failure.labels("0", "STANDARD", tag, app).inc()
        elif isinstance(request, msg.DownloadPeerBackToSourceStartedRequest):
            tag, app, _ = peer_labels(request.peer_id)
            m.download_peer_back_to_source_started.labels("0", "STANDARD", tag, app).inc()
        elif isinstance(request, msg.StatPeerRequest):
            m.stat_peer.labels().inc()
        elif isinstance(request, msg.LeavePeerRequest):
            m.leave_peer.labels().inc()
        elif isinstance(request, msg.StatTaskRequest):
            m.stat_task.labels().inc()
        elif isinstance(request, msg.AnnounceHostRequest):
            m.announce_host.labels().inc()
        elif isinstance(request, msg.LeaveHostRequest):
            m.leave_host.labels().inc()
        elif isinstance(request, msg.ProbeStartedRequest):
            m.sync_probes.labels().inc()

    # --------------------------------------------------------------- probes

    def _probe_targets(self, request: msg.ProbeStartedRequest) -> msg.ProbeTargetsResponse:
        svc = self.service
        targets: list[msg.ProbeTarget] = []
        if svc.probes is not None:
            src_slot = svc.state.host_index(request.host_id)
            if src_slot is not None:
                alive = svc.state.host_alive_mask()
                alive[src_slot] = False
                # the reference's jax.random.key of the same seed, bit for bit
                key = prng.key(time.time_ns() % (1 << 31))
                for slot in svc.probes.find_probed_hosts(alive, key, request.count):
                    host_id = svc.state.host_id_at(int(slot))
                    info = svc._host_info.get(host_id)
                    if info is not None:
                        targets.append(
                            msg.ProbeTarget(host_id=host_id, ip=info.ip, port=info.port)
                        )
        return msg.ProbeTargetsResponse(targets=targets)

    def _probe_finished(self, request: msg.ProbeFinishedRequest) -> None:
        import numpy as np

        svc = self.service
        if svc.probes is None:
            return
        src = svc.state.host_index(request.host_id)
        if src is None:
            return
        dsts, rtts = [], []
        for r in request.results:
            if not r.ok:
                continue
            dst = svc.state.host_index(r.host_id)
            if dst is not None:
                dsts.append(dst)
                rtts.append(r.rtt_ns)
        if dsts:
            svc.probes.enqueue(
                np.full(len(dsts), src, np.int32),
                np.asarray(dsts, np.int32),
                np.asarray(rtts, np.float32),
            )

    # ----------------------------------------------------------------- stat

    def _stat_peer(self, peer_id: str) -> msg.StatResponse:
        from dragonfly2_tpu_torch.state.fsm import PeerState

        # flush valve: finished_pieces reads the
        # buffered piece-report columns — without this, a StatPeer racing
        # the tick reported a count missing reports already acknowledged
        # to the reporting peer
        self.service.flush_piece_reports()
        idx = self.service.state.peer_index(peer_id)
        if idx is None:
            return msg.StatResponse(found=False)
        return msg.StatResponse(
            found=True,
            state=PeerState(int(self.service.state.peer_state[idx])).display,
            detail={"finished_pieces": int(self.service.state.peer_finished_count[idx])},
        )

    def _stat_task(self, task_id: str) -> msg.StatResponse:
        from dragonfly2_tpu_torch.state.fsm import TaskState

        idx = self.service.state.task_index(task_id)
        if idx is None:
            return msg.StatResponse(found=False)
        return msg.StatResponse(
            found=True,
            state=TaskState(int(self.service.state.task_state[idx])).display,
            detail={
                "total_pieces": int(self.service.state.task_total_pieces[idx]),
                "content_length": int(self.service.state.task_content_length[idx]),
            },
        )

    # ----------------------------------------------------------------- tick

    async def _tick_loop(self) -> None:
        while True:
            # Fire immediately when new work arrives (empty->nonempty wake
            # from the connection handlers); otherwise tick on the interval,
            # which doubles as the retry cadence for still-pending peers and
            # the out-of-band drain cadence. Work arriving DURING a tick
            # leaves the event set, so the next tick runs back-to-back —
            # batching under load happens naturally because each device call
            # takes every pending peer with it.
            try:
                await asyncio.wait_for(self._tick_wake.wait(), timeout=self.tick_interval)
            except asyncio.TimeoutError:
                pass
            self._tick_wake.clear()
            try:
                await self._tick_once()
                # Seed triggers can be enqueued OUT of band (a manager
                # preheat job calls the service directly); per-connection
                # draining alone would leave them stuck until some peer
                # happens to send a message.
                await self._drain_seed_triggers()
                # Interval resource GC rides the same loop (pkg/gc wired
                # into the scheduler bootstrap, scheduler.go:110-299):
                # cheap due-check inline, the actual sweep off-loop since
                # it takes the service lock.
                if self.service.gc_due():
                    swept = await asyncio.to_thread(self._run_gc)
                    if any(swept.values()):
                        logger.info("resource gc reaped %s", swept)
            except Exception:  # noqa: BLE001 - keep ticking
                logger.exception("schedule tick failed")

    async def _topology_loop(self) -> None:
        """The networktopology collect ticker: snapshot the probe graph
        into the trace storage on its own cadence."""
        while True:
            await asyncio.sleep(self.topology_collect_interval)
            try:
                rows = await asyncio.to_thread(self._snapshot_topology)
                logger.debug("network topology snapshot: %d rows", rows)
            except Exception:  # noqa: BLE001 - the next interval retries
                logger.exception("network topology snapshot failed")

    def _snapshot_topology(self) -> int:
        with self.service.mu, _on_device(self.service):
            return self.service.snapshot_topology()

    def _run_gc(self) -> dict:
        with _on_device(self.service):
            return self.service.run_gc()

    async def _tick_once(self) -> None:
        svc = self.service
        pending = len(svc._pending)
        self.metrics.concurrent_schedule.labels().set(pending)
        if pending == 0:
            return
        t0 = time.perf_counter()

        # v1 responses convert to PeerPacket INSIDE the tick thread while
        # service.mu is still held — to_peer_packet reads svc._peer_meta,
        # which dispatch threads mutate, so converting later on the event
        # loop could see a racing leave/GC and emit a packet with an empty
        # task_id. The membership snapshot is ALSO taken
        # under svc.mu: _dispatch_v1 mutates _v1_peers while holding it,
        # so a pre-lock snapshot could miss a v1 peer that registered
        # between snapshot and tick and hand its connection a raw v2 frame.

        def run():
            with svc.mu, _on_device(svc):
                with self._v1_mu:
                    v1_peers = set(self._v1_peers)
                out = []
                for response in svc.tick():
                    peer_id = getattr(response, "peer_id", None)
                    if peer_id in v1_peers:
                        response = self.v1.to_peer_packet(response)
                        if response is None:
                            continue
                    out.append(response)
                return out

        # The device call blocks; run it off-loop so streams stay live.
        # (The per-phase histogram is observed by the service's own
        # PhaseRecorder inside tick() — telemetry/flight.py — so the
        # server no longer re-derives it from the ring.)
        with default_tracer().span("scheduler.tick", pending=pending) as tick_span:
            responses = await asyncio.to_thread(run)
        self._m_tick.labels().observe(time.perf_counter() - t0)
        self._m_batch.labels().observe(pending)
        # Responses carry the tick span's context so the client's piece
        # downloads continue the scheduling trace (one trace id from the
        # tick through the daemon's downloads).
        await self._send_responses(
            responses,
            trace_context={
                "trace_id": tick_span.trace_id, "span_id": tick_span.span_id,
            },
        )

    async def _send_responses(self, responses, trace_context=None) -> None:
        # v1 responses arrive here already converted to V1PeerPacket (the
        # conversion runs in the tick thread under service.mu); a packet
        # routes by its src_pid.
        for response in responses:
            peer_id = getattr(response, "peer_id", None) or getattr(
                response, "src_pid", None
            )
            async with self._lock:
                writer = self._peer_conn.get(peer_id)
            if writer is None:
                continue
            try:
                wire.write_frame(writer, response, trace_context=trace_context)
                await writer.drain()
            except (ConnectionError, RuntimeError):
                async with self._lock:
                    self._peer_conn.pop(peer_id, None)


class TrainerRPCServer:
    """Trainer service edge: the Train client-stream as a socket server.

    Capability parity with trainer/rpcserver/trainer_server_v1.go +
    trainer/service/service_v1.go:59-162: a connection streams TrainRequest
    frames ('download' chunks -> the MLP dataset, 'networktopology' -> the
    GNN dataset, per-host files keyed by host_id), EOF kicks training off
    the event loop, errors clear only that host's partial files, and the
    single TrainResponse reports the outcome."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 health_check=None, ssl_context=None):
        self.service = service  # TrainerService (cluster/trainer_service.py)
        self.health_check = health_check
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self._server: asyncio.AbstractServer | None = None
        self._writers: set[asyncio.StreamWriter] = set()
        self._tracker = ConnTracker()
        reg = default_registry()
        self.metrics = trainer_series(reg)
        register_version(reg, "trainer")
        self._m_chunks = self.metrics.train_chunks
        self._m_trains = self.metrics.train_runs

    async def start(self) -> tuple[str, int]:
        self.service.stop.clear()  # a service outlives a stopped server
        self._server = await asyncio.start_server(
            self._tracker.tracked(self._serve_conn), self.host, self.port,
            ssl=self.ssl_context,
        )
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        logger.info("trainer rpc listening on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        # A training in flight runs on a worker thread that cancelling its
        # handler cannot reach, and the interpreter joins that thread at
        # exit: the service's stop event ends it at its next step
        # (training/train.py TrainingAborted), so SIGTERM exits promptly.
        self.service.stop.set()
        if self._server:
            self._server.close()
            # Cancel live Train streams before wait_closed() (3.12 waits on
            # every in-flight handler; utils/conntrack.py).
            await self._tracker.cancel_all()
            await self._server.wait_closed()
        for w in list(self._writers):
            w.close()

    async def _serve_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._writers.add(writer)
        host_id = None
        # trace context from the upload stream's frames (rpc/wire.py): the
        # training run parents on the announcer/scheduler span that sent
        # the datasets — one trace id across the announce->train edge
        remote_ctx = None
        try:
            committed = False
            while True:
                request = await wire.read_frame(reader)
                if request is None:
                    # Bare EOF before the TrainEndRequest commit marker: the
                    # connection tore (read_frame folds ConnectionError into
                    # None) — never train on a possibly-truncated dataset.
                    break
                if remote_ctx is None:
                    remote_ctx = getattr(request, "trace_context", None)
                health = mux.handle_health_request(request, self.health_check)
                if health is not None:
                    wire.write_frame(writer, health)
                    await writer.drain()
                    continue
                if isinstance(request, msg.TrainEndRequest):
                    host_id = request.host_id or host_id
                    committed = True
                    break
                if not isinstance(request, msg.TrainRequest):
                    await self._abort_reply(
                        reader, writer, host_id, "expected TrainRequest"
                    )
                    return
                host_id = request.host_id
                self._m_chunks.labels(request.dataset).inc()
                try:
                    if request.dataset == "download":
                        self.service.train_mlp_chunk(host_id, request.chunk)
                    elif request.dataset == "networktopology":
                        self.service.train_gnn_chunk(host_id, request.chunk)
                    else:
                        raise ValueError(f"unknown dataset {request.dataset!r}")
                except Exception as e:  # noqa: BLE001 - reply, don't kill server
                    await self._abort_reply(reader, writer, host_id, str(e))
                    return
            if not committed:
                if host_id is not None:
                    self.service.train_abort(host_id)
                    self._m_trains.labels("aborted").inc()
                return  # torn connection: nobody is listening for a reply
            if host_id is None:
                wire.write_frame(writer, msg.TrainResponse(ok=False, description="empty stream"))
                await writer.drain()
                return
            # commit -> train both models off-loop (service_v1.go:155 goroutine)
            try:
                with default_tracer().span(
                    "trainer.train_ingest", remote_parent=remote_ctx,
                    host_id=host_id,
                ):
                    outcome = await asyncio.to_thread(self._train_finish, host_id)
                self._m_trains.labels("succeeded").inc()
                self.metrics.training.labels().inc()
                parts = []
                if outcome.gnn is not None:
                    parts.append(f"gnn v{outcome.gnn.version}")
                if outcome.mlp is not None:
                    parts.append(f"mlp v{outcome.mlp.version}")
                wire.write_frame(
                    writer, msg.TrainResponse(ok=True, description=", ".join(parts))
                )
            except Exception as e:  # noqa: BLE001
                self.service.train_abort(host_id)
                self._m_trains.labels("failed").inc()
                self.metrics.training_failure.labels().inc()
                wire.write_frame(writer, msg.TrainResponse(ok=False, description=str(e)))
            await writer.drain()
        except Exception:  # noqa: BLE001 - one bad conn must not kill the server
            logger.exception("trainer connection handler failed")
            if host_id is not None:
                self.service.train_abort(host_id)
        finally:
            self._writers.discard(writer)
            writer.close()

    def _train_finish(self, host_id: str):
        from dragonfly2_tpu_torch.training.train import TrainingAborted

        with _on_device(self.service):
            try:
                return self.service.train_finish(host_id)
            except TrainingAborted:
                logger.info("training for %s aborted: the trainer is stopping", host_id)
                raise

    async def _abort_reply(self, reader, writer, host_id, description: str) -> None:
        """Mid-stream error: clear the host's partial files, reply, then
        drain the client's remaining frames so the error response isn't
        lost to a connection reset while the client is still writing."""
        if host_id is not None:
            self.service.train_abort(host_id)
        self._m_trains.labels("aborted").inc()
        wire.write_frame(writer, msg.TrainResponse(ok=False, description=description))
        await writer.drain()
        while await wire.read_frame(reader) is not None:
            pass
