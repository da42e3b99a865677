"""Scheduler v1 compat surface — the schedulerv1 dialect as an adapter.

Port of dragonfly2_tpu/cluster/service_v1.py, whole: the same
dataclasses under the same wire names, so a v1 frame either package
encodes decodes in the other.

Capability parity with the reference's V1 service
(scheduler/service/service_v1.go): RegisterPeerTask (:95),
ReportPieceResult (:187, the bidi piece stream answered with PeerPacket
parent reassignments), ReportPeerResult (:294), AnnounceTask (:349),
StatTask (:434), LeaveTask (:457). The reference serves BOTH protocol
generations against one resource layer; this repo's native protocol is
the v2-shaped message set (cluster/messages.py), and this module closes
the gap the same way: v1-dialect dataclasses over the same wire codec,
each translated onto the existing SchedulerService handlers, scheduling
responses translated back into v1 ``PeerPacket`` frames
(rpc/server.py routes per-peer responses through ``to_peer_packet`` for
connections that registered via v1).

Size-scope mapping (service_v1.go:1005-1110): EMPTY short-circuits at
register like the reference's registerEmptyTask; TINY/SMALL register and
take the normal scheduling path — the reference itself falls back to
registerNormalTask whenever the direct piece / single parent is not
available (:1021-1110), and this scheduler never holds piece bytes.

Codes mirror the public api common.proto v1 enum semantics the v1
clients switch on (Success / SchedError / SchedNeedBackSource /
SchedPeerGone).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.state.fsm import PeerState, TaskState
from dragonfly2_tpu_torch.utils import idgen

# pkg/rpc/common/common.go:20-24
BEGIN_OF_PIECE = -1
END_OF_PIECE = 1 << 30

# api common.proto v1 Code values the v1 dialect switches on
CODE_SUCCESS = 200
CODE_SCHED_ERROR = 5000
CODE_SCHED_NEED_BACK_SOURCE = 5001
CODE_SCHED_PEER_GONE = 5002
# client-side piece verification failure (the common.proto client-error
# band): a v1 peer reporting this code means the piece's bytes failed its
# digest check — translated onto the v2 reason="corruption" quarantine
# path, mirroring the reference's md5-mismatch piece-result handling.
CODE_CLIENT_PIECE_MD5_NOT_MATCHED = 4004


@dataclasses.dataclass
class V1PeerHost:
    """schedulerv1.PeerHost."""

    id: str
    ip: str = ""
    rpc_port: int = 8002
    down_port: int = 8001
    host_name: str = ""
    security_domain: str = ""
    location: str = ""
    idc: str = ""


@dataclasses.dataclass
class V1UrlMeta:
    """commonv1.UrlMeta."""

    digest: str = ""
    tag: str = ""
    range: str = ""
    filter: str = ""
    application: str = ""
    priority: int = 0


@dataclasses.dataclass
class V1PeerTaskRequest:
    """schedulerv1.PeerTaskRequest (RegisterPeerTask input)."""

    url: str
    peer_id: str
    peer_host: V1PeerHost
    url_meta: V1UrlMeta = dataclasses.field(default_factory=V1UrlMeta)
    task_id: str = ""
    is_migrating: bool = False
    prefetch: bool = False


@dataclasses.dataclass
class V1RegisterResult:
    task_id: str
    size_scope: int = int(msg.SizeScope.NORMAL)
    code: int = CODE_SUCCESS


@dataclasses.dataclass
class V1PieceInfo:
    """commonv1.PieceInfo (the subset the scheduler consumes)."""

    piece_num: int = 0
    range_start: int = 0
    range_size: int = 0
    piece_md5: str = ""
    piece_offset: int = 0
    download_cost: int = 0  # milliseconds, like the reference's cost field


@dataclasses.dataclass
class V1PieceResult:
    """schedulerv1.PieceResult — one frame of the ReportPieceResult stream."""

    task_id: str
    src_pid: str
    dst_pid: str = ""
    success: bool = False
    code: int = CODE_SUCCESS
    piece_info: V1PieceInfo = dataclasses.field(default_factory=V1PieceInfo)
    finished_count: int = 0

    @property
    def peer_id(self) -> str:  # server routing key (rpc/server.py)
        return self.src_pid


@dataclasses.dataclass
class V1DestPeer:
    ip: str
    rpc_port: int
    peer_id: str


@dataclasses.dataclass
class V1PeerPacket:
    """schedulerv1.PeerPacket — the scheduling answer streamed to a v1 peer."""

    task_id: str
    src_pid: str
    parallel_count: int = 1
    # typing.Optional (not PEP-604 `| None`): the wire codec resolves
    # Optional through typing.get_origin == typing.Union (rpc/wire.py)
    main_peer: typing.Optional[V1DestPeer] = None
    candidate_peers: list[V1DestPeer] = dataclasses.field(default_factory=list)
    code: int = CODE_SUCCESS


@dataclasses.dataclass
class V1PeerResult:
    """schedulerv1.PeerResult (ReportPeerResult input)."""

    task_id: str
    peer_id: str
    src_ip: str = ""
    traffic: int = 0
    cost: int = 0
    success: bool = False
    code: int = CODE_SUCCESS
    total_piece_count: int = 0
    content_length: int = -1


@dataclasses.dataclass
class V1PeerTarget:
    """schedulerv1.PeerTarget (LeaveTask input)."""

    task_id: str
    peer_id: str


@dataclasses.dataclass
class V1AnnounceTaskRequest:
    """schedulerv1.AnnounceTaskRequest: a peer already holds the whole
    task (dfcache import path) — the scheduler records host+task+peer as
    SUCCEEDED so the peer is immediately schedulable as a parent."""

    task_id: str
    url: str
    peer_host: V1PeerHost
    peer_id: str
    url_meta: V1UrlMeta = dataclasses.field(default_factory=V1UrlMeta)
    total_piece_count: int = 0
    content_length: int = -1


@dataclasses.dataclass
class V1Task:
    """schedulerv1.Task (StatTask response)."""

    id: str
    type: int = 0
    content_length: int = -1
    total_piece_count: int = 0
    state: str = ""
    peer_count: int = 0
    has_available_peer: bool = False


class SchedulerServiceV1:
    """Translates the v1 dialect onto a SchedulerService instance. All
    methods expect the caller to hold service.mu (the RPC server's
    dispatch already does)."""

    def __init__(self, service):
        self.svc = service

    @staticmethod
    def _host_info(peer_host: V1PeerHost) -> msg.HostInfo:
        return msg.HostInfo(
            host_id=peer_host.id,
            hostname=peer_host.host_name,
            ip=peer_host.ip,
            port=peer_host.rpc_port,
            download_port=peer_host.down_port,
            idc=peer_host.idc,
            location=peer_host.location,
        )

    # ----------------------------------------------------------- register

    def register_peer_task(self, req: V1PeerTaskRequest) -> V1RegisterResult:
        """service_v1.go:95 — store task/host/peer, trigger the seed on a
        cold task, answer the size scope. Content length is unknown at v1
        register time (the origin probe lives client-side), so only an
        explicitly-empty range registers EMPTY; everything else schedules
        as NORMAL, the reference's own fallback for missing direct
        pieces (:1021-1110)."""
        task_id = req.task_id or idgen.task_id_v1(
            req.url,
            tag=req.url_meta.tag,
            application=req.url_meta.application,
            filtered_query_params=req.url_meta.filter,
        )
        host = self._host_info(req.peer_host)
        v2 = msg.RegisterPeerRequest(
            peer_id=req.peer_id,
            task_id=task_id,
            host=host,
            url=req.url,
            priority=req.url_meta.priority,
            tag=req.url_meta.tag,
            application=req.url_meta.application,
        )
        response = self.svc.register_peer(v2)
        if isinstance(response, msg.EmptyTaskResponse):
            return V1RegisterResult(task_id=task_id, size_scope=int(msg.SizeScope.EMPTY))
        return V1RegisterResult(task_id=task_id, size_scope=int(msg.SizeScope.NORMAL))

    # -------------------------------------------------------- piece stream

    def report_piece_result(self, res: V1PieceResult):
        """service_v1.go:187 — one piece frame. Returns a v2-shaped
        response (or None); the caller converts tick/stream responses for
        v1 connections with `to_peer_packet`. Success frames land in the
        scheduler's buffered piece-report ingestion (absorbed into the
        SoA columns once per tick, report_ingest phase) — the v1 stream
        shares the columnar control plane with v2."""
        num = res.piece_info.piece_num
        if num == BEGIN_OF_PIECE:
            # handleBeginOfPiece (:1122): Received -> Running happens on
            # the v2 register path already; nothing to replay.
            return None
        if num == END_OF_PIECE:
            return None  # handleEndOfPiece is a no-op (:1156)
        if res.success:
            return self.svc.handle(msg.DownloadPieceFinishedRequest(
                peer_id=res.src_pid,
                piece_number=num,
                parent_peer_id=res.dst_pid,
                length=res.piece_info.range_size,
                cost_ns=int(res.piece_info.download_cost) * 1_000_000,
            ))
        # handlePieceFailure (:1210): blocklist the failed parent and
        # reschedule — the v2 piece-failed handler does exactly that. An
        # md5-mismatch code rides through as reason="corruption" so v1
        # peers feed the same quarantine path as v2 ones.
        return self.svc.handle(msg.DownloadPieceFailedRequest(
            peer_id=res.src_pid,
            parent_peer_id=res.dst_pid,
            reason=(
                "corruption"
                if res.code == CODE_CLIENT_PIECE_MD5_NOT_MATCHED else ""
            ),
        ))

    # ------------------------------------------------------- final result

    def report_peer_result(self, res: V1PeerResult):
        """service_v1.go:294 — route by success x back-to-source, exactly
        the reference's four-way dispatch onto the v2 handlers."""
        idx = self.svc.state.peer_index(res.peer_id)
        if idx is None:
            return V1PeerPacket(
                task_id=res.task_id, src_pid=res.peer_id, code=CODE_SCHED_PEER_GONE
            )
        back_to_source = (
            self.svc.state.peer_state[idx] == int(PeerState.BACK_TO_SOURCE)
        )
        if res.success:
            if back_to_source:
                self.svc.handle(msg.DownloadPeerBackToSourceFinishedRequest(
                    peer_id=res.peer_id, piece_count=res.total_piece_count,
                ))
            else:
                self.svc.handle(msg.DownloadPeerFinishedRequest(peer_id=res.peer_id))
        elif back_to_source:
            self.svc.handle(msg.DownloadPeerBackToSourceFailedRequest(peer_id=res.peer_id))
        else:
            self.svc.handle(msg.DownloadPeerFailedRequest(peer_id=res.peer_id))
        return None

    # ------------------------------------------------------------- others

    def announce_task(self, req: V1AnnounceTaskRequest) -> None:
        """service_v1.go:349 — register host/task/peer and drive both to
        SUCCEEDED so the announced replica serves immediately."""
        host = self._host_info(req.peer_host)
        self.svc.register_peer(msg.RegisterPeerRequest(
            peer_id=req.peer_id,
            task_id=req.task_id,
            host=host,
            url=req.url,
            content_length=max(req.content_length, -1),
            total_piece_count=req.total_piece_count,
            priority=1,  # no seed trigger for an already-complete replica
            tag=req.url_meta.tag,
            application=req.url_meta.application,
        ))
        idx = self.svc.state.peer_index(req.peer_id)
        if idx is not None:
            # one columnar batch instead of a per-piece record_piece loop
            # (an announced replica can carry thousands of pieces)
            n = max(req.total_piece_count, 1)
            self.svc.state.record_pieces_batch(
                np.full(n, int(idx), np.int64), np.arange(n), np.zeros(n)
            )
        self.svc.handle(msg.DownloadPeerFinishedRequest(peer_id=req.peer_id))

    def stat_task(self, req: msg.StatTaskRequest) -> V1Task:
        """service_v1.go:434."""
        st = self.svc.state
        idx = st.task_index(req.task_id)
        if idx is None:
            return V1Task(id=req.task_id, state="", peer_count=0)
        peers = self.svc._task_peers.get(req.task_id, [])
        has_available = False
        for pid in peers:
            pidx = st.peer_index(pid)
            if pidx is not None and st.peer_state[pidx] == int(PeerState.SUCCEEDED):
                has_available = True
                break
        return V1Task(
            id=req.task_id,
            content_length=int(st.task_content_length[idx]),
            total_piece_count=int(st.task_total_pieces[idx]),
            state=TaskState(int(st.task_state[idx])).name,
            peer_count=len(peers),
            has_available_peer=has_available,
        )

    def leave_task(self, req: V1PeerTarget) -> None:
        """service_v1.go:457 — the peer leaves the task's swarm."""
        self.svc.leave_peer(req.peer_id)

    # ---------------------------------------------------------- responses

    def to_peer_packet(self, response) -> V1PeerPacket | None:
        """v2 scheduling response -> v1 PeerPacket for v1 connections."""
        if isinstance(response, msg.NormalTaskResponse):
            peers = [
                V1DestPeer(ip=p.ip, rpc_port=p.port, peer_id=p.peer_id)
                for p in response.candidate_parents
            ]
            meta = self.svc._peer_meta.get(response.peer_id)
            return V1PeerPacket(
                task_id=meta.task_id if meta else "",
                src_pid=response.peer_id,
                parallel_count=max(len(peers), 1),
                main_peer=peers[0] if peers else None,
                candidate_peers=peers[1:],
                code=CODE_SUCCESS,
            )
        if isinstance(response, msg.NeedBackToSourceResponse):
            meta = self.svc._peer_meta.get(response.peer_id)
            return V1PeerPacket(
                task_id=meta.task_id if meta else "",
                src_pid=response.peer_id,
                code=CODE_SCHED_NEED_BACK_SOURCE,
            )
        if isinstance(response, msg.ScheduleFailure):
            return V1PeerPacket(
                task_id="", src_pid=response.peer_id, code=CODE_SCHED_ERROR
            )
        if isinstance(response, msg.EmptyTaskResponse):
            return V1PeerPacket(
                task_id="", src_pid=response.peer_id, code=CODE_SUCCESS
            )
        return None


V1_REQUEST_TYPES = (
    V1PeerTaskRequest,
    V1PieceResult,
    V1PeerResult,
    V1PeerTarget,
    V1AnnounceTaskRequest,
)


# Register the dialect with the wire codec at import time (like
# rpc/inference.py does for its message set): any client or server that
# imports this module can speak it without also importing rpc/server.
# register_module picks up every dataclass defined here, so a future V1
# message cannot be forgotten from a hand-maintained list.
import sys as _sys  # noqa: E402

from dragonfly2_tpu_torch.rpc import wire as _wire  # noqa: E402

_wire.register_module(_sys.modules[__name__])
