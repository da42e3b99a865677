"""Port of dragonfly2_tpu/cluster/messages.py, whole.

Scheduler control-plane message set — the AnnouncePeer v2 oneof as typed
dataclasses.

Capability parity with the d7y.io/api schedulerv2 message set consumed by
scheduler/service/service_v2.go:89-204 (RegisterPeerRequest,
DownloadPieceFinished/Failed, DownloadPeerFinished/Failed,
DownloadPeerBackToSourceStarted, Reschedule) and the responses the
scheduling loop sends (NormalTaskResponse with candidate parents,
NeedBackToSourceResponse, scheduling.go:85-213). Transport-neutral: the
asyncio gRPC edge (cluster/rpc.py) and in-proc tests both speak these.
"""

from __future__ import annotations

import dataclasses
import enum

from dragonfly2_tpu_torch.records.schema import CPUStat, DiskStat, MemoryStat


class SizeScope(enum.IntEnum):
    """Task size classes driving the register fast paths
    (service_v1.go:1005-1110 / service_v2 handleRegisterPeerRequest)."""

    NORMAL = 0
    SMALL = 1
    TINY = 2
    EMPTY = 3

    @staticmethod
    def of(content_length: int, piece_length: int = 4 << 20) -> "SizeScope":
        if content_length == 0:
            return SizeScope.EMPTY
        if content_length <= 128:  # TinyFileSize
            return SizeScope.TINY
        if content_length <= piece_length:
            return SizeScope.SMALL
        return SizeScope.NORMAL


@dataclasses.dataclass
class HostInfo:
    host_id: str
    hostname: str = ""
    ip: str = ""
    host_type: str = "normal"
    idc: str = ""
    location: str = ""
    port: int = 8002
    download_port: int = 8001
    concurrent_upload_limit: int = 50
    upload_count: int = 0
    upload_failed_count: int = 0
    # Live resource stats sampled by the daemon at announce time
    # (announcer.go:186-252 gopsutil) — the host feature columns of the
    # training CSV; location/idc already ride the fields above.
    cpu: CPUStat = dataclasses.field(default_factory=CPUStat)
    memory: MemoryStat = dataclasses.field(default_factory=MemoryStat)
    disk: DiskStat = dataclasses.field(default_factory=DiskStat)
    tcp_connection_count: int = 0
    upload_tcp_connection_count: int = 0


@dataclasses.dataclass
class RegisterPeerRequest:
    peer_id: str
    task_id: str
    host: HostInfo
    url: str = ""
    content_length: int = -1  # -1 unknown
    piece_length: int = 4 << 20
    total_piece_count: int = 0
    priority: int = 0
    tag: str = ""
    application: str = ""
    # Mid-task re-announce (failure-domain failover): pieces this peer
    # ALREADY holds on disk. A daemon that failed over to another
    # scheduler — or re-dialed a restarted one — announces its kept
    # progress so the scheduler adopts the partial download instead of
    # treating it as a brand-new peer; a seed answering a trigger for a
    # task it has fully cached announces all pieces, becoming a parent
    # without moving a byte.
    finished_pieces: list[int] | None = None


@dataclasses.dataclass
class DownloadPieceFinishedRequest:
    peer_id: str
    piece_number: int
    length: int
    cost_ns: int
    parent_peer_id: str = ""
    # Per-piece md5 (pkg/digest dialect). The scheduler TRUSTS this only
    # on back-to-source reports (parent_peer_id == ""): the origin/seed
    # fetch is the trust anchor of the task's digest chain — a
    # parent-relayed digest is what the chain exists to check.
    digest: str = ""


@dataclasses.dataclass
class DownloadPieceFailedRequest:
    peer_id: str
    parent_peer_id: str
    temporary: bool = True
    # failure attribution: "" = transport/serve error (blocklist only),
    # "corruption" = the piece's bytes failed digest verification against
    # the scheduler-attested chain — the scheduler quarantines the parent
    reason: str = ""


@dataclasses.dataclass
class DownloadPeerFinishedRequest:
    peer_id: str
    content_length: int = 0
    piece_count: int = 0


@dataclasses.dataclass
class DownloadPeerFailedRequest:
    peer_id: str
    description: str = ""


@dataclasses.dataclass
class DownloadPeerBackToSourceStartedRequest:
    peer_id: str
    description: str = ""


@dataclasses.dataclass
class DownloadPeerBackToSourceFinishedRequest:
    peer_id: str
    content_length: int = 0
    piece_count: int = 0
    # whole-task sha256 computed by the origin fetcher at mark_done — the
    # root of the task's digest chain (children verify it at completion)
    task_digest: str = ""


@dataclasses.dataclass
class DownloadPeerBackToSourceFailedRequest:
    peer_id: str
    description: str = ""


@dataclasses.dataclass
class RescheduleRequest:
    peer_id: str
    candidate_parent_ids: list[str] = dataclasses.field(default_factory=list)
    description: str = ""


# --------------------------------------------------------------- responses

@dataclasses.dataclass
class CandidateParent:
    peer_id: str
    host_id: str
    ip: str
    port: int
    download_port: int
    state: str
    score: float


@dataclasses.dataclass
class NormalTaskResponse:
    peer_id: str
    candidate_parents: list[CandidateParent]
    # Scheduler-ATTESTED digest chain for the task (origin-reported piece
    # md5s keyed by STRINGIFIED piece number — the wire codec's hardened
    # msgpack unpack refuses int map keys — plus the whole-task sha256).
    # The child verifies every parent-fetched piece against these: the
    # parent's X-Dragonfly-Piece-Digest header is advisory once an
    # attested digest exists, so a parent that lies consistently (header
    # matching its corrupted bytes) is still caught. Empty until the
    # origin fetch reports the chain.
    piece_digests: dict = dataclasses.field(default_factory=dict)
    task_digest: str = ""


@dataclasses.dataclass
class NeedBackToSourceResponse:
    peer_id: str
    description: str


@dataclasses.dataclass
class EmptyTaskResponse:
    peer_id: str


@dataclasses.dataclass
class ScheduleFailure:
    peer_id: str
    code: str
    description: str


# ------------------------------------------------- host + probe streams

@dataclasses.dataclass
class AnnounceHostRequest:
    host: HostInfo


@dataclasses.dataclass
class LeaveHostRequest:
    host_id: str


@dataclasses.dataclass
class LeavePeerRequest:
    peer_id: str


@dataclasses.dataclass
class ProbeStartedRequest:
    """SyncProbes: daemon asks which hosts to ping (service_v2.go:675)."""

    host_id: str
    count: int = 10


@dataclasses.dataclass
class ProbeTarget:
    host_id: str
    ip: str
    port: int


@dataclasses.dataclass
class ProbeTargetsResponse:
    targets: list[ProbeTarget]


@dataclasses.dataclass
class ProbeResult:
    host_id: str
    rtt_ns: int
    ok: bool = True


@dataclasses.dataclass
class ProbeFinishedRequest:
    host_id: str
    results: list[ProbeResult]


# ------------------------------------------------------ seed-peer trigger

@dataclasses.dataclass
class TriggerSeedRequest:
    """Scheduler -> seed daemon: download this task from origin so the
    cluster has a parent (resource/seed_peer.go:101 TriggerTask /
    cdnsystem ObtainSeeds, client rpcserver/seeder.go:53). Pushed over the
    seed host's announce connection."""

    host_id: str
    task_id: str
    url: str
    piece_length: int = 4 << 20
    tag: str = ""
    application: str = ""
    # auth/extra headers for the back-source fetch (image preheat carries
    # the registry bearer token here, manager/job/preheat.go:297-311)
    headers: dict = dataclasses.field(default_factory=dict)


# --------------------------------------------- scheduler fleet handoff

@dataclasses.dataclass
class PeerHandoffRequest:
    """Scheduler -> scheduler: adopt an in-flight peer whose task's ring
    owner moved (replica crash/restart or a rolling-upgrade restart
    rebalancing the consistent hashring — the fleet analogue of the
    daemon-side failover walk over ``HashRing.successors``). Carries
    everything the new owner needs to re-register the peer as a
    load-not-create plus the pieces the daemon kept on disk, so the
    receiving scheduler ADOPTS the partial download through the same
    ``RegisterPeerRequest.finished_pieces`` path instead of restarting
    it. New fields must default (add-field-with-default wire
    discipline): an N-1 scheduler that drops them still performs a
    correct, if less attributed, adoption."""

    peer_id: str
    task_id: str
    host: HostInfo
    url: str = ""
    content_length: int = -1
    piece_length: int = 4 << 20
    total_piece_count: int = 0
    tag: str = ""
    application: str = ""
    # pieces the peer holds at handoff time (None = unknown/none): the
    # adoption payload, same semantics as RegisterPeerRequest
    finished_pieces: list[int] | None = None
    # provenance for per-shard attribution: which replica released the
    # peer and why ("crash" | "upgrade" | "rebalance")
    from_scheduler: str = ""
    reason: str = ""


# ------------------------------------------------------ manager job edge

@dataclasses.dataclass
class JobTriggerSeedRequest:
    """Manager -> scheduler: enqueue a preheat seed trigger (the
    machinery preheat job hop, manager/job/preheat.go:90-286 ->
    scheduler/job.go:152). host_id empty = the scheduler round-robins
    its own announced seed hosts."""

    task_id: str
    url: str
    piece_length: int = 4 << 20
    tag: str = ""
    application: str = ""
    host_id: str = ""
    headers: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class JobTriggerSeedResponse:
    ok: bool
    description: str = ""


@dataclasses.dataclass
class TaskStatesRequest:
    """Manager -> scheduler: poll task FSM states for job progress
    (the machinery group-state poll, internal/job/job.go:53-87)."""

    task_ids: list[str]


@dataclasses.dataclass
class TaskStatesResponse:
    # state int per requested task id; -1 = unknown to this scheduler
    states: list[int]


@dataclasses.dataclass
class SchedulerInfoRequest:
    """Manager -> scheduler: entity counts + announced hosts (the
    sync_peers job's per-scheduler collection, scheduler/job/job.go:224)."""


@dataclasses.dataclass
class SchedulerInfoResponse:
    counts: dict
    hosts: list


@dataclasses.dataclass
class FlightRecorderRequest:
    """Manager/operator -> scheduler: dump the in-product flight recorder
    (telemetry/flight.py — last-N tick phase breakdowns, jit compile/
    retrace counters, spans currently open)."""

    last_n: int = 64


@dataclasses.dataclass
class FlightRecorderResponse:
    dump: dict = dataclasses.field(default_factory=dict)


# ----------------------------------------------------------------- stat

@dataclasses.dataclass
class StatPeerRequest:
    peer_id: str


@dataclasses.dataclass
class StatTaskRequest:
    task_id: str


@dataclasses.dataclass
class StatResponse:
    found: bool
    state: str = ""
    detail: dict = dataclasses.field(default_factory=dict)


# ------------------------------------------------------- trainer stream

@dataclasses.dataclass
class TrainRequest:
    """One chunk of the scheduler->trainer dataset upload
    (trainer/service/service_v1.go:59-162; 128 MiB chunks announcer.go:40).
    dataset is 'download' or 'networktopology'."""

    host_id: str
    ip: str
    hostname: str
    dataset: str
    chunk: bytes


@dataclasses.dataclass
class TrainEndRequest:
    """Explicit end-of-upload commit marker. A torn connection shows up as
    bare EOF, which the trainer treats as an abort; only this frame starts
    training — the role CloseSend/io.EOF separation plays in the reference
    (trainer/service/service_v1.go stream handling)."""

    host_id: str = ""


@dataclasses.dataclass
class TrainResponse:
    ok: bool
    description: str = ""
