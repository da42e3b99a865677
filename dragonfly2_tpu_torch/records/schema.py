"""Trace record schemas — the training dataset's shape.

A copy of the record dataclasses of dragonfly2_tpu/records/schema.py
(its CSV flatten/unflatten codec is not ported yet). Capability parity
with the upstream scheduler/storage/types.go: ``Download`` (:189-225, peer
+ task + host features, up to 20 ``Parent``s each with up to 10 ``Piece``
costs) and ``NetworkTopology`` (:285-297, ``SrcHost`` + up to 5
``DestHost``s with EWMA ``Probes.AverageRTT``), with host stat sub-structs
from scheduler/resource/host.go:210-330. Ragged reality (fewer parents or
pieces) becomes zero-padded arrays and masks in records/features.py.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CPUStat:
    logical_count: int = 0
    physical_count: int = 0
    percent: float = 0.0
    process_percent: float = 0.0


@dataclasses.dataclass
class MemoryStat:
    total: int = 0
    available: int = 0
    used: int = 0
    used_percent: float = 0.0
    process_used: int = 0
    free: int = 0


@dataclasses.dataclass
class NetworkStat:
    tcp_connection_count: int = 0
    upload_tcp_connection_count: int = 0
    location: str = ""
    idc: str = ""


@dataclasses.dataclass
class DiskStat:
    total: int = 0
    free: int = 0
    used: int = 0
    used_percent: float = 0.0
    inodes_total: int = 0
    inodes_used: int = 0
    inodes_free: int = 0
    inodes_used_percent: float = 0.0


@dataclasses.dataclass
class BuildInfo:
    git_version: str = ""
    git_commit: str = ""
    go_version: str = ""
    platform: str = ""


@dataclasses.dataclass
class TaskRecord:
    id: str = ""
    url: str = ""
    type: str = ""
    content_length: int = 0
    total_piece_count: int = 0
    back_to_source_limit: int = 0
    back_to_source_peer_count: int = 0
    state: str = ""
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class HostRecord:
    id: str = ""
    type: str = ""
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    os: str = ""
    platform: str = ""
    platform_family: str = ""
    platform_version: str = ""
    kernel_version: str = ""
    concurrent_upload_limit: int = 0
    concurrent_upload_count: int = 0
    upload_count: int = 0
    upload_failed_count: int = 0
    cpu: CPUStat = dataclasses.field(default_factory=CPUStat)
    memory: MemoryStat = dataclasses.field(default_factory=MemoryStat)
    network: NetworkStat = dataclasses.field(default_factory=NetworkStat)
    disk: DiskStat = dataclasses.field(default_factory=DiskStat)
    build: BuildInfo = dataclasses.field(default_factory=BuildInfo)
    scheduler_cluster_id: int = 0
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class PieceRecord:
    length: int = 0
    cost: int = 0  # nanoseconds
    created_at: int = 0


@dataclasses.dataclass
class ParentRecord:
    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    cost: int = 0
    upload_piece_count: int = 0
    finished_piece_count: int = 0
    host: HostRecord = dataclasses.field(default_factory=HostRecord)
    pieces: list[PieceRecord] = dataclasses.field(default_factory=list)  # maxlen 10
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class ErrorRecord:
    code: str = ""
    message: str = ""


@dataclasses.dataclass
class DownloadRecord:
    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    error: ErrorRecord = dataclasses.field(default_factory=ErrorRecord)
    cost: int = 0
    finished_piece_count: int = 0
    task: TaskRecord = dataclasses.field(default_factory=TaskRecord)
    host: HostRecord = dataclasses.field(default_factory=HostRecord)
    parents: list[ParentRecord] = dataclasses.field(default_factory=list)  # maxlen 20
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class ProbesRecord:
    average_rtt: int = 0  # nanoseconds, EWMA
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class SrcHostRecord:
    id: str = ""
    type: str = ""
    hostname: str = ""
    ip: str = ""
    port: int = 0
    network: NetworkStat = dataclasses.field(default_factory=NetworkStat)


@dataclasses.dataclass
class DestHostRecord:
    id: str = ""
    type: str = ""
    hostname: str = ""
    ip: str = ""
    port: int = 0
    network: NetworkStat = dataclasses.field(default_factory=NetworkStat)
    probes: ProbesRecord = dataclasses.field(default_factory=ProbesRecord)


@dataclasses.dataclass
class NetworkTopologyRecord:
    id: str = ""
    host: SrcHostRecord = dataclasses.field(default_factory=SrcHostRecord)
    dest_hosts: list[DestHostRecord] = dataclasses.field(default_factory=list)  # maxlen 5
    created_at: int = 0

