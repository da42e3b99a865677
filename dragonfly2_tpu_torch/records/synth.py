"""Seeded synthetic cluster + trace generator.

A copy of ``make_cluster`` and ``gen_download_records`` from
dragonfly2_tpu/records/synth.py: the same ``random.Random`` stream, so a
seed gives the same records in both packages. Produces
``DownloadRecord`` streams with the shape and value ranges the upstream
scheduler emits (scheduler/service/service_v1.go:1418-1632
createDownloadRecord), with a planted ground truth: each host has a latent
"quality" and pairwise RTT drawn from an IDC-structured model, so a
learned ranker has signal to recover.
"""

from __future__ import annotations

import dataclasses
import random

from dragonfly2_tpu_torch.records.schema import (
    DownloadRecord,
    HostRecord,
    NetworkStat,
    ParentRecord,
    PieceRecord,
    TaskRecord,
)
from dragonfly2_tpu_torch.utils import idgen

IDCS = ["idc-a", "idc-b", "idc-c", "idc-d"]
REGIONS = ["as", "eu", "na"]

NS_PER_MS = 1_000_000

# latent RTT tier model (shared by rtt_ns and the simulator's vectorised
# legacy piece-cost replay — keep in one place so they cannot drift)
RTT_SAME_IDC_MS = 0.5
RTT_SAME_REGION_MS = 5.0
RTT_CROSS_REGION_MS = 60.0
RTT_JITTER_SIGMA = 0.3


@dataclasses.dataclass
class SynthHost:
    id: str
    hostname: str
    ip: str
    idc: str
    location: str
    is_seed: bool
    quality: float          # latent upload quality in (0, 1)
    upload_count: int
    upload_failed_count: int
    concurrent_upload_limit: int
    concurrent_upload_count: int


@dataclasses.dataclass
class SynthCluster:
    hosts: list[SynthHost]
    rng: random.Random

    def host_record(self, h: SynthHost, now_ns: int) -> HostRecord:
        return HostRecord(
            id=h.id,
            type="super" if h.is_seed else "normal",
            hostname=h.hostname,
            ip=h.ip,
            port=8002,
            download_port=8001,
            os="linux",
            platform="ubuntu",
            concurrent_upload_limit=h.concurrent_upload_limit,
            concurrent_upload_count=h.concurrent_upload_count,
            upload_count=h.upload_count,
            upload_failed_count=h.upload_failed_count,
            network=NetworkStat(
                tcp_connection_count=int(self.rng.uniform(10, 500)),
                upload_tcp_connection_count=int(self.rng.uniform(0, 100)),
                location=h.location,
                idc=h.idc,
            ),
            scheduler_cluster_id=1,
            created_at=now_ns,
            updated_at=now_ns,
        )

    def base_rtt_ms(self, src: SynthHost, dst: SynthHost) -> float:
        """Jitter-free latent RTT tier — the ONE source of truth for the
        IDC-structured model (the simulator's vectorised legacy replay
        draws its own jitter batch over these same tiers)."""
        if src.idc == dst.idc:
            return RTT_SAME_IDC_MS
        if src.location.split("|")[0] == dst.location.split("|")[0]:
            return RTT_SAME_REGION_MS
        return RTT_CROSS_REGION_MS

    def rtt_ns(self, src: SynthHost, dst: SynthHost) -> int:
        """IDC-structured latent RTT: ~0.5ms same IDC, ~5ms same region, ~60ms cross."""
        jitter = self.rng.lognormvariate(0.0, RTT_JITTER_SIGMA)
        return max(1, int(self.base_rtt_ms(src, dst) * jitter * NS_PER_MS))


def make_cluster(num_hosts: int, seed: int = 0, seed_peer_fraction: float = 0.05) -> SynthCluster:
    rng = random.Random(seed)
    hosts = []
    for i in range(num_hosts):
        idc = rng.choice(IDCS)
        region = rng.choice(REGIONS)
        location = f"{region}|zone-{rng.randint(0, 3)}|rack-{rng.randint(0, 15)}"
        hostname = f"host-{i}"
        ip = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        upload_count = rng.randint(0, 5000)
        hosts.append(
            SynthHost(
                id=idgen.host_id_v2(ip, hostname),
                hostname=hostname,
                ip=ip,
                idc=idc,
                location=location,
                is_seed=rng.random() < seed_peer_fraction,
                quality=rng.betavariate(4, 2),
                upload_count=upload_count,
                upload_failed_count=int(upload_count * rng.random() * 0.3),
                concurrent_upload_limit=50,
                concurrent_upload_count=rng.randint(0, 50),
            )
        )
    return SynthCluster(hosts=hosts, rng=rng)


def gen_download_records(
    cluster: SynthCluster,
    num_records: int,
    num_tasks: int = 64,
    max_parents: int = 20,
    max_pieces: int = 10,
) -> list[DownloadRecord]:
    """Peer download traces: parent piece-serving cost correlates with the
    parent host's latent quality and RTT to the child — the signal the
    GraphSAGE ranker should learn."""
    rng = cluster.rng
    now_ns = 1_700_000_000 * 1_000_000_000
    tasks = []
    for t in range(num_tasks):
        url = f"https://example.com/objects/blob-{t}.bin"
        piece_count = rng.randint(4, 512)
        tasks.append(
            TaskRecord(
                id=idgen.task_id_v2(url, tag="synth", application="bench", piece_length=4 << 20),
                url=url,
                type="standard",
                content_length=piece_count * (4 << 20),
                total_piece_count=piece_count,
                back_to_source_limit=3,
                state="Succeeded",
                created_at=now_ns,
                updated_at=now_ns,
            )
        )

    records = []
    for _ in range(num_records):
        task = rng.choice(tasks)
        child = rng.choice(cluster.hosts)
        n_parents = rng.randint(1, max_parents)
        parents = []
        for _ in range(n_parents):
            parent_host = rng.choice(cluster.hosts)
            if parent_host.id == child.id:
                continue
            rtt = cluster.rtt_ns(child, parent_host)
            n_pieces = rng.randint(1, max_pieces)
            pieces = []
            for _ in range(n_pieces):
                # piece cost ~ rtt + bandwidth term scaled by inverse quality
                service_ms = (4 << 20) / (max(parent_host.quality, 0.05) * 100e6) * 1e3
                cost = int(rtt + service_ms * rng.lognormvariate(0.0, 0.25) * NS_PER_MS)
                pieces.append(PieceRecord(length=4 << 20, cost=cost, created_at=now_ns))
            finished = sum(p.length for p in pieces)
            parents.append(
                ParentRecord(
                    id=idgen.peer_id_v2(),
                    tag="synth",
                    application="bench",
                    state="Succeeded",
                    cost=sum(p.cost for p in pieces),
                    upload_piece_count=len(pieces),
                    finished_piece_count=rng.randint(
                        min(len(pieces), task.total_piece_count), task.total_piece_count
                    ),
                    host=cluster.host_record(parent_host, now_ns),
                    pieces=pieces,
                    created_at=now_ns,
                    updated_at=now_ns,
                )
            )
            del finished
        records.append(
            DownloadRecord(
                id=idgen.peer_id_v2(),
                tag="synth",
                application="bench",
                state="Succeeded",
                cost=max((p.cost for p in parents), default=0),
                finished_piece_count=task.total_piece_count,
                task=task,
                host=cluster.host_record(child, now_ns),
                parents=parents,
                created_at=now_ns,
                updated_at=now_ns,
            )
        )
    return records
