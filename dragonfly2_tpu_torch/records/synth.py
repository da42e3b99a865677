"""Port of dragonfly2_tpu/records/synth.py, whole: the same
``random.Random`` stream, so a seed gives the same cluster and records in
both packages.

Seeded synthetic cluster + trace generator.

Stands in for a live cluster when unit-testing and benchmarking: produces
``DownloadRecord``/``NetworkTopologyRecord`` streams with the same shape and
value ranges the reference's scheduler emits (scheduler/service/
service_v1.go:1418-1632 createDownloadRecord; networktopology
snapshot network_topology.go:386-497), with a *planted ground truth*: each
host has a latent "quality" and pairwise RTT drawn from an IDC-structured
model, so learned rankers/regressors have signal to recover and tests can
assert convergence.
"""

from __future__ import annotations

import dataclasses
import random

from dragonfly2_tpu_torch.records.schema import (
    DestHostRecord,
    DownloadRecord,
    HostRecord,
    NetworkStat,
    NetworkTopologyRecord,
    ParentRecord,
    PieceRecord,
    ProbesRecord,
    SrcHostRecord,
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


def gen_network_topology_records(
    cluster: SynthCluster,
    num_records: int,
    max_dest_hosts: int = 5,
) -> list[NetworkTopologyRecord]:
    rng = cluster.rng
    now_ns = 1_700_000_000 * 1_000_000_000
    records = []
    for i in range(num_records):
        src = rng.choice(cluster.hosts)
        dests = rng.sample([h for h in cluster.hosts if h.id != src.id],
                           k=min(max_dest_hosts, len(cluster.hosts) - 1))
        dest_records = []
        for dst in dests:
            rtt = cluster.rtt_ns(src, dst)
            dest_records.append(
                DestHostRecord(
                    id=dst.id,
                    type="super" if dst.is_seed else "normal",
                    hostname=dst.hostname,
                    ip=dst.ip,
                    port=8002,
                    network=NetworkStat(location=dst.location, idc=dst.idc),
                    probes=ProbesRecord(average_rtt=rtt, created_at=now_ns, updated_at=now_ns),
                )
            )
        records.append(
            NetworkTopologyRecord(
                id=f"nt-{i}",
                host=SrcHostRecord(
                    id=src.id,
                    type="super" if src.is_seed else "normal",
                    hostname=src.hostname,
                    ip=src.ip,
                    port=8002,
                    network=NetworkStat(location=src.location, idc=src.idc),
                ),
                dest_hosts=dest_records,
                created_at=now_ns,
            )
        )
    return records


def gen_ranking_dataset(
    cluster: SynthCluster,
    num_records: int,
    max_parents: int = 20,
    seed: int = 1,
):
    """Vectorized (RankingDataset, HostGraph) with the SAME planted
    ground truth as gen_download_records -> downloads_to_ranking_dataset
    (parent piece throughput driven by latent quality + IDC-structured
    RTT), but built directly in numpy: the record-object round-trip costs
    ~200 s of host Python at the representative bench scale (100k records
    x 20 parents), which would dwarf the training being measured."""
    import numpy as np

    from dragonfly2_tpu_torch.records.features import (
        EDGE_FEATURE_SCALE,
        HostGraph,
        RankingDataset,
        host_numeric_features,
        idc_code,
        location_codes,
    )
    from dragonfly2_tpu_torch.config.constants import CONSTANTS

    rng = np.random.default_rng(seed)
    hosts = cluster.hosts
    h_count = len(hosts)
    now_ns = 1_700_000_000 * 1_000_000_000

    # per-host invariants: one Python pass over hosts, everything after
    # is pure array math
    feats = np.stack([
        host_numeric_features(cluster.host_record(h, now_ns)) for h in hosts
    ]).astype(np.float32)
    idc_codes = np.asarray([idc_code(h.idc) for h in hosts], np.int64)
    loc_codes = np.stack([location_codes(h.location) for h in hosts])
    regions = np.asarray([IDCS.index(h.idc) for h in hosts], np.int64)
    region_of = np.asarray(
        [REGIONS.index(h.location.split("|")[0]) for h in hosts], np.int64
    )
    quality = np.asarray([h.quality for h in hosts], np.float64)

    n, p = num_records, max_parents
    child_idx = rng.integers(0, h_count, n)
    parent_idx = rng.integers(0, h_count, (n, p))
    n_parents = rng.integers(1, p + 1, n)
    mask = (np.arange(p)[None, :] < n_parents[:, None]) & (
        parent_idx != child_idx[:, None]
    )

    # IDC-structured latent RTT (rtt_ns): 0.5 ms same IDC, 5 ms same
    # region, 60 ms cross, lognormal jitter
    same_idc_raw = regions[parent_idx] == regions[child_idx][:, None]
    same_region = region_of[parent_idx] == region_of[child_idx][:, None]
    base_ms = np.where(same_idc_raw, 0.5, np.where(same_region, 5.0, 60.0))
    rtt_ns = base_ms * rng.lognormal(0.0, 0.3, (n, p)) * NS_PER_MS

    # per-parent piece serving: n_pieces x (rtt + bandwidth term scaled by
    # inverse quality), the gen_download_records cost model
    n_pieces = rng.integers(1, 10, (n, p))
    service_ms = (4 << 20) / (np.maximum(quality[parent_idx], 0.05) * 100e6) * 1e3
    total_cost_ns = n_pieces * (
        rtt_ns + service_ms * rng.lognormal(0.0, 0.25, (n, p)) * NS_PER_MS
    )
    total_bytes = n_pieces * (4 << 20)
    tput = np.where(total_cost_ns > 0, total_bytes / (total_cost_ns / 1e9), 0.0)
    tput = np.where(mask, tput, 0.0)

    same_idc = (
        (idc_codes[child_idx][:, None] != 0)
        & (idc_codes[parent_idx] == idc_codes[child_idx][:, None])
    ).astype(np.float32)
    c_loc, p_loc = loc_codes[child_idx][:, None, :], loc_codes[parent_idx]
    both = (c_loc != 0) & (c_loc == p_loc)
    # match depth = length of common prefix of nonzero codes
    depth = np.cumprod(both, axis=-1).sum(axis=-1).astype(np.float32)
    loc_match = depth / CONSTANTS.MAX_LOCATION_ELEMENTS

    ds = RankingDataset(
        child=feats[child_idx],
        parents=feats[parent_idx] * mask[..., None],
        same_idc=same_idc * mask,
        loc_match=loc_match * mask,
        mask=mask,
        throughput=np.log1p(tput).astype(np.float32) * mask,
        child_host_idx=child_idx.astype(np.int32),
        parent_host_idx=(parent_idx * mask).astype(np.int32),
    )

    # directed multigraph -> merged unique directed edges, both directions
    src = np.concatenate([child_idx[:, None].repeat(p, 1)[mask], parent_idx[mask]])
    dst = np.concatenate([parent_idx[mask], child_idx[:, None].repeat(p, 1)[mask]])
    w = np.concatenate([tput[mask], tput[mask]])
    key = src.astype(np.int64) * h_count + dst
    uniq, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    sums = np.zeros(len(uniq))
    np.add.at(sums, inverse, w)
    edge_feats = np.stack([
        np.log1p(sums / counts), np.log1p(counts)
    ], axis=-1).astype(np.float32) / EDGE_FEATURE_SCALE
    graph = HostGraph(
        host_ids=[h.id for h in hosts],
        node_feats=feats,
        edge_src=(uniq // h_count).astype(np.int32),
        edge_dst=(uniq % h_count).astype(np.int32),
        edge_feats=edge_feats,
    )
    return ds, graph
