"""Columnar feature extraction: trace records -> dense padded arrays.

A copy of dragonfly2_tpu/records/features.py: host numeric features, the
evaluator batch (``CandidateFeatures``, ``downloads_to_eval_batch``), the
topology pairs, ``RankingDataset``, ``HostGraph`` and
``downloads_to_ranking_dataset``. Everything here is numpy: ragged
parent/piece lists become zero-padded arrays + masks, categorical identity
fields (IDC, location path elements, host ids) become stable int64 hash
codes (utils/digest.stable_hash64). The feature surface mirrors what the
upstream evaluator reads off resource.Peer/Host
(scheduler/scheduling/evaluator/evaluator_base.go:86-188).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from dragonfly2_tpu_torch.config.constants import CONSTANTS
from dragonfly2_tpu_torch.records.schema import DownloadRecord, HostRecord, NetworkTopologyRecord
from dragonfly2_tpu_torch.state.fsm import HostType, PeerState
from dragonfly2_tpu_torch.utils.digest import stable_hash64

MAX_LOC = CONSTANTS.MAX_LOCATION_ELEMENTS

# Numeric host features consumed by the learned models (not the rule blend).
HOST_NUMERIC_FEATURES = [
    "is_seed",
    "concurrent_upload_limit",
    "concurrent_upload_count",
    "free_upload_count",
    "log_upload_count",
    "log_upload_failed_count",
    "upload_success_ratio",
    "log_tcp_connection_count",
    "log_upload_tcp_connection_count",
    "cpu_percent",
    "mem_used_percent",
    "disk_used_percent",
]
NUM_HOST_FEATURES = len(HOST_NUMERIC_FEATURES)

# Fixed per-feature scales applied at extraction so every consumer (trainer,
# server, metrics) sees O(1)-magnitude inputs; schema-derived constants, not
# data statistics, so train/serve stay consistent by construction.
HOST_FEATURE_SCALE = np.array(
    [1.0, 50.0, 50.0, 50.0, 10.0, 10.0, 1.0, 8.0, 8.0, 100.0, 100.0, 100.0],
    dtype=np.float32,
)
EDGE_FEATURE_SCALE = np.array([20.0, 5.0], dtype=np.float32)  # [log1p tput, log1p count]


# A cluster holds few distinct locations and IDCs for many hosts: each
# string is hashed once (a 10^6-host announce spent a quarter of its time
# here). Pure functions of the string, so the codes are unchanged.
@functools.lru_cache(maxsize=1 << 16)
def _location_codes(location: str) -> np.ndarray:
    out = np.zeros(MAX_LOC, dtype=np.int64)
    if location:
        for i, element in enumerate(location.lower().split("|")[:MAX_LOC]):
            out[i] = stable_hash64(element) or 1
    out.flags.writeable = False
    return out


def location_codes(location: str) -> np.ndarray:
    """Hash each `|`-separated element; 0 = absent (evaluator_base.go:159-188)."""
    return _location_codes(location).copy()


@functools.lru_cache(maxsize=1 << 16)
def idc_code(idc: str) -> int:
    return stable_hash64(idc.lower()) or 1 if idc else 0


def location_match_depth(a: np.ndarray, b: np.ndarray) -> int:
    """Count matching leading location elements (code 0 = absent); the
    host-side twin of ops/evaluator.location_affinity_score's prefix rule."""
    depth = 0
    for x, y in zip(a, b):
        if x == 0 or y == 0 or x != y:
            break
        depth += 1
    return depth


def host_numeric_features(h: HostRecord) -> np.ndarray:
    free_upload = max(h.concurrent_upload_limit - h.concurrent_upload_count, 0)
    success_ratio = (
        (h.upload_count - h.upload_failed_count) / h.upload_count if h.upload_count > 0 else 1.0
    )
    return (
        np.array(
            [
                1.0 if HostType.from_name(h.type) != HostType.NORMAL else 0.0,
                h.concurrent_upload_limit,
                h.concurrent_upload_count,
                free_upload,
                np.log1p(max(h.upload_count, 0)),
                np.log1p(max(h.upload_failed_count, 0)),
                success_ratio,
                np.log1p(max(h.network.tcp_connection_count, 0)),
                np.log1p(max(h.network.upload_tcp_connection_count, 0)),
                h.cpu.percent,
                h.memory.used_percent,
                h.disk.used_percent,
            ],
            dtype=np.float32,
        )
        / HOST_FEATURE_SCALE
    )


@dataclasses.dataclass
class CandidateFeatures:
    """The (B, K)-shaped arrays the batched evaluator kernel consumes.

    B = concurrent scheduling requests (child peers), K = padded candidate
    parents per request. All identity comparisons are precomputed int codes.
    """

    valid: np.ndarray                 # (B, K) bool — candidate slot populated
    finished_pieces: np.ndarray       # (B, K) int32 parent finished piece count
    child_finished_pieces: np.ndarray  # (B,) int32
    total_piece_count: np.ndarray     # (B,) int32 (0 = unknown)
    upload_count: np.ndarray          # (B, K) int64
    upload_failed_count: np.ndarray   # (B, K) int64
    upload_limit: np.ndarray          # (B, K) int32
    upload_used: np.ndarray           # (B, K) int32 concurrent uploads in flight
    host_type: np.ndarray             # (B, K) int8 (HostType)
    peer_state: np.ndarray            # (B, K) int8 (PeerState)
    parent_idc: np.ndarray            # (B, K) int64
    child_idc: np.ndarray             # (B,) int64
    parent_location: np.ndarray       # (B, K, MAX_LOC) int64
    child_location: np.ndarray        # (B, MAX_LOC) int64
    parent_host_id: np.ndarray        # (B, K) int64 hashed host id
    child_host_id: np.ndarray         # (B,) int64
    avg_rtt_ns: np.ndarray            # (B, K) float32 probe EWMA (0 = no probes)
    has_rtt: np.ndarray               # (B, K) bool
    piece_costs: np.ndarray           # (B, K, C) float32 recent piece costs ring
    piece_cost_count: np.ndarray      # (B, K) int32 number of valid costs
    numeric: np.ndarray               # (B, K, NUM_HOST_FEATURES) float32 (ml evaluator)
    child_numeric: np.ndarray         # (B, NUM_HOST_FEATURES) float32

    @classmethod
    def zeros(cls, b: int, k: int, cost_capacity: int = CONSTANTS.PIECE_COST_CAPACITY):
        return cls(
            valid=np.zeros((b, k), dtype=bool),
            finished_pieces=np.zeros((b, k), dtype=np.int32),
            child_finished_pieces=np.zeros((b,), dtype=np.int32),
            total_piece_count=np.zeros((b,), dtype=np.int32),
            upload_count=np.zeros((b, k), dtype=np.int64),
            upload_failed_count=np.zeros((b, k), dtype=np.int64),
            upload_limit=np.zeros((b, k), dtype=np.int32),
            upload_used=np.zeros((b, k), dtype=np.int32),
            host_type=np.zeros((b, k), dtype=np.int8),
            peer_state=np.zeros((b, k), dtype=np.int8),
            parent_idc=np.zeros((b, k), dtype=np.int64),
            child_idc=np.zeros((b,), dtype=np.int64),
            parent_location=np.zeros((b, k, MAX_LOC), dtype=np.int64),
            child_location=np.zeros((b, MAX_LOC), dtype=np.int64),
            parent_host_id=np.zeros((b, k), dtype=np.int64),
            child_host_id=np.zeros((b,), dtype=np.int64),
            avg_rtt_ns=np.zeros((b, k), dtype=np.float32),
            has_rtt=np.zeros((b, k), dtype=bool),
            piece_costs=np.zeros((b, k, cost_capacity), dtype=np.float32),
            piece_cost_count=np.zeros((b, k), dtype=np.int32),
            numeric=np.zeros((b, k, NUM_HOST_FEATURES), dtype=np.float32),
            child_numeric=np.zeros((b, NUM_HOST_FEATURES), dtype=np.float32),
        )

    def as_dict(self) -> dict[str, np.ndarray]:
        return dataclasses.asdict(self)


def downloads_to_eval_batch(
    records: list[DownloadRecord],
    batch_tasks: int | None = None,
    batch_candidates: int | None = None,
) -> CandidateFeatures:
    """Replay download traces as evaluator scoring requests.

    Each record becomes one row: the child peer asking for parents, its
    recorded parents as the candidate set (the trace-replay harness from
    SURVEY.md §7 stage 2).
    """
    b = batch_tasks or len(records)
    k = batch_candidates or CONSTANTS.MAX_PARENTS_PER_RECORD
    feats = CandidateFeatures.zeros(b, k)
    cost_cap = feats.piece_costs.shape[-1]
    for i, rec in enumerate(records[:b]):
        feats.child_finished_pieces[i] = rec.finished_piece_count
        feats.total_piece_count[i] = rec.task.total_piece_count
        feats.child_idc[i] = idc_code(rec.host.network.idc)
        feats.child_location[i] = location_codes(rec.host.network.location)
        feats.child_host_id[i] = stable_hash64(rec.host.id) if rec.host.id else 0
        feats.child_numeric[i] = host_numeric_features(rec.host)
        for j, parent in enumerate(rec.parents[:k]):
            h = parent.host
            feats.valid[i, j] = True
            feats.finished_pieces[i, j] = parent.finished_piece_count
            feats.upload_count[i, j] = h.upload_count
            feats.upload_failed_count[i, j] = h.upload_failed_count
            feats.upload_limit[i, j] = h.concurrent_upload_limit
            feats.upload_used[i, j] = h.concurrent_upload_count
            feats.host_type[i, j] = int(HostType.from_name(h.type))
            feats.peer_state[i, j] = int(PeerState.from_name(parent.state))
            feats.parent_idc[i, j] = idc_code(h.network.idc)
            feats.parent_location[i, j] = location_codes(h.network.location)
            feats.parent_host_id[i, j] = stable_hash64(h.id) if h.id else 0
            feats.numeric[i, j] = host_numeric_features(h)
            costs = [p.cost for p in parent.pieces][-cost_cap:]
            feats.piece_cost_count[i, j] = len(costs)
            feats.piece_costs[i, j, : len(costs)] = np.asarray(costs, dtype=np.float32)
    return feats


def topology_to_pairs(records: list[NetworkTopologyRecord]) -> tuple[np.ndarray, np.ndarray]:
    """Probe pairs -> (X, y) for the MLP RTT regressor.

    X = [src numeric basics, dst numeric basics, same_idc, loc_match_depth/5]
    y = log1p(average_rtt_ms) — log-scale keeps the 0.1ms..100ms range sane.
    """
    xs, ys = [], []
    for rec in records:
        src = rec.host
        src_idc = idc_code(src.network.idc)
        src_loc = location_codes(src.network.location)
        src_seed = 1.0 if HostType.from_name(src.type) != HostType.NORMAL else 0.0
        for dst in rec.dest_hosts:
            if dst.probes.average_rtt <= 0:
                continue
            dst_idc = idc_code(dst.network.idc)
            dst_loc = location_codes(dst.network.location)
            match_depth = location_match_depth(src_loc, dst_loc)
            xs.append(
                [
                    src_seed,
                    np.log1p(src.network.tcp_connection_count),
                    np.log1p(src.network.upload_tcp_connection_count),
                    1.0 if HostType.from_name(dst.type) != HostType.NORMAL else 0.0,
                    np.log1p(dst.network.tcp_connection_count),
                    np.log1p(dst.network.upload_tcp_connection_count),
                    1.0 if (src_idc != 0 and src_idc == dst_idc) else 0.0,
                    match_depth / MAX_LOC,
                ]
            )
            ys.append(np.log1p(dst.probes.average_rtt / 1e6))
    if not xs:
        return np.zeros((0, 8), np.float32), np.zeros((0,), np.float32)
    return np.asarray(xs, dtype=np.float32), np.asarray(ys, dtype=np.float32)


NUM_PAIR_FEATURES = 8


@dataclasses.dataclass
class RankingDataset:
    """Per-download candidate ranking examples for the GraphSAGE ranker.

    label = observed piece throughput from that parent (bytes/sec, log1p);
    the ranker is trained listwise over the valid candidates.
    """

    child: np.ndarray        # (N, NUM_HOST_FEATURES) float32
    parents: np.ndarray      # (N, P, NUM_HOST_FEATURES) float32
    same_idc: np.ndarray     # (N, P) float32
    loc_match: np.ndarray    # (N, P) float32 match depth / MAX_LOC
    mask: np.ndarray         # (N, P) bool
    throughput: np.ndarray   # (N, P) float32 log1p(bytes/sec)
    child_host_idx: np.ndarray   # (N,) int32 into the host graph
    parent_host_idx: np.ndarray  # (N, P) int32 into the host graph


@dataclasses.dataclass
class HostGraph:
    """Host-level interaction graph for GraphSAGE neighborhood aggregation.

    Nodes: hosts observed anywhere in the traces. Edges: child->parent
    piece-transfer relations (COO), carrying observed mean throughput.
    """

    host_ids: list[str]
    node_feats: np.ndarray   # (H, NUM_HOST_FEATURES) float32
    edge_src: np.ndarray     # (E,) int32 — child host index
    edge_dst: np.ndarray     # (E,) int32 — parent host index
    edge_feats: np.ndarray   # (E, 2) float32 [log1p(throughput), log1p(count)]


def downloads_to_ranking_dataset(
    records: list[DownloadRecord],
    max_parents: int = CONSTANTS.MAX_PARENTS_PER_RECORD,
) -> tuple[RankingDataset, HostGraph]:
    host_index: dict[str, int] = {}
    host_feats: list[np.ndarray] = []
    edge_stats: dict[tuple[int, int], list[float]] = {}

    def intern_host(h: HostRecord) -> int:
        idx = host_index.get(h.id)
        if idx is None:
            idx = len(host_index)
            host_index[h.id] = idx
            host_feats.append(host_numeric_features(h))
        return idx

    n = len(records)
    p = max_parents
    child = np.zeros((n, NUM_HOST_FEATURES), np.float32)
    parents = np.zeros((n, p, NUM_HOST_FEATURES), np.float32)
    same_idc = np.zeros((n, p), np.float32)
    loc_match = np.zeros((n, p), np.float32)
    mask = np.zeros((n, p), bool)
    throughput = np.zeros((n, p), np.float32)
    child_host_idx = np.zeros((n,), np.int32)
    parent_host_idx = np.zeros((n, p), np.int32)

    for i, rec in enumerate(records):
        ci = intern_host(rec.host)
        child[i] = host_feats[ci]
        child_host_idx[i] = ci
        c_idc = idc_code(rec.host.network.idc)
        c_loc = location_codes(rec.host.network.location)
        for j, parent in enumerate(rec.parents[:p]):
            pi = intern_host(parent.host)
            parents[i, j] = host_feats[pi]
            parent_host_idx[i, j] = pi
            mask[i, j] = True
            p_idc = idc_code(parent.host.network.idc)
            same_idc[i, j] = 1.0 if (c_idc != 0 and c_idc == p_idc) else 0.0
            p_loc = location_codes(parent.host.network.location)
            loc_match[i, j] = location_match_depth(c_loc, p_loc) / MAX_LOC
            total_bytes = sum(pc.length for pc in parent.pieces)
            total_cost_ns = sum(pc.cost for pc in parent.pieces)
            tput = total_bytes / (total_cost_ns / 1e9) if total_cost_ns > 0 else 0.0
            throughput[i, j] = np.log1p(tput)
            edge_stats.setdefault((ci, pi), []).append(tput)

    if edge_stats:
        # Both directions: child->parent lets children aggregate who served
        # them; parent->child lets a parent's own serving history (the
        # quality signal) reach ITS embedding. Mirrored pairs that already
        # exist as forward edges are MERGED so no directed edge appears
        # twice (duplicate edges would double-count neighbors in the
        # segment mean).
        directed: dict[tuple[int, int], list[float]] = {}
        for (a, b), v in edge_stats.items():
            directed.setdefault((a, b), []).extend(v)
            directed.setdefault((b, a), []).extend(v)
        keys = list(directed.keys())
        edge_src = np.asarray([k[0] for k in keys], np.int32)
        edge_dst = np.asarray([k[1] for k in keys], np.int32)
        edge_feats = (
            np.asarray(
                [[np.log1p(np.mean(v)), np.log1p(len(v))] for v in directed.values()],
                np.float32,
            )
            / EDGE_FEATURE_SCALE
        )
    else:
        edge_src = np.zeros((0,), np.int32)
        edge_dst = np.zeros((0,), np.int32)
        edge_feats = np.zeros((0, 2), np.float32)

    node_feats = (
        np.stack(host_feats) if host_feats else np.zeros((0, NUM_HOST_FEATURES), np.float32)
    )
    ds = RankingDataset(
        child=child,
        parents=parents,
        same_idc=same_idc,
        loc_match=loc_match,
        mask=mask,
        throughput=throughput,
        child_host_idx=child_host_idx,
        parent_host_idx=parent_host_idx,
    )
    graph = HostGraph(
        host_ids=list(host_index.keys()),
        node_feats=node_feats,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_feats=edge_feats,
    )
    return ds, graph
