"""Columnar feature extraction: trace records -> dense padded arrays.

A copy of the ranking half of dragonfly2_tpu/records/features.py: host
numeric features, ``RankingDataset``, ``HostGraph`` and
``downloads_to_ranking_dataset`` (the evaluator batch and topology pairs
are not ported yet). Everything here is numpy: ragged parent/piece lists
become zero-padded arrays + masks, categorical identity fields (IDC,
location path elements) become stable int64 hash codes
(utils/digest.stable_hash64). The feature surface mirrors what the
upstream evaluator reads off resource.Peer/Host
(scheduler/scheduling/evaluator/evaluator_base.go:86-188).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dragonfly2_tpu_torch.config.constants import CONSTANTS
from dragonfly2_tpu_torch.records.schema import DownloadRecord, HostRecord
from dragonfly2_tpu_torch.state.fsm import HostType
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


def location_codes(location: str) -> np.ndarray:
    """Hash each `|`-separated element; 0 = absent (evaluator_base.go:159-188)."""
    out = np.zeros(MAX_LOC, dtype=np.int64)
    if location:
        for i, element in enumerate(location.lower().split("|")[:MAX_LOC]):
            out[i] = stable_hash64(element) or 1
    return out


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
