"""Training input pipeline: ragged traces -> fixed-shape batches.

From dragonfly2_tpu/training/data.py: the minibatch index stream (one
static batch shape per model, minibatches cycled with a seeded
permutation, the final short batch wrapped around so every step sees the
same shape), the ranker's ``rank_batches``, and the graph inputs of the
GraphSAGE ranker (``graph_arrays`` for the segment path,
``dense_graph_arrays`` for the dense-adjacency one). It draws from the
same ``np.random.Generator`` in the same order as the reference, so a
seed gives both packages the same batches. Also the decision-ledger
exporters (``decision_rows``, ``decisions_to_rank_arrays``,
``decision_rank_batches``), which turn a ledger dump
(telemetry/decisions.py) into ranking batches. Everything here is numpy;
the caller moves it to its device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from dragonfly2_tpu_torch.models.graphsage import RankBatch
from dragonfly2_tpu_torch.records.features import HostGraph, RankingDataset


def minibatches(
    n: int, batch_size: int, rng: np.random.Generator, shuffle: bool = True
) -> Iterator[np.ndarray]:
    """Yield index arrays of EXACTLY batch_size (last one wraps around),
    keeping shapes static across steps."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        if len(idx) < batch_size:
            idx = np.concatenate([idx, order[: batch_size - len(idx)]])
        yield idx


def rank_batches(
    ds: RankingDataset, batch_size: int, rng: np.random.Generator, shuffle: bool = True
) -> Iterator[RankBatch]:
    n = ds.child.shape[0]
    pair_feats = np.concatenate(
        [ds.same_idc[..., None], ds.loc_match[..., None]], axis=-1
    ).astype(np.float32)
    for idx in minibatches(n, batch_size, rng, shuffle):
        yield RankBatch(
            child_idx=ds.child_host_idx[idx],
            parent_idx=ds.parent_host_idx[idx],
            pair_feats=pair_feats[idx],
            throughput=ds.throughput[idx],
            mask=ds.mask[idx],
        )


# --------------------------------------------------------------- decisions
#
# Ledger -> training-trace exporter (telemetry/decisions.py): the decision
# ledger records, per applied selection, the candidate host slots and pair
# features and, once the outcome joins, the chosen parent's measured
# download: the (child, candidates, label) shape the ranker trains on. Host
# indices are the scheduler's host SLOTS, the node space
# serving_graph_arrays feeds the embedding table, so a batch from here
# scores against the serving host graph as it is.


def decision_rows(doc) -> list[dict]:
    """Every decision-ledger row reachable in a dump document, in seq
    order (telemetry/decisions.py ``extract_dump_rows``)."""
    from dragonfly2_tpu_torch.telemetry.decisions import extract_dump_rows

    return extract_dump_rows(doc)


def decisions_to_rank_arrays(rows: list[dict]) -> dict:
    """Ledger rows -> fixed-shape ranking arrays.

    Keeps only decisions with a joined COMPLETED outcome and a chosen
    parent; the label is ``log1p(bytes/sec)`` of the measured download,
    at the chosen candidate's position. The time basis is the outcome's
    ``cost_ms`` (the download cost summed from reported piece costs: virtual
    time in a replay, measured transfer time in production), ``ttc_ms`` only
    for dumps that predate it. Non-chosen candidates ride as context rows
    with ``mask=False``: one labeled action per decision.

    Returns ``{child_idx (N,), parent_idx (N,P), pair_feats (N,P,2),
    throughput (N,P), mask (N,P)}`` with P = the max candidate count.
    """
    def _basis_ms(r: dict) -> float:
        o = r.get("outcome") or {}
        return float(o.get("cost_ms") or o.get("ttc_ms") or 0.0)

    def _labeled(r: dict) -> bool:
        o = r.get("outcome") or {}
        return (
            o.get("state") == "completed"
            and r.get("chosen_pos", -1) >= 0
            and _basis_ms(r) > 0
            and bool(o.get("bytes"))
        )

    usable = [r for r in rows if _labeled(r)]
    p = max((len(r.get("candidates", ())) for r in usable), default=0)
    n = len(usable)
    out = {
        "child_idx": np.zeros(n, np.int32),
        "parent_idx": np.zeros((n, p), np.int32),
        "pair_feats": np.zeros((n, p, 2), np.float32),
        "throughput": np.zeros((n, p), np.float32),
        "mask": np.zeros((n, p), bool),
    }
    for i, r in enumerate(usable):
        out["child_idx"][i] = int(r.get("child_host_slot", 0))
        o = r["outcome"]
        bps = float(o["bytes"]) / max(_basis_ms(r) / 1e3, 1e-9)
        for c in r.get("candidates", ()):
            j = int(c["pos"])
            if j >= p:
                continue
            out["parent_idx"][i, j] = max(int(c.get("host_slot", 0)), 0)
            feats = c.get("features", {})
            out["pair_feats"][i, j, 0] = float(feats.get("same_idc", 0.0))
            out["pair_feats"][i, j, 1] = float(feats.get("loc_match", 0.0))
        chosen = int(r["chosen_pos"])
        if chosen < p:
            out["throughput"][i, chosen] = np.log1p(bps)
            out["mask"][i, chosen] = True
    return out


def decision_rank_batches(
    rows: list[dict], batch_size: int, rng: np.random.Generator,
    shuffle: bool = True,
) -> Iterator[RankBatch]:
    """Ledger rows -> ``RankBatch`` minibatches (static shapes by the same
    wrap-around bucketing as ``rank_batches``)."""
    arrays = decisions_to_rank_arrays(rows)
    n = arrays["child_idx"].shape[0]
    if n == 0:
        return
    for idx in minibatches(n, batch_size, rng, shuffle):
        yield RankBatch(
            child_idx=arrays["child_idx"][idx],
            parent_idx=arrays["parent_idx"][idx],
            pair_feats=arrays["pair_feats"][idx],
            throughput=arrays["throughput"][idx],
            mask=arrays["mask"][idx],
        )


def graph_arrays(graph: HostGraph, pad_edges_to: int | None = None) -> dict:
    """HostGraph -> dict of arrays for GraphSAGERanker, with optional edge
    padding to a static bucket size. Padded edges are self-loops on a
    dedicated sink node appended here (the LAST node row, zero features),
    so they never touch a real host's mean."""
    node_feats = graph.node_feats
    e = graph.edge_src.shape[0]
    if pad_edges_to is not None and pad_edges_to > e:
        pad = pad_edges_to - e
        node_feats = np.concatenate(
            [node_feats, np.zeros((1,) + node_feats.shape[1:], node_feats.dtype)]
        )
        sink = node_feats.shape[0] - 1
        edge_src = np.concatenate([graph.edge_src, np.full(pad, sink, np.int32)])
        edge_dst = np.concatenate([graph.edge_dst, np.full(pad, sink, np.int32)])
        edge_feats = np.concatenate(
            [graph.edge_feats, np.zeros((pad,) + graph.edge_feats.shape[1:], np.float32)]
        )
    else:
        edge_src, edge_dst, edge_feats = graph.edge_src, graph.edge_dst, graph.edge_feats
    return {
        "node_feats": node_feats.astype(np.float32),
        "edge_src": edge_src.astype(np.int32),
        "edge_dst": edge_dst.astype(np.int32),
        "edge_feats": edge_feats.astype(np.float32),
    }


def edge_bucket(e: int, granularity: int = 4096) -> int:
    """Round edge count up to a bucket so graph growth keeps few shapes."""
    return max(granularity, ((e + granularity - 1) // granularity) * granularity)


# Above this node count the [N, N] adjacency would cross ~2 GB of device
# memory and the segment path wins.
DENSE_ADJ_MAX_NODES = 16_384


def dense_graph_arrays(graph: HostGraph) -> dict:
    """HostGraph -> arrays for the dense-aggregation path
    (models/graphsage.SAGELayer adj= branch): `adj` is the row-normalized
    neighbor matrix (adj @ h == mean over N(v)), `edge_mean` the static
    per-node mean of incident edge features. Same math as the segment
    path: one product instead of gather + scatter-add per layer."""
    n = graph.node_feats.shape[0]
    if n > DENSE_ADJ_MAX_NODES:
        raise ValueError(
            f"{n} nodes > DENSE_ADJ_MAX_NODES={DENSE_ADJ_MAX_NODES}; use graph_arrays instead"
        )
    adj = np.zeros((n, n), np.float32)
    np.add.at(adj, (graph.edge_src, graph.edge_dst), 1.0)
    cnt = np.maximum(adj.sum(axis=1, keepdims=True), 1.0)
    adj /= cnt
    edge_sum = np.zeros((n, graph.edge_feats.shape[1]), np.float32)
    np.add.at(edge_sum, graph.edge_src, graph.edge_feats.astype(np.float32))
    edge_mean = edge_sum / cnt
    return {
        "node_feats": graph.node_feats.astype(np.float32),
        # segment inputs kept for API compatibility; unused on this path
        "edge_src": graph.edge_src.astype(np.int32),
        "edge_dst": graph.edge_dst.astype(np.int32),
        "edge_feats": graph.edge_feats.astype(np.float32),
        # f16 on the host: halves the one-time transfer; the model casts
        # to its compute dtype before the product
        "adj": adj.astype(np.float16),
        "edge_mean": edge_mean,
    }
