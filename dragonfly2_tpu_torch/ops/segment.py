"""Segment reductions — the graph-aggregation primitive.

Port of dragonfly2_tpu/ops/segment.py. Neighborhood aggregation is a
reduction by segment id over COO edge arrays: gather node states at edge
endpoints, reduce by segment. ``num_segments`` is explicit, as the
reference's static argument is.

``jax.ops.segment_sum`` drops ids that are negative or >= num_segments,
where torch's ``index_add_`` raises; the port routes such ids to one
scratch segment past the end and cuts it off, so no mask ever syncs with
the device. An empty segment's max is the dtype's lowest value (-inf for
floats), its mean 0. On CUDA the float sums are atomics, so their order,
and so their last bits, vary from run to run.
"""

from __future__ import annotations

import numpy as np
import torch


def _routed(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Ids outside [0, num_segments) -> the scratch segment num_segments."""
    ids = segment_ids.long()
    inside = (ids >= 0) & (ids < num_segments)
    return torch.where(inside, ids, torch.full_like(ids, num_segments))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, _routed(segment_ids, num_segments), data)
    return out[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    totals = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
    counts = torch.clamp_min(segment_sum(ones, segment_ids, num_segments), 1)
    if data.ndim > 1:
        counts = counts.reshape((-1,) + (1,) * (data.ndim - 1))
    return totals / counts


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    lowest = (float("-inf") if data.is_floating_point() else torch.iinfo(data.dtype).min)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), lowest, dtype=data.dtype,
                     device=data.device)
    ids = _routed(segment_ids, num_segments).reshape((-1,) + (1,) * (data.ndim - 1))
    out.scatter_reduce_(0, ids.expand_as(data), data, "amax")
    return out[:num_segments]


def segment_count(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape, dtype=torch.int32, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def pad_pow2(n: int, min_pad: int = 64) -> int:
    """Min-`min_pad` power-of-two bucket for a count — THE serving-graph
    padding policy. The producer (scheduler.serving_graph_arrays: node
    and edge padding, whose last node row is the zero-feature sink) and
    the consumer (gather_coo_subgraph below) must bucket identically."""
    return max(min_pad, 1 << int(np.ceil(np.log2(max(n, 1)))))


# ------------------------------------------------------- subgraph gathering
#
# Host-side companion to the segment reductions above: the incremental
# serving-embedding refresh recomputes only the dirty hosts' k-hop
# in-neighborhoods. This helper cuts that neighborhood out of the full COO
# arrays as a LOCALLY-indexed subgraph whose node/edge/target counts are
# padded to power-of-two buckets.


def gather_coo_subgraph(
    edge_src,  # (E,) int array-like
    edge_dst,  # (E,) int array-like
    dirty,     # (D,) int array-like — frontier node ids
    num_nodes: int,
    hops: int = 2,
    max_frac: float = 0.25,
    min_pad: int = 64,
):
    """Gather the subgraph needed to recompute `hops`-layer GNN embeddings
    of every node whose embedding is affected by the `dirty` input nodes.

    Aggregation for node v rides edges with src == v gathering dst
    (SAGELayer), so v READS its out-neighbors: the TARGET set (nodes whose
    embeddings change when `dirty` inputs change) expands REVERSE
    (dst->src), while the SUPPORT set (nodes whose features the recompute
    reads) expands FORWARD (src->dst) from the targets.

    Precondition: row `num_nodes - 1` is a sacrificial sink (the serving
    graph's zero-feature padding row). Padding nodes alias it and padding
    edges are self-loops on it, so only the sink's (never-served)
    embedding absorbs the padding.

    Returns None when the support set exceeds `max_frac` of the graph (a
    full recompute pays better). Otherwise a dict of numpy arrays:
      nodes         (Ns,) int32  global ids of subgraph nodes (padding
                                 rows point at `num_nodes - 1`)
      edge_src/dst  (Es,) int32  LOCAL endpoint indices (padding edges
                                 are sink self-loops)
      edge_index    (Es,) int64  indices into the FULL edge arrays for
                                 gathering edge features (padding -> 0)
      edge_pad      (Es,) bool   True on padding edges (zero their feats)
      target_local  (Nt,) int32  local rows whose fresh embedding to keep
      target_global (Nt,) int32  global rows to scatter them into
                                 (padding -> num_nodes, dropped by
                                 ``GraphSAGERanker.embed_subset``)
    """
    edge_src = np.asarray(edge_src, np.int64)
    edge_dst = np.asarray(edge_dst, np.int64)
    dirty = np.asarray(dirty, np.int64)
    dirty = dirty[(dirty >= 0) & (dirty < num_nodes)]
    if dirty.size == 0:
        return None

    mask = np.zeros(num_nodes, bool)
    mask[dirty] = True

    def _expand_fwd(m):
        # what X reads: dst endpoints of edges leaving X
        out = m.copy()
        out[edge_dst[m[edge_src]]] = True
        return out

    def _expand_rev(m):
        # what reads X: src endpoints of edges arriving in X
        out = m.copy()
        out[edge_src[m[edge_dst]]] = True
        return out

    for _ in range(hops):  # targets: reverse ball_k(dirty) — dependents
        mask = _expand_rev(mask)
    target_mask = mask.copy()
    for _ in range(hops):  # support: forward ball_k(targets) — inputs
        mask = _expand_fwd(mask)
    support_count = int(mask.sum())
    if support_count > max_frac * num_nodes:
        return None

    sink = num_nodes - 1
    mask[sink] = True  # padding rows alias the zero-feature sink
    nodes = np.nonzero(mask)[0].astype(np.int64)
    local_of = np.full(num_nodes, -1, np.int64)
    local_of[nodes] = np.arange(nodes.size)
    local_sink = int(local_of[sink])

    # keep every edge whose BOTH endpoints live in the support set
    keep = mask[edge_src] & mask[edge_dst]
    edge_index = np.nonzero(keep)[0]
    sub_src = local_of[edge_src[edge_index]]
    sub_dst = local_of[edge_dst[edge_index]]

    targets = np.nonzero(target_mask)[0].astype(np.int64)

    ns = pad_pow2(nodes.size, min_pad)
    nodes_p = np.full(ns, sink, np.int32)
    nodes_p[: nodes.size] = nodes
    es = pad_pow2(edge_index.size, min_pad)
    src_p = np.full(es, local_sink, np.int32)
    dst_p = np.full(es, local_sink, np.int32)
    idx_p = np.zeros(es, np.int64)
    pad_e = np.ones(es, bool)
    src_p[: sub_src.size] = sub_src
    dst_p[: sub_dst.size] = sub_dst
    idx_p[: edge_index.size] = edge_index
    pad_e[: edge_index.size] = False
    nt = pad_pow2(targets.size, min_pad)
    tloc_p = np.full(nt, local_sink, np.int32)
    tglob_p = np.full(nt, num_nodes, np.int32)  # out of range -> dropped
    tloc_p[: targets.size] = local_of[targets]
    tglob_p[: targets.size] = targets
    return {
        "nodes": nodes_p,
        "edge_src": src_p,
        "edge_dst": dst_p,
        "edge_index": idx_p,
        "edge_pad": pad_e,
        "target_local": tloc_p,
        "target_global": tglob_p,
    }
