"""GraphSAGE parent-peer ranker, in PyTorch.

Port of dragonfly2_tpu/models/graphsage.py: two GraphSAGE layers embed
every host of the interaction graph (records/features.HostGraph, COO edge
arrays); a pairwise head scores a child's candidate parents from
[child_emb, parent_emb, pair feats]; ``listwise_rank_loss`` trains it.

Module names follow the flax tree (``sage_i/{self, neigh, edge}``,
``head_0``, ``head_1``, ``head_out``) so models/convert.py maps one onto
the other by path. Numerics follow flax: Dense layers compute in the
compute dtype (bf16 by default) from float32 parameters, ``neigh`` and
``edge`` carry no bias, gelu is the tanh approximation, and neighbour
aggregation accumulates in float32 on both paths (segment sums, or
``adj @ nodes`` from compute-dtype operands) before its cast to the
compute dtype. Parameters start as flax's do (``flax_init_``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from dragonfly2_tpu_torch.models.attention import Dense, flax_init_
from dragonfly2_tpu_torch.ops.segment import segment_sum
from dragonfly2_tpu_torch.records.features import NUM_HOST_FEATURES

_NEG = -1e30
EDGE_FEATURES = 2  # records/features.HostGraph: [log1p(throughput), log1p(count)]
PAIR_FEATURES = 2  # training/data.rank_batches: [same_idc, loc_match]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class SAGELayer(nn.Module):
    """h_v' = act(W_self h_v + W_neigh mean_{u in N(v)} h_u + W_e mean e_uv)."""

    def __init__(self, in_features: int, features: int, edge_features: int = EDGE_FEATURES,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        # "self" is the flax name; reach it as getattr(layer, "self")
        self.add_module("self", Dense(in_features, features, compute_dtype))
        self.neigh = Dense(in_features, features, compute_dtype, bias=False)
        self.edge = Dense(edge_features, features, compute_dtype, bias=False)

    def forward(self, nodes, edge_src, edge_dst, edge_feats, num_nodes: int,
                adj=None, edge_mean=None):
        dt = self.compute_dtype
        nodes = nodes.to(dt)
        if adj is not None:
            # dense path: adj is the row-normalized [N, N] neighbour matrix,
            # so the mean is one product (training/data.dense_graph_arrays)
            agg = torch.matmul(adj.to(dt).float(), nodes.float()).to(dt)
            e_agg = edge_mean.to(dt)
        else:
            msgs = nodes[edge_dst.long()].float()
            ones = torch.ones((edge_src.shape[0], 1), dtype=torch.float32, device=nodes.device)
            agg = segment_sum(msgs, edge_src, num_nodes)
            cnt = torch.clamp_min(segment_sum(ones, edge_src, num_nodes), 1.0)
            agg = (agg / cnt).to(dt)
            e_agg = segment_sum(edge_feats.float(), edge_src, num_nodes)
            e_agg = (e_agg / cnt).to(dt)
        out = getattr(self, "self")(nodes) + self.neigh(agg) + self.edge(e_agg)
        return _gelu(out)


class GraphSAGERanker(nn.Module):
    def __init__(self, hidden_dim: int = 128, num_layers: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 in_features: int = NUM_HOST_FEATURES, edge_features: int = EDGE_FEATURES,
                 pair_features: int = PAIR_FEATURES):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        for i in range(num_layers):
            self.add_module(f"sage_{i}", SAGELayer(
                in_features if i == 0 else hidden_dim, hidden_dim, edge_features, compute_dtype))
        self.head_0 = Dense(2 * hidden_dim + pair_features, hidden_dim, compute_dtype)
        self.head_1 = Dense(hidden_dim, hidden_dim // 2, compute_dtype)
        self.head_out = Dense(hidden_dim // 2, 1, compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> "GraphSAGERanker":
        return flax_init_(self, generator)

    def layers(self) -> list[SAGELayer]:
        return [getattr(self, f"sage_{i}") for i in range(self.num_layers)]

    def embed(self, node_feats, edge_src, edge_dst, edge_feats, adj=None, edge_mean=None):
        """Host embeddings from the interaction graph (the serving path
        caches these). With adj/edge_mean (training.data.dense_graph_arrays)
        aggregation is one product a layer; params are identical either way."""
        n = node_feats.shape[0]
        h = node_feats
        for layer in self.layers():
            h = layer(h, edge_src, edge_dst, edge_feats, n, adj=adj, edge_mean=edge_mean)
        return h

    def embed_subset(self, node_feats, edge_src, edge_dst, edge_feats, table,
                     target_local, target_global):
        """Incremental serving refresh: re-embed a gathered subgraph
        (ops/segment.gather_coo_subgraph, LOCAL indices) and write the fresh
        rows into a copy of the (H, D) embedding ``table``. Padding targets
        carry an out-of-range global index and are dropped, as the
        reference's ``mode="drop"`` scatter drops them: they land in a
        scratch row past the end, which is cut off."""
        sub = self.embed(node_feats, edge_src, edge_dst, edge_feats)
        h = table.shape[0]
        rows = target_global.long()
        rows = torch.where(rows < 0, rows + h, rows)  # jax wraps negative indices
        rows = torch.where((rows >= 0) & (rows < h), rows, torch.full_like(rows, h))
        out = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
        out.index_put_((rows,), sub[target_local.long()].to(table.dtype))
        return out[:h]

    def score(self, child_emb, parent_emb, pair_feats):
        """child_emb (B,D) + parent_emb (B,P,D) + pair_feats (B,P,F) -> (B,P)."""
        b, p, _ = parent_emb.shape
        dt = self.compute_dtype
        child = child_emb[:, None, :].expand(b, p, child_emb.shape[-1])
        x = torch.cat([child.to(dt), parent_emb.to(dt), pair_feats.to(dt)], dim=-1)
        x = _gelu(self.head_0(x))
        x = _gelu(self.head_1(x))
        return self.head_out(x)[..., 0].float()

    def forward(self, graph: dict, child_idx, parent_idx, pair_feats):
        """Full forward: embed the graph, gather per-example embeddings, score.

        graph: dict(node_feats, edge_src, edge_dst, edge_feats[, adj, edge_mean])
        child_idx (B,), parent_idx (B,P), pair_feats (B,P,F) -> scores (B,P)
        """
        emb = self.embed(graph["node_feats"], graph["edge_src"], graph["edge_dst"],
                         graph["edge_feats"], adj=graph.get("adj"),
                         edge_mean=graph.get("edge_mean"))
        return self.score(emb[child_idx.long()], emb[parent_idx.long()], pair_feats)


def listwise_rank_loss(
    scores: torch.Tensor, throughput: torch.Tensor, mask: torch.Tensor,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Listwise softmax CE: target distribution = softmax of observed
    log-throughput over valid candidates; rows need >= 2 valid entries."""
    neg = torch.tensor(_NEG, dtype=scores.dtype, device=scores.device)
    logits = torch.where(mask, scores, neg)
    target_logits = torch.where(mask, throughput / temperature, neg)
    target = torch.softmax(target_logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    per_row = -(target * torch.where(mask, logp, 0.0)).sum(-1)
    row_ok = mask.sum(-1) >= 2
    return (per_row * row_ok).sum() / row_ok.sum().clamp_min(1).to(per_row.dtype)


@dataclasses.dataclass(frozen=True)
class RankBatch:
    """One padded training batch for the ranker (numpy arrays or tensors)."""

    child_idx: object     # (B,)
    parent_idx: object    # (B, P)
    pair_feats: object    # (B, P, F)
    throughput: object    # (B, P)
    mask: object          # (B, P)
