"""The ranking loss of dragonfly2_tpu/models/graphsage.py, in PyTorch.

Only ``listwise_rank_loss`` is ported: the attention ranker trains on it.
The GraphSAGE ranker itself is not ported yet.
"""

from __future__ import annotations

import torch

_NEG = -1e30


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
