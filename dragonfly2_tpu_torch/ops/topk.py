"""Masked top-k selection.

Port of dragonfly2_tpu/ops/topk.py. Invalid candidates are pushed below
every real score so selection never picks them, and validity flows back
out as a mask derived from the per-row eligible COUNT, never from
sentinel compares.

For the widths the scheduler uses (K <= 128) the selection is an exact
rank by pairwise comparison: rank[i] = #{j : score_j > score_i, or equal
score with lower index}, a strict total order, so the ranks are a
permutation. The reference scatters the top-k into place with a one-hot
einsum; here the scores and their indices are scattered by rank directly
(``scatter_``), which is exact on every device: a matmul on CUDA would go
through cuBLAS, where a TF32 setting or a -inf x 0 term could change a
value. Wider rows take a stable descending sort, which keeps lax.top_k's
lowest-index tie-break.

The mask sentinel is float32 min rather than -inf, and real scores are
first raised to ``_SCORE_FLOOR`` (NaN and -inf included; +inf becomes
float32's largest value), so an eligible but awful candidate still ranks
above every masked one.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")
_FINITE_MIN = torch.finfo(torch.float32).min
# Real scores are clamped to this floor BEFORE masking; the mask sentinel
# sits strictly below it.
_SCORE_FLOOR = -1e37

# Above this candidate width the (B, K, K) comparison tensor stops being
# cheap and a sort wins; every scheduler path sits well below.
_RANK_SELECT_MAX_WIDTH = 128


def _sanitize(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """NaN and -inf to the floor, +inf to float32 max, then masked slots to
    the sentinel."""
    sane = torch.clamp_min(
        torch.nan_to_num(scores, nan=_SCORE_FLOOR, neginf=_SCORE_FLOOR), _SCORE_FLOOR
    )
    return torch.where(mask, sane, torch.full_like(sane, _FINITE_MIN))


def _valid_slots(mask: torch.Tensor, k: int) -> torch.Tensor:
    pos = torch.arange(k, dtype=torch.int32, device=mask.device)
    return pos < mask.sum(dim=-1, dtype=torch.int32)[..., None]


def _masked_top_k_rank(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Exact top-k via pairwise ranking and a scatter by rank (no sort)."""
    n = scores.shape[-1]
    masked = _sanitize(scores, mask)
    idx = torch.arange(n, dtype=torch.int32, device=scores.device)
    s_i = masked[..., :, None]
    s_j = masked[..., None, :]
    # j outranks i when it scores higher, or ties with a lower index
    outranks = (s_j > s_i) | ((s_j == s_i) & (idx[None, :] < idx[:, None]))
    rank = outranks.sum(dim=-1)  # (..., K) int64, a permutation of 0..K-1
    width = max(n, k)  # k > K: positions past K stay empty (index 0)
    shape = masked.shape[:-1] + (width,)
    values = torch.zeros(shape, dtype=torch.float32, device=scores.device)
    values.scatter_(-1, rank, masked)
    indices = torch.zeros(shape, dtype=torch.int32, device=scores.device)
    indices.scatter_(-1, rank, idx.expand_as(masked))
    valid = _valid_slots(mask, k)
    values = values[..., :k]
    return torch.where(valid, values, torch.full_like(values, NEG_INF)), indices[..., :k], valid


def masked_top_k(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k along the last axis honoring a validity mask.

    Returns (values float32, indices int32, valid bool): ``valid[i, j]`` is
    False for slots that had fewer than j+1 valid candidates (their value
    is -inf). Ties break toward the lower index. Runs on the tensors'
    device."""
    scores = scores.to(torch.float32)
    if scores.shape[-1] <= _RANK_SELECT_MAX_WIDTH:
        return _masked_top_k_rank(scores, mask, k)
    masked = _sanitize(scores, mask)
    values, indices = torch.sort(masked, dim=-1, descending=True, stable=True)
    values, indices = values[..., :k], indices[..., :k].to(torch.int32)
    valid = _valid_slots(mask, k)
    return torch.where(valid, values, torch.full_like(values, NEG_INF)), indices, valid
