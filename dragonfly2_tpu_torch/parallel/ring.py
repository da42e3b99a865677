"""Plain attention with the reference's masking contract.

Port of ``dense_attention`` from dragonfly2_tpu/parallel/ring.py (the ring
attention itself is not ported yet). Layouts: q/k/v are [B, H, L, D] and
kv_mask is a [B, L] bool key-validity mask.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30


def dense_attention(q, k, v, kv_mask, causal: bool = False) -> torch.Tensor:
    """Reference softmax attention. [B,H,L,D] x [B,L] -> [B,H,L,D].

    Products take the input dtype and accumulate in float32: bf16 values
    widen to float32 exactly, so a float32 matmul of the widened inputs is
    the reference's bf16-in, f32-accumulate einsum. Masked keys are filled
    with -1e30 before the softmax, and rows with no valid key come out 0.
    ``causal`` keeps key positions <= the query position."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = kv_mask.bool()[:, None, None, :].expand(scores.shape)
    if causal:
        ln = q.shape[2]
        pos = torch.arange(ln, device=q.device)
        valid = valid & (pos[None, :] <= pos[:, None])[None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1) * valid
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
