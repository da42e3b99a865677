"""Attention parent ranker — the set-transformer scorer, in PyTorch.

Port of dragonfly2_tpu/models/attention.py. A download's candidate-parent
list is a SET whose members attend to each other, so "is this parent
good" can depend on what else is on offer. Tokens are [tasks, candidates,
hidden] matmuls in the compute dtype (bf16); the attention inner product
is injectable, and defaults to ops/flash.py's ``flash_attention`` (the
Hopper kernels on CUDA tensors, their plain twins on CPU tensors; with
autograd on, the forward saves its logsumexp and the backward runs the
dK/dV and dQ kernels). The reference applies ``dense_attention`` by
default; ``flash_attention`` is the same function under the same masking
contract.

Module and parameter names follow the flax tree (``embed``,
``block_i/{LayerNorm_0, qkv, proj, LayerNorm_1, mlp_up, mlp_down}``, the
top-level ``LayerNorm_0``, ``score``) so models/convert.py maps one onto
the other by name. Numerics follow flax, not torch defaults:

- LayerNorm: epsilon 1e-6, statistics in float32 with the fast variance
  E[x^2] - E[x]^2 clamped at 0, output in the compute dtype;
- Dense layers compute in the compute dtype from float32 parameters, and
  the ``score`` head in float32;
- gelu is the tanh approximation;
- invalid candidate slots score -1e30.

Both ``forward``s take ``mesh`` as the reference's ``__call__``s do; in
the reference only the mixture-of-experts MLP reads it, and that MLP
(``moe_experts > 0``) is not ported yet. Sequence parallelism comes in
through ``attention_fn`` (parallel/ring.py, parallel/ulysses.py).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from dragonfly2_tpu_torch.ops.flash import flash_attention
from dragonfly2_tpu_torch.records.features import NUM_HOST_FEATURES

AttentionFn = Callable  # (q, k, v, kv_mask) -> out, all [B, H, L, D]

# pair features per (child, parent): same IDC and location match
# (training/train.py _pair_feats)
NUM_PAIR_FEATURES = 2
IN_FEATURES = 2 * NUM_HOST_FEATURES + NUM_PAIR_FEATURES


class Dense(nn.Linear):
    """flax.linen.Dense(dtype=compute_dtype): float32 parameters, inputs and
    parameters cast to the compute dtype for the product."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm(dtype=compute_dtype) with its defaults."""

    def __init__(self, features: int, compute_dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.compute_dtype = compute_dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale.float())
        return (y + self.bias.float()).to(self.compute_dtype)


class SelfAttentionBlock(nn.Module):
    """Pre-LN MHA + MLP with an injectable attention inner product."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        moe_experts: int = 0,
        moe_capacity_factor: float = 2.0,
    ):
        super().__init__()
        if moe_experts > 0:
            raise NotImplementedError("the mixture-of-experts MLP is not ported yet")
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.LayerNorm_0 = LayerNorm(hidden_dim, compute_dtype)
        self.qkv = Dense(hidden_dim, 3 * hidden_dim, compute_dtype)
        self.proj = Dense(hidden_dim, hidden_dim, compute_dtype)
        self.LayerNorm_1 = LayerNorm(hidden_dim, compute_dtype)
        self.mlp_up = Dense(hidden_dim, 4 * hidden_dim, compute_dtype)
        self.mlp_down = Dense(4 * hidden_dim, hidden_dim, compute_dtype)

    def forward(self, x, mask, attention_fn: AttentionFn = flash_attention, mesh=None):
        batch, length, _ = x.shape
        head_dim = self.hidden_dim // self.num_heads
        h = self.LayerNorm_0(x)
        q, k, v = self.qkv(h).split(self.hidden_dim, dim=-1)

        def heads(t):  # [B, L, Hd] -> [B, H, L, D]
            return t.reshape(batch, length, self.num_heads, head_dim).transpose(1, 2).contiguous()

        out = attention_fn(heads(q), heads(k), heads(v), mask)
        out = out.transpose(1, 2).reshape(batch, length, self.hidden_dim)
        x = x + self.proj(out)
        h = self.LayerNorm_1(x)
        h = F.gelu(self.mlp_up(h), approximate="tanh")
        return x + self.mlp_down(h)


class AttentionRanker(nn.Module):
    """Scores [tasks, P] candidate parents from child/parent/pair features.

    ``in_features`` is the token width, parent + child + pair features
    (flax infers it from the first call; torch needs it up front)."""

    def __init__(
        self,
        hidden_dim: int = 128,
        num_heads: int = 4,
        num_layers: int = 2,
        compute_dtype: torch.dtype = torch.bfloat16,
        moe_experts: int = 0,
        moe_capacity_factor: float = 2.0,
        in_features: int = IN_FEATURES,
    ):
        super().__init__()
        if moe_experts > 0:
            raise NotImplementedError("the mixture-of-experts MLP is not ported yet")
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        self.in_features = in_features
        self.embed = Dense(in_features, hidden_dim, compute_dtype)
        for i in range(num_layers):
            self.add_module(
                f"block_{i}", SelfAttentionBlock(hidden_dim, num_heads, compute_dtype)
            )
        self.LayerNorm_0 = LayerNorm(hidden_dim, compute_dtype)
        self.score = Dense(hidden_dim, 1, torch.float32)

    def blocks(self) -> list[SelfAttentionBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "AttentionRanker":
        """flax's init: lecun-normal kernels (truncated at 2 sigma), zero
        biases, unit LayerNorm scales — drawn from ``generator``."""
        for module in self.modules():
            if isinstance(module, Dense):
                fan_in = module.weight.shape[1]
                # stddev of the untruncated normal, as variance_scaling sets it
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(
                    module.weight, std=std, a=-2 * std, b=2 * std, generator=generator
                )
                module.bias.zero_()
            elif isinstance(module, LayerNorm):
                module.scale.fill_(1.0)
                module.bias.zero_()
        return self

    def forward(
        self,
        child_feats,  # [N, F]
        parent_feats,  # [N, P, F]
        pair_feats,  # [N, P, Fp]
        mask,  # [N, P] bool
        attention_fn: AttentionFn = flash_attention,
        mesh=None,
    ):
        n, p, _ = parent_feats.shape
        dt = self.compute_dtype
        tokens = torch.cat(
            [
                parent_feats.to(dt),
                child_feats[:, None, :].expand(n, p, child_feats.shape[-1]).to(dt),
                pair_feats.to(dt),
            ],
            dim=-1,
        )
        x = self.embed(tokens)
        for block in self.blocks():
            x = block(x, mask, attention_fn, mesh=mesh)
        x = self.LayerNorm_0(x)
        scores = self.score(x)[..., 0]
        return scores.masked_fill(~mask, -1e30)
