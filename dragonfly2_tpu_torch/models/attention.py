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

Both ``forward``s take ``mesh`` as the reference's ``__call__``s do; only
the mixture-of-experts MLP (``moe_experts > 0``, parallel/moe.py) reads it,
routing through the all_to_alls when the mesh has ep > 1. Sequence
parallelism comes in through ``attention_fn`` (parallel/ring.py,
parallel/ulysses.py). Given ``tp_attention_fns`` (one attention function a
tp shard), the blocks run tensor-parallel over the mesh's tp axis, the
port's counterpart of the reference's GSPMD param shardings
(training/train.py ``_attention_tp_shardings``). ``PipelineRanker`` is the
reference's pipeline-parallel ranker (training/train.py
``_build_pp_ranker``): one block a pp stage on the GPipe schedule.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from dragonfly2_tpu_torch.ops.flash import flash_attention
from dragonfly2_tpu_torch.parallel import moe as moe_lib
from dragonfly2_tpu_torch.parallel.mesh import EP_AXIS, PP_AXIS
from dragonfly2_tpu_torch.parallel.pipeline import sharded_pipeline_apply
from dragonfly2_tpu_torch.parallel.tensor import sum_to
from dragonfly2_tpu_torch.records.features import NUM_HOST_FEATURES

AttentionFn = Callable  # (q, k, v, kv_mask) -> out, all [B, H, L, D]

# pair features per (child, parent): same IDC and location match
# (training/train.py _pair_feats)
NUM_PAIR_FEATURES = 2
IN_FEATURES = 2 * NUM_HOST_FEATURES + NUM_PAIR_FEATURES


class Dense(nn.Linear):
    """flax.linen.Dense(dtype=compute_dtype): float32 parameters, inputs and
    parameters cast to the compute dtype for the product."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # stddev of the untruncated normal, as variance_scaling sets it
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def flax_init_(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's init for every Dense, LayerNorm and MoE MLP under ``root``:
    lecun-normal kernels (truncated at 2 sigma), zero biases, unit
    LayerNorm scales, drawn from ``generator`` in module order. A 3-D MoE
    weight [E, in, out] counts its expert dim as receptive field, as
    flax's ``variance_scaling`` does: fan_in is in x E. Returns ``root``."""
    for module in root.modules():
        if isinstance(module, Dense):
            _lecun_normal_(module.weight, module.weight.shape[1], generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, SelfAttentionBlock) and module.moe_experts > 0:
            for name in ("moe_gate", "moe_w1", "moe_w2"):
                weight = getattr(module, name)
                receptive = weight.shape[0] if weight.dim() == 3 else 1
                _lecun_normal_(weight, weight.shape[-2] * receptive, generator)
            module.moe_b1.zero_()
            module.moe_b2.zero_()
    return root


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


def _linear(x, weight, bias, dtype):
    """A Dense product in ``dtype`` from a slice of its parameters."""
    return F.linear(x.to(dtype), weight.to(dtype), None if bias is None else bias.to(dtype))


def _groups(n: int, parts: int) -> list[tuple[int, int, int]]:
    """(part j, start, stop) of each non-empty group of
    ``torch.tensor_split(range(n), parts)``."""
    bounds, start = [], 0
    for j, size in enumerate(len(g) for g in torch.tensor_split(torch.arange(n), parts)):
        if size:
            bounds.append((j, start, start + size))
        start += size
    return bounds


class SelfAttentionBlock(nn.Module):
    """Pre-LN MHA + MLP with an injectable attention inner product.

    moe_experts > 0 swaps the dense MLP for a Switch-style top-1 mixture of
    expert scorers (parallel/moe.py), flax-named raw parameters
    ``moe_gate`` [F, E], ``moe_w1`` [E, F, 4F], ``moe_b1`` [E, 4F],
    ``moe_w2`` [E, 4F, F] and ``moe_b2`` [E, F]. On a mesh with ep > 1 the
    expert queues ride the all_to_alls; otherwise the exact no-drop
    ``moe_reference``."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        moe_experts: int = 0,
        moe_capacity_factor: float = 2.0,
    ):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.moe_experts = moe_experts
        self.moe_capacity_factor = moe_capacity_factor
        self.LayerNorm_0 = LayerNorm(hidden_dim, compute_dtype)
        self.qkv = Dense(hidden_dim, 3 * hidden_dim, compute_dtype)
        self.proj = Dense(hidden_dim, hidden_dim, compute_dtype)
        self.LayerNorm_1 = LayerNorm(hidden_dim, compute_dtype)
        f, e, wide = hidden_dim, moe_experts, 4 * hidden_dim
        if moe_experts > 0:
            self.moe_gate = nn.Parameter(torch.zeros(f, e))
            self.moe_w1 = nn.Parameter(torch.zeros(e, f, wide))
            self.moe_b1 = nn.Parameter(torch.zeros(e, wide))
            self.moe_w2 = nn.Parameter(torch.zeros(e, wide, f))
            self.moe_b2 = nn.Parameter(torch.zeros(e, f))
        else:
            self.mlp_up = Dense(hidden_dim, wide, compute_dtype)
            self.mlp_down = Dense(wide, hidden_dim, compute_dtype)

    def forward(self, x, mask, attention_fn: AttentionFn = flash_attention, mesh=None,
                tp_attention_fns=None):
        if tp_attention_fns is not None:
            return self._forward_tp(x, mask, tp_attention_fns, mesh)
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
        if self.moe_experts > 0:
            return x + self._moe(h, mesh)
        h = F.gelu(self.mlp_up(h), approximate="tanh")
        return x + self.mlp_down(h)

    def _forward_tp(self, x, mask, attention_fns, mesh):
        """The block as tp shards (Megatron): shard j holds head group j's
        columns of ``qkv`` (q, k and v alike) and its slice of ``mlp_up``'s
        columns, biases following, and the matching rows of ``proj`` and
        ``mlp_down``, whose partial products are summed before their
        biases are added; the LayerNorms stay whole. Shard j attends over
        its head group through ``attention_fns[j]`` on the tp axis's j-th
        device. The heads and the MLP's width split as
        ``torch.tensor_split`` splits them; a shard left empty does
        nothing."""
        tp = len(attention_fns)
        batch, length, _ = x.shape
        hd, dt = self.hidden_dim, self.compute_dtype
        d = hd // self.num_heads
        devices = [mesh.at(tp=j) for j in range(tp)]
        h = self.LayerNorm_0(x)
        partials = []
        for j, first, last in _groups(self.num_heads, tp):
            dev, lo, hi = devices[j], first * d, last * d
            rows = [slice(lo + o, hi + o) for o in (0, hd, 2 * hd)]
            w = torch.cat([self.qkv.weight[r] for r in rows]).to(dev)
            b = torch.cat([self.qkv.bias[r] for r in rows]).to(dev)
            q, k, v = _linear(h.to(dev), w, b, dt).split(hi - lo, dim=-1)

            def heads(t):  # [B, L, g*D] -> [B, g, L, D]
                return t.reshape(batch, length, last - first, d).transpose(1, 2).contiguous()

            out = attention_fns[j](heads(q), heads(k), heads(v), mask.to(dev))
            out = out.transpose(1, 2).reshape(batch, length, hi - lo)
            partials.append(_linear(out, self.proj.weight[:, lo:hi].to(dev), None, dt))
        # the row-parallel products' sum (the reference's psum)
        x = x + sum_to(partials, x.device) + self.proj.bias.to(dt)
        h = self.LayerNorm_1(x)
        if self.moe_experts > 0:
            return x + self._moe(h, mesh)
        partials = []
        for j, lo, hi in _groups(self.mlp_up.out_features, tp):
            dev = devices[j]
            u = _linear(h.to(dev), self.mlp_up.weight[lo:hi].to(dev),
                        self.mlp_up.bias[lo:hi].to(dev), dt)
            u = F.gelu(u, approximate="tanh")
            partials.append(_linear(u, self.mlp_down.weight[:, lo:hi].to(dev), None, dt))
        return x + (sum_to(partials, x.device) + self.mlp_down.bias.to(dt))

    def _moe(self, h, mesh):
        e = self.moe_experts
        shape = h.shape
        tokens = h.reshape(-1, self.hidden_dim)
        params = (self.moe_gate, self.moe_w1, self.moe_b1, self.moe_w2, self.moe_b2)
        if mesh is not None and mesh.shape[EP_AXIS] > 1:
            ep = mesh.shape[EP_AXIS]
            t_local = tokens.shape[0] // ep
            capacity = max(1, int(t_local / e * self.moe_capacity_factor))
            out = moe_lib.sharded_moe_ffn(mesh, tokens, *params, capacity=capacity)
        else:
            out = moe_lib.moe_reference(tokens, *params)
        return out.reshape(shape).to(self.compute_dtype)


def _tokens(child_feats, parent_feats, pair_feats, dtype) -> torch.Tensor:
    """[N, P, F] tokens: a candidate's features, its child's, the pair's."""
    n, p, _ = parent_feats.shape
    return torch.cat(
        [
            parent_feats.to(dtype),
            child_feats[:, None, :].expand(n, p, child_feats.shape[-1]).to(dtype),
            pair_feats.to(dtype),
        ],
        dim=-1,
    )


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
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        self.in_features = in_features
        self.embed = Dense(in_features, hidden_dim, compute_dtype)
        for i in range(num_layers):
            self.add_module(
                f"block_{i}",
                SelfAttentionBlock(hidden_dim, num_heads, compute_dtype, moe_experts,
                                   moe_capacity_factor),
            )
        self.LayerNorm_0 = LayerNorm(hidden_dim, compute_dtype)
        self.score = Dense(hidden_dim, 1, torch.float32)

    def blocks(self) -> list[SelfAttentionBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def reset_parameters(self, generator: torch.Generator) -> "AttentionRanker":
        return flax_init_(self, generator)

    def forward(
        self,
        child_feats,  # [N, F]
        parent_feats,  # [N, P, F]
        pair_feats,  # [N, P, Fp]
        mask,  # [N, P] bool
        attention_fn: AttentionFn = flash_attention,
        mesh=None,
        tp_attention_fns=None,
    ):
        x = self.embed(_tokens(child_feats, parent_feats, pair_feats, self.compute_dtype))
        for block in self.blocks():
            x = block(x, mask, attention_fn, mesh=mesh, tp_attention_fns=tp_attention_fns)
        x = self.LayerNorm_0(x)
        scores = self.score(x)[..., 0]
        return scores.masked_fill(~mask, -1e30)


class PipelineRanker(nn.Module):
    """The deep pipeline-parallel variant of the ranker (the reference's
    ``_build_pp_ranker``, training/train.py:946): ``embed``, the final
    LayerNorm ``ln`` and ``score`` on the model's device, and ``stages``
    SelfAttentionBlocks (4 heads, no MoE), one a pp stage on the GPipe
    schedule (parallel/pipeline.py). ``blocks`` is one block whose every
    parameter is stacked [stages, ...], stage i's at index i, as the
    reference's tree stacks them; each stage runs the block on its slice
    (``torch.func.functional_call``). The candidate mask rides each
    microbatch as an extra channel, and the rows are padded with masked
    rows to a multiple of ``microbatches``. Its flax tree wraps each
    top-level entry in ``{"params": ...}`` (models/convert.py)."""

    flax_collections = True

    def __init__(self, hidden_dim: int, stages: int, microbatches: int,
                 compute_dtype: torch.dtype = torch.bfloat16, in_features: int = IN_FEATURES):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.stages = stages
        self.microbatches = microbatches
        self.compute_dtype = compute_dtype
        self.in_features = in_features
        self.embed = Dense(in_features, hidden_dim, compute_dtype)
        self.blocks = SelfAttentionBlock(hidden_dim, compute_dtype=compute_dtype)
        for name, param in list(self.blocks.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            stacked = param.detach()[None].repeat(stages, *([1] * param.dim()))
            setattr(self.blocks.get_submodule(owner), leaf, nn.Parameter(stacked))
        self.ln = LayerNorm(hidden_dim, compute_dtype)
        self.score = Dense(hidden_dim, 1, torch.float32)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "PipelineRanker":
        for module in (self.embed, self.ln, self.score):
            flax_init_(module, generator)
        for i in range(self.stages):
            stage = flax_init_(SelfAttentionBlock(self.hidden_dim, compute_dtype=self.compute_dtype),
                               generator)
            for name, param in stage.named_parameters():
                self.blocks.get_parameter(name)[i] = param
        return self

    def forward(self, child_feats, parent_feats, pair_feats, mask,
                attention_fn: AttentionFn = flash_attention, mesh=None, tp_attention_fns=None):
        if mesh is None or mesh.shape[PP_AXIS] != self.stages:
            raise ValueError(f"the pipeline ranker runs on a mesh with pp = {self.stages}")
        if tp_attention_fns is not None:
            raise ValueError("the pipeline ranker's blocks do not run tensor-parallel")
        hidden = self.hidden_dim
        x = self.embed(_tokens(child_feats, parent_feats, pair_feats, self.compute_dtype))
        n, p, _ = x.shape
        pad = (-n) % self.microbatches
        x = torch.cat([x, x.new_zeros((pad, p, hidden))])
        mask_p = torch.cat([mask, mask.new_zeros((pad, p))])
        a = torch.cat([x, mask_p[..., None].to(x.dtype)], dim=-1)
        a = a.reshape(self.microbatches, -1, p, hidden + 1)

        def stage_fn(params, act):  # act: [mb, P, hidden + 1]
            tok, flag = act[..., :hidden], act[..., hidden:]
            y = torch.func.functional_call(self.blocks, params, (tok, flag[..., 0] > 0.5),
                                           {"attention_fn": attention_fn})
            return torch.cat([y, flag], dim=-1)

        y = sharded_pipeline_apply(mesh, stage_fn, dict(self.blocks.named_parameters()), a)
        y = y.reshape(-1, p, hidden + 1)[:n, :, :hidden]
        scores = self.score(self.ln(y))[..., 0]
        return scores.masked_fill(~mask, -1e30)
