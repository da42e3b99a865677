"""Tensor parallelism: Megatron-style column/row-parallel feed-forward.

Port of dragonfly2_tpu/parallel/tensor.py. The two-matmul block needs
exactly one collective:

    y = gelu(x @ W1 + b1) @ W2 + b2
        W1 [F, H] column-sharded over ``tp``: each shard owns H/tp of the
        hidden; gelu is elementwise, so it needs no exchange.
        W2 [H, F] row-sharded over ``tp``: partial [.., F] products,
        summed once (the reference's psum).

The reference runs the per-shard body under ``shard_map``; the port, in one
process (parallel/mesh.py), runs it over the shards' blocks in lockstep,
the psum a sum of the partials moved to each shard's device with
``Tensor.to``. Weights are (in, out) as in the reference; the products are
``torch.matmul`` (the reference's are ``jnp.dot``, no Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS


def sum_to(blocks: list[torch.Tensor], device) -> torch.Tensor:
    """The blocks' sum, in shard order, on ``device``."""
    total = blocks[0].to(device)
    for block in blocks[1:]:
        total = total + block.to(device)
    return total


def psum(blocks: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every shard's sum of all the blocks, on its own device (one sum for
    shards that share a device)."""
    sums: dict = {}
    for block in blocks:
        if block.device not in sums:
            sums[block.device] = sum_to(blocks, block.device)
    return [sums[block.device] for block in blocks]


def tp_ffn(xs, w1s, b1s, w2s, b2s) -> list[torch.Tensor]:
    """One dp row's tp shards in lockstep: ``xs[j]`` is x [..., F] on shard
    j's device (replicated over tp); ``w1s[j]`` [F, H/tp], ``b1s[j]``
    [H/tp] and ``w2s[j]`` [H/tp, F] its weight shards; ``b2s[j]`` [F]
    replicated. Returns every shard's full [..., F] output.

    Numerics are the reference's: both products accumulate in float32,
    gelu is the tanh approximation (``jax.nn.gelu``'s default) and is cast
    to x's dtype, the partials are summed once, then b2 is added and the
    result cast to x's dtype."""
    partials = []
    for x, w1, b1, w2 in zip(xs, w1s, b1s, w2s):
        h = torch.matmul(x.float(), w1.float()) + b1
        h = F.gelu(h, approximate="tanh").to(x.dtype)
        partials.append(torch.matmul(h.float(), w2.float()))
    return [(out + b2).to(x.dtype) for out, b2, x in zip(psum(partials), b2s, xs)]


def sharded_tp_ffn(mesh, x, w1, b1, w2, b2) -> torch.Tensor:
    """Batch over dp, hidden over tp, global shapes in and out: x [T, F],
    w1 [F, H], b1 [H], w2 [H, F], b2 [F]. Raises unless dp divides T and tp
    divides H, as ``shard_map`` does. The output is on x's device."""
    dp, tp = mesh.shape[DP_AXIS], mesh.shape[TP_AXIS]
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by dp={dp}")
    if w1.shape[1] % tp:
        raise ValueError(f"hidden {w1.shape[1]} not divisible by tp={tp}")
    rows = x.split(x.shape[0] // dp)
    cols = w1.shape[1] // tp
    outs = []
    for i, row in enumerate(rows):
        devs = [mesh.at(dp=i, tp=j) for j in range(tp)]
        span = [slice(j * cols, (j + 1) * cols) for j in range(tp)]
        out = tp_ffn(
            [row.to(d) for d in devs],
            [w1[:, s].to(d) for s, d in zip(span, devs)],
            [b1[s].to(d) for s, d in zip(span, devs)],
            [w2[s].to(d) for s, d in zip(span, devs)],
            [b2.to(d) for d in devs],
        )
        outs.append(out[0].to(x.device))
    return torch.cat(outs)
