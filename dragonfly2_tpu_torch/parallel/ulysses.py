"""Ulysses (all-to-all) sequence parallelism, the second long-context
strategy beside ring attention (parallel/ring.py).

Port of dragonfly2_tpu/parallel/ulysses.py. Where the ring keeps queries
resident and rotates KV blocks hop by hop, Ulysses re-shards twice: heads
scatter across the ``sp`` axis while the sequence gathers, every shard runs
exact full-sequence attention over H/sp heads, and the inverse exchange
restores the sequence sharding. The reference does that with two
``lax.all_to_all``s and an ``all_gather`` of the key mask; the port, in one
process (parallel/mesh.py), with slices of the shards' blocks moved with
``Tensor.to`` and joined with ``torch.cat``.

The local attend ``inner`` defaults to ops/flash.py's ``flash_attention``
(the reference's default is ``dense_attention``, the same function under
the same masking contract): under autograd it runs ``FlashAttention``, so
the training kernels run here too.

Layouts match ring.py: q/k/v [B, H, L, D], kv_mask [B, L] key validity.
"""

from __future__ import annotations

from typing import Callable

import torch

from dragonfly2_tpu_torch.ops.flash import flash_attention
from dragonfly2_tpu_torch.parallel.mesh import DP_AXIS, shard_rows, unshard_rows


def ulysses_attention(qs, ks, vs, masks, inner: Callable = flash_attention, causal: bool = False):
    """One dp row's sp shards in lockstep: ``qs[j]`` etc. are shard j's
    [B, H, L/sp, D] blocks (``masks[j]`` its [B, L/sp] key mask) on its
    device; returns the shards' [B, H, L/sp, D] outputs, a list.

    Exchange 1: shard j gathers head group j of every shard's sequence
    block, [B, H/sp, L, D], and the whole key mask. ``inner`` attends the
    full sequence for that head group. Exchange 2 inverts the first.
    Requires H % sp == 0."""
    sp = len(qs)
    heads = qs[0].shape[1]
    if heads % sp:
        raise ValueError(f"num_heads={heads} must be divisible by sp={sp}")
    group = heads // sp
    devices = [q.device for q in qs]

    def scatter_heads(blocks):  # sp x [B, H, Ls, D] -> sp x [B, H/sp, L, D]
        return [
            torch.cat([b[:, j * group:(j + 1) * group].to(dev) for b in blocks], dim=2)
            for j, dev in enumerate(devices)
        ]

    def gather_heads(blocks):  # sp x [B, H/sp, L, D] -> sp x [B, H, Ls, D]
        ls = blocks[0].shape[2] // sp
        return [
            torch.cat([b[:, :, i * ls:(i + 1) * ls].to(dev) for b in blocks], dim=1)
            for i, dev in enumerate(devices)
        ]

    qg, kg, vg = scatter_heads(qs), scatter_heads(ks), scatter_heads(vs)
    # every shard needs the full-sequence key mask for its head group
    mask_full = [torch.cat([m.to(dev) for m in masks], dim=1) for dev in devices]
    out = [inner(qg[j], kg[j], vg[j], mask_full[j], causal=causal) for j in range(sp)]
    return gather_heads(out)


def sharded_ulysses_attention(
    mesh, q, k, v, kv_mask, inner: Callable = flash_attention, causal: bool = False
) -> torch.Tensor:
    """Batch over ``dp``, sequence over ``sp``: the same global-shapes
    in/out contract as ring.sharded_ring_attention (the output on q's
    device), so the two strategies are drop-in swaps for each other."""
    qb, kb, vb = (shard_rows(mesh, t, 2) for t in (q, k, v))
    mb = shard_rows(mesh, kv_mask, 1)
    out = [
        ulysses_attention(qb[i], kb[i], vb[i], mb[i], inner=inner, causal=causal)
        for i in range(mesh.shape[DP_AXIS])
    ]
    return unshard_rows(out, 2, q.device)
