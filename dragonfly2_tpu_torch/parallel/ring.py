"""Ring attention: sequence parallelism over the mesh's ``sp`` axis.

Port of dragonfly2_tpu/parallel/ring.py. Each shard keeps its query block
and attends it to one KV block per step while the KV blocks rotate one hop
around the ring, with a flash-style online softmax (running max, sum and
float32 accumulator), so nothing materialises the full [L, L] score
matrix. The reference runs the per-shard body under ``shard_map`` with
``lax.ppermute`` for the rotation; the port runs it in one process over
the blocks of every shard in lockstep (parallel/mesh.py), and the rotation
is a ``Tensor.to`` of each KV block to the next shard's device.

Layouts: q/k/v are [B, H, L, D] and kv_mask is a [B, L] bool key-validity
mask. ``dense_attention`` is the single-device reference and the parity
oracle in tests.
"""

from __future__ import annotations

import math

import torch

from dragonfly2_tpu_torch.parallel.mesh import DP_AXIS, SP_AXIS, shard_rows, unshard_rows

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


def ring_attention(qs, ks, vs, masks, use_flash: bool = False, q_pos=None, k_pos=None):
    """The ring over one dp row's sp shards, in lockstep: ``qs[j]``,
    ``ks[j]``, ``vs[j]`` ([B, H, L/sp, D]) and ``masks[j]`` ([B, L/sp]) are
    shard j's blocks on its device. Every step attends each shard's queries
    to the KV block it holds, then hands every KV block to the next shard
    (shard j receives shard j-1's). Returns the shards' outputs, a list.

    ``use_flash=True`` computes each block with ops/flash.py's
    ``flash_attention_partials`` (the partial kernel on CUDA) and merges the
    partials with the same combine. Forward-only: the partials have no
    gradient, so training keeps the einsum path.

    Causal mode: pass ``q_pos``/``k_pos``, each shard's GLOBAL sequence
    positions ([L/sp] int64, one tensor per shard). Keys with k_pos > q_pos
    are masked as the KV blocks rotate, so the mask holds under any layout,
    the zigzag one of ``zigzag_positions`` included (einsum path only).

    No block is written in place: on one device ``Tensor.to`` hands the
    same tensor to the next shard."""
    causal = q_pos is not None
    if k_pos is not None and q_pos is None:
        raise ValueError("k_pos without q_pos: causal masking is keyed on "
                         "q_pos — passing only k_pos would silently compute "
                         "full bidirectional attention")
    if causal and use_flash:
        raise ValueError("causal ring attention uses the einsum path "
                         "(the flash partials kernel has no position mask)")
    n = len(qs)
    devices = [q.device for q in qs]
    scale = 1.0 / math.sqrt(qs[0].shape[-1])
    if use_flash:
        from dragonfly2_tpu_torch.ops.flash import flash_attention_partials

    def attend_block(j, acc, row_max, row_sum, kb, vb, mb, kpb=None):
        if use_flash:
            acc_b, m_b, l_b = flash_attention_partials(qs[j], kb, vb, mb)
            new_max = torch.maximum(row_max, m_b)
            c_old = torch.exp(row_max - new_max)
            c_new = torch.exp(m_b - new_max)
            acc = acc * c_old[..., None] + acc_b * c_new[..., None]
            return acc, new_max, row_sum * c_old + l_b * c_new
        scores = torch.einsum("bhqd,bhkd->bhqk", qs[j].float(), kb.float()) * scale
        key_valid = mb[:, None, None, :]
        if causal:
            key_valid = key_valid & (kpb[None, :] <= q_pos[j][:, None])[None, None]
        scores = torch.where(key_valid, scores, _NEG)
        new_max = torch.maximum(row_max, scores.amax(-1))
        correction = torch.exp(row_max - new_max)
        probs = torch.exp(scores - new_max[..., None]) * key_valid
        acc = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", probs, vb.float())
        return acc, new_max, row_sum * correction + probs.sum(-1)

    states = []
    for q in qs:
        stats = q.shape[:3]
        states.append((
            torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full(stats, _NEG, dtype=torch.float32, device=q.device),
            torch.zeros(stats, dtype=torch.float32, device=q.device),
        ))
    # key positions ride the ring with their blocks (causal mode only)
    blocks = [list(ks), list(vs), list(masks)]
    if causal:
        blocks.append(list(k_pos if k_pos is not None else q_pos))
    # n - 1 attend + rotate steps, then the last block attends without the
    # trailing rotation, whose output nobody would read
    for step in range(n):
        states = [attend_block(j, *states[j], *(b[j] for b in blocks)) for j in range(n)]
        if step < n - 1:
            blocks = [[b[(j - 1) % n].to(devices[j]) for j in range(n)] for b in blocks]
    return [
        (acc / row_sum.clamp_min(1e-9)[..., None]).to(q.dtype)
        for q, (acc, _, row_sum) in zip(qs, states)
    ]


def _check_mask(kv_mask) -> None:
    if kv_mask.dtype != torch.bool:
        raise ValueError(f"kv_mask must be bool, got {kv_mask.dtype}")


def sharded_ring_attention(mesh, q, k, v, kv_mask, use_flash: bool = False) -> torch.Tensor:
    """Batch over ``dp``, sequence over ``sp``: global [B, H, L, D] in and
    out (the output on q's device), each shard holding L/sp of the sequence
    while the KV blocks ride the ring. ``use_flash`` computes the blocks
    with the partials kernel (forward-only)."""
    _check_mask(kv_mask)
    qb, kb, vb = (shard_rows(mesh, t, 2) for t in (q, k, v))
    mb = shard_rows(mesh, kv_mask, 1)
    out = [
        ring_attention(qb[i], kb[i], vb[i], mb[i], use_flash=use_flash)
        for i in range(mesh.shape[DP_AXIS])
    ]
    return unshard_rows(out, 2, q.device)


# ------------------------------------------------------------- causal sp


def zigzag_positions(seq_len: int, n_shards: int):
    """Zigzag context-parallel layout: split the sequence into 2n chunks
    and give shard i chunks (i, 2n-1-i), so every shard owns one early and
    one late chunk and the causal work per shard evens out.

    Returns (order, inverse), int64 tensors: ``x[..., order, :]`` lays the
    sequence out in zigzag shard order; ``y[..., inverse, :]`` undoes it.
    ``order`` is also each zigzag slot's global position (what the causal
    mask needs)."""
    if seq_len % (2 * n_shards):
        raise ValueError(f"seq_len {seq_len} not divisible by 2*{n_shards}")
    chunk = seq_len // (2 * n_shards)
    order = []
    for i in range(n_shards):
        order.extend(range(i * chunk, (i + 1) * chunk))
        j = 2 * n_shards - 1 - i
        order.extend(range(j * chunk, (j + 1) * chunk))
    order = torch.tensor(order, dtype=torch.int64)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(seq_len, dtype=torch.int64)
    return order, inverse


def sharded_causal_ring_attention(mesh, q, k, v, kv_mask) -> torch.Tensor:
    """Causal ring attention over ``sp`` with zigzag load balancing. Global
    [B, H, L, D] in and out, in contiguous sequence order: the zigzag
    reorder and its inverse happen here, and positions ride the ring, so
    the masking is layout-independent. Einsum path."""
    _check_mask(kv_mask)
    sp = mesh.shape[SP_AXIS]
    order, inverse = zigzag_positions(q.shape[2], sp)
    order, inverse = order.to(q.device), inverse.to(q.device)
    qb, kb, vb = (shard_rows(mesh, x.index_select(2, order), 2) for x in (q, k, v))
    mb = shard_rows(mesh, kv_mask.index_select(1, order), 1)
    positions = order.split(q.shape[2] // sp)
    out = []
    for i in range(mesh.shape[DP_AXIS]):
        pos = [positions[j].to(mesh.device(i, j)) for j in range(sp)]
        out.append(ring_attention(qb[i], kb[i], vb[i], mb[i], q_pos=pos, k_pos=pos))
    return unshard_rows(out, 2, q.device).index_select(2, inverse)
