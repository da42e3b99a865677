"""Probe RTT ring buffers + folded EWMA — device-resident network topology.

Port of dragonfly2_tpu/ops/ewma.py. The reference's Redis probe lists
(`probes:src:dst`, queue length 5) and their moving average (probes.go:
avg starts at the oldest probe and folds `avg = W*avg + (1-W)*sample` over
the queue in order, W = 0.1) are a (N, Q) ring-buffer tensor updated by
scatters on its device.

Two places where torch promises less than the reference's XLA programs:

- a scatter with duplicate indices has no defined winner on CUDA, so
  ``enqueue`` writes every duplicate of a pair with the batch's LAST value
  for that pair, which is what the reference's scatter keeps;
- ``torch.topk`` has no defined order among ties, so ``least_probed_hosts``
  takes a stable ascending sort, the order ``lax.top_k(-keys, k)`` gives
  (ties to the lower index).

The jitter is the reference's ``jax.random.uniform`` draw, bit for bit
(utils/prng.py).
"""

from __future__ import annotations

import torch

from dragonfly2_tpu_torch.config.constants import CONSTANTS
from dragonfly2_tpu_torch.utils import prng

W = CONSTANTS.EWMA_WEIGHT  # weight on the running average


def _ordered(ring: torch.Tensor, cursor: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Return ring contents oldest->newest along the last axis."""
    q = ring.shape[-1]
    idx = torch.arange(q, dtype=torch.int64, device=ring.device)
    start = torch.where(count[..., None] >= q, cursor[..., None].long(), 0)
    return torch.gather(ring, -1, (start + idx) % q)


def fold_average(ring: torch.Tensor, cursor: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Folded moving average over each pair's queue (probes.go:175-200).
    Empty queues yield 0.

    float32 as the reference's jitted fold rounds it: XLA fuses each step
    into fma(W, avg, (1 - W) * x), the sample's product rounded to float32
    and the sum rounded once. The port adds in float64, where W * avg is
    exact, and rounds once, the same bits on every device."""
    ordered = _ordered(ring, cursor, count)
    q = ring.shape[-1]
    w = torch.tensor(W, dtype=torch.float32, device=ring.device).double()
    w_new = torch.tensor(1.0 - W, dtype=torch.float32, device=ring.device)
    avg = ordered[..., 0]
    for i in range(1, q):
        step = (w * avg.double() + (w_new * ordered[..., i]).double()).float()
        avg = torch.where(count > i, step, avg)
    return torch.where(count > 0, avg, torch.zeros_like(avg))


def enqueue(
    ring: torch.Tensor,      # (N, Q) float32 rtt ns
    cursor: torch.Tensor,    # (N,) int32 next write slot
    count: torch.Tensor,     # (N,) int32 valid entries
    pair_idx: torch.Tensor,  # (M,) int pairs receiving a new probe
    rtt_ns: torch.Tensor,    # (M,) float32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter M new probes into their pair rings, drop the oldest where
    full, and return (ring, cursor, count, averages of ALL pairs), new
    tensors. Duplicate pair ids within one batch keep the last write."""
    pair_idx = pair_idx.long()
    m = pair_idx.shape[0]
    pos = torch.arange(m, dtype=torch.int64, device=ring.device)
    last = torch.full((ring.shape[0],), -1, dtype=torch.int64, device=ring.device)
    last.scatter_reduce_(0, pair_idx, pos, reduce="amax")
    value = rtt_ns.to(torch.float32)[last[pair_idx]]  # every duplicate writes the last one
    write_slot = cursor[pair_idx].long()
    q = ring.shape[-1]
    ring = ring.index_put((pair_idx, write_slot), value)
    cursor = cursor.index_put((pair_idx,), ((write_slot + 1) % q).to(cursor.dtype))
    count = count.index_put((pair_idx,), torch.clamp_max(count[pair_idx] + 1, q))
    return ring, cursor, count, fold_average(ring, cursor, count)


def probed_count_increment(probed_count: torch.Tensor, host_idx: torch.Tensor) -> torch.Tensor:
    """INCR probed-count:host for each probed destination (probes.go:214-218)."""
    ones = torch.ones(host_idx.shape, dtype=probed_count.dtype, device=probed_count.device)
    return probed_count.index_add(0, host_idx.long(), ones)


def least_probed_hosts(
    probed_count: torch.Tensor, alive: torch.Tensor, noise_key: tuple[int, int],
    k: int = CONSTANTS.FIND_PROBED_HOSTS_LIMIT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick up to k alive hosts, least-probed first with random tie-break —
    FindProbedHosts semantics (networktopology/network_topology.go:190-257).
    Returns (indices, valid): dead hosts sort last and come back invalid."""
    n = probed_count.shape[0]
    jitter = prng.uniform(noise_key, n, 0.0, 0.5, device=probed_count.device)
    keys = torch.where(alive, probed_count.to(torch.float32) + jitter,
                       torch.full_like(jitter, float("inf")))
    idx = torch.sort(keys, stable=True).indices[:k]
    return idx, alive[idx]
