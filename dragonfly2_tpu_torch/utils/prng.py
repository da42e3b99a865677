"""The reference's random draws, bit for bit, in torch.

The reference draws its probe jitter with ``jax.random.uniform`` from a
``jax.random.key(seed)`` (ops/ewma.py ``least_probed_hosts``; the simulator
keys it with a Python ``randint``). This module reproduces that stream
exactly: the default threefry2x32 generator with partitionable counters,
so a seed gives the port and the reference the same float32 bits, and the
same tie-breaks among equally probed hosts.

- ``key(seed)`` is (0, seed) for a 32-bit seed (the high word of a 64-bit
  seed, then the low word).
- Element i of a draw of n is threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)),
  its two output words XORed.
- A float32 in [0, 1) is the top 23 bits under the exponent of 1.0, minus
  1; ``uniform`` scales it to [minval, maxval) and clamps at minval. XLA
  fuses the scale into one multiply-add rounded once, so the port
  computes it in float64, where the product is exact, and rounds once.

The words are held in int64 tensors masked to 32 bits, so the same code
runs on the CPU and on the card.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s two words for a seed below 2**63."""
    if seed < 0:
        raise ValueError(f"seed {seed} must be non-negative")
    return (seed >> 32) & _MASK, seed & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round threefry2x32 block of two int64 tensors of 32-bit words."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _MASK
    return x0, x1


def random_bits(k: tuple[int, int], n: int, device=None) -> torch.Tensor:
    """``n`` 32-bit words (int64) as ``jax.random.bits`` draws them."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k, i >> 32, i & _MASK)
    return x0 ^ x1


def uniform(k: tuple[int, int], n: int, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=minval, maxval=maxval)`` in
    float32, bit for bit."""
    mantissa = (random_bits(k, n, device) >> 9) | 0x3F800000
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    scale = (torch.tensor(maxval, dtype=torch.float32, device=device) - lo).double()
    return torch.maximum(lo, (floats.double() * scale + lo.double()).float())
