"""Training input pipeline: ragged traces -> fixed-shape batches.

The minibatch index stream of dragonfly2_tpu/training/data.py: one static
batch shape per model, minibatches cycled with a seeded permutation, the
final short batch wrapped around so every step sees the same shape. It
draws from the same ``np.random.Generator`` in the same order as the
reference, so a seed gives both packages the same batches.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def minibatches(
    n: int, batch_size: int, rng: np.random.Generator, shuffle: bool = True
) -> Iterator[np.ndarray]:
    """Yield index arrays of EXACTLY batch_size (last one wraps around),
    keeping shapes static across steps."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        if len(idx) < batch_size:
            idx = np.concatenate([idx, order[: batch_size - len(idx)]])
        yield idx
