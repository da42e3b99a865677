"""Module helpers of the scheduler service.

From dragonfly2_tpu/cluster/scheduler.py (:3156-3208): the candidate
sampler both candidate-fill paths share, the eval buckets, the pipelined
tick's chunk stride and row padding. ``SchedulerService`` itself is not
ported yet.
"""

from __future__ import annotations

import numpy as np


def _round_up_64(n: int) -> int:
    return ((n + 63) // 64) * 64


def _sample_rows(rng: np.random.Generator, live: np.ndarray, m: int, k: int
                 ) -> np.ndarray:
    """(m, min(k, len(live))) independent uniform k-subsets of `live`,
    one rng draw for the whole group: random keys per row + argpartition
    (argsort when everything fits) pick k distinct slots uniformly.
    Shared by both candidate-fill paths so their rng streams match."""
    keys = rng.random((m, live.size))
    if live.size <= k:
        idx = np.argsort(keys, axis=1, kind="stable")
    else:
        idx = np.argpartition(keys, k - 1, axis=1)[:, :k]
    return live[idx].astype(np.int32)


# Fixed (B, K) batch buckets of the scheduling programs; the largest is
# the BASELINE.json eval shape (1k concurrent tasks per device call).
_EVAL_BUCKETS = (64, 256, 1024)


def _bucket_rows(n: int) -> int:
    for cap in _EVAL_BUCKETS:
        if n <= cap:
            return cap
    return _EVAL_BUCKETS[-1]


def _chunk_stride(b: int) -> int:
    """Chunk stride for the pipelined tick: the smallest bucket that cuts
    the batch into at most 4 chunks — for batches up to 4x the largest
    bucket (4096 rows); beyond that the stride stays at the largest
    bucket and the chunk count grows with the batch (ceil(b/1024), the
    pre-pipeline chunking). A batch that fits the smallest bucket stays
    one chunk (nothing to overlap); anything larger splits so the double
    buffer has at least two device calls to pipeline. Total padded rows
    never exceed the single-big-bucket split (4 x 64 = 256, 4 x 256 =
    1024), so compute cost is unchanged while per-chunk D2H round-trips
    overlap. Every chunk still pads to one of the three fixed buckets."""
    for cap in _EVAL_BUCKETS:
        if -(-b // cap) <= 4:
            return cap
    return _EVAL_BUCKETS[-1]


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])
