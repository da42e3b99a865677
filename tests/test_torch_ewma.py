"""ops/ewma.py against dragonfly2_tpu/ops/ewma.py on the same numpy inputs.

Everything is held exactly: the rings, cursors, counts and probed counts
are integers or copies, and the averages are the reference's float32 bits
(the port rounds the fold as XLA's fused multiply-add does). Duplicate
pair ids in one batch keep the last write; ``least_probed_hosts`` returns
the reference's indices, ties and dead hosts included."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import ewma as ref
from dragonfly2_tpu_torch.ops import ewma
from dragonfly2_tpu_torch.utils import prng


def _state(n, q=5):
    return (np.zeros((n, q), np.float32), np.zeros(n, np.int32), np.zeros(n, np.int32))


def _both_enqueue(rng, pairs, batches, batch_sizes, scale_exp=(3, 9)):
    ring, cursor, count = _state(pairs)
    want = tuple(jnp.asarray(a) for a in (ring, cursor, count))
    got = tuple(torch.from_numpy(a.copy()) for a in (ring, cursor, count))
    for _ in range(batches):
        m = int(rng.choice(batch_sizes))  # few shapes: the reference compiles each
        pair_idx = rng.integers(0, pairs, m).astype(np.int32)
        rtt = (rng.random(m) * 10 ** rng.uniform(*scale_exp)).astype(np.float32)
        *want, want_avg = ref.enqueue(*want, jnp.asarray(pair_idx), jnp.asarray(rtt))
        *got, got_avg = ewma.enqueue(*got, torch.from_numpy(pair_idx), torch.from_numpy(rtt))
        for g, w, name in zip(got, want, ("ring", "cursor", "count")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(got_avg.numpy().view(np.uint32),
                                      np.asarray(want_avg).view(np.uint32))
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_enqueue_matches_reference_over_a_stream(seed):
    """Batches of up to 3x the pair count: duplicates in most batches, rings
    filled and wrapped many times over."""
    rng = np.random.default_rng(seed)
    ring, cursor, count = _both_enqueue(rng, pairs=97, batches=40, batch_sizes=(1, 29, 300))
    assert int(count.min()) == 5  # every ring full, so every fold ran whole


def test_duplicate_pairs_keep_the_last_write():
    ring, cursor, count = (torch.from_numpy(a) for a in _state(4))
    pair_idx = torch.tensor([2, 1, 2, 2, 1])
    rtt = torch.tensor([10.0, 20.0, 30.0, 40.0, 50.0])
    ring, cursor, count, avg = ewma.enqueue(ring, cursor, count, pair_idx, rtt)
    assert ring[2, 0] == 40.0 and ring[1, 0] == 50.0
    assert cursor.tolist() == [0, 1, 1, 0] and count.tolist() == [0, 1, 1, 0]
    assert avg.tolist() == [0.0, 50.0, 40.0, 0.0]
    want = ref.enqueue(*(jnp.asarray(a) for a in _state(4)), jnp.asarray(pair_idx.numpy()),
                       jnp.asarray(rtt.numpy()))
    np.testing.assert_array_equal(ring.numpy(), np.asarray(want[0]))


def test_fold_average_partial_and_wrapped_rings():
    rng = np.random.default_rng(7)
    ring = (rng.random((64, 5)) * 1e6).astype(np.float32)
    count = rng.integers(0, 6, 64).astype(np.int32)
    cursor = rng.integers(0, 5, 64).astype(np.int32)
    want = jax.jit(ref.fold_average)(jnp.asarray(ring), jnp.asarray(cursor), jnp.asarray(count))
    got = ewma.fold_average(torch.from_numpy(ring), torch.from_numpy(cursor),
                            torch.from_numpy(count))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))
    assert (got.numpy()[count == 0] == 0).all()


def test_probed_count_increment_matches_reference():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 9, 50).astype(np.int32)
    hosts = rng.integers(0, 50, 400).astype(np.int32)  # many repeats
    want = ref.probed_count_increment(jnp.asarray(counts), jnp.asarray(hosts))
    got = ewma.probed_count_increment(torch.from_numpy(counts), torch.from_numpy(hosts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


LEAST_PROBED = [
    # (probed counts, alive, k): ties, dead hosts, k > alive
    ([1, 2, 2, 0], [1, 1, 1, 0], 4),
    ([0, 0, 0, 0, 0, 0], [1, 0, 1, 1, 0, 1], 6),
    ([3, 1, 3, 1, 3, 1, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1], 5),
    ([5] * 40, [1] * 40, 10),
    ([0, 1], [0, 0], 2),
]


@pytest.mark.parametrize("counts,alive,k", LEAST_PROBED)
@pytest.mark.parametrize("seed", [0, 12345, 2**30 - 1])
def test_least_probed_hosts_returns_the_reference_indices(counts, alive, k, seed):
    counts = np.asarray(counts, np.int32)
    alive = np.asarray(alive, bool)
    want_idx, want_valid = ref.least_probed_hosts(jnp.asarray(counts), jnp.asarray(alive),
                                                  jax.random.key(seed), k=k)
    got_idx, got_valid = ewma.least_probed_hosts(torch.from_numpy(counts),
                                                 torch.from_numpy(alive), prng.key(seed), k=k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))

