"""utils/prng.py against jax.random: the same key, the same float32 bits.

The port reproduces ``jax.random.uniform(jax.random.key(seed), (n,),
minval, maxval)`` under jax's default threefry2x32 with partitionable
counters; the tolerance is zero (the bits are compared as uint32)."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from dragonfly2_tpu_torch.utils import prng

SEEDS = (0, 1, 12345, 2**30 - 1)
LENGTHS = (1, 7, 16384)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("minval,maxval", [(0.0, 1.0), (0.0, 0.5), (-2.0, 3.0)])
def test_uniform_bits_equal_jax(seed, n, minval, maxval):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), (n,), minval=minval,
                                         maxval=maxval))
    got = prng.uniform(prng.key(seed), n, minval, maxval, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_raw_bits_equal_jax(seed):
    want = np.asarray(jax.random.bits(jax.random.key(seed), (1000,)))
    got = prng.random_bits(prng.key(seed), 1000, device="cpu").numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_key_words_match_jax_key_data():
    for seed in SEEDS:
        want = np.asarray(jax.random.key_data(jax.random.key(seed)))
        assert prng.key(seed) == tuple(int(w) for w in want)
    with pytest.raises(ValueError):
        prng.key(-1)
