"""ops/segment.py against dragonfly2_tpu/ops/segment.py on the same inputs.

The four reductions on the CPU, 1-D and 2-D data, with ids outside
[0, num_segments) dropped and empty segments: integer results exactly,
float sums and means within 1e-6 relative (both add in float32, possibly
in another order), maxima exactly. ``gather_coo_subgraph`` is numpy on
both sides: its arrays are equal."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import segment as ref
from dragonfly2_tpu_torch.ops import segment

RTOL = 1e-6


def _both(name, data, ids, n):
    want = np.asarray(getattr(ref, name)(jnp.asarray(data), jnp.asarray(ids), num_segments=n))
    got = getattr(segment, name)(torch.from_numpy(data), torch.from_numpy(ids), n).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


def test_out_of_range_ids_are_dropped():
    data = np.arange(1, 6, dtype=np.float32)
    ids = np.array([0, -1, 3, 2, 0], np.int32)
    got, want = _both("segment_sum", data, ids, 3)
    assert got.tolist() == want.tolist() == [6.0, 0.0, 4.0]
    got, want = _both("segment_max", data, ids, 3)
    assert got.tolist() == want.tolist() == [5.0, -np.inf, 4.0]
    got, want = _both("segment_mean", data, ids, 3)
    assert got.tolist() == want.tolist() == [3.0, 0.0, 4.0]
    want = np.asarray(ref.segment_count(jnp.asarray(ids), num_segments=3))
    got = segment.segment_count(torch.from_numpy(ids), 3).numpy()
    assert got.dtype == np.int32 and got.tolist() == want.tolist() == [2, 0, 1]


@pytest.mark.parametrize("shape", [(300,), (300, 7)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("seed", [0, 1])
def test_reductions_match_reference(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    n = 40  # some segments stay empty; ids run past both ends
    ids = rng.integers(-3, n + 8, shape[0]).astype(np.int32)
    ids[ids % 9 == 0] = 5  # one crowded segment
    data = (rng.standard_normal(shape) * 100).astype(dtype)
    for name in ("segment_sum", "segment_mean", "segment_max"):
        if dtype == np.int32 and name == "segment_mean":
            continue  # the reference divides ints by int counts: not a path anyone runs
        got, want = _both(name, data, ids, n)
        if dtype == np.float32 and name != "segment_max":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * 1e3, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    want = np.asarray(ref.segment_count(jnp.asarray(ids), num_segments=n))
    np.testing.assert_array_equal(segment.segment_count(torch.from_numpy(ids), n).numpy(), want)


def _graph(rng, n, e):
    src = rng.integers(0, n - 1, e)
    dst = rng.integers(0, n - 1, e)
    return src, dst


@pytest.mark.parametrize("hops,dirty_count,max_frac", [(2, 3, 0.5), (1, 6, 0.5), (2, 3, 0.01)])
def test_gather_coo_subgraph_matches_reference(hops, dirty_count, max_frac):
    rng = np.random.default_rng(hops * 10 + dirty_count)
    n = 400
    src, dst = _graph(rng, n, 700)
    dirty = np.concatenate([rng.integers(0, n - 1, dirty_count), [-1, n + 3]])
    want = ref.gather_coo_subgraph(src, dst, dirty, n, hops=hops, max_frac=max_frac)
    got = segment.gather_coo_subgraph(src, dst, dirty, n, hops=hops, max_frac=max_frac)
    if want is None:
        assert got is None
        return
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["target_global"] == n).any()  # padded targets point past the table
    assert segment.gather_coo_subgraph(src, dst, [-5], n) is None


def test_pad_pow2():
    assert [segment.pad_pow2(x) for x in (0, 1, 64, 65, 1000)] == [64, 64, 64, 128, 1024]
    assert segment.pad_pow2(3, min_pad=1) == ref.pad_pow2(3, min_pad=1) == 4
