"""The port's masked_top_k (ops/topk.py) against the reference's, on the
same numpy inputs: both widths (the K <= 128 rank path and the wide sort),
duplicate scores, rows with fewer valid candidates than k, and hostile
scores (NaN, -inf, +inf). Tolerance: none; values, indices and validity
must be identical (-inf slots included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import topk as ref
from dragonfly2_tpu_torch.ops import topk


def _both(scores, mask, k):
    want = [np.asarray(x) for x in ref.masked_top_k(jnp.asarray(scores), jnp.asarray(mask), k)]
    got = [x.numpy() for x in topk.masked_top_k(torch.from_numpy(scores), torch.from_numpy(mask), k)]
    return want, got


def _assert_same(want, got):
    for name, w, g in zip(("values", "indices", "valid"), want, got):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("width,k", [(15, 4), (20, 4), (64, 4), (15, 20), (128, 15), (256, 6),
                                     (300, 64)])
def test_matches_reference(width, k):
    rng = np.random.default_rng(width + k)
    scores = rng.random((64, width)).astype(np.float32)
    scores[:, 10 % width] = scores[:, 5 % width]  # duplicates: ties go to the lower index
    scores[:, 12 % width] = scores[:, 5 % width]
    mask = rng.random((64, width)) < 0.5
    mask[0] = False  # no valid candidate at all
    mask[1] = False
    mask[1, 3] = True  # exactly one
    mask[2] = True
    _assert_same(*_both(scores, mask, k))


@pytest.mark.parametrize("width", [8, topk._RANK_SELECT_MAX_WIDTH * 2])
def test_hostile_scores(width):
    """Eligible -inf/NaN candidates still outrank every masked one,
    validity comes from the eligible count, and +inf becomes float32's
    largest value in both libraries."""
    scores = np.full((3, width), 1.0, np.float32)
    scores[:, 0] = -np.inf
    scores[:, 1] = np.nan
    scores[1, 2] = np.inf
    scores[2] = np.nan
    mask = np.zeros((3, width), bool)
    mask[:, :4] = True
    want, got = _both(scores, mask, 6)
    _assert_same(want, got)
    v, i, m = got
    assert (m.sum(axis=1) == 4).all()
    assert set(i[0, :4].tolist()) == {0, 1, 2, 3}
    assert i[0, :2].tolist() == [2, 3]
    assert v[1, 0] == np.finfo(np.float32).max and i[1, 0] == 2
    assert np.isneginf(v[:, 4:]).all()


def test_rank_path_is_the_sort_path():
    """Below the width limit the scatter by rank gives what a stable sort
    gives: the two paths are one contract."""
    rng = np.random.default_rng(9)
    scores = np.round(rng.random((32, 40)) * 8).astype(np.float32)  # many ties
    mask = rng.random((32, 40)) < 0.7
    rank = topk.masked_top_k(torch.from_numpy(scores), torch.from_numpy(mask), 12)
    masked = topk._sanitize(torch.from_numpy(scores), torch.from_numpy(mask))
    values, indices = torch.sort(masked, dim=-1, descending=True, stable=True)
    valid = rank[2]
    assert torch.equal(rank[1][valid], indices[:, :12].to(torch.int32)[valid])
    assert torch.equal(rank[0][valid], values[:, :12][valid])
