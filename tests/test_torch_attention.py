"""The port's AttentionRanker (models/attention.py), loaded with weights
converted from a reference flax init (models/convert.py), against the
reference AttentionRanker run with both of its attention functions:
dense_attention and the Pallas flash kernel (interpret mode on CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.attention import AttentionRanker as RefRanker
from dragonfly2_tpu.ops.flash import flash_attention as ref_flash
from dragonfly2_tpu.parallel.ring import dense_attention as ref_dense
from dragonfly2_tpu.records.features import NUM_HOST_FEATURES as REF_NUM_HOST_FEATURES
from dragonfly2_tpu_torch.models import attention as port_attention
from dragonfly2_tpu_torch.models.convert import (
    attention_params_from_flax,
    attention_params_to_flax,
)
from dragonfly2_tpu_torch.ops.flash import flash_attention

HIDDEN, HEADS, LAYERS, P = 32, 2, 2, 15
# float32: two implementations of one float32 function (matmul summation
# order only); bf16: both round every layer's activations to bf16, the
# tests/test_attention.py:144-147 tolerance family
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _inputs(n=6, seed=0):
    rng = np.random.default_rng(seed)
    f = port_attention.NUM_HOST_FEATURES
    child = rng.standard_normal((n, f)).astype(np.float32)
    parents = rng.standard_normal((n, P, f)).astype(np.float32)
    pair = (rng.random((n, P, port_attention.NUM_PAIR_FEATURES)) < 0.5).astype(np.float32)
    mask = rng.random((n, P)) < 0.8
    mask[:, 0] = True
    mask[1] = False  # a task with no eligible parent
    return child, parents, pair, mask


def _ref_setup(dtype):
    model = RefRanker(hidden_dim=HIDDEN, num_heads=HEADS, num_layers=LAYERS,
                      compute_dtype=getattr(jnp, dtype))
    params = model.init(jax.random.key(0), *_inputs())
    return model, jax.device_get(params)


def _port_ranker(params, dtype="bfloat16"):
    model = port_attention.AttentionRanker(HIDDEN, HEADS, LAYERS, getattr(torch, dtype))
    model.load_state_dict(attention_params_from_flax(params))
    return model


def test_feature_widths_match_reference():
    assert port_attention.NUM_HOST_FEATURES == REF_NUM_HOST_FEATURES
    assert port_attention.IN_FEATURES == 2 * REF_NUM_HOST_FEATURES + 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref_attention", ["dense", "flash"])
def test_ranker_matches_reference(dtype, ref_attention):
    model, params = _ref_setup(dtype)
    inputs = _inputs(seed=1)
    attention_fn = ref_dense if ref_attention == "dense" else ref_flash
    want = np.asarray(model.apply(params, *inputs, attention_fn=attention_fn))
    port = _port_ranker(params, dtype)
    with torch.no_grad():
        got = port(*(torch.from_numpy(x) for x in inputs)).numpy()
    mask = inputs[3]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got[mask], want[mask], atol=TOL[dtype], rtol=TOL[dtype])
    assert (got[~mask] == np.float32(-1e30)).all() and (want[~mask] == np.float32(-1e30)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_reference(dtype):
    """One SelfAttentionBlock on its own, flash attention as attention_fn."""
    from dragonfly2_tpu.models.attention import SelfAttentionBlock as RefBlock

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, P, HIDDEN)).astype(np.float32)
    mask = rng.random((3, P)) < 0.7
    block = RefBlock(HIDDEN, HEADS, getattr(jnp, dtype))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    params = jax.device_get(block.init(jax.random.key(1), xj, mask))
    want = np.asarray(block.apply(params, xj, mask, ref_flash), np.float32)
    port = port_attention.SelfAttentionBlock(HIDDEN, HEADS, getattr(torch, dtype))
    port.load_state_dict(attention_params_from_flax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(mask),
                   flash_attention).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_conversion_round_trips_exactly():
    _, params = _ref_setup("bfloat16")
    port = _port_ranker(params)
    back = attention_params_to_flax(port)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back) == 4 + LAYERS * 12 + 2
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf)
        assert flat_back[path].dtype == leaf.dtype


def test_seeded_init_is_deterministic_and_flax_shaped():
    a = port_attention.AttentionRanker(HIDDEN, HEADS, LAYERS).reset_parameters(
        torch.Generator().manual_seed(3))
    b = port_attention.AttentionRanker(HIDDEN, HEADS, LAYERS).reset_parameters(
        torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    w = a.embed.weight.detach()
    limit = 2 * (1 / np.sqrt(w.shape[1])) / 0.87962566103423978
    assert float(w.abs().max()) <= limit and float(a.embed.bias.detach().abs().max()) == 0.0
    _, params = _ref_setup("bfloat16")
    ref_shapes = {jax.tree_util.keystr(p): v.shape
                  for p, v in jax.tree_util.tree_leaves_with_path(params)}
    port_shapes = {jax.tree_util.keystr(p): v.shape
                   for p, v in jax.tree_util.tree_leaves_with_path(attention_params_to_flax(a))}
    assert port_shapes == ref_shapes


def test_moe_is_not_ported():
    """The mixture-of-experts ranker, which raised before the port had it:
    from the reference's flax init, on one device (the no-drop
    ``moe_reference``), its scores match the reference's in float32 and
    bf16, and its tree crosses models/convert.py both ways unchanged."""
    inputs = _inputs(seed=2)
    mask = inputs[3]
    for dtype in ("float32", "bfloat16"):
        model = RefRanker(hidden_dim=HIDDEN, num_heads=HEADS, num_layers=LAYERS,
                          compute_dtype=getattr(jnp, dtype), moe_experts=4)
        params = jax.device_get(jax.jit(model.init)(jax.random.key(0), *inputs))
        want = np.asarray(jax.jit(model.apply)(params, *inputs))
        port = port_attention.AttentionRanker(HIDDEN, HEADS, LAYERS, getattr(torch, dtype),
                                              moe_experts=4)
        port.load_state_dict(attention_params_from_flax(params))
        with torch.no_grad():
            got = port(*(torch.from_numpy(x) for x in inputs)).numpy()
        np.testing.assert_allclose(got[mask], want[mask], atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=dtype)
        back = dict(jax.tree_util.tree_leaves_with_path(attention_params_to_flax(port)))
        flat_ref = jax.tree_util.tree_leaves_with_path(params)
        assert len(back) == len(flat_ref)
        for path, leaf in flat_ref:
            np.testing.assert_array_equal(back[path], leaf)
