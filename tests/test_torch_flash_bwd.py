"""The port's training attention (ops/flash.py: the forward with lse, the
backward, and FlashAttention) against the reference's Pallas kernels in
interpret mode (as tests/test_flash.py runs them on CPU), on the same
numpy inputs.

On CPU tensors the wrappers take the kernels' plain versions; the CUDA
kernels themselves are held to those plain versions by
tests/test_torch_cuda.py and chip_smoke.py on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops.flash import _flash_backward, _flash_forward
from dragonfly2_tpu.ops.flash import flash_attention as ref_flash
from dragonfly2_tpu.parallel.ring import dense_attention as ref_dense
from dragonfly2_tpu_torch.ops import flash

# float32: two float32 implementations of one function (the
# tests/test_flash.py:60-72 family). bf16: within 6e-2 of the float32
# oracle (tests/test_flash.py:140-159); the reference scales q in float32
# before its bf16 cast in the forward (flash.py:262) but after the product
# in the backward (:390-395), so bf16 results agree within tolerance and
# never bit for bit.
TOL = {"float32": 1e-4, "bfloat16": 6e-2}

# (L, causal, mask, head dim): "mask" random keys off; "dead" batch row 0
# has no valid key; "none" kv_mask=None; "ones" an all-ones mask. L = 65 and
# 129 sit one past a 64-row tile and a 128-row block, the Hopper instances'
# tile edges, at the head dims whose tiles split into 64-column blocks.
CASES = [
    (20, False, "mask", 16),
    (20, True, "dead", 16),
    (20, False, "none", 16),
    (20, True, "ones", 16),
    (70, True, "mask", 16),
    (70, False, "dead", 16),
    (65, True, "dead", 64),
    (65, True, "dead", 128),
    (129, True, "dead", 64),
    (129, True, "dead", 128),
]
# ids as before head dims were cases: "20-False-mask", then "-d64" etc.
CASE_IDS = [f"{l}-{c}-{m}" + ("" if d == 16 else f"-d{d}") for l, c, m, d in CASES]
DTYPES = ["float32", "bfloat16"]


def _mk(l, mask_kind, seed, b=2, h=2, d=16):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(4))
    mask = rng.random((b, l)) < 0.7
    mask[:, 0] = True
    if mask_kind == "dead":
        mask[0] = False
    elif mask_kind == "ones":
        mask[:] = True
    return q, k, v, do, (None if mask_kind == "none" else mask)


def _round(x, dtype):
    """numpy float32 values rounded to ``dtype`` (both packages then start
    from the same bf16 numbers)."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _port(x, dtype):
    if x is None:
        return None
    t = torch.from_numpy(x)
    return t if x.dtype == np.bool_ else t.to(getattr(torch, dtype))


def _ref(x, dtype):
    if x is None:
        return None
    return jnp.asarray(x) if x.dtype == np.bool_ else jnp.asarray(x, getattr(jnp, dtype))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rows_with_a_key(mask, l, b, causal):
    """[B, 1, L] bool: query rows that see at least one valid key."""
    m = np.ones((b, l), bool) if mask is None else mask
    seen = np.cumsum(m, axis=1) > 0 if causal else np.broadcast_to(m.any(1, keepdims=True), m.shape)
    return seen[:, None, :]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,causal,mask_kind,d", CASES, ids=CASE_IDS)
def test_forward_lse_matches_reference(l, causal, mask_kind, d, dtype):
    q, k, v, _, mask = _mk(l, mask_kind, seed=l + causal, d=d)
    q, k, v = (_round(x, dtype) for x in (q, k, v))
    o, lse = flash.flash_attention_lse(*(_port(x, dtype) for x in (q, k, v, mask)), causal=causal)
    assert o.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert tuple(lse.shape) == q.shape[:3]
    # the float32 oracle: the reference kernel on the same (rounded) values
    want_o, want_lse = _flash_forward(
        *(_ref(x, "float32") for x in (q, k, v, mask)), causal=causal, save_lse=True
    )
    rows = np.broadcast_to(_rows_with_a_key(mask, l, q.shape[0], causal), lse.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(want_o), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse)[rows], _np(want_lse)[rows], atol=tol, rtol=tol)
    assert np.isfinite(_np(lse)).all()
    if mask_kind == "dead":
        assert (_np(o)[0] == 0).all()
    if dtype == "bfloat16":  # and the reference kernel in bf16 itself
        ref_o, ref_lse = _flash_forward(
            *(_ref(x, dtype) for x in (q, k, v, mask)), causal=causal, save_lse=True
        )
        np.testing.assert_allclose(_np(o), _np(ref_o), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(lse)[rows], _np(ref_lse)[rows], atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,causal,mask_kind,d", CASES, ids=CASE_IDS)
def test_backward_twin_matches_reference(l, causal, mask_kind, d, dtype):
    """flash_attention_bwd_plain against _flash_backward (both backward
    kernels, interpret mode), fed the same q, k, v, o, lse and dO."""
    q, k, v, do, mask = _mk(l, mask_kind, seed=100 + l + causal, d=d)
    rq, rk, rv, rdo, rmask = (_ref(x, dtype) for x in (q, k, v, do, mask))
    o, lse = _flash_forward(rq, rk, rv, rmask, causal=causal, save_lse=True)
    want = _flash_backward(rq, rk, rv, rmask, o, lse, rdo, causal)
    got = flash.flash_attention_bwd(
        *(_port(x, dtype) for x in (q, k, v, mask)),
        _port(np.array(o, np.float32), dtype), torch.from_numpy(np.array(lse)),
        _port(do, dtype), causal,
    )
    tol = TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol, err_msg=name)
        if mask_kind == "dead":
            assert (_np(g)[0] == 0).all(), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,causal,mask_kind,d", CASES, ids=CASE_IDS)
def test_end_to_end_gradients_match_reference(l, causal, mask_kind, d, dtype):
    """torch.autograd.grad through the port's flash_attention against
    jax.grad of the reference's flash_attention (its custom_vjp)."""
    q, k, v, _, mask = _mk(l, mask_kind, seed=200 + l + causal, d=d)
    q, k, v = (_round(x, dtype) for x in (q, k, v))
    tq, tk, tv = (_port(x, dtype).requires_grad_() for x in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, _port(mask, dtype), causal=causal)
    got = torch.autograd.grad((out.float() ** 2).sum(), (tq, tk, tv))

    def loss(fn, dt):
        return lambda q_, k_, v_: jnp.sum(
            fn(q_, k_, v_, _ref(mask, dt), causal=causal).astype(jnp.float32) ** 2
        )

    # the float32 oracle: dense attention on the same rounded values
    want = jax.grad(loss(ref_dense_or_ones, "float32"), argnums=(0, 1, 2))(
        *(_ref(x, "float32") for x in (q, k, v))
    )
    ref = jax.grad(loss(ref_flash, dtype), argnums=(0, 1, 2))(*(_ref(x, dtype) for x in (q, k, v)))
    tol = TOL[dtype]
    for name, g, w, r in zip(("dq", "dk", "dv"), got, want, ref):
        assert g.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol, err_msg=name)
        np.testing.assert_allclose(_np(g), _np(r), atol=tol, rtol=tol, err_msg=name)
        if mask_kind == "dead":
            assert (_np(g)[0] == 0).all(), name  # exactly 0, as tests/test_flash.py:125-137


def ref_dense_or_ones(q, k, v, mask, causal):
    if mask is None:
        mask = jnp.ones((q.shape[0], q.shape[2]), bool)
    return ref_dense(q, k, v, mask, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_no_mask_equals_all_ones(causal):
    q, k, v, do, _ = _mk(20, "none", seed=9)
    ones = torch.ones(q.shape[0], q.shape[2], dtype=torch.bool)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    o_none, lse_none = flash.flash_attention_lse(*args, None, causal)
    o_ones, lse_ones = flash.flash_attention_lse(*args, ones, causal)
    torch.testing.assert_close(o_none, o_ones, rtol=0, atol=0)
    torch.testing.assert_close(lse_none, lse_ones, rtol=0, atol=0)
    g_none = flash.flash_attention_bwd(*args, None, o_none, lse_none, torch.from_numpy(do), causal)
    g_ones = flash.flash_attention_bwd(*args, ones, o_ones, lse_ones, torch.from_numpy(do), causal)
    for a, b in zip(g_none, g_ones):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lse_forward_output_is_the_finished_forward():
    q, k, v, _, mask = _mk(70, "dead", seed=3)
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    for causal in (False, True):
        o, _ = flash.flash_attention_lse_plain(*args, causal)
        torch.testing.assert_close(o, flash.flash_attention_plain(*args, causal), atol=1e-6, rtol=1e-6)


def test_flash_attention_keeps_the_autograd_graph(monkeypatch):
    """With grad recording and an input that requires grad, the result is
    FlashAttention's: on the CPU its forward is the lse plain version and
    its backward the backward plain version. Under inference_mode and
    no_grad it is the finished forward, with no grad_fn."""
    calls = []
    for name in ("flash_attention_lse_plain", "flash_attention_bwd_plain"):
        real = getattr(flash, name)
        monkeypatch.setattr(
            flash, name, lambda *a, _real=real, _name=name, **kw: calls.append(_name) or _real(*a, **kw)
        )
    q, k, v, _, mask = _mk(20, "mask", seed=1)
    tq = torch.from_numpy(q).requires_grad_()
    tk, tv, tmask = (torch.from_numpy(x) for x in (k, v, mask))
    out = flash.flash_attention(tq, tk, tv, tmask)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert calls == ["flash_attention_lse_plain"]
    (grad,) = torch.autograd.grad(out.sum(), tq)
    assert calls == ["flash_attention_lse_plain", "flash_attention_bwd_plain"]
    assert grad.shape == tq.shape and torch.isfinite(grad).all() and grad.abs().sum() > 0
    with torch.inference_mode():
        assert flash.flash_attention(tq, tk, tv, tmask).grad_fn is None
    with torch.no_grad():
        assert flash.flash_attention(tq, tk, tv, tmask).grad_fn is None
    assert flash.flash_attention(tq.detach(), tk, tv, tmask).grad_fn is None
    assert len(calls) == 2
    assert (flash.LSE_LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES) == (0, 0, 0)


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, do, mask = (torch.from_numpy(x) for x in _mk(20, "mask", seed=2))
    o, lse = flash.flash_attention_lse(q, k, v, mask)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_attention_bwd(q, k, v, mask, o, lse.double(), do)
    with pytest.raises(ValueError, match="dO"):
        flash.flash_attention_bwd(q, k, v, mask, o, lse, do[:, :, :10].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention_bwd(q, k, v, mask, o, lse, do.transpose(2, 3).contiguous().transpose(2, 3))
    # the kernel-only entries never take the plain version
    delta = (do * o).sum(-1)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do)


# the regime of the card's one-pass dQ and dK/dV and packed-sets forward:
# B x H = 3 x 5 short sets, batch row 0 with no valid key, at the head dims
# those kernels take (192 at L = 10, 320 at L = 20), and the one-pass
# backward's column-warp layouts and swept tiles (4 x 48 columns at 136 and
# 192, 4 x 64 at 256 with one whole tile, 5 x 64 at 264 with one row and at
# 320 with a ragged second tile)
PACKED_CASES = [(10, 192), (20, 320), (20, 136), (20, 192), (32, 256), (1, 264), (33, 320)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,d", PACKED_CASES, ids=[f"l{l}-d{d}" for l, d in PACKED_CASES])
def test_backward_twin_matches_reference_on_packed_sets(l, d, causal, dtype):
    """flash_attention_bwd_plain against _flash_backward (interpret mode)
    and the forward with lse against _flash_forward, on several short sets
    of the wide head dims; the dead batch row's gradients are exactly 0."""
    q, k, v, do, mask = _mk(l, "dead", seed=300 + l + causal, b=3, h=5, d=d)
    rq, rk, rv, rdo, rmask = (_ref(x, dtype) for x in (q, k, v, do, mask))
    o, lse = _flash_forward(rq, rk, rv, rmask, causal=causal, save_lse=True)
    want = _flash_backward(rq, rk, rv, rmask, o, lse, rdo, causal)
    got = flash.flash_attention_bwd(
        *(_port(x, dtype) for x in (q, k, v, mask)),
        _port(np.array(o, np.float32), dtype), torch.from_numpy(np.array(lse)),
        _port(do, dtype), causal,
    )
    tol = TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol, err_msg=name)
        assert (_np(g)[0] == 0).all(), name
    # the forward with lse on the same values, against the reference's
    rounded = [_round(x, dtype) for x in (q, k, v)]
    got_o, got_lse = flash.flash_attention_lse(*(_port(x, dtype) for x in (*rounded, mask)),
                                               causal=causal)
    want_o, want_lse = _flash_forward(*(_ref(x, "float32") for x in (*rounded, mask)),
                                      causal=causal, save_lse=True)
    rows = np.broadcast_to(_rows_with_a_key(mask, l, 3, causal), got_lse.shape)
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got_lse)[rows], _np(want_lse)[rows], atol=tol, rtol=tol)
    assert (_np(got_o)[0] == 0).all()
