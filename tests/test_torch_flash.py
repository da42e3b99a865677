"""The port's flash_attention (ops/flash.py) against the reference's
Pallas flash_attention (interpret mode on CPU, as tests/test_flash.py runs
it) and dense_attention, on the same numpy inputs.

On CPU tensors the wrapper takes the kernel's plain version; the CUDA
kernel itself is held to that plain version by tests/test_torch_cuda.py
and by chip_smoke.py on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops.flash import flash_attention as ref_flash
from dragonfly2_tpu.parallel.ring import dense_attention as ref_dense
from dragonfly2_tpu_torch.ops import flash
from dragonfly2_tpu_torch.parallel.ring import dense_attention

# f32: the same function in two float32 implementations; bf16: inputs
# rounded alike, the reference kernel rounds q (pre-scaled) and p to bf16
# for its matmuls (tests/test_attention.py:144-147 tolerance family)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _mk(b, h, l, d, seed, fully_masked=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(3))
    mask = rng.random((b, l)) < 0.8
    mask[:, 0] = True
    if fully_masked:
        mask[0] = False
    return q, k, v, mask


def _port(x, dtype):
    t = torch.from_numpy(x)
    return t if x.dtype == np.bool_ else t.to(getattr(torch, dtype))


def _ref(x, dtype):
    return jnp.asarray(x) if x.dtype == np.bool_ else jnp.asarray(x, getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "l,causal,fully_masked",
    [(15, False, False), (15, False, True), (15, True, False),
     (130, False, False), (130, True, True), (130, False, True)],
)
def test_matches_reference_flash_and_dense(l, causal, fully_masked, dtype):
    q, k, v, mask = _mk(2, 2, l, 32, seed=l + causal, fully_masked=fully_masked)
    before = flash.LAUNCHES
    out = flash.flash_attention(*(_port(x, dtype) for x in (q, k, v, mask)), causal=causal)
    assert flash.LAUNCHES == before  # a CPU tensor never launches the kernel
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    got = out.float().numpy()
    want_flash = np.asarray(ref_flash(*(_ref(x, dtype) for x in (q, k, v, mask)), causal=causal), np.float32)
    want_dense = np.asarray(ref_dense(*(_ref(x, dtype) for x in (q, k, v, mask)), causal=causal), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want_flash, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_dense, atol=tol, rtol=tol)
    if fully_masked:
        assert (got[0] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_no_mask_matches_reference(causal):
    q, k, v, _ = _mk(1, 2, 130, 16, seed=7)
    got = flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), None, causal=causal)
    want = np.asarray(ref_flash(q, k, v, None, causal=causal))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["float32"], rtol=TOL["float32"])


def test_plain_version_is_dense_attention():
    q, k, v, mask = (torch.from_numpy(x) for x in _mk(2, 2, 40, 64, seed=3, fully_masked=True))
    for causal in (False, True):
        torch.testing.assert_close(
            flash.flash_attention_plain(q, k, v, mask, causal),
            dense_attention(q, k, v, mask, causal), rtol=0, atol=0,
        )


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = (torch.from_numpy(x) for x in _mk(2, 2, 15, 32, seed=1))
    # a head dim no instance has is taken (the reference takes any D)
    q24, k24, v24 = (x[..., :24].contiguous() for x in (q, k, v))
    torch.testing.assert_close(flash.flash_attention(q24, k24, v24, mask),
                               dense_attention(q24, k24, v24, mask), rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, mask)
    with pytest.raises(ValueError, match="kv_mask"):
        flash.flash_attention(q, k, v, mask.float())
    with pytest.raises(TypeError, match="dtype"):
        flash.flash_attention(q.half(), k.half(), v.half(), mask)
    with pytest.raises(ValueError, match="equal"):
        flash.flash_attention(q, k[:, :, :10].contiguous(), v, mask)
    # neither cpu nor cuda: no silent fallback to the plain version
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), mask.to("meta"))


def test_warps_per_block():
    assert [flash.warps_for(n) for n in (1, 15, 16, 17, 32, 33, 4096)] == [1, 1, 1, 2, 2, 4, 4]


# any head dim: on the CPU the plain versions; the gradients of the
# reference's Pallas flash_attention through its custom_vjp (interpret
# mode), float32 (the tests/test_torch_flash_bwd.py family)
GRAD_TOL = 1e-4


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 24, 48, 96])
def test_any_head_dim_matches_reference(d, causal):
    q, k, v, mask = _mk(2, 2, 15, d, seed=d + causal, fully_masked=True)
    do = np.random.default_rng(d).standard_normal(q.shape).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = flash.LAUNCHES, flash.LSE_LAUNCHES
    out = flash.flash_attention(*leaves, torch.from_numpy(mask), causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert (flash.LAUNCHES, flash.LSE_LAUNCHES) == before
    assert out.shape == q.shape
    want = np.asarray(ref_flash(q, k, v, mask, causal=causal))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=TOL["float32"], rtol=TOL["float32"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_dense(q, k, v, mask, causal=causal)),
                               atol=TOL["float32"], rtol=TOL["float32"])
    assert (out.detach().numpy()[0] == 0).all()  # the fully masked batch row

    def loss(q, k, v):
        return (ref_flash(q, k, v, mask, causal=causal) * do).sum()

    want_grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, w in zip(("dq", "dk", "dv"), got, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
        assert (g.numpy()[0] == 0).all(), name


@pytest.mark.parametrize("d", [8, 24, 48, 96])
def test_padded_route_is_the_same_function(d):
    """The CUDA route for a head dim outside the instances, as algebra on
    the plain versions: zero-pad q, k, v (and o, dO) to D_pad, score with
    the unpadded D's softmax scale as the kernels are given it, and slice
    back: the unpadded output, lse, partials and gradients (float32, to
    rounding)."""
    q, k, v, mask = (torch.from_numpy(x) for x in _mk(2, 2, 15, d, seed=d, fully_masked=True))
    do = torch.from_numpy(np.random.default_rng(d).standard_normal(q.shape).astype(np.float32))
    qp, kp, vp = flash._padded(q, k, v)
    d_pad, scale = qp.shape[-1], flash._scale(q)
    assert d_pad == min(x for x in flash.HEAD_DIMS if x >= d) and scale == 1 / d ** 0.5
    tol = dict(atol=1e-6, rtol=1e-5)
    for causal in (False, True):
        o, lse = flash.flash_attention_lse_plain(q, k, v, mask, causal)
        op, lsep = flash.flash_attention_lse_plain(qp, kp, vp, mask, causal, scale)
        torch.testing.assert_close(op[..., :d], o, **tol)
        assert (op[..., d:] == 0).all()
        torch.testing.assert_close(lsep, lse, **tol)
        dqp, dkp, dvp = flash.flash_attention_bwd_plain(qp, kp, vp, mask, *flash._padded(o), lse,
                                                        *flash._padded(do), causal, scale)
        dq, dk, dv = flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, causal)
        torch.testing.assert_close(dqp[..., :d], dq, **tol)
        torch.testing.assert_close(dkp[..., :d], dk, **tol)
        torch.testing.assert_close(dvp[..., :d], dv, **tol)
    acc, row_max, row_sum = flash.flash_attention_partials_plain(q, k, v, mask)
    accp, maxp, sump = flash.flash_attention_partials_plain(qp, kp, vp, mask, scale)
    torch.testing.assert_close(accp[..., :d], acc, **tol)
    torch.testing.assert_close(maxp, row_max, **tol)
    torch.testing.assert_close(sump, row_sum, **tol)


def test_kernel_wrappers_refuse_a_head_dim_without_an_instance():
    """No head dim is refused: the kernels take D in HEAD_DIMS and any D
    above 128 with D % 8 == 0 as it is (192, 320: no pad copy), and the
    route pads any other D to the next one a kernel takes (130 -> 136).
    On the CPU the plain versions take any D: no padding."""
    for d in (32, 136, 192, 256, 320, 512):
        assert flash._kernel_dim(d) == d
        assert not flash._padded_route(torch.zeros(1, 1, 4, d, device="meta"))
    assert flash._kernel_dim(24) == 32 and flash._kernel_dim(130) == 136
    assert flash._padded_route(torch.zeros(1, 1, 4, 130, device="meta"))
    q = torch.zeros(1, 1, 4, 130)
    assert flash._padded(q)[0].shape[-1] == 136
    assert not flash._padded_route(q) and not flash._padded_route(torch.zeros(1, 1, 4, 24))


# head dims above 128 (the wide instances on the card, ROADMAP C3): on the
# CPU the plain versions, held to the reference's Pallas kernels
# (interpret mode) and dense_attention, float32
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [160, 192, 256, 264, 320, 384, 512])
def test_head_dims_above_128_match_reference(d, causal):
    from dragonfly2_tpu.ops.flash import _flash_forward as ref_forward
    from dragonfly2_tpu.ops.flash import flash_attention_partials as ref_partials

    q, k, v, mask = _mk(2, 2, 15, d, seed=d + causal, fully_masked=True)
    do = np.random.default_rng(d).standard_normal(q.shape).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    counts = (flash.LAUNCHES, flash.LSE_LAUNCHES, flash.PARTIAL_LAUNCHES, flash.FWD_WIDE_LAUNCHES,
              flash.LSE_WIDE_LAUNCHES, flash.PARTIAL_WIDE_LAUNCHES)
    out = flash.flash_attention(*leaves, torch.from_numpy(mask), causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    tol = dict(atol=TOL["float32"], rtol=TOL["float32"])
    want = np.asarray(ref_flash(q, k, v, mask, causal=causal))
    np.testing.assert_allclose(out.detach().numpy(), want, **tol)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(ref_dense(q, k, v, mask, causal=causal)), **tol)
    assert (out.detach().numpy()[0] == 0).all()  # the fully masked batch row

    def loss(q, k, v):
        return (ref_flash(q, k, v, mask, causal=causal) * do).sum()

    want_grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, w in zip(("dq", "dk", "dv"), got, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)

    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    o, lse = flash.flash_attention_lse(tq, tk, tv, tm, causal)
    want_o, want_lse = ref_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(mask), causal, save_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **tol)
    acc, row_max, row_sum = flash.flash_attention_partials(tq, tk, tv, tm)
    want_acc, want_max, want_sum = (np.asarray(x) for x in ref_partials(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    np.testing.assert_allclose(row_max.numpy(), want_max, **tol)
    np.testing.assert_allclose(row_sum.numpy(), want_sum, **tol)
    rows = np.maximum(want_sum, 1.0)[..., None]
    np.testing.assert_allclose(acc.numpy() / rows, want_acc / rows, **tol)
    # a CPU tensor takes the plain versions and launches nothing
    assert (flash.LAUNCHES, flash.LSE_LAUNCHES, flash.PARTIAL_LAUNCHES, flash.FWD_WIDE_LAUNCHES,
            flash.LSE_WIDE_LAUNCHES, flash.PARTIAL_WIDE_LAUNCHES) == counts


# the regime of the card's packed-sets forward (D up to 256 at L up to 32)
# and one-pass dK/dV (D in (256, 512]): several short sets, B x H = 15 sets
# (not a multiple of the kernels' 32-row blocks), batch row 0 fully masked;
# the plain versions, which the card holds those kernels to, against the
# reference's Pallas kernels (interpret mode), dense_attention and
# jax.grad, float32
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 10, 192), (3, 5, 20, 320)], ids=["l10-d192", "l20-d320"])
def test_packed_short_sets_match_reference(shape, causal):
    from dragonfly2_tpu.ops.flash import _flash_forward as ref_forward
    from dragonfly2_tpu.ops.flash import flash_attention_partials as ref_partials

    b, h, l, d = shape
    q, k, v, mask = _mk(b, h, l, d, seed=l + d + causal, fully_masked=True)
    do = np.random.default_rng(l + d).standard_normal(q.shape).astype(np.float32)
    tol = dict(atol=TOL["float32"], rtol=TOL["float32"])
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash.flash_attention(*leaves, torch.from_numpy(mask), causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_flash(q, k, v, mask, causal=causal)),
                               **tol)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(ref_dense(q, k, v, mask, causal=causal)), **tol)
    assert (out.detach().numpy()[0] == 0).all()  # the fully masked batch row

    def loss(q, k, v):
        return (ref_flash(q, k, v, mask, causal=causal) * do).sum()

    want_grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, w in zip(("dq", "dk", "dv"), got, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
        assert (g.numpy()[0] == 0).all(), name

    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    o, lse = flash.flash_attention_lse(tq, tk, tv, tm, causal)
    want_o, want_lse = ref_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(mask), causal, save_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **tol)
    if not causal:  # the partials have no causal mode, as in the reference
        acc, row_max, row_sum = flash.flash_attention_partials(tq, tk, tv, tm)
        want_acc, want_max, want_sum = (np.asarray(x) for x in ref_partials(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
        np.testing.assert_allclose(row_max.numpy(), want_max, **tol)
        np.testing.assert_allclose(row_sum.numpy(), want_sum, **tol)
        rows = np.maximum(want_sum, 1.0)[..., None]
        np.testing.assert_allclose(acc.numpy() / rows, want_acc / rows, **tol)
        assert (acc.numpy()[0] == 0).all() and (row_sum.numpy()[0] == 0).all()


# the regime of the card's packed-sets forward and dK/dV at the head dims of
# HEAD_DIMS (L up to SETS_MAX_L, a block 32 / L whole sets): B x H = 15
# sets, so the last block is short at most L, L from 1 (32 sets a block)
# through 10 and 15 (three, two) to 20-32 (one), batch row 0 fully masked; the
# plain versions, which the card holds those kernels to, against the
# reference's Pallas kernels (interpret mode), dense_attention and
# jax.grad, float32
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [1, 10, 15, 20, 21, 22, 32])
@pytest.mark.parametrize("d", [32, 128])
def test_packed_short_sets_at_the_head_dims_match_reference(d, l, causal):
    from dragonfly2_tpu.ops.flash import _flash_forward as ref_forward
    from dragonfly2_tpu.ops.flash import flash_attention_partials as ref_partials

    q, k, v, mask = _mk(3, 5, l, d, seed=l + d + causal, fully_masked=True)
    do = np.random.default_rng(l + d).standard_normal(q.shape).astype(np.float32)
    tol = dict(atol=TOL["float32"], rtol=TOL["float32"])
    tq, tk, tv, tm, tdo = (torch.from_numpy(x) for x in (q, k, v, mask, do))
    counts = (flash.LAUNCHES, flash.LSE_LAUNCHES, flash.PARTIAL_LAUNCHES, flash.DKV_LAUNCHES)

    out = flash.flash_attention(tq, tk, tv, tm, causal=causal)
    want, vjp = jax.vjp(lambda q, k, v: ref_flash(q, k, v, mask, causal=causal),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_dense(q, k, v, mask, causal=causal)),
                               **tol)
    assert (out.numpy()[0] == 0).all()  # the fully masked batch row

    o, lse = flash.flash_attention_lse(tq, tk, tv, tm, causal)
    want_o, want_lse = ref_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(mask), causal, save_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **tol)

    # dK/dV from the forward's o and lse, as the kernel gets them
    _, dk, dv = flash.flash_attention_bwd_plain(tq, tk, tv, tm, o, lse, tdo, causal)
    _, want_dk, want_dv = vjp(jnp.asarray(do))
    for name, g, w in (("dk", dk, want_dk), ("dv", dv, want_dv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
        assert (g.numpy()[0] == 0).all(), name

    if not causal:  # the partials have no causal mode, as in the reference
        acc, row_max, row_sum = flash.flash_attention_partials(tq, tk, tv, tm)
        want_acc, want_max, want_sum = (np.asarray(x) for x in ref_partials(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
        np.testing.assert_allclose(row_max.numpy(), want_max, **tol)
        np.testing.assert_allclose(row_sum.numpy(), want_sum, **tol)
        rows = np.maximum(want_sum, 1.0)[..., None]
        np.testing.assert_allclose(acc.numpy() / rows, want_acc / rows, **tol)
        assert (acc.numpy()[0] == 0).all() and (row_sum.numpy()[0] == 0).all()
    # CPU tensors take the plain versions and launch nothing
    assert (flash.LAUNCHES, flash.LSE_LAUNCHES, flash.PARTIAL_LAUNCHES,
            flash.DKV_LAUNCHES) == counts


# the regime of the card's packed-sets dQ at the head dims of HEAD_DIMS (L
# up to SETS_MAX_L, a block the queries of 32 / L whole sets, sweeping their
# keys), at the same edges: the port's backward (on the CPU its plain
# version) from the forward's o and lse, as the kernels get them, against
# jax.vjp of the reference's Pallas flash_attention (its dQ kernel in
# interpret mode), float32
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [1, 10, 15, 20, 21, 22, 32])
@pytest.mark.parametrize("d", [32, 128])
def test_packed_short_sets_dq_at_the_head_dims_matches_reference(d, l, causal):
    q, k, v, mask = _mk(3, 5, l, d, seed=l + d + causal, fully_masked=True)
    do = np.random.default_rng(l + d + 1).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tm, tdo = (torch.from_numpy(x) for x in (q, k, v, mask, do))
    counts = (flash.DKV_LAUNCHES, flash.DQ_LAUNCHES, flash.LSE_LAUNCHES)

    o, lse = flash.flash_attention_lse(tq, tk, tv, tm, causal)
    dq, _, _ = flash.flash_attention_bwd(tq, tk, tv, tm, o, lse, tdo, causal)
    _, vjp = jax.vjp(lambda q, k, v: ref_flash(q, k, v, mask, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_dq, _, _ = vjp(jnp.asarray(do))
    assert dq.shape == q.shape and dq.dtype == torch.float32
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=GRAD_TOL, rtol=GRAD_TOL)
    assert (dq.numpy()[0] == 0).all()  # the fully masked batch row
    # CPU tensors take the plain versions and launch nothing
    assert (flash.DKV_LAUNCHES, flash.DQ_LAUNCHES, flash.LSE_LAUNCHES) == counts
