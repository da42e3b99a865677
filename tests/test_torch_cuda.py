"""The port's CUDA kernels against their plain versions, on the card.

Imports no jax, so it runs on the GPU machine, which has none:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(--noconftest: tests/conftest.py sets up jax for the reference). Every
test skips, inside the test, where there is no CUDA device."""

import pytest
import torch

from dragonfly2_tpu_torch.ops import flash

pytestmark = pytest.mark.cuda

# bf16 rounding of q, k, v and p before the tensor cores, and of a bf16
# output (chip_smoke.py holds the kernel to the same tolerance)
ATOL, RTOL = 3e-2, 2e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize(
    "shape,causal,dtype",
    [
        ((8, 4, 15, 32), False, torch.bfloat16),
        ((2, 2, 130, 16), True, torch.bfloat16),
        ((2, 2, 33, 64), False, torch.bfloat16),
        ((2, 2, 200, 128), False, torch.float32),
    ],
)
def test_kernel_matches_plain(shape, causal, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, l, d = shape
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
    mask = torch.rand(b, l, generator=gen, device="cuda") < 0.8
    mask[0] = False
    for kv_mask in (mask, None):
        before = flash.LAUNCHES
        out = flash.flash_attention(q, k, v, kv_mask, causal)
        assert flash.LAUNCHES == before + 1
        assert out.dtype == dtype and out.shape == q.shape and out.is_cuda
        ref = flash.flash_attention_plain(q, k, v, kv_mask, causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    assert (flash.flash_attention(q, k, v, mask, causal)[0] == 0).all()


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    _need_card()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(flash, "flash_attention_plain", refuse)
    monkeypatch.setattr(flash, "dense_attention", refuse)
    q = torch.randn(2, 2, 15, 32, device="cuda", dtype=torch.bfloat16)
    assert torch.isfinite(flash.flash_attention(q, q, q, None)).all()
    with pytest.raises(ValueError, match="one device"):
        flash.flash_attention(q, q, q, torch.ones(2, 15, dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, None)


# the backward: bf16 rounding of q, k, v, dO, P and dS before the tensor
# cores (the plain version keeps P and dS in the input dtype only), summed
# over up to L keys or queries
GRAD_ATOL, GRAD_RTOL = 5e-2, 5e-2


def _training_inputs(shape, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, l, d = shape
    q, k, v, do = (torch.randn(b, h, l, d, generator=gen, device="cuda").to(dtype) for _ in range(4))
    mask = torch.rand(b, l, generator=gen, device="cuda") < 0.8
    mask[:, 0] = True
    mask[0] = False  # a fully masked batch row
    return q, k, v, do, mask


@pytest.mark.parametrize(
    "shape,causal,dtype",
    [
        ((256, 4, 20, 32), False, torch.bfloat16),  # the trained shape
        ((2, 4, 1000, 32), True, torch.bfloat16),  # long, causal, ragged tiles
        ((2, 2, 70, 128), True, torch.bfloat16),
        ((3, 2, 33, 16), False, torch.float32),
    ],
)
def test_training_kernels_match_plain(shape, causal, dtype):
    _need_card()
    q, k, v, do, mask = _training_inputs(shape, dtype)
    for kv_mask in (mask, None):
        counts = (flash.LSE_LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES)
        o, lse = flash.flash_attention_lse(q, k, v, kv_mask, causal)
        ref_o, ref_lse = flash.flash_attention_lse_plain(q, k, v, kv_mask, causal)
        torch.testing.assert_close(o.float(), ref_o.float(), atol=ATOL, rtol=RTOL)
        seen = torch.isfinite(ref_lse) & (ref_lse > -1e20)  # rows with a valid key
        torch.testing.assert_close(lse[seen], ref_lse[seen], atol=ATOL, rtol=RTOL)
        assert torch.isfinite(lse).all()
        # both sides from the same o and lse: the backward kernels alone
        got = flash.flash_attention_bwd(q, k, v, kv_mask, o, lse, do, causal)
        want = flash.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal)
        assert (flash.LSE_LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES) == tuple(
            c + 1 for c in counts
        )
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == dtype and g.shape == q.shape and g.is_cuda, name
            torch.testing.assert_close(g.float(), w.float(), atol=GRAD_ATOL, rtol=GRAD_RTOL, msg=name)
            if kv_mask is not None:
                assert (g[0] == 0).all(), name  # the fully masked batch row


def test_flash_attention_autograd_on_the_card():
    _need_card()
    q, k, v, do, mask = _training_inputs((8, 4, 20, 32), torch.bfloat16, seed=1)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash.LAUNCHES, flash.LSE_LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES)
    out = flash.flash_attention(*args, mask)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, args, do)
    after = (flash.LAUNCHES, flash.LSE_LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1, 1]
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash.flash_attention(*cpu, mask.cpu()), cpu, do.cpu())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float().cpu(), w.float(), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    with torch.inference_mode():
        assert flash.flash_attention(q, k, v, mask).grad_fn is None
    assert flash.LAUNCHES == after[0] + 1


def test_one_training_step_gradients_match_the_plain_path():
    """The full-width ranker's gradients from one batch, on the card (the
    kernels) against the CPU (the plain versions), from the same weights."""
    _need_card()
    import numpy as np

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.training.train import AttentionTrainer, build_ranker

    rng = np.random.default_rng(0)
    n, p = 64, 20
    counts = rng.integers(0, p + 1, n)
    rows = {
        "child": rng.standard_normal((n, 12)).astype(np.float32),
        "parents": rng.standard_normal((n, p, 12)).astype(np.float32),
        "pair": (rng.random((n, p, 2)) < 0.5).astype(np.float32),
        "mask": np.arange(p)[None, :] < counts[:, None],
        "throughput": (rng.random((n, p)) * 12).astype(np.float32),
    }
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        model = build_ranker(TrainerConfig(), 26, seed=0, params=None, device=device)
        trainer = AttentionTrainer(model, rows, 1e-3, device)
        loss = trainer.loss(torch.arange(n, device=device))
        loss.backward()
        losses[device] = loss.item()
        grads[device] = {name: prm.grad.float().cpu() for name, prm in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) < 2e-2
    # the score head's and the last LayerNorm's biases shift a row's scores
    # alike, which the listwise loss ignores: their true gradient is 0, so
    # both devices' must be rounding-small against the model's largest
    largest = max(float(g.abs().max()) for g in grads["cpu"].values())
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        if name in ("score.bias", "LayerNorm_0.bias"):
            assert max(float(got.abs().max()), float(want.abs().max())) <= 1e-3 * largest, name
            continue
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= 5e-2 * scale, (name, err, scale)


# the partial kernel: acc (unnormalised, a sum over up to L keys) relative
# to its row sum, to the forward's tolerance; row_max and row_sum to STATS
# for bf16 inputs (float32 from the same float32 scores as the plain
# version's), to the forward's for float32 inputs (the kernel rounds them
# to bf16 for the tensor cores, the plain version does not)
STATS_ATOL, STATS_RTOL = 1e-3, 1e-3
# the ring at L = 512 and the Hopper instances at L = 1000 .. 4097, where a
# row averages hundreds or thousands of keys (|o| ~ 0.01-0.05) and the
# forward's tolerance would pass a dropped key tile: rtol above one bf16 ulp
LONG_ATOL, LONG_RTOL = 3e-3, 1e-2
# gradients there: a dK/dV element sums hundreds or thousands of small
# terms (~0.02-0.03 at L = 4096), where GRAD would pass a skipped query tile
LONG_GRAD_ATOL, LONG_GRAD_RTOL = 5e-3, 1e-2
FILLER = -1e30 * 0.6931471805599453  # row_max of a row with no valid key


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((500, 4, 10, 32), torch.bfloat16),  # the ranker's eval shard at dp = sp = 2
        ((2, 4, 1000, 32), torch.bfloat16),  # ragged tiles
        ((2, 2, 70, 128), torch.bfloat16),
        ((3, 2, 33, 16), torch.float32),
    ],
)
def test_partial_kernel_matches_plain(shape, dtype):
    _need_card()
    q, k, v, _, mask = _training_inputs(shape, dtype, seed=2)
    for kv_mask in (mask, None):
        before = flash.PARTIAL_LAUNCHES
        acc, row_max, row_sum = flash.flash_attention_partials(q, k, v, kv_mask)
        assert flash.PARTIAL_LAUNCHES == before + 1
        assert [t.dtype for t in (acc, row_max, row_sum)] == [torch.float32] * 3
        assert acc.shape == q.shape and row_max.shape == row_sum.shape == q.shape[:3]
        want_acc, want_max, want_sum = flash.flash_attention_partials_plain(q, k, v, kv_mask)
        live = want_sum > 0
        stats = (dict(atol=STATS_ATOL, rtol=STATS_RTOL) if dtype == torch.bfloat16
                 else dict(atol=ATOL, rtol=RTOL))
        torch.testing.assert_close(row_max[live], want_max[live], **stats)
        torch.testing.assert_close(row_sum, want_sum, **stats)
        scale = want_sum.clamp_min(1.0)[..., None]
        torch.testing.assert_close(acc / scale, want_acc / scale, atol=ATOL, rtol=RTOL)
        if kv_mask is not None:  # batch row 0 has no valid key
            torch.testing.assert_close(row_max[0], torch.full_like(row_max[0], FILLER), rtol=1e-6,
                                       atol=0)
            assert (row_sum[0] == 0).all() and (acc[0] == 0).all()


def test_partials_refuse_autograd_on_the_card():
    _need_card()
    q, k, v, _, mask = _training_inputs((2, 2, 20, 32), torch.bfloat16)
    before = flash.PARTIAL_LAUNCHES
    with pytest.raises(RuntimeError, match="no gradient"):
        flash.flash_attention_partials(q.requires_grad_(), k, v, mask)
    assert flash.PARTIAL_LAUNCHES == before


@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
def test_ring_on_one_card_matches_flash_attention(dp, sp):
    """A dp x sp mesh of one card's device: the ring with the partial kernel
    launches dp * sp^2 times and matches flash_attention on the whole
    sequence; the einsum ring and the causal zigzag ring too."""
    _need_card()
    from dragonfly2_tpu_torch.parallel.mesh import make_mesh
    from dragonfly2_tpu_torch.parallel.ring import (
        sharded_causal_ring_attention,
        sharded_ring_attention,
    )

    q, k, v, _, mask = _training_inputs((4, 4, 512, 32), torch.bfloat16, seed=3)
    mesh = make_mesh(dp * sp, dp=dp, sp=sp, devices=[torch.device("cuda", 0)] * (dp * sp))
    want = flash.flash_attention(q, k, v, mask)
    before = flash.PARTIAL_LAUNCHES
    got = sharded_ring_attention(mesh, q, k, v, mask, use_flash=True)
    assert flash.PARTIAL_LAUNCHES == before + dp * sp * sp
    assert got.dtype == q.dtype and got.is_cuda
    torch.testing.assert_close(got.float(), want.float(), atol=LONG_ATOL, rtol=LONG_RTOL)
    assert (got[0] == 0).all()  # the fully masked batch row
    einsum = sharded_ring_attention(mesh, q, k, v, mask)
    torch.testing.assert_close(einsum.float(), want.float(), atol=LONG_ATOL, rtol=LONG_RTOL)
    causal = sharded_causal_ring_attention(mesh, q, k, v, mask)
    torch.testing.assert_close(causal.float(), flash.flash_attention(q, k, v, mask, True).float(),
                               atol=LONG_ATOL, rtol=LONG_RTOL)


# --------------------------------------------- the Hopper (sm90) instances

SM90_ENTRIES = {
    "dfly_flash_fwd_sm90", "dfly_flash_fwd_lse_sm90", "dfly_flash_fwd_partial_sm90",
    "dfly_flash_bwd_dkv_sm90", "dfly_flash_bwd_dq_sm90",
}
SM90_COUNTERS = ("FWD_SM90_LAUNCHES", "LSE_SM90_LAUNCHES", "PARTIAL_SM90_LAUNCHES",
                 "DKV_SM90_LAUNCHES", "DQ_SM90_LAUNCHES")


def _sm90_counts():
    return {name: getattr(flash, name) for name in SM90_COUNTERS}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("l", [96, 1000, 4000, 4097])
def test_sm90_instances_match_plain(l, d, causal):
    """Ragged lengths at every head dim, from the shortest Hopper set (one
    partial 128-row block, a ragged key tile) up: the three forward modes,
    dK/dV and dQ against their plain versions at the long tolerances, with
    a mask (batch row 0 fully masked) and without, and the per-variant
    counters."""
    _need_card()
    assert flash._sm90_path(l, d, torch.bfloat16)
    q, k, v, do, mask = _training_inputs((2, 2, l, d), torch.bfloat16, seed=l + d)
    tol = dict(atol=LONG_ATOL, rtol=LONG_RTOL)
    for kv_mask in (mask, None):
        before = _sm90_counts()
        out = flash.flash_attention(q, k, v, kv_mask, causal)
        torch.testing.assert_close(out.float(), flash.flash_attention_plain(q, k, v, kv_mask, causal)
                                   .float(), **tol)
        o, lse = flash.flash_attention_lse(q, k, v, kv_mask, causal)
        ref_o, ref_lse = flash.flash_attention_lse_plain(q, k, v, kv_mask, causal)
        torch.testing.assert_close(o.float(), ref_o.float(), **tol)
        assert torch.equal(o, out)  # one kernel, two modes: the same output
        seen = ref_lse > -1e20  # rows with a valid key
        torch.testing.assert_close(lse[seen], ref_lse[seen], atol=STATS_ATOL, rtol=STATS_RTOL)
        assert torch.isfinite(lse).all()

        acc, row_max, row_sum = flash.flash_attention_partials(q, k, v, kv_mask)
        want_acc, want_max, want_sum = flash.flash_attention_partials_plain(q, k, v, kv_mask)
        live = want_sum > 0
        torch.testing.assert_close(row_max[live], want_max[live], atol=STATS_ATOL, rtol=STATS_RTOL)
        torch.testing.assert_close(row_sum, want_sum, atol=STATS_ATOL, rtol=STATS_RTOL)
        scale = want_sum.clamp_min(1.0)[..., None]
        torch.testing.assert_close(acc / scale, want_acc / scale, atol=LONG_ATOL, rtol=LONG_RTOL)

        dq_before = flash.DQ_LAUNCHES
        got = flash.flash_attention_bwd(q, k, v, kv_mask, o, lse, do, causal)
        want = flash.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == torch.bfloat16 and g.shape == q.shape, name
            torch.testing.assert_close(g.float(), w.float(), atol=LONG_GRAD_ATOL,
                                       rtol=LONG_GRAD_RTOL, msg=lambda m, name=name: f"{name}: {m}")
        assert flash.DQ_LAUNCHES == dq_before + 1
        assert _sm90_counts() == {name: count + 1 for name, count in before.items()}
        if kv_mask is not None:  # batch row 0 has no valid key
            assert (out[0] == 0).all() and (o[0] == 0).all()
            torch.testing.assert_close(row_max[0], torch.full_like(row_max[0], FILLER), rtol=1e-6,
                                       atol=0)
            assert (row_sum[0] == 0).all() and (acc[0] == 0).all()
            for name, g in zip(("dq", "dk", "dv"), got):
                assert (g[0] == 0).all(), name


def test_sm90_path_never_reaches_the_plain_version_or_the_mma_sync_instance(monkeypatch):
    """A CUDA tensor on the Hopper path goes to the Hopper instances, or
    the call raises."""
    _need_card()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("flash_attention_plain", "dense_attention", "flash_attention_lse_plain",
                 "flash_attention_partials_plain", "flash_attention_bwd_plain"):
        monkeypatch.setattr(flash, name, refuse)
    launched = []  # the launches made: the launcher checks the operands before it launches
    real = flash._launch
    monkeypatch.setattr(flash, "_launch",
                        lambda name, *a: (real(name, *a), launched.append(name))[0])
    q, k, v, do, mask = _training_inputs((2, 2, 300, 64), torch.bfloat16, seed=4)
    flash.flash_attention(q, k, v, mask)
    flash.flash_attention_partials(q, k, v, mask)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(flash.flash_attention(*leaves, mask, True), leaves, do)
    assert launched == ["dfly_flash_fwd_sm90", "dfly_flash_fwd_partial_sm90",
                        "dfly_flash_fwd_lse_sm90", "dfly_flash_bwd_dkv_sm90",
                        "dfly_flash_bwd_dq_sm90"]
    # an operand TMA cannot read (8 bytes off a 16-byte boundary) raises
    skewed = torch.empty(q.numel() + 4, dtype=q.dtype, device="cuda")[4:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        flash.flash_attention(skewed, k, v, mask)
    assert len(launched) == 5


def test_short_sets_keep_the_mma_sync_instances(monkeypatch):
    """The ranker's shapes (served, trained, eval shard) and float32 launch
    the mma.sync instances only."""
    _need_card()
    launched = []
    real = flash._launch
    monkeypatch.setattr(flash, "_launch",
                        lambda name, *a: launched.append(name) or real(name, *a))
    before = _sm90_counts()
    for shape, dtype in (((64, 4, 15, 32), torch.bfloat16), ((64, 4, 20, 32), torch.bfloat16),
                         ((64, 4, 10, 32), torch.bfloat16), ((2, 2, 300, 64), torch.float32)):
        q, k, v, do, mask = _training_inputs(shape, dtype)
        flash.flash_attention(q, k, v, mask)
        flash.flash_attention_partials(q, k, v, mask)
        o, lse = flash.flash_attention_lse(q, k, v, mask)
        flash.flash_attention_bwd(q, k, v, mask, o, lse, do)
    torch.cuda.synchronize()
    assert _sm90_counts() == before
    assert len(launched) == 4 * 5 and not SM90_ENTRIES & set(launched)


# ----------------------------------- head dims outside the instances (C2)


# The padded route zero-pads q, k, v (and o, dO) to the next instance and
# gives the kernels the unpadded D's softmax scale, so it computes the
# unpadded function: its outputs, row stats and gradients are held to the
# plain versions at D itself, at the kernels' own tolerances (the long ones
# at L = 1000). tests/test_torch_flash.py holds the algebra on the CPU.


@pytest.mark.parametrize("l", [15, 1000])
def test_head_dim_24_pads_to_an_instance(l):
    """D = 24 on the card: zero-padded to 32 and scored at D = 24's scale,
    through the instance at 32 (the Hopper one at L = 1000): forward, lse,
    partials, backward and autograd against the plain versions at D = 24."""
    _need_card()
    q, k, v, do, mask = _training_inputs((2, 4, l, 24), torch.bfloat16, seed=l)
    long = l > flash.SM90_MIN_L
    tol = dict(atol=LONG_ATOL, rtol=LONG_RTOL) if long else dict(atol=ATOL, rtol=RTOL)
    stats = dict(atol=STATS_ATOL, rtol=STATS_RTOL)
    grad_tol = (dict(atol=LONG_GRAD_ATOL, rtol=LONG_GRAD_RTOL) if long
                else dict(atol=GRAD_ATOL, rtol=GRAD_RTOL))
    for causal in (False, True):
        before = _sm90_counts(), flash.LAUNCHES
        out = flash.flash_attention(q, k, v, mask, causal)
        assert out.shape == q.shape and out.dtype == q.dtype and out.is_contiguous()
        assert flash.LAUNCHES == before[1] + 1
        assert (_sm90_counts()["FWD_SM90_LAUNCHES"] == before[0]["FWD_SM90_LAUNCHES"] + 1) == long
        torch.testing.assert_close(out.float(), flash.flash_attention_plain(q, k, v, mask, causal)
                                   .float(), **tol)
        assert (out[0] == 0).all()
        o, lse = flash.flash_attention_lse(q, k, v, mask, causal)
        ref_o, ref_lse = flash.flash_attention_lse_plain(q, k, v, mask, causal)
        seen = ref_lse > -1e20
        torch.testing.assert_close(o.float(), ref_o.float(), **tol)
        torch.testing.assert_close(lse[seen], ref_lse[seen], **stats)
        got = flash.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)
        want = flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, causal)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape == q.shape and g.dtype == q.dtype, name
            torch.testing.assert_close(g.float(), w.float(), **grad_tol,
                                       msg=lambda m, name=name: f"{name}: {m}")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        counts = flash.LSE_LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES
        auto = torch.autograd.grad(flash.flash_attention(*leaves, mask, causal), leaves, do)
        assert (flash.LSE_LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES) == tuple(
            c + 1 for c in counts)
        for name, g, w in zip(("dq", "dk", "dv"), auto, got):
            torch.testing.assert_close(g.float(), w.float(), **grad_tol,
                                       msg=lambda m, name=name: f"{name}: {m}")
    acc, row_max, row_sum = flash.flash_attention_partials(q, k, v, mask)
    want_acc, want_max, want_sum = flash.flash_attention_partials_plain(q, k, v, mask)
    live = want_sum > 0
    torch.testing.assert_close(row_max[live], want_max[live], **stats)
    torch.testing.assert_close(row_sum, want_sum, **stats)
    scale_rows = want_sum.clamp_min(1.0)[..., None]
    torch.testing.assert_close(acc / scale_rows, want_acc / scale_rows, **tol)


WIDE_COUNTERS = ("FWD_WIDE_LAUNCHES", "LSE_WIDE_LAUNCHES", "PARTIAL_WIDE_LAUNCHES",
                 "DKV_WIDE_LAUNCHES", "DQ_WIDE_LAUNCHES")
WIDE_SM90_COUNTERS = ("FWD_WIDE_SM90_LAUNCHES", "LSE_WIDE_SM90_LAUNCHES",
                      "PARTIAL_WIDE_SM90_LAUNCHES", "DKV_WIDE_SM90_LAUNCHES",
                      "DQ_WIDE_SM90_LAUNCHES")
WIDE_ENTRIES = ["dfly_flash_fwd_wide", "dfly_flash_fwd_lse_wide", "dfly_flash_fwd_partial_wide",
                "dfly_flash_bwd_dkv_wide", "dfly_flash_bwd_dq_wide"]
PLAIN_VERSIONS = ("flash_attention_plain", "dense_attention", "flash_attention_lse_plain",
                  "flash_attention_partials_plain", "flash_attention_bwd_plain")


def _wide_counts():
    return {name: getattr(flash, name) for name in WIDE_COUNTERS + WIDE_SM90_COUNTERS}


def _refuse_plain(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in PLAIN_VERSIONS:
        monkeypatch.setattr(flash, name, refuse)


def _record_launches(monkeypatch):
    launched = []
    real = flash._launch
    monkeypatch.setattr(flash, "_launch",
                        lambda name, *a: launched.append(name) or real(name, *a))
    return launched


def _plain_outputs(q, k, v, do, mask, causal):
    """Every entry's plain version at q's own D: (o, lse, partials, the
    backward from (o, lse))."""
    o, lse = flash.flash_attention_lse_plain(q, k, v, mask, causal)
    partials = flash.flash_attention_partials_plain(q, k, v, mask)
    return o, lse, partials, flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, causal)


def _check_partials(got, want, tol, stats=None):
    """The partials against the plain version's: row_max and row_sum to
    ``stats`` (STATS by default), acc over row_sum to ``tol``."""
    acc, row_max, row_sum = got
    want_acc, want_max, want_sum = want
    stats = stats or dict(atol=STATS_ATOL, rtol=STATS_RTOL)
    live = want_sum > 0
    torch.testing.assert_close(row_max[live], want_max[live], **stats)
    torch.testing.assert_close(row_sum, want_sum, **stats)
    rows = want_sum.clamp_min(1.0)[..., None]
    torch.testing.assert_close(acc / rows, want_acc / rows, **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [320, 512])
def test_head_dim_above_128_is_refused_before_any_launch(monkeypatch, d, dtype):
    """No head dim is refused any more (ROADMAP C3 closed): above 256 every
    entry (the finished forward, with lse, the partials, dK/dV, dQ, and
    autograd through FlashAttention) launches the wide mma.sync instance
    (the forward and dK/dV in one pass, dQ in 256-column chunks),
    unpadded, and matches the plain
    versions at D in bf16 and float32; no plain version runs on a CUDA
    tensor."""
    _need_card()
    q, k, v, do, mask = _training_inputs((2, 2, 40, d), dtype, seed=d)
    ref_o, ref_lse, ref_partials, ref_grads = _plain_outputs(q, k, v, do, mask, False)
    _refuse_plain(monkeypatch)
    monkeypatch.setattr(flash, "_padded", lambda *t: pytest.fail("a wide D was padded"))
    launched = _record_launches(monkeypatch)
    before = _wide_counts()
    tol, grad_tol = dict(atol=ATOL, rtol=RTOL), dict(atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # row statistics: from float32 scores of bf16 operands, which the plain
    # version's float32 operands are not (the kernel rounds them in shared
    # memory), so float32 inputs hold them to the kernel tolerance, as
    # test_training_kernels_match_plain does
    stats = dict(atol=STATS_ATOL, rtol=STATS_RTOL) if dtype == torch.bfloat16 else tol
    out = flash.flash_attention(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref_o.float(), **tol)
    o, lse = flash.flash_attention_lse(q, k, v, mask)
    assert torch.equal(o, out)
    seen = ref_lse > -1e20
    torch.testing.assert_close(lse[seen], ref_lse[seen], **stats)
    _check_partials(flash.flash_attention_partials(q, k, v, mask), ref_partials, tol, stats)
    # the backward kernels from the plain version's o and lse, as the plain one takes them
    got = flash.flash_attention_bwd(q, k, v, mask, ref_o, ref_lse, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, ref_grads):
        assert g.shape == q.shape and g.dtype == dtype, name
        torch.testing.assert_close(g.float(), w.float(), **grad_tol,
                                   msg=lambda m, name=name: f"{name}: {m}")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(flash.flash_attention(*leaves, mask), leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), auto, ref_grads):
        torch.testing.assert_close(g.float(), w.float(), **grad_tol,
                                   msg=lambda m, name=name: f"{name}: {m}")
    torch.cuda.synchronize()
    assert sorted(set(launched)) == sorted(WIDE_ENTRIES)
    counts = _wide_counts()
    assert {n: counts[n] - before[n] for n in WIDE_COUNTERS} == {
        "FWD_WIDE_LAUNCHES": 1, "LSE_WIDE_LAUNCHES": 2, "PARTIAL_WIDE_LAUNCHES": 1,
        "DKV_WIDE_LAUNCHES": 2, "DQ_WIDE_LAUNCHES": 2}
    assert all(counts[n] == before[n] for n in WIDE_SM90_COUNTERS)


def _wide_names(l, d, dtype):
    """The wide entry each of the forward, the partials, the forward with
    lse, dK/dV and dQ launches at (L, D, dtype), from the thresholds."""
    fwd, dkv, dq = ("_wide_sm90" if flash._sm90_path(l, d, dtype, kernel) else "_wide"
                    for kernel in ("fwd", "dkv", "dq"))
    return ["dfly_flash_fwd" + fwd, "dfly_flash_fwd_partial" + fwd, "dfly_flash_fwd_lse" + fwd,
            "dfly_flash_bwd_dkv" + dkv, "dfly_flash_bwd_dq" + dq]


@pytest.mark.parametrize("l,dtype", [(20, torch.bfloat16), (1000, torch.bfloat16),
                                     (40, torch.float32)])
def test_wide_route_makes_no_pad_copy(monkeypatch, l, dtype):
    """D = 192, the wide ranker's head dim, goes to the wide instances as
    it is: the padding helper is never called, at the ranker's L = 20 (the
    mma.sync ones), at L = 1000 (the Hopper forward and dK/dV) and in
    float32 (mma.sync everywhere)."""
    _need_card()
    q, k, v, do, mask = _training_inputs((2, 2, l, 192), dtype, seed=l)
    monkeypatch.setattr(flash, "_padded", lambda *t: pytest.fail("a wide D was padded"))
    launched = _record_launches(monkeypatch)
    flash.flash_attention(q, k, v, mask)
    flash.flash_attention_partials(q, k, v, mask)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(flash.flash_attention(*leaves, mask, True), leaves, do)
    torch.cuda.synchronize()
    assert all(g.shape == q.shape for g in grads)
    assert launched == _wide_names(l, 192, dtype)
    if dtype == torch.float32:
        assert not any(name.endswith("_sm90") for name in launched)


WIDE_SM90_CASES = [
    # the ranker's training batch with a ragged key mask, forced onto the
    # Hopper instances whatever the threshold
    ((256, 4, 20, 192), False, True),
    ((2, 2, 1000, 192), False, False), ((2, 2, 1000, 192), True, False),
    ((2, 2, 4097, 192), False, False), ((2, 2, 4097, 256), True, False),
    ((2, 2, 1000, 136), True, False), ((2, 2, 1000, 200), False, False),
]


@pytest.mark.parametrize("shape,causal,forced", WIDE_SM90_CASES)
def test_wide_sm90_instances_match_plain(monkeypatch, shape, causal, forced):
    """The wide Hopper instances (forward in its three modes, dK/dV, dQ)
    against the plain versions (the long tolerances at long L), with a mask holding
    fully masked batch rows and ragged rows, and without; the counters
    prove that they ran."""
    _need_card()
    if forced:
        monkeypatch.setattr(flash, "WIDE_SM90_MIN_L", 0)
        monkeypatch.setattr(flash, "WIDE_DKV_SM90_MIN_L", 0)
        monkeypatch.setattr(flash, "WIDE_DQ_SM90_MIN_L", 0)
    b, h, l, d = shape
    assert all(flash._sm90_path(l, d, torch.bfloat16, kernel) for kernel in ("fwd", "dkv", "dq"))
    q, k, v, do, mask = _training_inputs(shape, torch.bfloat16, seed=l + d + causal)
    lengths = torch.randint(1, l + 1, (b,), generator=torch.Generator().manual_seed(l)).cuda()
    mask &= torch.arange(l, device="cuda")[None, :] < lengths[:, None]  # ragged sets
    mask[1:, 0] = True
    mask[0] = False
    # the long tolerances where a row averages hundreds of keys; the short
    # sets' own at the ranker's 20
    long = l > flash.SM90_MIN_L
    tol = dict(atol=LONG_ATOL, rtol=LONG_RTOL) if long else dict(atol=ATOL, rtol=RTOL)
    grad_tol = (dict(atol=LONG_GRAD_ATOL, rtol=LONG_GRAD_RTOL) if long
                else dict(atol=GRAD_ATOL, rtol=GRAD_RTOL))
    for kv_mask in (mask, None):
        before = _wide_counts()
        out = flash.flash_attention(q, k, v, kv_mask, causal)
        ref_o, ref_lse = flash.flash_attention_lse_plain(q, k, v, kv_mask, causal)
        torch.testing.assert_close(out.float(), ref_o.float(), **tol)
        o, lse = flash.flash_attention_lse(q, k, v, kv_mask, causal)
        assert torch.equal(o, out)
        seen = ref_lse > -1e20
        torch.testing.assert_close(lse[seen], ref_lse[seen], atol=STATS_ATOL, rtol=STATS_RTOL)
        assert torch.isfinite(lse).all()
        partials = flash.flash_attention_partials(q, k, v, kv_mask)
        _check_partials(partials, flash.flash_attention_partials_plain(q, k, v, kv_mask), tol)
        got = flash.flash_attention_bwd(q, k, v, kv_mask, o, lse, do, causal)
        want = flash.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape == q.shape and g.dtype == q.dtype, name
            torch.testing.assert_close(g.float(), w.float(), **grad_tol,
                                       msg=lambda m, name=name: f"{name}: {m}")
        counts = _wide_counts()
        assert {n: counts[n] - before[n] for n in counts} == {
            **{n: 1 for n in WIDE_SM90_COUNTERS}, **{n: 0 for n in WIDE_COUNTERS}}
        if kv_mask is not None:  # batch row 0 has no valid key
            acc, row_max, row_sum = partials
            assert (out[0] == 0).all() and (acc[0] == 0).all() and (row_sum[0] == 0).all()
            torch.testing.assert_close(row_max[0], torch.full_like(row_max[0], FILLER),
                                       rtol=1e-6, atol=0)
            for name, g in zip(("dq", "dk", "dv"), got):
                assert (g[0] == 0).all(), name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [160, 192, 256])
@pytest.mark.parametrize("l", [40, 1000])
def test_wide_instances_match_plain(l, d, causal):
    """The wide instances at a short and a long ragged L: the three forward
    modes, dK/dV, dQ and autograd against the plain versions at D, each
    taken as it is, on the instance the thresholds pick (the wide Hopper
    forward, dK/dV and dQ at both lengths)."""
    _need_card()
    q, k, v, do, mask = _training_inputs((2, 2, l, d), torch.bfloat16, seed=l + d + causal)
    tol, grad_tol = dict(atol=ATOL, rtol=RTOL), dict(atol=GRAD_ATOL, rtol=GRAD_RTOL)
    stats = dict(atol=STATS_ATOL, rtol=STATS_RTOL)
    counter = {"dfly_flash_fwd": "FWD", "dfly_flash_fwd_partial": "PARTIAL",
               "dfly_flash_fwd_lse": "LSE", "dfly_flash_bwd_dkv": "DKV", "dfly_flash_bwd_dq": "DQ"}
    one_each = {n: 0 for n in WIDE_COUNTERS + WIDE_SM90_COUNTERS}
    for name in _wide_names(l, d, torch.bfloat16):
        base, _, instance = name.partition("_wide")
        one_each[f"{counter[base]}_WIDE{instance.upper()}_LAUNCHES"] = 1
    for kv_mask in (mask, None):
        before = _wide_counts()
        out = flash.flash_attention(q, k, v, kv_mask, causal)
        assert out.shape == q.shape and out.dtype == q.dtype
        torch.testing.assert_close(out.float(), flash.flash_attention_plain(
            q, k, v, kv_mask, causal).float(), **tol)
        o, lse = flash.flash_attention_lse(q, k, v, kv_mask, causal)
        ref_o, ref_lse = flash.flash_attention_lse_plain(q, k, v, kv_mask, causal)
        assert torch.equal(o, out)  # one kernel, two modes
        seen = ref_lse > -1e20
        torch.testing.assert_close(lse[seen], ref_lse[seen], **stats)
        assert torch.isfinite(lse).all()
        acc, row_max, row_sum = flash.flash_attention_partials(q, k, v, kv_mask)
        want_acc, want_max, want_sum = flash.flash_attention_partials_plain(q, k, v, kv_mask)
        live = want_sum > 0
        torch.testing.assert_close(row_max[live], want_max[live], atol=STATS_ATOL,
                                   rtol=STATS_RTOL)
        torch.testing.assert_close(row_sum, want_sum, atol=STATS_ATOL, rtol=STATS_RTOL)
        rows = want_sum.clamp_min(1.0)[..., None]
        torch.testing.assert_close(acc / rows, want_acc / rows, **tol)
        got = flash.flash_attention_bwd(q, k, v, kv_mask, o, lse, do, causal)
        want = flash.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape == q.shape and g.dtype == q.dtype, name
            torch.testing.assert_close(g.float(), w.float(), **grad_tol,
                                       msg=lambda m, name=name: f"{name}: {m}")
        counts = _wide_counts()
        assert {n: counts[n] - before[n] for n in counts} == one_each
        if kv_mask is not None:  # batch row 0 has no valid key
            assert (out[0] == 0).all() and (acc[0] == 0).all() and (row_sum[0] == 0).all()
            torch.testing.assert_close(row_max[0], torch.full_like(row_max[0], FILLER),
                                       rtol=1e-6, atol=0)
            for name, g in zip(("dq", "dk", "dv"), got):
                assert (g[0] == 0).all(), name
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(flash.flash_attention(*leaves, mask, causal), leaves, do)
    o, lse = flash.flash_attention_lse(q, k, v, mask, causal)
    for name, g, w in zip(("dq", "dk", "dv"), auto,
                          flash.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [33, 64, 65, 4097])
@pytest.mark.parametrize("d", [136, 192, 256])
def test_wide_dq_sm90_matches_plain(monkeypatch, d, l, causal):
    """The wide Hopper dQ, forced at every L (a ragged key tile at 33 and
    65, one whole tile at 64, 65 tiles at 4097), at both compile-time
    widths (136 and 192 at 192, 256 at 256), against the plain version
    from the same o and lse, with a fully masked batch row (exactly 0) and
    without a mask; no plain version runs on a CUDA tensor."""
    _need_card()
    monkeypatch.setattr(flash, "WIDE_DQ_SM90_MIN_L", 0)
    q, k, v, do, mask = _training_inputs((2, 2, l, d), torch.bfloat16, seed=l + d + causal)
    long = l > flash.SM90_MIN_L
    grad_tol = (dict(atol=LONG_GRAD_ATOL, rtol=LONG_GRAD_RTOL) if long
                else dict(atol=GRAD_ATOL, rtol=GRAD_RTOL))
    cases = []
    for kv_mask in (mask, None):
        o, lse = flash.flash_attention_lse_plain(q, k, v, kv_mask, causal)
        delta = (do.float() * o.float()).sum(-1)
        want = flash.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal)[0]
        cases.append((kv_mask, lse, delta, want))
    _refuse_plain(monkeypatch)
    launched = _record_launches(monkeypatch)
    for kv_mask, lse, delta, want in cases:
        before = flash.DQ_LAUNCHES, flash.DQ_WIDE_SM90_LAUNCHES, flash.DQ_WIDE_LAUNCHES
        got = flash.flash_attention_bwd_dq(q, k, v, kv_mask, lse, delta, do, causal)
        torch.cuda.synchronize()
        assert (flash.DQ_LAUNCHES, flash.DQ_WIDE_SM90_LAUNCHES, flash.DQ_WIDE_LAUNCHES) == (
            before[0] + 1, before[1] + 1, before[2])
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), **grad_tol)
        if kv_mask is not None:
            assert (got[0] == 0).all()  # batch row 0 has no valid key
    assert launched == ["dfly_flash_bwd_dq_wide_sm90"] * 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("l", [1, 20, 33, 1024])
@pytest.mark.parametrize("d", [264, 320, 384, 512])
def test_forward_above_256_matches_plain(monkeypatch, d, l, dtype):
    """The wide forward's one-pass kernel (D in (256, 512]: 5 to 8 column
    warps; L = 1 and 20 one key tile, 33 a ragged second, 1024 thirty-two
    with the next in flight) in its three modes, causal or not for the
    finished output and lse, against the plain versions, with a fully
    masked batch row; one launch each at the call's own D, no plain
    version and no pad copy."""
    _need_card()
    q, k, v, _, mask = _training_inputs((2, 2, l, d), dtype, seed=l + d)
    # the kernel's operands are bf16 (float32 inputs are rounded to bf16 in
    # shared memory): the plain version on those operands holds both dtypes
    # to the long tolerances at L = 1024 and lse to STATS. A float32 call's
    # output is also held to the plain version on its unrounded inputs, to
    # the kernel tolerance (the rounding moves a causal call's first rows, a
    # few keys each, by up to ~0.01 at any L)
    rq, rk, rv = (t.to(torch.bfloat16).to(dtype) for t in (q, k, v))
    tol = dict(atol=LONG_ATOL, rtol=LONG_RTOL) if l > 1000 else dict(atol=ATOL, rtol=RTOL)
    stats = dict(atol=STATS_ATOL, rtol=STATS_RTOL)
    refs = {causal: flash.flash_attention_lse_plain(rq, rk, rv, mask, causal)
            for causal in (False, True)}
    unrounded = {causal: flash.flash_attention_plain(q, k, v, mask, causal)
                 for causal in (False, True) if dtype == torch.float32}
    ref_partials = flash.flash_attention_partials_plain(rq, rk, rv, mask)
    _refuse_plain(monkeypatch)
    monkeypatch.setattr(flash, "_padded", lambda *t: pytest.fail("a wide D was padded"))
    launched = _record_launches(monkeypatch)
    before = _wide_counts()
    for causal, (ref_o, ref_lse) in refs.items():
        out = flash.flash_attention(q, k, v, mask, causal)
        torch.testing.assert_close(out.float(), ref_o.float(), **tol)
        if causal in unrounded:
            torch.testing.assert_close(out, unrounded[causal], atol=ATOL, rtol=RTOL)
        o, lse = flash.flash_attention_lse(q, k, v, mask, causal)
        assert torch.equal(o, out)  # one kernel, two modes
        seen = ref_lse > -1e20
        torch.testing.assert_close(lse[seen], ref_lse[seen], **stats)
        assert torch.isfinite(lse).all() and (out[0] == 0).all()
    partials = flash.flash_attention_partials(q, k, v, mask)
    _check_partials(partials, ref_partials, tol, stats)
    assert (partials[0][0] == 0).all() and (partials[2][0] == 0).all()
    torch.cuda.synchronize()
    assert launched == ["dfly_flash_fwd_wide", "dfly_flash_fwd_lse_wide"] * 2 + [
        "dfly_flash_fwd_partial_wide"]
    counts = _wide_counts()
    assert {n: counts[n] - before[n] for n in counts} == {
        **{n: 0 for n in counts}, "FWD_WIDE_LAUNCHES": 2, "LSE_WIDE_LAUNCHES": 2,
        "PARTIAL_WIDE_LAUNCHES": 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [136, 192, 256])
@pytest.mark.parametrize("l", [1, 7, 10, 16, 20, 31, 32])
def test_packed_short_sets_match_plain(monkeypatch, l, d, causal, dtype):
    """The wide forward's packed-sets kernel (D up to 256 at L up to 32: 32
    flattened rows a block, whatever sets they belong to) in its three
    modes, the finished output and lse causal or not, the partials
    without, on B x H = 3 x 5 sets, so sets straddle the blocks at every L
    but 1, 16 and 32, against the plain versions; batch row 0 has no valid
    key and comes out exactly 0 (the partials' row_max at the filler); and
    without a mask. One launch each, counted on the *_WIDE_LAUNCHES
    counters; no plain version and no pad copy."""
    _need_card()
    q, k, v, _, mask = _training_inputs((3, 5, l, d), dtype, seed=l + d + causal)
    # the kernel rounds float32 operands to bf16 in shared memory: the plain
    # version on the rounded values holds both dtypes, lse and the row
    # statistics to STATS, as test_forward_above_256_matches_plain does
    rq, rk, rv = (t.to(torch.bfloat16).to(dtype) for t in (q, k, v))
    tol, stats = dict(atol=ATOL, rtol=RTOL), dict(atol=STATS_ATOL, rtol=STATS_RTOL)
    refs = {masked: (*flash.flash_attention_lse_plain(rq, rk, rv, kv_mask, causal),
                     None if causal else flash.flash_attention_partials_plain(rq, rk, rv, kv_mask))
            for masked, kv_mask in ((True, mask), (False, None))}
    _refuse_plain(monkeypatch)
    monkeypatch.setattr(flash, "_padded", lambda *t: pytest.fail("a wide D was padded"))
    launched = _record_launches(monkeypatch)
    before = _wide_counts()
    for masked, (ref_o, ref_lse, ref_partials) in refs.items():
        kv_mask = mask if masked else None
        out = flash.flash_attention(q, k, v, kv_mask, causal)
        torch.testing.assert_close(out.float(), ref_o.float(), **tol)
        o, lse = flash.flash_attention_lse(q, k, v, kv_mask, causal)
        assert torch.equal(o, out)  # one kernel, two modes
        seen = ref_lse > -1e20
        torch.testing.assert_close(lse[seen], ref_lse[seen], **stats)
        assert torch.isfinite(lse).all()
        if masked:
            assert (out[0] == 0).all()
        if not causal:
            acc, row_max, row_sum = flash.flash_attention_partials(q, k, v, kv_mask)
            _check_partials((acc, row_max, row_sum), ref_partials, tol, stats)
            if masked:
                assert (acc[0] == 0).all() and (row_sum[0] == 0).all()
                torch.testing.assert_close(row_max[0], torch.full_like(row_max[0], FILLER),
                                           rtol=1e-6, atol=0)
    torch.cuda.synchronize()
    want = ["dfly_flash_fwd_wide", "dfly_flash_fwd_lse_wide"] + (
        [] if causal else ["dfly_flash_fwd_partial_wide"])
    assert launched == want * 2
    counts = _wide_counts()
    assert {n: counts[n] - before[n] for n in counts} == {
        **{n: 0 for n in counts}, "FWD_WIDE_LAUNCHES": 2, "LSE_WIDE_LAUNCHES": 2,
        "PARTIAL_WIDE_LAUNCHES": 0 if causal else 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("l", [1, 10, 15, 20, 21, 22, 32])
def test_packed_sets_at_the_head_dims_match_plain(monkeypatch, l, d, causal, dtype):
    """The mma.sync forward's, dK/dV's and dQ's packed-sets kernels (D in
    HEAD_DIMS at L up to SETS_MAX_L: a block holds the rows, keys or
    queries of 32 / L whole sets) on B x H = 3 x 5 sets, so the last block
    is short at most L: the forward in its three modes (the
    partials without causal), dK/dV and dQ against the plain versions, with
    a mask whose batch row 0 has no valid key (exactly 0 out, the partials'
    row_max at the filler, dK = dV = dQ = 0) and without. dK/dV and dQ take
    the plain forward's lse and delta. One launch of each counted; no plain
    version on the card."""
    _need_card()
    q, k, v, do, mask = _training_inputs((3, 5, l, d), dtype, seed=l + d + causal)
    # the kernels round float32 operands to bf16 in shared memory: the plain
    # versions take the rounded values, so lse and the row statistics hold
    # to STATS in both dtypes
    rq, rk, rv, rdo = (t.to(torch.bfloat16).to(dtype) for t in (q, k, v, do))
    tol, stats = dict(atol=ATOL, rtol=RTOL), dict(atol=STATS_ATOL, rtol=STATS_RTOL)
    refs = {}
    for masked, kv_mask in ((True, mask), (False, None)):
        o, lse = flash.flash_attention_lse_plain(rq, rk, rv, kv_mask, causal)
        delta = (rdo.float() * o.float()).sum(-1)
        dq, dk, dv = flash.flash_attention_bwd_plain(rq, rk, rv, kv_mask, o, lse, rdo, causal)
        partials = None if causal else flash.flash_attention_partials_plain(rq, rk, rv, kv_mask)
        refs[masked] = (o, lse, delta, dq, dk, dv, partials)
    _refuse_plain(monkeypatch)
    launched = _record_launches(monkeypatch)
    before = {name: getattr(flash, name) for name in ("LAUNCHES", "LSE_LAUNCHES",
                                                      "PARTIAL_LAUNCHES", "DKV_LAUNCHES",
                                                      "DQ_LAUNCHES")}
    for masked, (ref_o, ref_lse, delta, ref_dq, ref_dk, ref_dv, ref_partials) in refs.items():
        kv_mask = mask if masked else None
        out = flash.flash_attention(q, k, v, kv_mask, causal)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref_o.float(), **tol)
        o, lse = flash.flash_attention_lse(q, k, v, kv_mask, causal)
        assert torch.equal(o, out)  # one kernel, two modes
        seen = ref_lse > -1e20
        torch.testing.assert_close(lse[seen], ref_lse[seen], **stats)
        assert torch.isfinite(lse).all()
        dk, dv = flash.flash_attention_bwd_dkv(q, k, v, kv_mask, ref_lse, delta, do, causal)
        dq = flash.flash_attention_bwd_dq(q, k, v, kv_mask, ref_lse, delta, do, causal)
        for name, g, w in (("dk", dk, ref_dk), ("dv", dv, ref_dv), ("dq", dq, ref_dq)):
            assert g.dtype == dtype and g.shape == q.shape, name
            torch.testing.assert_close(g.float(), w.float(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       msg=lambda m, name=name: f"{name}: {m}")
        if masked:
            assert (out[0] == 0).all() and (dk[0] == 0).all() and (dv[0] == 0).all()
            assert (dq[0] == 0).all()
        if not causal:
            acc, row_max, row_sum = flash.flash_attention_partials(q, k, v, kv_mask)
            _check_partials((acc, row_max, row_sum), ref_partials, tol, stats)
            if masked:
                assert (acc[0] == 0).all() and (row_sum[0] == 0).all()
                torch.testing.assert_close(row_max[0], torch.full_like(row_max[0], FILLER),
                                           rtol=1e-6, atol=0)
    torch.cuda.synchronize()
    calls = ["dfly_flash_fwd", "dfly_flash_fwd_lse", "dfly_flash_bwd_dkv", "dfly_flash_bwd_dq"] + (
        [] if causal else ["dfly_flash_fwd_partial"])
    assert launched == calls * 2
    assert {name: getattr(flash, name) - count for name, count in before.items()} == {
        "LAUNCHES": 2, "LSE_LAUNCHES": 2, "DKV_LAUNCHES": 2, "DQ_LAUNCHES": 2,
        "PARTIAL_LAUNCHES": 0 if causal else 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [1, 20, 33, 1024])
@pytest.mark.parametrize("d", [264, 320, 384, 512])
def test_dkv_above_256_in_one_pass_matches_plain(monkeypatch, d, l, causal, dtype):
    """dK/dV's one-pass kernel (D in (256, 512]: 5 to 8 column warps; L = 1
    and 20 sweep one query tile in one stage, 33 a ragged second tile and
    1024 thirty-two, in two stages) against flash_attention_bwd_plain from
    the same o and lse; batch row 0 has no valid key, so its dK and dV are
    exactly 0; and without a mask. One launch each, counted on
    DKV_WIDE_LAUNCHES; no plain version and no pad copy."""
    _need_card()
    q, k, v, do, mask = _training_inputs((2, 2, l, d), dtype, seed=l + d + causal)
    # bf16-representable operands, which the kernel takes as they are, and
    # an o in bf16, so that the plain version run in bf16 on the same values
    # rounds where the kernel rounds (its operands, P and dS): the long
    # tolerances where a dK/dV row sums hundreds of queries. A float32 call
    # is also held to the plain version in float32, which keeps P and dS in
    # float32, to the kernel tolerance (test_training_kernels_match_plain's)
    q, k, v, do = (t.to(torch.bfloat16).to(dtype) for t in (q, k, v, do))
    long = l > flash.SM90_MIN_L
    grad_tol = (dict(atol=LONG_GRAD_ATOL, rtol=LONG_GRAD_RTOL) if long
                else dict(atol=GRAD_ATOL, rtol=GRAD_RTOL))
    cases = []
    for kv_mask in (mask, None):
        o, lse = flash.flash_attention_lse_plain(q, k, v, kv_mask, causal)
        o = o.to(torch.bfloat16).to(dtype)
        delta = (do.float() * o.float()).sum(-1)
        want = flash.flash_attention_bwd_plain(
            *(t.to(torch.bfloat16) for t in (q, k, v)), kv_mask, o.to(torch.bfloat16), lse,
            do.to(torch.bfloat16), causal)[1:]
        unrounded = (flash.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal)[1:]
                     if dtype == torch.float32 else None)
        cases.append((kv_mask, lse, delta, want, unrounded))
    _refuse_plain(monkeypatch)
    monkeypatch.setattr(flash, "_padded", lambda *t: pytest.fail("a wide D was padded"))
    launched = _record_launches(monkeypatch)
    for kv_mask, lse, delta, want, unrounded in cases:
        before = _wide_counts()
        got = flash.flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do, causal)
        torch.cuda.synchronize()
        counts = _wide_counts()
        assert {n: counts[n] - before[n] for n in counts} == {
            **{n: 0 for n in counts}, "DKV_WIDE_LAUNCHES": 1}
        for i, name in enumerate(("dk", "dv")):
            g = got[i]
            assert g.dtype == dtype and g.shape == q.shape, name
            torch.testing.assert_close(g.float(), want[i].float(), **grad_tol,
                                       msg=lambda m, name=name: f"{name}: {m}")
            if unrounded is not None:
                torch.testing.assert_close(g, unrounded[i], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                           msg=lambda m, name=name: f"{name} (float32 plain): {m}")
            if kv_mask is not None:
                assert (g[0] == 0).all(), name
    assert launched == ["dfly_flash_bwd_dkv_wide"] * 2


# the one-pass dQ and dK/dV at their edges: every column-warp layout (4 x
# 48 at 136 and 192, 4 x 64 at 256, 5 to 8 x 64 above), one swept tile in
# one stage (L = 1, 20, 32), a ragged second tile (33) and thirty-two in two
# stages (1024)
ONEPASS_DIMS = [136, 192, 256, 264, 320, 384, 512]
ONEPASS_LENGTHS = [1, 20, 32, 33, 1024]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", ONEPASS_LENGTHS)
@pytest.mark.parametrize("d", ONEPASS_DIMS)
def test_wide_backward_in_one_pass_matches_plain(monkeypatch, d, l, causal, dtype):
    """flash_attention_bwd_dq and flash_attention_bwd_dkv on the wide
    mma.sync entries (the Hopper thresholds raised past every L, so bf16 at
    D up to 256 reaches the one-pass kernels too) against
    flash_attention_bwd_plain from the same o and lse, on B x H = 3 x 5
    sets; batch row 0 has no valid key, so its gradients are exactly 0; and
    without a mask. One launch each, counted on DQ_WIDE_LAUNCHES and
    DKV_WIDE_LAUNCHES; no plain version and no pad copy."""
    _need_card()
    monkeypatch.setattr(flash, "WIDE_DKV_SM90_MIN_L", 1 << 30)
    monkeypatch.setattr(flash, "WIDE_DQ_SM90_MIN_L", 1 << 30)
    q, k, v, do, mask = _training_inputs((3, 5, l, d), dtype, seed=2 * (l + d) + causal)
    # bf16-representable operands and o, so that the plain version run in
    # bf16 on the same values rounds where the kernels round (operands, P
    # and dS): the long tolerances where a row sums hundreds of terms. A
    # float32 call is also held to the float32 plain version, which keeps P
    # and dS in float32, at 5e-2
    q, k, v, do = (t.to(torch.bfloat16).to(dtype) for t in (q, k, v, do))
    long = l > flash.SM90_MIN_L
    grad_tol = (dict(atol=LONG_GRAD_ATOL, rtol=LONG_GRAD_RTOL) if long
                else dict(atol=GRAD_ATOL, rtol=GRAD_RTOL))
    cases = []
    for kv_mask in (mask, None):
        o, lse = flash.flash_attention_lse_plain(q, k, v, kv_mask, causal)
        o = o.to(torch.bfloat16).to(dtype)
        delta = (do.float() * o.float()).sum(-1)
        want = flash.flash_attention_bwd_plain(
            *(t.to(torch.bfloat16) for t in (q, k, v)), kv_mask, o.to(torch.bfloat16), lse,
            do.to(torch.bfloat16), causal)
        unrounded = (flash.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal)
                     if dtype == torch.float32 else None)
        cases.append((kv_mask, lse, delta, want, unrounded))
    _refuse_plain(monkeypatch)
    monkeypatch.setattr(flash, "_padded", lambda *t: pytest.fail("a wide D was padded"))
    launched = _record_launches(monkeypatch)
    for kv_mask, lse, delta, want, unrounded in cases:
        before = _wide_counts()
        got = (flash.flash_attention_bwd_dq(q, k, v, kv_mask, lse, delta, do, causal),
               *flash.flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do, causal))
        torch.cuda.synchronize()
        counts = _wide_counts()
        assert {n: counts[n] - before[n] for n in counts} == {
            **{n: 0 for n in counts}, "DQ_WIDE_LAUNCHES": 1, "DKV_WIDE_LAUNCHES": 1}
        for i, name in enumerate(("dq", "dk", "dv")):
            g = got[i]
            assert g.dtype == dtype and g.shape == q.shape, name
            torch.testing.assert_close(g.float(), want[i].float(), **grad_tol,
                                       msg=lambda m, name=name: f"{name}: {m}")
            if unrounded is not None:
                torch.testing.assert_close(g, unrounded[i], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                           msg=lambda m, name=name: f"{name} (float32 plain): {m}")
            if kv_mask is not None:
                assert (g[0] == 0).all(), name
    assert launched == ["dfly_flash_bwd_dq_wide", "dfly_flash_bwd_dkv_wide"] * 2


def test_wide_instances_take_float32():
    """float32 at D = 256 (rounded to bf16 in shared memory, as the other
    mma.sync instances round it): forward and both backward kernels."""
    _need_card()
    q, k, v, do, mask = _training_inputs((2, 2, 70, 256), torch.float32, seed=9)
    out = flash.flash_attention(q, k, v, mask, True)
    torch.testing.assert_close(out, flash.flash_attention_plain(q, k, v, mask, True),
                               atol=ATOL, rtol=RTOL)
    o, lse = flash.flash_attention_lse(q, k, v, mask, True)
    got = flash.flash_attention_bwd(q, k, v, mask, o, lse, do, True)
    want = flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32, name
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   msg=lambda m, name=name: f"{name}: {m}")


# ---------------------------- the host launcher (csrc/flash_launch.cpp)

COUNTERS = ("LAUNCHES", "LSE_LAUNCHES", "PARTIAL_LAUNCHES", "DKV_LAUNCHES", "DQ_LAUNCHES")


def _all_counts():
    return {name: getattr(flash, name) for name in COUNTERS}


def _every_kind(q, k, v, do, mask, lse, delta):
    """One launch of each kind of the launcher, through the wrappers."""
    with torch.no_grad():
        fwd = flash.flash_attention(q, k, v, mask, True)
    return (fwd, flash.flash_attention_lse(q, k, v, mask, True),
            flash.flash_attention_partials(q, k, v, mask),
            flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do, True),
            flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, True))


def _flat(outputs):
    flat = []
    for out in outputs:
        flat.extend(out if isinstance(out, tuple) else (out,))
    return flat


@pytest.mark.parametrize("d", [32, 192])
def test_the_launcher_launches_on_the_current_stream(d):
    """Every kind launched under a side stream goes to that stream: the
    side stream first sleeps, then writes the operands; a launch on any
    other stream would read them before they are written. Read after the
    side stream syncs, the outputs equal the same calls' on the default
    stream."""
    _need_card()
    q, k, v, do, mask = _training_inputs((64, 4, 20, d), torch.bfloat16, seed=21)
    o, lse = flash.flash_attention_lse(q, k, v, mask, True)
    delta = (do.float() * o.float()).sum(-1)
    want = _flat(_every_kind(q, k, v, do, mask, lse, delta))
    late = [torch.full_like(t, 7.0) for t in (q, k, v, do)]  # what a stream that does not wait reads
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        for t, source in zip(late, (q, k, v, do)):
            t.copy_(source)
        got = _flat(_every_kind(*late, mask, lse, delta))
    side.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("d", [32, 192])
def test_launches_from_two_threads_give_the_single_thread_result(d):
    """Two worker threads launching at once, as the inference server's
    do, with the interpreter switching threads as often as it can: every
    output equals the single thread's and every launch is counted."""
    import sys
    import threading

    _need_card()
    q, k, v, do, mask = _training_inputs((256, 4, 20, d), torch.bfloat16, seed=22)
    want = flash.flash_attention_lse(q, k, v, mask)
    torch.cuda.synchronize()
    before = flash.LSE_LAUNCHES
    calls, results, errors = 100, {}, []
    barrier = threading.Barrier(2)

    def worker(i):
        try:
            barrier.wait(timeout=30)
            outs = [flash.flash_attention_lse(q, k, v, mask) for _ in range(calls)]
            torch.cuda.synchronize()
            results[i] = outs
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert sorted(results) == [0, 1] and flash.LSE_LAUNCHES == before + 2 * calls
    for outs in results.values():
        for o, lse in outs:
            assert torch.equal(o, want[0]) and torch.equal(lse, want[1])


@pytest.mark.parametrize("misuse,error,match", [
    ("cpu_operand", ValueError, "one device"),
    ("mixed_dtypes", TypeError, "dtype"),
    ("non_contiguous", ValueError, "contiguous"),
    ("misaligned", ValueError, "aligned"),
])
def test_each_misuse_raises_before_any_launch(misuse, error, match):
    """What the kernels do not take raises its Python type from the
    launcher, for every kind, with nothing counted and no kernel run: a
    CPU operand beside CUDA ones, k of another dtype, a non-contiguous or
    a misaligned k."""
    from torch.profiler import ProfilerActivity, profile

    _need_card()
    q, k, v, do, mask = _training_inputs((8, 4, 20, 32), torch.bfloat16, seed=23)
    o, lse = flash.flash_attention_lse(q, k, v, mask)
    delta = (do.float() * o.float()).sum(-1)
    bad = {
        "cpu_operand": lambda: k.cpu(),
        "mixed_dtypes": lambda: k.float(),
        "non_contiguous": lambda: k.transpose(2, 3).contiguous().transpose(2, 3),
        "misaligned": lambda: torch.empty(k.numel() + 4, dtype=k.dtype,
                                          device="cuda")[4:].view(k.shape).copy_(k),
    }[misuse]()
    calls = [
        lambda: flash._flash_forward(q, bad, v, mask, False),
        lambda: flash.flash_attention_lse(q, bad, v, mask),
        lambda: flash.flash_attention_partials(q, bad, v, mask),
        lambda: flash.flash_attention_bwd_dkv(q, bad, v, mask, lse, delta, do),
        lambda: flash.flash_attention_bwd_dq(q, bad, v, mask, lse, delta, do),
    ]
    torch.cuda.synchronize()
    before = _all_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            with pytest.raises(error, match=match):
                call()
        torch.cuda.synchronize()
    assert _all_counts() == before
    assert not [e.name for e in prof.events() if "flash" in e.name
                and e.device_type == torch.autograd.DeviceType.CUDA]


# ------------------------------------------------- the scheduler's tick


def _tick_state(seed):
    """A small seeded port state: hosts (two of them quarantined), tasks,
    peers in every state with cost rings, identity hashes above 2^31."""
    import numpy as np

    from dragonfly2_tpu_torch.state.cluster import MAX_LOC, NUM_HOST_FEATURES, ClusterState

    r = np.random.default_rng(seed)
    st = ClusterState(max_hosts=48, max_tasks=6, max_peers=128)
    for i in range(40):
        st.upsert_host(f"h{i}", id_hash=int(r.integers(1, 1 << 62)), host_type=int(r.integers(0, 2)),
                       idc=int(r.integers(0, 3)), location=r.integers(0, 3, MAX_LOC),
                       upload_limit=int(r.integers(0, 8)), upload_count=int(r.integers(0, 20)),
                       upload_failed=int(r.integers(0, 4)),
                       numeric=r.random(NUM_HOST_FEATURES).astype(np.float32))
    for i in range(6):
        st.upsert_task(f"t{i}", total_pieces=int(r.integers(0, 40)))
    for i in range(120):
        p = st.add_peer(f"p{i}", int(r.integers(0, 6)), int(r.integers(0, 40)))
        st.peer_state[p] = int(r.integers(0, 10))
        for _ in range(int(r.integers(0, 40))):
            st.record_piece(p, int(r.integers(0, 50)), float(r.lognormal(18, 0.5)))
    slot = {f"t{i}": np.where(r.random(64) < 0.7, r.integers(0, 128, 64), -1).astype(np.int32)
            for i in range(6)}
    qmask = np.zeros(48, bool)
    qmask[[1, 5]] = True
    return st, slot, qmask


def _tick_inbuf(seed, bsz, b, k=15):
    import numpy as np

    from dragonfly2_tpu_torch.ops import tick

    r = np.random.default_rng(seed)
    samples = r.integers(-1, 64, (b, k))
    samples[0] = -1  # a row with no candidate
    task_row = r.integers(-1, 6, b)
    child = r.integers(0, 128, b)
    child[1] = -1
    return tick.build_inbuf(bsz, samples, r.integers(0, 3, (b, k)), task_row, child,
                            r.random((b, k)) < 0.2, r.random((b, k)) < 0.8)


def test_fused_tick_on_the_card_equals_the_cpu():
    """TickMirror.sync and fused_tick_chunk on CUDA against the CPU on the
    same state: cols identical, int segments and selections identical,
    scores and ledger rows within 1e-6, the shadow buffer byte for byte,
    with pad rows, task_row -1 and a child row of -1; and no read-back
    inside the chunk's call."""
    _need_card()
    import copy

    import numpy as np

    from dragonfly2_tpu_torch.ops import evaluator as ev
    from dragonfly2_tpu_torch.ops import tick

    st, slot, qmask = _tick_state(0)
    out = {}
    for device in ("cpu", "cuda"):
        s = copy.deepcopy(st)
        cols = tick.TickMirror(s, 64, device=device).sync(slot, s.task_index, set(slot), qmask)
        assert all(v.device.type == device for v in cols.values())
        out[device] = [cols]
        for b, bsz in ((20, 64), (256, 256)):
            inbuf = _tick_inbuf(b, bsz, b)
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                flat, packed = tick.fused_tick_chunk(inbuf, cols, bsz, 15, 32, 5, 12, limit=4,
                                                     emit_led=True, emit_packed=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            shadow = ev.schedule_from_packed(packed, bsz, 15, 32, 5, 12, limit=4)
            out[device].append((flat.cpu().numpy(), packed.cpu().numpy(), shadow.cpu().numpy()))
    for name, value in out["cpu"][0].items():
        assert torch.equal(out["cuda"][0][name].cpu(), value), name
    for (flat, packed, shadow), (cflat, cpacked, cshadow), bsz in zip(out["cuda"][1:],
                                                                       out["cpu"][1:], (64, 256)):
        g, w = (tick.decode_out(x, bsz, 15, 4, True) for x in (flat, cflat))
        for name in ("cand_peer_idx", "cand_slots", "cand_host_slots", "cand_valid",
                     "quarantine_skipped"):
            assert np.array_equal(g[name], w[name]), name
        assert np.array_equal(g["selection"][..., 0], w["selection"][..., 0])
        valid = w["selection"][..., 0] >= 0
        assert valid.any() and not valid.all()
        np.testing.assert_allclose(g["selection"][..., 1][valid], w["selection"][..., 1][valid],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(g["led_feats"], w["led_feats"], atol=1e-6, rtol=0)
        assert np.array_equal(packed, cpacked)
        assert np.array_equal(shadow[..., 0], g["selection"][..., 0])
        assert np.array_equal(cshadow, w["selection"])


def test_topk_and_schedule_from_packed_on_the_card_equal_the_cpu():
    _need_card()
    import numpy as np

    from dragonfly2_tpu_torch.ops import evaluator as ev
    from dragonfly2_tpu_torch.ops import tick
    from dragonfly2_tpu_torch.ops.topk import masked_top_k

    r = np.random.default_rng(2)
    scores = np.round(r.random((64, 200)) * 16).astype(np.float32)  # ties
    scores[:, 0] = np.nan
    scores[:, 1] = -np.inf
    scores[:, 2] = np.inf
    mask = r.random((64, 200)) < 0.5
    mask[0] = False  # an all-invalid row
    for width, k in ((15, 4), (64, 15), (200, 6)):
        s, m = torch.from_numpy(scores[:, :width].copy()), torch.from_numpy(mask[:, :width].copy())
        cpu = masked_top_k(s, m, k)
        gpu = masked_top_k(s.cuda(), m.cuda(), k)
        for a, b_ in zip(gpu, cpu):
            assert torch.equal(a.cpu(), b_)
    st, slot, qmask = _tick_state(1)
    cols = tick.TickMirror(st, 64, device="cpu").sync(slot, st.task_index, set(slot), qmask)
    _, packed = tick.fused_tick_chunk(_tick_inbuf(3, 64, 50), cols, 64, 15, 32, 5, 12,
                                      emit_packed=True)
    buf = packed.numpy()
    for algorithm in ("default", "nt"):
        gpu = ev.schedule_from_packed(buf, 64, 15, 32, 5, 12, algorithm=algorithm, limit=4)
        assert gpu.is_cuda
        cpu = ev.schedule_from_packed(buf, 64, 15, 32, 5, 12, algorithm=algorithm, limit=4,
                                      device="cpu")
        assert torch.equal(gpu.cpu(), cpu)


# slice 16: the probe store's scatters and the segment reductions on the card,
# against the same calls on the CPU


def test_ewma_enqueue_with_duplicates_matches_the_cpu():
    """Duplicate pair ids in one batch: the last write wins on the card too
    (a CUDA scatter promises no winner; the port writes every duplicate
    with the last value). Rings, cursors, counts and averages exactly."""
    _need_card()
    from dragonfly2_tpu_torch.ops import ewma

    gen = torch.Generator().manual_seed(0)
    state = {d: (torch.zeros(300, 5), torch.zeros(300, dtype=torch.int32),
                 torch.zeros(300, dtype=torch.int32)) for d in ("cpu", "cuda")}
    state["cuda"] = tuple(t.cuda() for t in state["cuda"])
    for _ in range(20):
        pair_idx = torch.randint(0, 300, (900,), generator=gen)  # ~3 writes a pair
        rtt = torch.rand(900, generator=gen) * 1e7
        out = {}
        for dev in ("cpu", "cuda"):
            *state[dev], avg = ewma.enqueue(*state[dev], pair_idx.to(dev), rtt.to(dev))
            out[dev] = (*state[dev], avg)
        for got, want in zip(out["cuda"], out["cpu"]):
            assert torch.equal(got.cpu(), want)
    counts = torch.zeros(300, dtype=torch.int32)
    hosts = torch.randint(0, 300, (2000,), generator=gen)
    assert torch.equal(ewma.probed_count_increment(counts.cuda(), hosts.cuda()).cpu(),
                       ewma.probed_count_increment(counts, hosts))


def test_least_probed_hosts_on_the_card_matches_the_cpu():
    _need_card()
    from dragonfly2_tpu_torch.ops import ewma

    counts = torch.randint(0, 3, (10_000,), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    alive = torch.rand(10_000, generator=torch.Generator().manual_seed(2)) > 0.2
    for seed in (0, 12345, 2**30 - 1):
        idx, valid = ewma.least_probed_hosts(counts.cuda(), alive.cuda(), (0, seed), k=50)
        want_idx, want_valid = ewma.least_probed_hosts(counts, alive, (0, seed), k=50)
        assert torch.equal(idx.cpu(), want_idx) and torch.equal(valid.cpu(), want_valid)


@pytest.mark.parametrize("shape", [(50_000,), (50_000, 128)])
def test_segment_reductions_match_the_cpu(shape):
    """Sums and means within float32 atomics' reordering; max and count
    exactly; ids past either end dropped on both devices."""
    _need_card()
    from dragonfly2_tpu_torch.ops import segment

    gen = torch.Generator().manual_seed(3)
    n = 10_000
    ids = torch.randint(-5, n + 5, (shape[0],), generator=gen, dtype=torch.int32)
    data = torch.randn(shape, generator=gen)
    for name in ("segment_sum", "segment_mean", "segment_max"):
        got = getattr(segment, name)(data.cuda(), ids.cuda(), n).cpu()
        want = getattr(segment, name)(data, ids, n)
        if name == "segment_max":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(segment.segment_count(ids.cuda(), n).cpu(),
                       segment.segment_count(ids, n))


# slice 17: the ml arm's serving on the card, against the same calls on the
# CPU. bf16 selections are held equal on every row whose margin (the least
# gap between consecutive valid ensemble scores down to the cut, on the
# CPU's side) exceeds ML_MARGIN_TOL; the rows inside it are counted
ML_MARGIN_TOL = 1.2e-2
ML_LIMIT = 4


def _ml_model(hidden=64, dtype=torch.bfloat16, seed=0):
    from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker

    return GraphSAGERanker(hidden, 2, dtype).reset_parameters(
        torch.Generator().manual_seed(seed)).eval().requires_grad_(False)


def _ml_graph(n=4096, edges=32768, seed=0):
    import numpy as np

    from dragonfly2_tpu_torch.records.features import NUM_HOST_FEATURES

    r = np.random.default_rng(seed)
    return {"node_feats": r.normal(size=(n, NUM_HOST_FEATURES)).astype(np.float32),
            "edge_src": r.integers(0, n - 1, edges).astype(np.int32),
            "edge_dst": r.integers(0, n - 1, edges).astype(np.int32),
            "edge_feats": r.normal(size=(edges, 2)).astype(np.float32)}


def _ml_buf(b=256, k=15, n_hosts=4096, seed=0):
    import numpy as np

    from dragonfly2_tpu_torch.ops import evaluator as ev
    from dragonfly2_tpu_torch.records.features import CandidateFeatures
    from dragonfly2_tpu_torch.state.fsm import PeerState

    r = np.random.default_rng(seed)
    f = CandidateFeatures.zeros(b, k)
    f.valid[:] = r.random((b, k)) < 0.8
    f.finished_pieces[:] = r.integers(0, 64, (b, k))
    f.total_piece_count[:] = 64
    f.upload_count[:] = r.integers(0, 100, (b, k))
    f.upload_limit[:] = r.integers(1, 20, (b, k))
    f.upload_used[:] = r.integers(0, 10, (b, k))
    f.peer_state[:] = int(PeerState.SUCCEEDED)
    f.parent_idc[:] = r.integers(0, 4, (b, k))
    f.child_idc[:] = r.integers(0, 4, b)
    f.parent_host_id[:] = np.arange(1, b * k + 1).reshape(b, k)
    fd = f.as_dict()
    buf = ev.pack_eval_batch(fd, in_degree=r.integers(0, 3, (b, k)).astype(np.int32),
                             child_host_slot=r.integers(0, n_hosts, b).astype(np.int32),
                             cand_host_slot=r.integers(0, n_hosts, (b, k)).astype(np.int32))
    return buf, (b, k, fd["piece_costs"].shape[-1], fd["parent_location"].shape[-1],
                 fd["numeric"].shape[-1])


def test_ml_schedule_from_packed_on_the_card_equals_the_cpu_outside_the_margin():
    _need_card()
    import copy

    from dragonfly2_tpu_torch.ops import evaluator as ev
    from dragonfly2_tpu_torch.registry import serving

    model = _ml_model()
    table = serving._gnn_embed(model, _ml_graph())
    card, card_table = copy.deepcopy(model).cuda(), table.cuda()
    for seed in range(3):
        buf, dims = _ml_buf(seed=seed)
        got = serving._ml_schedule_from_packed(card, card_table, buf, *dims, ML_LIMIT)
        assert got.is_cuda
        got = got.cpu()
        want = serving._ml_schedule_from_packed(model, table, buf, *dims, ML_LIMIT)
        f = ev.unpack_eval_batch(torch.from_numpy(buf), *dims)
        scores = serving._ml_scores(model, table, f["child_host_slot"], f["cand_host_slot"], f,
                                    "default")
        mask = ev.filter_candidates(f, f["blocklist"], f["in_degree"], f["can_add_edge"])
        wide = torch.ones(dims[0], dtype=torch.bool)
        for i in range(dims[0]):
            s = scores[i][mask[i]].sort(descending=True).values[: ML_LIMIT + 1]
            if s.numel() > 1:
                wide[i] = bool((s[:-1] - s[1:]).min() > ML_MARGIN_TOL)
        same = (got[..., 0] == want[..., 0]).all(-1)
        assert int(wide.sum()) >= dims[0] // 8
        assert same[wide].all(), f"{int((~same[wide]).sum())} rows outside the margin differ"
        sel = got[..., 0] >= 0
        torch.testing.assert_close(got[..., 1][sel], want[..., 1][sel], atol=ML_MARGIN_TOL / 2,
                                   rtol=0)


def _ml_evaluator_on_card(tmp_path, seed=0):
    from dragonfly2_tpu_torch.models import convert
    from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend
    from dragonfly2_tpu_torch.registry import (BucketModelRegistry, MLEvaluator,
                                               ModelEvaluation, ModelServer)

    reg = BucketModelRegistry(FilesystemBackend(tmp_path), "models")
    tree = convert.graphsage_params_to_flax(_ml_model(seed=seed))
    mv = reg.create_model_version("ranker", "gnn", "h", tree, ModelEvaluation(),
                                  metadata={"hidden_dim": 64})
    reg.activate(mv.model_id, mv.version)
    server = ModelServer(reg, "ranker", "h", "gnn")
    assert server.refresh() and server.device.type == "cuda"
    return reg, server, MLEvaluator(server), tree


def test_the_refresh_on_its_own_stream_commits_the_inline_table(tmp_path):
    """The worker's refresh (its own CUDA stream, synchronized before the
    commit) and an inline one commit tables within phase 12's embed
    tolerance of each other (the segment sums are atomics)."""
    _need_card()
    import time

    graph = _ml_graph()
    _, _, background, _ = _ml_evaluator_on_card(tmp_path / "a")
    _, _, inline, _ = _ml_evaluator_on_card(tmp_path / "b")
    try:
        background.refresh_embeddings(dict(graph))
        deadline = time.monotonic() + 60
        while background.serving_snapshot() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        inline.refresh_embeddings(dict(graph), wait=True)
        stream = background._stream
        assert stream is not None and stream != torch.cuda.default_stream()
        got, want = background.serving_snapshot().host_emb, inline.serving_snapshot().host_emb
        assert got.is_cuda and got.shape == (4096, 64)
        torch.testing.assert_close(got.float(), want.float(), atol=5e-2, rtol=5e-2)
    finally:
        background.close()
        inline.close()


def test_a_tick_during_refreshes_reads_one_consistent_snapshot(tmp_path):
    """A thread refreshes in a loop (full and incremental, a params flip
    among them) while ticks score on the card: each call serves the
    (params_version, emb_version) of the snapshot it pinned, a pair
    committed as a unit, and its output equals the same call recomputed
    from that snapshot."""
    _need_card()
    import threading

    import numpy as np

    from dragonfly2_tpu_torch.models import convert
    from dragonfly2_tpu_torch.registry import ModelEvaluation, serving

    graph = _ml_graph()
    reg, server, evaluator, tree = _ml_evaluator_on_card(tmp_path)
    evaluator.refresh_embeddings(dict(graph), wait=True)
    buf, dims = _ml_buf()
    rng = np.random.default_rng(1)
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            i += 1
            evaluator.refresh_embeddings(dict(
                graph, dirty_slots=rng.integers(0, 4096, 8).astype(np.int32),
                full_sync=i % 5 == 0))

    thread = threading.Thread(target=hammer, name="race-hammer")
    thread.start()
    used = []
    try:
        for i in range(60):
            if i == 30:
                flipped = convert.graphsage_params_to_flax(_ml_model(seed=1))
                mv = reg.create_model_version("ranker", "gnn", "h", flipped, ModelEvaluation(),
                                              metadata={"hidden_dim": 64})
                reg.activate(mv.model_id, mv.version)
                assert server.refresh()
            snap = evaluator.serving_snapshot()
            out = evaluator.schedule_from_packed(buf, *dims, limit=ML_LIMIT, snap=snap)
            assert evaluator.last_used_versions == (snap.params_version, snap.emb_version)
            again = serving._ml_schedule_from_packed(snap.model, snap.host_emb, buf, *dims,
                                                     ML_LIMIT)
            assert torch.equal(out, again)
            used.append(evaluator.last_used_versions)
    finally:
        stop.set()
        thread.join(timeout=30)
        evaluator.close()
    # the deque keeps the last 256 commits: the newest served pairs are in it
    assert used[-1] in set(evaluator.committed_versions)
    assert len(set(used)) > 2 and evaluator.refresh_count > 2
    assert used[-1][0] == server.version


# --------------------------------------------------------------- the trainer


def _rank_trace(hosts=80, records=200, tasks=16):
    from dragonfly2_tpu_torch.records import synth
    from dragonfly2_tpu_torch.records.features import downloads_to_ranking_dataset

    cluster = synth.make_cluster(hosts, seed=11)
    return downloads_to_ranking_dataset(synth.gen_download_records(cluster, records,
                                                                   num_tasks=tasks))


def _step_on(device, trainer_of, idx):
    """One AdamW step of ``trainer_of(device)`` on rows ``idx``: (loss,
    gradients, parameters after the step), on the host."""
    trainer = trainer_of(device)
    loss = trainer.loss(torch.from_numpy(idx).to(device))
    trainer.optimizer.zero_grad()
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()}
    trainer.optimizer.step()
    params = {n: p.detach().float().cpu() for n, p in trainer.model.named_parameters()}
    return loss.item(), grads, params


def _held(got, want, loose=(), rel=5e-2):
    """Each parameter's gradient (or value) within ``rel`` of its largest
    element; ``loose`` ones (true gradient 0) rounding-small against the
    largest of all."""
    largest = max(float(g.abs().max()) for g in want.values())
    for name, w in want.items():
        g = got[name]
        if name in loose:
            assert max(float(g.abs().max()), float(w.abs().max())) <= 1e-2 * largest, name
            continue
        assert float((g - w).abs().max()) <= rel * float(w.abs().max()) + 1e-6, name


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "segment"])
def test_gnn_step_on_the_card_matches_the_cpu(dense):
    """train_gnn's step (bf16 GraphSAGE over the whole graph, the listwise
    loss, AdamW) from the same weights on one batch: the loss within 2e-2,
    each gradient within 5e-2 of its largest element (bf16 rounding at every
    layer, the card's segment sums atomics), the head's output bias (shift-
    invariant, true gradient 0) rounding-small; the AdamW step moves every
    parameter alike (lr 1e-3 a step: within 2e-3 absolute)."""
    _need_card()
    import numpy as np

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.training import data, train

    ds, graph = _rank_trace()
    garrs = data.dense_graph_arrays(graph) if dense else data.graph_arrays(
        graph, pad_edges_to=data.edge_bucket(graph.edge_src.shape[0]))
    rows = train._rank_rows(train._take_rank_batch(ds, np.arange(len(ds.mask))))
    cfg = TrainerConfig(hidden_dim=128)

    def trainer_of(device):
        model = train.build_graphsage(cfg, graph, 0, None, device)
        return train.GNNTrainer(model, rows, garrs, cfg.learning_rate, device)

    idx = np.random.default_rng(0).permutation(len(ds.mask))[:64]
    (cuda_loss, cuda_grads, cuda_params), (cpu_loss, cpu_grads, cpu_params) = (
        _step_on(d, trainer_of, idx) for d in ("cuda", "cpu"))
    assert abs(cuda_loss - cpu_loss) < 2e-2
    _held(cuda_grads, cpu_grads, loose=("head_out.bias",))
    for name, want in cpu_params.items():
        assert float((cuda_params[name] - want).abs().max()) <= 2e-3, name


def test_mlp_step_on_the_card_matches_the_cpu():
    """train_mlp's step (bf16 regressor, weighted MSE, AdamW) from the same
    weights on one batch: the loss within 2e-2 relative, each gradient
    within 5e-2 of its largest element, the step within 2e-3."""
    _need_card()
    import numpy as np

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.records import synth
    from dragonfly2_tpu_torch.records.features import topology_to_pairs
    from dragonfly2_tpu_torch.training import train

    x, y = topology_to_pairs(synth.gen_network_topology_records(synth.make_cluster(80, seed=11),
                                                                300))
    rows = {"x": x, "y": y, "w": np.ones(len(y), np.float32)}
    cfg = TrainerConfig(hidden_dim=128)

    def trainer_of(device):
        model = train.build_regressor(cfg, x.shape[1], 0, None, device)
        return train.MLPTrainer(model, rows, cfg.learning_rate, device)

    idx = np.random.default_rng(0).permutation(len(y))[:256]
    (cuda_loss, cuda_grads, cuda_params), (cpu_loss, cpu_grads, cpu_params) = (
        _step_on(d, trainer_of, idx) for d in ("cuda", "cpu"))
    assert abs(cuda_loss - cpu_loss) <= 2e-2 * abs(cpu_loss)
    _held(cuda_grads, cpu_grads)
    for name, want in cpu_params.items():
        assert float((cuda_params[name] - want).abs().max()) <= 2e-3, name


def test_a_checkpoint_saved_on_the_card_restores_on_the_cpu(tmp_path):
    """train_mlp on the card with a checkpointer; the CPU resumes from it
    (a complete run: zero steps, the card's params bit for bit) and a
    longer CPU run trains on from the card's AdamW state."""
    _need_card()
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.records import synth
    from dragonfly2_tpu_torch.records.features import topology_to_pairs
    from dragonfly2_tpu_torch.training import train
    from dragonfly2_tpu_torch.training.checkpoint import TrainCheckpointer

    x, y = topology_to_pairs(synth.gen_network_topology_records(synth.make_cluster(80, seed=11),
                                                                300))
    ck = TrainCheckpointer(tmp_path / "ck")
    cfg = TrainerConfig(hidden_dim=32, batch_size=64, epochs=2)
    card = train.train_mlp(x, y, cfg, checkpointer=ck, device="cuda")
    assert ck.latest_step() == 1 and card.steps == 2 * 19
    state = ck.restore()
    assert {leaf["exp_avg"].shape for leaf in state["opt_state"].values()}
    cpu = train.train_mlp(x, y, cfg, checkpointer=ck, device="cpu")
    assert cpu.steps == 0
    for layer, leaves in card.params["params"].items():
        for key, value in leaves.items():
            assert (cpu.params["params"][layer][key] == value).all(), (layer, key)
    more = train.train_mlp(x, y, TrainerConfig(hidden_dim=32, batch_size=64, epochs=3),
                           checkpointer=ck, device="cpu")
    assert more.steps == 19 and ck.latest_step() == 2


def test_trainer_service_on_the_card_publishes_three_versions(tmp_path):
    """TrainerService(device="cuda") with the attention family on: three
    active versions from a small trace, each loading against its serving
    module's shapes; the attention training launched the training kernels."""
    _need_card()
    from dragonfly2_tpu_torch.cluster.trainer_service import (
        ATTENTION_MODEL_NAME,
        GNN_MODEL_NAME,
        MLP_MODEL_NAME,
        TrainerService,
    )
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.models import convert
    from dragonfly2_tpu_torch.models.attention import AttentionRanker
    from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
    from dragonfly2_tpu_torch.models.mlp import ProbeRTTRegressor
    from dragonfly2_tpu_torch.records import synth
    from dragonfly2_tpu_torch.records.storage import HostTraceStorage, TraceStorage
    from dragonfly2_tpu_torch.registry import ModelRegistry

    cluster = synth.make_cluster(24, seed=1)
    store = TraceStorage(tmp_path / "traces")
    for rec in synth.gen_download_records(cluster, 120, num_tasks=8):
        store.create_download(rec)
    for rec in synth.gen_network_topology_records(cluster, 60):
        store.create_network_topology(rec)
    store.flush()
    registry = ModelRegistry(tmp_path / "registry")
    svc = TrainerService(HostTraceStorage(tmp_path / "trainer"), registry,
                         TrainerConfig(epochs=2, batch_size=32, hidden_dim=32,
                                       train_attention=True), device="cuda")
    svc.train_mlp_chunk("h1", store.open_download())
    svc.train_gnn_chunk("h1", store.open_network_topology())
    before = flash.DKV_LAUNCHES
    outcome = svc.train_finish("h1")
    assert flash.DKV_LAUNCHES > before
    for name, module in ((GNN_MODEL_NAME, GraphSAGERanker(32)),
                         (ATTENTION_MODEL_NAME, AttentionRanker(32, in_features=26)),
                         (MLP_MODEL_NAME, ProbeRTTRegressor(32))):
        mid = registry.model_id(name, "h1")
        assert registry.active_version(mid).version == 1, name
        registry.load_params(mid, 1, template=convert.params_to_flax(module))
    assert outcome.gnn_result.steps > 0 and outcome.mlp_result.steps > 0
