"""The port's sequence-parallel path against the reference on the same numpy
inputs: the flash partials, ring attention (einsum and flash blocks, with
gradients, and the causal zigzag ring), Ulysses, the mesh and its padding
rules, and train_attention on a dp x sp mesh.

The reference runs on tests/conftest.py's 8 virtual CPU devices, its Pallas
partials in interpret mode. The port runs its meshes in one process over
``devices=["cpu"] * n`` (parallel/mesh.py), where ops/flash.py takes each
kernel's plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.config.config import TrainerConfig as RefTrainerConfig
from dragonfly2_tpu.models.attention import AttentionRanker as RefRanker
from dragonfly2_tpu.ops.flash import flash_attention_partials as ref_partials
from dragonfly2_tpu.parallel import mesh as ref_mesh
from dragonfly2_tpu.parallel import ring as ref_ring
from dragonfly2_tpu.parallel import ulysses as ref_ulysses
from dragonfly2_tpu.records import synth as ref_synth
from dragonfly2_tpu.records.features import downloads_to_ranking_dataset as ref_dataset
from dragonfly2_tpu.training import train as ref_train
from dragonfly2_tpu_torch.config.config import TrainerConfig
from dragonfly2_tpu_torch.models.attention import AttentionRanker
from dragonfly2_tpu_torch.models.convert import attention_params_from_flax
from dragonfly2_tpu_torch.ops import flash
from dragonfly2_tpu_torch.parallel import mesh, ring, ulysses
from dragonfly2_tpu_torch.records import synth
from dragonfly2_tpu_torch.records.features import downloads_to_ranking_dataset
from dragonfly2_tpu_torch.training import train

# float32: the same function in two float32 implementations (blockwise
# online softmax against one softmax: summation order only)
F32_TOL = 1e-5
# gradients through the ring's exp/max chain, float32 (the reference's own
# ring-vs-dense gradient tolerance, tests/test_attention.py:66)
GRAD_TOL = 1e-4
# bf16 inputs: the reference kernel folds log2(e)/sqrt(D) into q in float32
# and rounds the scaled q to bf16 (flash.py:262); the port scales the
# float32 scores. Two roundings of q, ~2^-9 relative each, shift the scores
# and through exp2 the row sums and acc (tests/test_attention.py:144-147
# tolerance family)
BF16_TOL = 5e-2
FILLER = -1e30 * np.log(2.0)  # row_max of a row with no valid key


def _qkv(batch=2, heads=4, length=16, dim=16, seed=0, dead_rows=0):
    rng = np.random.default_rng(seed)
    shape = (batch, heads, length, dim)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mask = rng.random((batch, length)) < 0.8
    mask[:, 0] = True
    mask[:dead_rows] = False
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cpu_mesh(n, **axes):
    return mesh.make_mesh(n, devices=["cpu"] * n, **axes)


# --------------------------------------------------------------- partials


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [15, 130])
def test_partials_match_reference(length, dtype):
    q, k, v, mask = _qkv(3, 2, length, 32, seed=length, dead_rows=1)
    before = flash.PARTIAL_LAUNCHES
    got = flash.flash_attention_partials(
        *(t.to(getattr(torch, dtype)) for t in _t(q, k, v)), torch.from_numpy(mask)
    )
    assert flash.PARTIAL_LAUNCHES == before  # a CPU tensor never launches the kernel
    want = ref_partials(*(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)), jnp.asarray(mask))
    acc, row_max, row_sum = (g.numpy() for g in got)
    want_acc, want_max, want_sum = (np.asarray(w) for w in want)
    assert [g.dtype for g in got] == [torch.float32] * 3
    assert acc.shape == q.shape and row_max.shape == row_sum.shape == q.shape[:3]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    live = mask.any(-1)
    np.testing.assert_allclose(row_max[live], want_max[live], atol=tol, rtol=tol)
    np.testing.assert_allclose(row_sum[live], want_sum[live], atol=tol, rtol=tol)
    # acc is a sum of up to L terms of |v| ~ 1 weighted by p <= 1: its
    # error scales with the row sum
    scale = np.maximum(want_sum, 1.0)[..., None]
    np.testing.assert_allclose(acc / scale, want_acc / scale, atol=tol, rtol=tol)
    # a row with no valid key: the finite filler, no -inf or NaN
    for stats in (row_max, want_max):
        np.testing.assert_allclose(stats[~live], FILLER, rtol=1e-6)
    assert (row_sum[~live] == 0).all() and (want_sum[~live] == 0).all()
    assert (acc[~live] == 0).all() and (want_acc[~live] == 0).all()


def test_partials_refuse_autograd():
    q, k, v, mask = _t(*_qkv())
    with pytest.raises(RuntimeError, match="no gradient"):
        flash.flash_attention_partials(q.requires_grad_(), k, v, mask)
    with torch.no_grad():  # no graph recorded: the forward runs
        acc, _, _ = flash.flash_attention_partials(q, k, v, mask)
    assert acc.grad_fn is None


# ------------------------------------------------------------------- ring


RING_LAYOUTS = [  # (dp, sp, fully masked batch rows), tests/test_attention.py:25-52,151-164
    (1, 2, 0), (1, 4, 0), (4, 2, 0), (2, 4, 2),
]


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dp,sp,dead", RING_LAYOUTS)
def test_ring_matches_reference(dp, sp, dead, use_flash):
    q, k, v, mask = _qkv(batch=4, length=32, seed=dp * 10 + sp, dead_rows=dead)
    got = ring.sharded_ring_attention(_cpu_mesh(dp * sp, dp=dp, sp=sp), *_t(q, k, v, mask),
                                      use_flash=use_flash).numpy()
    ref = ref_mesh.make_mesh(dp * sp, dp=dp, sp=sp)
    want = np.asarray(ref_ring.sharded_ring_attention(ref, q, k, v, mask, use_flash=use_flash))
    dense = np.asarray(ref_ring.dense_attention(q, k, v, mask))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got, dense, atol=F32_TOL, rtol=F32_TOL)
    if dead:
        assert (got[:dead] == 0).all()


def test_ring_bf16_flash_blocks_match_reference():
    q, k, v, mask = _qkv(batch=2, heads=2, length=64, seed=5, dead_rows=1)
    got = ring.sharded_ring_attention(
        _cpu_mesh(4, dp=1, sp=4), *(t.to(torch.bfloat16) for t in _t(q, k, v)),
        torch.from_numpy(mask), use_flash=True,
    )
    assert got.dtype == torch.bfloat16
    want = ref_ring.sharded_ring_attention(
        ref_mesh.make_mesh(4, dp=1, sp=4), *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(mask), use_flash=True,
    )
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_ring_gradients_match_reference():
    q, k, v, mask = _qkv(batch=2, length=8, dim=8, seed=1)
    ref = ref_mesh.make_mesh(2, dp=1, sp=2)

    def ref_loss(q, k, v):
        return jnp.sum(ref_ring.sharded_ring_attention(ref, q, k, v, mask) ** 2)

    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(q, k, v)
    want_dense = jax.grad(
        lambda q, k, v: jnp.sum(ref_ring.dense_attention(q, k, v, mask) ** 2), argnums=(0, 1, 2)
    )(q, k, v)
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = ring.sharded_ring_attention(_cpu_mesh(2, dp=1, sp=2), *leaves, torch.from_numpy(mask))
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for name, g, w, wd in zip("qkv", got, want, want_dense):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(wd), atol=GRAD_TOL, err_msg=name)


def test_causal_zigzag_ring_matches_reference():
    b, h, length, d = 2, 2, 64, 16
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(b, h, length, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, length), bool)
    mask[1, -7:] = False  # ragged tail on one sequence
    got = ring.sharded_causal_ring_attention(_cpu_mesh(8, dp=2, sp=4), *_t(q, k, v, mask)).numpy()
    want = np.asarray(ref_ring.sharded_causal_ring_attention(ref_mesh.make_mesh(8, dp=2, sp=4),
                                                             q, k, v, mask))
    dense = np.asarray(ref_ring.dense_attention(q, k, v, mask, causal=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, dense, atol=2e-5, rtol=2e-5)
    for n in (1, 2, 4):
        order, inverse = ring.zigzag_positions(length, n)
        want_order, want_inverse = ref_ring.zigzag_positions(length, n)
        assert order.dtype == inverse.dtype == torch.int64
        np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
        np.testing.assert_array_equal(inverse.numpy(), np.asarray(want_inverse))
    with pytest.raises(ValueError, match="divisible"):
        ring.zigzag_positions(10, 4)


def test_ring_rejections():
    q = torch.zeros(1, 1, 8, 16)
    mask = torch.ones(1, 8, dtype=torch.bool)
    pos = [torch.arange(8)]
    with pytest.raises(ValueError, match="causal"):
        ring.ring_attention([q], [q], [q], [mask], use_flash=True, q_pos=pos)
    with pytest.raises(ValueError, match="k_pos without q_pos"):
        ring.ring_attention([q], [q], [q], [mask], k_pos=pos)
    with pytest.raises(ValueError, match="not divisible by sp"):
        ring.sharded_ring_attention(_cpu_mesh(3, dp=1, sp=3), q, q, q, mask)
    with pytest.raises(ValueError, match="not divisible by dp"):
        ring.sharded_ring_attention(_cpu_mesh(2, dp=2, sp=1), q, q, q, mask)


# ---------------------------------------------------------------- ulysses


@pytest.mark.parametrize("dp,sp,causal", [(1, 2, False), (1, 4, False), (4, 2, False),
                                          (1, 2, True)])
def test_ulysses_matches_reference(dp, sp, causal):
    """tests/test_ulysses.py's cases; the port's inner is flash_attention
    (its plain version here), the reference's dense_attention."""
    q, k, v, mask = _qkv(batch=4, length=16, seed=sp + causal)
    got = ulysses.sharded_ulysses_attention(_cpu_mesh(dp * sp, dp=dp, sp=sp), *_t(q, k, v, mask),
                                            causal=causal).numpy()
    want = np.asarray(ref_ulysses.sharded_ulysses_attention(
        ref_mesh.make_mesh(dp * sp, dp=dp, sp=sp), q, k, v, mask, causal=causal))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got, np.asarray(ref_ring.dense_attention(q, k, v, mask, causal=causal)),
                               atol=F32_TOL, rtol=F32_TOL)


def test_ulysses_rejects_indivisible_heads():
    q, k, v, mask = _t(*_qkv(heads=3))
    with pytest.raises(ValueError, match="divisible"):
        ulysses.sharded_ulysses_attention(_cpu_mesh(2, dp=1, sp=2), q, k, v, mask)


def test_ulysses_gradients_match_reference():
    """Through FlashAttention on each head group (the training kernels'
    plain versions here) against jax.grad of the reference's Ulysses."""
    q, k, v, mask = _qkv(batch=2, length=8, seed=2)
    ref = ref_mesh.make_mesh(2, dp=1, sp=2)
    want = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(ref_ulysses.sharded_ulysses_attention(ref, q, k, v, mask) ** 2),
        argnums=(0, 1, 2),
    ))(q, k, v)
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = ulysses.sharded_ulysses_attention(_cpu_mesh(2, dp=1, sp=2), *leaves,
                                            torch.from_numpy(mask))
    names, stack, seen = set(), [out.grad_fn], set()
    while stack:  # the autograd graph's node types
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(child for child, _ in node.next_functions)
    assert "FlashAttentionBackward" in names
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, err_msg=name)


# ------------------------------------------------------------------- mesh


def test_make_mesh_layout_and_errors():
    m = _cpu_mesh(8, dp=2, sp=4)
    assert m.shape == {"dp": 2, "graph": 1, "sp": 4, "tp": 1, "pp": 1, "ep": 1}
    assert m.shape == dict(ref_mesh.make_mesh(8, dp=2, sp=4).shape)
    assert m.devices.shape == (2, 1, 4, 1, 1, 1) and m.first_device == torch.device("cpu")
    assert mesh.make_mesh(devices=["cpu"] * 6, sp=3).shape["dp"] == 2  # dp from the rest
    for kwargs, message in (({"sp": 3}, "not divisible by model axes=3"),
                            ({"dp": 3, "sp": 2}, "mesh 3x1x2x1x1x1 != 8 devices")):
        with pytest.raises(ValueError, match=message):
            mesh.make_mesh(devices=["cpu"] * 8, **kwargs)
        with pytest.raises(ValueError, match=message):
            ref_mesh.make_mesh(8, **kwargs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh(1)


def test_shard_rows_round_trip():
    m = _cpu_mesh(8, dp=2, sp=4)
    x = torch.arange(4 * 3 * 8 * 2).reshape(4, 3, 8, 2)
    blocks = mesh.shard_rows(m, x, 2)
    assert len(blocks) == 2 and all(len(row) == 4 for row in blocks)
    assert blocks[1][2].shape == (2, 3, 2, 2) and blocks[1][2].is_contiguous()
    torch.testing.assert_close(blocks[1][2], x[2:, :, 4:6])
    torch.testing.assert_close(mesh.unshard_rows(blocks, 2, "cpu"), x)


@pytest.mark.parametrize("batch", [5, 8])
def test_padding_rules_match_reference(batch):
    """Masks pad with False, other leaves repeat their last row
    (mesh.py:121-166), for shard_batch and shard_stacked_batches."""
    rng = np.random.default_rng(batch)
    tree = {"mask": rng.random((batch, 3)) < 0.5,
            "x": rng.standard_normal((batch, 3)).astype(np.float32),
            "idx": np.arange(batch, dtype=np.int32)}
    stacked = {key: np.stack([value, value[::-1]]) for key, value in tree.items()}
    m, ref = _cpu_mesh(4, dp=4), ref_mesh.make_mesh(4, dp=4)
    for got, want in ((mesh.shard_batch(m, tree), ref_mesh.shard_batch(ref, tree)),
                      (mesh.shard_stacked_batches(m, stacked),
                       ref_mesh.shard_stacked_batches(ref, stacked))):
        for key in tree:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    placed = mesh.shard_batch(m, tree)["x"]
    tree["x"][0] = 99.0  # a private copy, not a view of the caller's array
    assert placed[0, 0] != 99.0


# ------------------------------------------------------- the slice as a whole


@pytest.fixture(scope="module")
def rank_data():
    """tests/test_training.py:26-40's trace, built by each package: 200
    rows of P = 20 candidates (10 a shard at sp = 2)."""
    port = downloads_to_ranking_dataset(
        synth.gen_download_records(synth.make_cluster(80, seed=11), 200, num_tasks=16))[0]
    ref = ref_dataset(
        ref_synth.gen_download_records(ref_synth.make_cluster(80, seed=11), 200, num_tasks=16))[0]
    return port, ref


# hidden 64 and 4 heads: head dim 16, which the port's kernels take. Batch
# 30 pads to 32 on dp 4, and eval_fraction 0.23 holds out 46 rows, padded
# to 48: both padding rules run.
SLICE_CFG = dict(hidden_dim=64, batch_size=30, epochs=2)
SLICE_EVAL_FRACTION = 0.23
# bf16 compute in both; 10 steps of losses drift apart by bf16 rounding at
# every layer (the same bound as test_torch_training.py's single-device
# comparison)
LOSS_ATOL = 2e-3
# AdamW moves an element by at most ~lr a step whatever its gradient, so an
# element whose bf16 gradient sits near zero may step either way in each
# package: the trained params agree within 2 * steps * lr everywhere. On
# the bulk, the median difference stays under a fifth of the median
# distance the reference moved the tensor from its init (a tenth or less
# when this was written), except where the true gradient is 0 and the
# steps follow rounding noise alone: the two biases that shift a row's
# scores alike (the listwise loss ignores that) and the key third of each
# qkv bias (a constant added to every key shifts a row's attention scores
# alike; test_torch_training.py's single-device comparison exempts the same)
PARAM_MEDIAN_SHARE = 0.2
SHIFT_INVARIANT = ("score.bias", "LayerNorm_0.bias")
# eval top-1 picks may flip on near-tied bf16 scores
EVAL_ROWS = 2


@pytest.fixture(scope="module")
def ref_mesh_runs(rank_data):
    _, ref_ds = rank_data
    ref = ref_mesh.make_mesh(8, dp=4, sp=2)
    runs = {
        strategy: ref_train.train_attention(
            ref_ds, RefTrainerConfig(**SLICE_CFG), mesh=ref, seed=0,
            eval_fraction=SLICE_EVAL_FRACTION, sp_strategy=strategy)
        for strategy in ("ring", "ulysses")
    }
    init = RefRanker(hidden_dim=SLICE_CFG["hidden_dim"], num_layers=2).init(
        jax.random.key(0), ref_ds.child[:2], ref_ds.parents[:2],
        ref_train._pair_feats(ref_ds, np.arange(2)), ref_ds.mask[:2],
    )
    return runs, jax.device_get(init)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_train_attention_on_dp_sp_mesh_matches_reference(rank_data, ref_mesh_runs, strategy):
    port_ds, ref_ds = rank_data
    runs, init = ref_mesh_runs
    want = runs[strategy]
    before = flash.PARTIAL_LAUNCHES
    got = train.train_attention(
        port_ds, TrainerConfig(**SLICE_CFG), mesh=_cpu_mesh(8, dp=4, sp=2), seed=0,
        eval_fraction=SLICE_EVAL_FRACTION, sp_strategy=strategy, device="cpu", params=init,
    )
    assert flash.PARTIAL_LAUNCHES == before
    # 154 training rows: 5 full batches of 30 an epoch, twice
    assert got.steps == want.steps == len(got.losses) == 10
    np.testing.assert_allclose(got.losses, want.losses, atol=LOSS_ATOL, rtol=0)
    lr, steps = RefTrainerConfig().learning_rate, got.steps
    got_p = attention_params_from_flax(got.params)
    want_p = attention_params_from_flax(jax.device_get(want.params))
    init_p = attention_params_from_flax(init)
    assert set(got_p) == set(want_p)
    for name, want_v in want_p.items():
        err = np.abs(got_p[name].numpy() - want_v.numpy())
        assert err.max() <= 2 * steps * lr, name
        if name in SHIFT_INVARIANT:
            continue
        moved = np.abs(want_v.numpy() - init_p[name].numpy())
        if name.endswith("qkv.bias"):
            hidden = SLICE_CFG["hidden_dim"]
            keep = np.r_[0:hidden, 2 * hidden:3 * hidden]
            err, moved = err[keep], moved[keep]
        assert np.median(err) <= PARAM_MEDIAN_SHARE * np.median(moved), name
    eval_idx, _ = ref_train._train_eval_split(
        np.random.default_rng(0).permutation(len(ref_ds.mask)), SLICE_EVAL_FRACTION)
    n_rows = int((ref_ds.mask[eval_idx].sum(-1) >= 2).sum())
    assert set(got.eval_metrics) == set(want.eval_metrics)
    for key in ("precision", "recall", "regret"):
        assert abs(got.eval_metrics[key] - want.eval_metrics[key]) <= EVAL_ROWS / n_rows + 1e-6, key
    assert got.eval_metrics["recall_ceiling"] == pytest.approx(want.eval_metrics["recall_ceiling"])


def test_mesh_eval_scores_match_one_device(rank_data):
    """The eval forward on the mesh (the ring's flash blocks, padded to dp)
    gives the single-device scores, float32."""
    port_ds, _ = rank_data
    model = AttentionRanker(64, 4, 2, torch.float32, in_features=26)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rows = train.take(port_ds, np.arange(46))
    m = _cpu_mesh(8, dp=4, sp=2)
    _, eval_fn = train.attention_fns(m, "ring")
    got = train.eval_scores(model, rows, eval_fn, m)
    want = train.eval_scores(model, rows)
    assert got.shape == (46, 20)
    valid = torch.from_numpy(rows["mask"])
    torch.testing.assert_close(got[valid], want[valid], atol=F32_TOL, rtol=F32_TOL)
    assert (got[~valid] == -1e30).all()


def test_mesh_paths_not_ported_raise(rank_data):
    """The tp, pp and ep paths, which raised before the port had them, now
    train from the config and the mesh alone: a finite, falling loss on a
    tiny mesh of each (tests/test_torch_parallel*.py hold them to the
    reference). A mesh and a device that disagree still raise."""
    port_ds, _ = rank_data
    cfg = TrainerConfig(hidden_dim=32, batch_size=32, epochs=3, attention_num_layers=1,
                        learning_rate=3e-3)
    for flags, axes in (({"attention_tp": True}, {"tp": 2}),
                        ({"attention_pp": True, "attention_pp_microbatches": 2}, {"pp": 2}),
                        ({"attention_moe_experts": 2}, {"ep": 2}),
                        ({"attention_moe_experts": 2}, {"sp": 2})):
        got = train.train_attention(port_ds, dataclasses.replace(cfg, **flags),
                                    mesh=_cpu_mesh(4, dp=2, **axes), device="cpu")
        assert got.steps == 15 and np.isfinite(got.losses).all(), axes
        assert np.mean(got.losses[-5:]) < np.mean(got.losses[:5]), (axes, got.losses)
    with pytest.raises(ValueError, match="disagrees"):
        train.train_attention(port_ds, cfg, mesh=_cpu_mesh(2, dp=1, sp=2), device="cuda")
