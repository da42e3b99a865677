"""The port's training path (records, loss, metrics, the ranker's steps and
train_attention) against the reference package on the same inputs.

The port trains through ops/flash.py's FlashAttention (on CPU tensors: the
forward-with-lse and backward plain versions); the reference's
train_attention applies dense_attention. Both compute the same function
under the same masking contract."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dragonfly2_tpu.config.config import TrainerConfig as RefTrainerConfig
from dragonfly2_tpu.models import metrics as ref_metrics
from dragonfly2_tpu.models.attention import AttentionRanker as RefRanker
from dragonfly2_tpu.models.graphsage import listwise_rank_loss as ref_loss
from dragonfly2_tpu.records import synth as ref_synth
from dragonfly2_tpu.records.features import downloads_to_ranking_dataset as ref_dataset
from dragonfly2_tpu.training import data as ref_data
from dragonfly2_tpu.training import train as ref_train
from dragonfly2_tpu_torch.config.config import TrainerConfig
from dragonfly2_tpu_torch.models import metrics
from dragonfly2_tpu_torch.models.attention import AttentionRanker
from dragonfly2_tpu_torch.models.convert import attention_params_from_flax
from dragonfly2_tpu_torch.models.graphsage import listwise_rank_loss
from dragonfly2_tpu_torch.parallel.mesh import make_mesh
from dragonfly2_tpu_torch.records import synth
from dragonfly2_tpu_torch.records.features import downloads_to_ranking_dataset
from dragonfly2_tpu_torch.training import data, train
from dragonfly2_tpu_torch.training.checkpoint import TrainCheckpointer


def _port_dataset(seed, hosts, records, tasks):
    cluster = synth.make_cluster(hosts, seed=seed)
    return downloads_to_ranking_dataset(synth.gen_download_records(cluster, records, num_tasks=tasks))


def _ref_dataset(seed, hosts, records, tasks):
    cluster = ref_synth.make_cluster(hosts, seed=seed)
    return ref_dataset(ref_synth.gen_download_records(cluster, records, num_tasks=tasks))


# ---------------------------------------------------------------- records


@pytest.mark.parametrize("seed", [0, 11])
def test_records_pipeline_is_bit_identical(seed):
    got_ds, got_graph = _port_dataset(seed, 60, 120, 8)
    want_ds, want_graph = _ref_dataset(seed, 60, 120, 8)
    for field in dataclasses.fields(want_ds):
        got, want = getattr(got_ds, field.name), getattr(want_ds, field.name)
        assert got.dtype == want.dtype and got.shape == want.shape, field.name
        np.testing.assert_array_equal(got, want, err_msg=field.name)
    assert got_graph.host_ids == want_graph.host_ids
    for name in ("node_feats", "edge_src", "edge_dst", "edge_feats"):
        np.testing.assert_array_equal(getattr(got_graph, name), getattr(want_graph, name), err_msg=name)


def test_split_and_minibatch_order_match_reference():
    for n, batch in ((1, 4), (2, 4), (200, 32), (163, 32)):
        got_rng, want_rng = np.random.default_rng(5), np.random.default_rng(5)
        got = train._train_eval_split(got_rng.permutation(n), 0.2)
        want = ref_train._train_eval_split(want_rng.permutation(n), 0.2)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for _ in range(2):  # two epochs from the same stream
            got_batches = list(data.minibatches(len(got[1]), min(batch, len(got[1])), got_rng))
            want_batches = list(ref_data.minibatches(len(want[1]), min(batch, len(want[1])), want_rng))
            assert len(got_batches) == len(want_batches)
            for a, b in zip(got_batches, want_batches):
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- loss


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    n, p = 6, 9
    scores = rng.standard_normal((n, p)).astype(np.float32)
    tput = (rng.random((n, p)) * 12).astype(np.float32)
    counts = np.array([0, 1, 2, 5, 9, 3])  # rows with 0, 1 and >= 2 valid candidates
    mask = np.arange(p)[None, :] < counts[:, None]
    return scores, tput, mask


def test_listwise_rank_loss_value_and_gradient_match_reference():
    scores, tput, mask = _loss_inputs()
    t_scores = torch.from_numpy(scores).requires_grad_()
    loss = listwise_rank_loss(t_scores, torch.from_numpy(tput), torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(loss, t_scores)
    want, want_grad = jax.value_and_grad(ref_loss)(jnp.asarray(scores), jnp.asarray(tput), jnp.asarray(mask))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)
    assert (grad.numpy()[:2] == 0).all()  # rows with fewer than 2 valid candidates
    # no row with >= 2 valid candidates: 0, not a division by zero
    empty = listwise_rank_loss(t_scores[:2], torch.from_numpy(tput[:2]), torch.from_numpy(mask[:2]))
    assert empty.item() == 0.0 == float(ref_loss(*(jnp.asarray(x[:2]) for x in (scores, tput, mask))))


# ---------------------------------------------------------------- metrics


def test_top1_selection_stats_match_reference():
    rng = np.random.default_rng(3)
    n, p = 64, 12
    counts = np.array([0, 1, 2, 3, 7, 11, 12] * 9 + [3])[:n]
    mask = np.arange(p)[None, :] < counts[:, None]
    # a coarse grid gives ties in both scores and throughputs
    scores = np.round(rng.standard_normal((n, p)) * 2).astype(np.float32)
    tput = np.round(rng.random((n, p)) * 6).astype(np.float32)
    tput[5, 2] = np.nan  # a NaN throughput at a valid slot
    tput[9, :] = np.nan  # a row whose throughputs are all NaN
    got = metrics.top1_selection_stats(scores, tput, mask)
    want = ref_metrics.top1_selection_stats(jnp.asarray(scores), jnp.asarray(tput), jnp.asarray(mask))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, atol=0, err_msg=key)


@pytest.mark.parametrize("valid", [3, 7, 11, 1, 2, 20])
def test_nearest_quantile_takes_the_reference_order_statistic(valid):
    """0.75 * (n - 1) lands on a .5 position at n = 3, 7, 11; jnp takes the
    lower order statistic there, torch.nanquantile would round to even."""
    rng = np.random.default_rng(valid)
    x = np.full((4, 20), np.nan, np.float32)
    x[:, :valid] = rng.permutation(np.arange(4 * valid, dtype=np.float32)).reshape(4, valid)
    got = metrics._nanquantile_nearest(torch.from_numpy(x), 0.75)
    want = jnp.nanquantile(jnp.asarray(x), 0.75, axis=-1, method="nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_regression_report_matches_reference():
    rng = np.random.default_rng(4)
    pred, target = rng.standard_normal((2, 50)).astype(np.float32)
    mask = (rng.random(50) < 0.6).astype(np.float32)
    for m in (None, mask):
        got = metrics.regression_report(pred, target, m)
        want = ref_metrics.regression_report(
            jnp.asarray(pred), jnp.asarray(target), None if m is None else jnp.asarray(m)
        )
        for key in ("mse", "mae"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


# ------------------------------------------------------ float32 AdamW steps

HIDDEN, HEADS, LAYERS = 32, 2, 2  # head dim 16
LR, STEPS = 1e-3, 3


def _batch(n=12, p=10, seed=7):
    rng = np.random.default_rng(seed)
    child = rng.standard_normal((n, 12)).astype(np.float32)
    parents = rng.standard_normal((n, p, 12)).astype(np.float32)
    pair = (rng.random((n, p, 2)) < 0.5).astype(np.float32)
    counts = rng.integers(0, p + 1, n)
    counts[:3] = (0, 1, p)
    mask = np.arange(p)[None, :] < counts[:, None]
    tput = (rng.random((n, p)) * 10).astype(np.float32)
    return child, parents, pair, mask, tput


def test_float32_steps_match_optax_adamw():
    """Loss, every parameter gradient, and the parameters after 3 AdamW
    steps, float32 compute (hidden 32, 2 heads: head dim 16), the port
    (flash_attention through FlashAttention) against the reference (dense
    attention, optax.adamw).

    Tolerances: loss and gradients are one float32 function in two
    implementations (atol 1e-6, rtol 1e-4). After the steps, a parameter
    moves by ~lr per step whatever its gradient's size, so a gradient that
    is zero up to rounding takes a step of arbitrary sign in each package:
    the score head's bias, the last LayerNorm's bias (a row-constant shift
    of the scores leaves the listwise loss unchanged), the key third of each
    qkv bias (a constant added to every key shifts a row's attention scores
    alike), and any element whose gradient fell below 1e-4 of its tensor's
    largest at some step. Those get atol 2 * steps * lr; every other element
    atol 1e-5, rtol 1e-4."""
    child, parents, pair, mask, tput = _batch()
    ref_model = RefRanker(hidden_dim=HIDDEN, num_heads=HEADS, num_layers=LAYERS,
                          compute_dtype=jnp.float32)
    ref_params = ref_model.init(jax.random.key(0), child, parents, pair, mask)

    @jax.jit
    @jax.value_and_grad
    def ref_loss_and_grads(params):
        return ref_loss(ref_model.apply(params, child, parents, pair, mask), tput, mask)

    model = AttentionRanker(HIDDEN, HEADS, LAYERS, torch.float32)
    model.load_state_dict(attention_params_from_flax(jax.device_get(ref_params)))
    inputs = [torch.from_numpy(x) for x in (child, parents, pair, mask)]
    optimizer = train.adamw(model.parameters(), LR)
    ref_opt = optax.adamw(LR)
    ref_state = ref_opt.init(ref_params)

    def flat(tree):
        return {k: np.asarray(v) for k, v in attention_params_from_flax(jax.device_get(tree)).items()}

    tiny = {name: np.zeros(param.shape, bool) for name, param in model.named_parameters()}
    for step in range(STEPS):
        loss = listwise_rank_loss(model(*inputs), torch.from_numpy(tput), inputs[3])
        optimizer.zero_grad()
        loss.backward()
        want_loss, ref_grads = ref_loss_and_grads(ref_params)
        np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-6, rtol=1e-4)
        want_grads = flat(ref_grads)
        for name, param in model.named_parameters():
            np.testing.assert_allclose(
                param.grad.numpy(), want_grads[name], atol=1e-6, rtol=1e-4, err_msg=f"step {step} {name}"
            )
            magnitude = np.abs(want_grads[name])
            tiny[name] |= magnitude < 1e-4 * magnitude.max()
        optimizer.step()
        updates, ref_state = ref_opt.update(ref_grads, ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)

    want_params = flat(ref_params)
    for name, param in model.named_parameters():
        got = param.detach().numpy()
        loose = tiny[name].copy()
        if name in ("score.bias", "LayerNorm_0.bias"):
            loose[...] = True
        else:
            assert tiny[name].mean() < 0.5, name  # the size rule stays an exception
        if name.endswith("qkv.bias"):
            loose[HIDDEN:2 * HIDDEN] = True
        err = np.abs(got - want_params[name])
        assert (err[loose] <= 2 * STEPS * LR).all(), name
        np.testing.assert_allclose(got[~loose], want_params[name][~loose], atol=1e-5, rtol=1e-4,
                                   err_msg=name)


# ---------------------------------------------------------- whole trainer


@pytest.fixture(scope="module")
def rank_data():
    """tests/test_training.py:26-40's fixture, built by each package."""
    return _port_dataset(11, 80, 200, 16)[0], _ref_dataset(11, 80, 200, 16)[0]


# bf16 compute in both; the losses of 10 steps drift apart by bf16
# rounding at every layer (attention through FlashAttention in the port,
# dense_attention in the reference): 1.7e-4 at most when this was written
LOSS_ATOL = 2e-3
# eval top-1 picks may flip on near-tied bf16 scores
EVAL_ROWS = 2


def test_train_attention_matches_reference(rank_data):
    _train_attention_matches(rank_data, hidden_dim=64)  # 4 heads: head dim 16


def test_train_attention_at_head_dim_24_matches_reference(rank_data):
    """A width whose head dim no kernel instance has (hidden 96, 4 heads:
    D = 24), which the reference trains: the port trains it too (on the
    CPU through the plain versions; on CUDA flash_attention pads it)."""
    _train_attention_matches(rank_data, hidden_dim=96)


def _train_attention_matches(rank_data, hidden_dim):
    port_ds, ref_ds = rank_data
    cfg = dict(hidden_dim=hidden_dim, batch_size=32, epochs=2)
    want = ref_train.train_attention(ref_ds, RefTrainerConfig(**cfg), seed=0)
    # the reference's initial weights, carried across: flax's threefry init
    # cannot be redrawn in torch
    init = RefRanker(hidden_dim=hidden_dim, num_layers=2).init(
        jax.random.key(0), ref_ds.child[:2], ref_ds.parents[:2],
        ref_train._pair_feats(ref_ds, np.arange(2)), ref_ds.mask[:2],
    )
    got = train.train_attention(port_ds, TrainerConfig(**cfg), seed=0, device="cpu",
                                params=jax.device_get(init))
    assert got.steps == want.steps == len(got.losses) == 10  # 160 training rows / 32, twice
    assert got.analytic_flops_per_sample == want.analytic_flops_per_sample
    assert train.flops_basis(got) == ("analytic_matmul_floor", got.analytic_flops_per_sample)
    assert got.flops_per_sample == 0.0 and got.samples_per_sec > 0 and got.peak_samples_per_sec > 0
    np.testing.assert_allclose(got.losses, want.losses, atol=LOSS_ATOL, rtol=0)
    # precision is picks that hit / rows that count, recall hits / relevant
    # candidates (at least one per such row), regret a mean over those rows:
    # EVAL_ROWS flipped picks move each by at most EVAL_ROWS / rows
    eval_idx, _ = ref_train._train_eval_split(np.random.default_rng(0).permutation(len(ref_ds.mask)), 0.2)
    n_rows = int((ref_ds.mask[eval_idx].sum(-1) >= 2).sum())
    assert set(got.eval_metrics) == set(want.eval_metrics)
    for key in ("precision", "recall", "regret"):
        assert abs(got.eval_metrics[key] - want.eval_metrics[key]) <= EVAL_ROWS / n_rows + 1e-6, key
    assert got.eval_metrics["recall_ceiling"] == pytest.approx(want.eval_metrics["recall_ceiling"])
    # the published tree is the flax layout, the same shapes as the reference's
    want_shapes = jax.tree_util.tree_map(np.shape, jax.device_get(want.params))
    assert jax.tree_util.tree_map(np.shape, got.params) == want_shapes


def test_train_attention_draws_its_own_init_from_the_seed(rank_data):
    port_ds, _ = rank_data
    cfg = TrainerConfig(hidden_dim=64, batch_size=64, epochs=1, attention_num_layers=1)
    a = train.train_attention(port_ds, cfg, seed=3, device="cpu")
    b = train.train_attention(port_ds, cfg, seed=3, device="cpu")
    assert a.losses == b.losses and np.isfinite(a.losses).all()
    assert a.steps == 3  # 160 training rows in batches of 64, the last wrapped


def test_not_yet_ported_paths_raise(rank_data, tmp_path):
    port_ds, _ = rank_data
    cfg = TrainerConfig(hidden_dim=32, batch_size=32, epochs=1)
    # the dp/sp mesh path is ported (tests/test_torch_sp.py); tp/pp/ep are not
    tp_mesh = make_mesh(2, dp=1, tp=2, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="mesh"):
        train.train_attention(port_ds, cfg, mesh=tp_mesh, device="cpu")
    # checkpoint resume is ported: one epoch, then a run of two resumes
    # after it and trains one more (tests/test_torch_trainer.py holds it
    # to the reference's resumed run)
    ck = TrainCheckpointer(tmp_path / "ck")
    first = train.train_attention(port_ds, cfg, checkpointer=ck, device="cpu")
    assert ck.latest_step() == 0 and first.steps == 5  # 160 training rows / 32
    resumed = train.train_attention(port_ds, dataclasses.replace(cfg, epochs=2),
                                    checkpointer=ck, device="cpu")
    assert resumed.steps == first.steps and ck.all_steps() == [0, 1]
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        train.train_attention(port_ds, dataclasses.replace(cfg, attention_moe_experts=4), device="cpu")
    with pytest.raises(NotImplementedError, match="parallelism"):
        train.train_attention(port_ds, dataclasses.replace(cfg, attention_tp=True), device="cpu")
    with pytest.raises(ValueError, match="sp_strategy"):
        train.train_attention(port_ds, cfg, sp_strategy="rnig", device="cpu")
