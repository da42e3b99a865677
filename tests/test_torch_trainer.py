"""The port's GNN and MLP trainers, their flop and roofline cards and the
checkpointer, against the reference package on the same inputs.

The reference's fixtures (tests/test_training.py: ``synth.make_cluster(80,
seed=11)``, 200 downloads over 16 tasks, 300 topology records, hidden 32)
are built by each package; the records pipelines are bit-identical
(tests/test_torch_training.py). The reference's initial weights (flax init
from ``jax.random.key(seed)``) are carried into the port as ``params=``,
since flax's threefry init cannot be redrawn in torch."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dragonfly2_tpu.config.config import TrainerConfig as RefTrainerConfig
from dragonfly2_tpu.models import graphsage as ref_sage
from dragonfly2_tpu.models import mlp as ref_mlp
from dragonfly2_tpu.parallel import mesh as ref_mesh
from dragonfly2_tpu.records import synth as ref_synth
from dragonfly2_tpu.records.features import downloads_to_ranking_dataset as ref_dataset
from dragonfly2_tpu.records.features import topology_to_pairs as ref_pairs
from dragonfly2_tpu.training import checkpoint as ref_checkpoint
from dragonfly2_tpu.training import data as ref_data
from dragonfly2_tpu.training import train as ref_train
from dragonfly2_tpu_torch.config.config import TrainerConfig
from dragonfly2_tpu_torch.models import convert
from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
from dragonfly2_tpu_torch.models.mlp import ProbeRTTRegressor
from dragonfly2_tpu_torch.parallel.mesh import make_mesh
from dragonfly2_tpu_torch.records import synth
from dragonfly2_tpu_torch.records.features import downloads_to_ranking_dataset, topology_to_pairs
from dragonfly2_tpu_torch.training import checkpoint, data, train
from dragonfly2_tpu_torch.training.checkpoint import TrainCheckpointer

HIDDEN = 32
LR, STEPS = 1e-3, 3
# bf16 compute in both: two epochs' losses drift apart by bf16 rounding at
# every layer (the aggregation's and the head's products, the gelus)
LOSS_ATOL = 2e-2
# eval top-1 picks may flip on near-tied bf16 scores
EVAL_ROWS = 2
# the MLP's weighted MSE starts near 10 (log1p(RTT ms) targets of ~3 from
# a fresh init) where bf16 carries 2^-8 of the value, ~0.04
MLP_LOSS_ATOL = 5e-2
# its held-out MSE and MAE after training, of order 1
REGRESSION_ATOL = 2e-2


@pytest.fixture(scope="module")
def rank_data():
    """(port dataset, port graph, reference dataset, reference graph)."""
    ds, graph = downloads_to_ranking_dataset(
        synth.gen_download_records(synth.make_cluster(80, seed=11), 200, num_tasks=16))
    ref_ds, ref_graph = ref_dataset(
        ref_synth.gen_download_records(ref_synth.make_cluster(80, seed=11), 200, num_tasks=16))
    return ds, graph, ref_ds, ref_graph


@pytest.fixture(scope="module")
def mlp_data():
    x, y = topology_to_pairs(synth.gen_network_topology_records(synth.make_cluster(80, seed=11), 300))
    rx, ry = ref_pairs(ref_synth.gen_network_topology_records(ref_synth.make_cluster(80, seed=11),
                                                              300))
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    return x, y


def _gnn_init(ref_ds, ref_graph, seed=0, dense=True, compute_dtype=jnp.bfloat16):
    """The reference train_gnn's initial params (train.py:675-679)."""
    _, train_idx = ref_train._train_eval_split(
        np.random.default_rng(seed).permutation(len(ref_ds.mask)), 0.2)
    sample = ref_train._take_rank_batch(ref_ds, train_idx[:2])
    garrs = (ref_data.dense_graph_arrays(ref_graph) if dense
             else ref_data.graph_arrays(ref_graph))
    model = ref_sage.GraphSAGERanker(hidden_dim=HIDDEN, compute_dtype=compute_dtype)
    params = model.init(jax.random.key(seed), garrs, sample.child_idx, sample.parent_idx,
                        sample.pair_feats)
    return model, jax.device_get(params), garrs


def _mlp_init(x, seed=0, compute_dtype=jnp.bfloat16):
    """The reference train_mlp's initial params (train.py:586-587)."""
    model = ref_mlp.ProbeRTTRegressor(hidden_dim=HIDDEN, compute_dtype=compute_dtype)
    return model, jax.device_get(model.init(jax.random.key(seed), jnp.zeros((1, x.shape[1]))))


def _shapes(tree):
    return jax.tree_util.tree_map(np.shape, jax.device_get(tree))


# ------------------------------------------------------ float32 AdamW steps


def _float32_steps(trainer, ref_loss, ref_params, batches, loose_names=()):
    """STEPS steps of the port's ``trainer`` on the rows at each of
    ``batches`` (index arrays) against jax.value_and_grad of
    ``ref_loss(params, rows)`` and optax.adamw, from the same float32 params.

    Loss and gradients: one float32 function in two implementations (atol
    1e-6, rtol 1e-4). After the steps, a parameter moves by ~lr a step
    whatever its gradient's size, so an element whose gradient is zero up
    to rounding steps with an arbitrary sign in each package:
    ``loose_names`` (shift-invariant under the loss) and any element whose
    gradient fell below 1e-4 of its tensor's largest at some step get atol
    2 * STEPS * LR; every other element atol 1e-5, rtol 1e-4. A gradient of
    exactly 0 (an input column that is 0 in every row of a batch, as most of
    the topology pairs' connection counts are) is no rounding: such an
    element moves by weight decay alone in both packages and is held
    tight."""
    value_and_grad = jax.jit(jax.value_and_grad(ref_loss))
    ref_opt = optax.adamw(LR)
    ref_state = ref_opt.init(ref_params)

    def flat(tree):
        return {k: np.asarray(v) for k, v in convert.params_from_flax(jax.device_get(tree)).items()}

    model = trainer.model
    tiny = {name: np.zeros(p.shape, bool) for name, p in model.named_parameters()}
    for step, idx in enumerate(batches):
        trainer.optimizer.zero_grad()
        loss = trainer.loss(torch.from_numpy(idx))
        loss.backward()
        rows = {key: value[torch.from_numpy(idx)].numpy() for key, value in trainer.rows.items()}
        want_loss, ref_grads = value_and_grad(ref_params, rows)
        np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-6, rtol=1e-4)
        want_grads = flat(ref_grads)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_grads[name], atol=1e-6, rtol=1e-4,
                                       err_msg=f"step {step} {name}")
            magnitude = np.abs(want_grads[name])
            tiny[name] |= (magnitude > 0) & (magnitude < 1e-4 * magnitude.max())
        trainer.optimizer.step()
        updates, ref_state = ref_opt.update(ref_grads, ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
    want_params = flat(ref_params)
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        loose = tiny[name].copy()
        if name in loose_names:
            loose[...] = True
        else:
            assert tiny[name].mean() < 0.5, name  # the size rule stays an exception
        assert (np.abs(got - want_params[name])[loose] <= 2 * STEPS * LR).all(), name
        np.testing.assert_allclose(got[~loose], want_params[name][~loose], atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def _step_batches(n, batch=32):
    return [np.random.default_rng(s).permutation(n)[:batch] for s in range(STEPS)]


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "segment"])
def test_gnn_float32_steps_match_optax_adamw(rank_data, dense):
    """The listwise loss over the whole graph's embedding, recomputed every
    step, on either aggregation path. The score head's output bias shifts a
    row's scores alike, which the listwise loss ignores: its true gradient
    is 0, so it is loose."""
    ds, graph, ref_ds, ref_graph = rank_data
    model, params, garrs = _gnn_init(ref_ds, ref_graph, dense=dense, compute_dtype=jnp.float32)
    rows = train._rank_rows(train._take_rank_batch(ds, np.arange(len(ds.mask))))
    port = GraphSAGERanker(HIDDEN, 2, torch.float32, in_features=graph.node_feats.shape[1])
    port.load_state_dict(convert.graphsage_params_from_flax(params))
    trainer = train.GNNTrainer(port, rows, garrs, LR, "cpu")
    assert ("adj" in trainer.graph) == dense

    def ref_loss(p, b):
        scores = model.apply(p, garrs, b["child_idx"], b["parent_idx"], b["pair_feats"])
        return ref_sage.listwise_rank_loss(scores, b["throughput"], b["mask"])

    _float32_steps(trainer, ref_loss, params, _step_batches(len(ds.mask)), ("head_out.bias",))


def test_mlp_float32_weighted_mse_steps_match_optax_adamw(mlp_data):
    """The reference's weighted MSE (train.py:595-597), with weights of 0,
    fractions and 1 so the weighting counts."""
    x, y = mlp_data
    model, params = _mlp_init(x, compute_dtype=jnp.float32)
    w = np.random.default_rng(2).choice([0.0, 0.25, 1.0], size=len(y)).astype(np.float32)
    port = ProbeRTTRegressor(HIDDEN, compute_dtype=torch.float32, in_features=x.shape[1])
    port.load_state_dict(convert.mlp_params_from_flax(params))
    trainer = train.MLPTrainer(port, {"x": x, "y": y, "w": w}, LR, "cpu")

    def ref_loss(p, b):
        pred = model.apply(p, b["x"])
        return ((pred - b["y"]) ** 2 * b["w"]).sum() / jnp.maximum(b["w"].sum(), 1.0)

    _float32_steps(trainer, ref_loss, params, _step_batches(len(y), 64))


# ------------------------------------------------------------ whole trainers


def _eval_rows(ref_ds, seed=0):
    eval_idx, _ = ref_train._train_eval_split(
        np.random.default_rng(seed).permutation(len(ref_ds.mask)), 0.2)
    return int((ref_ds.mask[eval_idx].sum(-1) >= 2).sum())


def _same_run(got, want, loss_atol=LOSS_ATOL):
    assert got.steps == want.steps == len(got.losses) > 0
    assert got.analytic_flops_per_sample == want.analytic_flops_per_sample
    assert train.flops_basis(got) == ("analytic_matmul_floor", got.analytic_flops_per_sample)
    assert got.samples_per_sec > 0 and got.peak_samples_per_sec > 0
    np.testing.assert_allclose(got.losses, want.losses, atol=loss_atol, rtol=0)
    assert _shapes(got.params) == _shapes(want.params)
    assert set(got.eval_metrics) == set(want.eval_metrics)


GNN_CASES = {
    "dense": {},
    "segment": {"dense_max": 10},  # below the graph's nodes: the segment path
    "dp-mesh": {"mesh": 4},
}


@pytest.mark.parametrize("case", sorted(GNN_CASES))
def test_train_gnn_matches_reference(rank_data, case, monkeypatch):
    """bf16 train_gnn of both packages from the reference's initial params:
    equal steps (the split and the batch order are the reference's), losses
    within LOSS_ATOL, top-1 metrics within EVAL_ROWS flipped picks, equal
    analytic flops (of the aggregation path taken), the flax tree's shapes.
    The dp mesh is 4 CPU devices in both packages (batch 30: padded to 32)."""
    ds, graph, ref_ds, ref_graph = rank_data
    opts = GNN_CASES[case]
    if "dense_max" in opts:
        monkeypatch.setattr(ref_data, "DENSE_ADJ_MAX_NODES", opts["dense_max"])
        monkeypatch.setattr(data, "DENSE_ADJ_MAX_NODES", opts["dense_max"])
    dense = "dense_max" not in opts and "mesh" not in opts
    cfg = dict(hidden_dim=HIDDEN, batch_size=30 if "mesh" in opts else 32, epochs=2)
    ref_mesh_arg = port_mesh = None
    if "mesh" in opts:
        ref_mesh_arg = ref_mesh.make_mesh(opts["mesh"])
        port_mesh = make_mesh(opts["mesh"], devices=["cpu"] * opts["mesh"])
    want = ref_train.train_gnn(ref_ds, ref_graph, RefTrainerConfig(**cfg), mesh=ref_mesh_arg)
    _, init, _ = _gnn_init(ref_ds, ref_graph, dense=dense)
    got = train.train_gnn(ds, graph, TrainerConfig(**cfg), mesh=port_mesh, device="cpu",
                          params=init)
    _same_run(got, want)
    assert got.steps == 2 * -(-160 // cfg["batch_size"])  # 160 training rows, the last batch wrapped
    n_rows = _eval_rows(ref_ds)
    for key in ("precision", "recall", "f1"):
        assert abs(got.eval_metrics[key] - want.eval_metrics[key]) <= EVAL_ROWS / n_rows + 1e-6, key
    assert got.eval_metrics["recall_ceiling"] == pytest.approx(want.eval_metrics["recall_ceiling"])


@pytest.mark.parametrize("mesh", [None, 4], ids=["one-device", "dp-mesh"])
def test_train_mlp_matches_reference(mlp_data, mesh):
    """bf16 train_mlp of both packages from the reference's initial params:
    equal steps, losses within LOSS_ATOL, held-out MSE and MAE within
    REGRESSION_ATOL, equal analytic flops, the flax tree's shapes. The dp
    mesh pads each batch of 60 to 64 by repeating its last row, in both."""
    x, y = mlp_data
    cfg = dict(hidden_dim=HIDDEN, batch_size=64 if mesh is None else 60, epochs=3,
               learning_rate=3e-3)
    ref_m = None if mesh is None else ref_mesh.make_mesh(mesh)
    port_m = None if mesh is None else make_mesh(mesh, devices=["cpu"] * mesh)
    want = ref_train.train_mlp(x, y, RefTrainerConfig(**cfg), mesh=ref_m)
    got = train.train_mlp(x, y, TrainerConfig(**cfg), mesh=port_m, device="cpu",
                          params=_mlp_init(x)[1])
    _same_run(got, want, MLP_LOSS_ATOL)
    assert got.steps == 3 * -(-1200 // cfg["batch_size"])
    for key in ("mse", "mae"):
        assert abs(got.eval_metrics[key] - want.eval_metrics[key]) <= REGRESSION_ATOL, key
    assert got.losses[-1] < got.losses[0]


# ------------------------------------------------------ flop and roofline cards


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "segment"])
def test_analytic_cards_and_roofline_match_reference(dense):
    """The three analytic floors and the GNN's roofline, at the reference's
    platform passed explicitly (its defaults are a TPU's), equal the
    reference's; the port's defaults are the H100's peaks."""
    from dragonfly2_tpu.telemetry import costcard

    shape = dict(n_nodes=10_000, node_feat_dim=12, edge_feat_dim=2, hidden=128, batch=256,
                 parents=20, pair_feat_dim=2, num_layers=2, dense_adj=dense)
    assert (train.analytic_gnn_flops_per_sample(**shape)
            == ref_train.analytic_gnn_flops_per_sample(**shape))
    platform = dict(peak_flops=costcard.PEAK_FLOPS_BF16, hbm_bytes_per_s=costcard.HBM_BYTES_PER_S)
    assert train.gnn_roofline_bound(**shape, **platform) == ref_train.gnn_roofline_bound(**shape)
    h100 = train.gnn_roofline_bound(**shape)
    assert (h100["peak_tflops"], h100["hbm_gbps"]) == (989.0, 3350.0)
    assert h100 == ref_train.gnn_roofline_bound(**shape, peak_flops=989e12, hbm_bytes_per_s=3.35e12)
    for args in ((8, 128, 3), (8, 32, 2), (14, 64, 4)):
        assert (train.analytic_mlp_flops_per_sample(*args)
                == ref_train.analytic_mlp_flops_per_sample(*args))
    assert (train.analytic_attention_flops_per_sample(26, 128, 20, 2)
            == ref_train.analytic_attention_flops_per_sample(26, 128, 20, 2))


# -------------------------------------------------------------- checkpoints


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_leaves(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_checkpoint_roundtrip_and_params_bytes(tmp_path, mlp_data):
    x, y = mlp_data
    res = train.train_mlp(x, y, TrainerConfig(epochs=1, batch_size=64, hidden_dim=16),
                          device="cpu")
    ck = TrainCheckpointer(tmp_path / "ckpt")
    state = {"params": res.params, "step": res.steps, "note": "roundtrip"}
    ck.save(res.steps, state)
    assert ck.latest_step() == res.steps and ck.all_steps() == [res.steps]
    restored = ck.restore(template=state)
    _assert_trees_equal(restored["params"], res.params)
    assert restored["step"] == res.steps and restored["note"] == "roundtrip"
    # a checkpoint's params are the flax msgpack layout, the reference's bytes
    blob = (tmp_path / "ckpt" / str(res.steps) / checkpoint.STATE_FILE).read_bytes()
    from flax import serialization

    assert checkpoint.params_to_bytes(res.params) == serialization.msgpack_serialize(res.params)
    _assert_trees_equal(checkpoint.params_from_bytes(checkpoint.params_to_bytes(res.params)),
                        ref_checkpoint.params_from_bytes(checkpoint.params_to_bytes(res.params)))
    _assert_trees_equal(serialization.msgpack_restore(blob)["params"], res.params)
    with pytest.raises(ValueError, match="template"):
        ck.restore(template={"params": res.params})  # a missing key
    ck.close()


def test_checkpoint_restore_survives_interrupted_save(tmp_path):
    """tests/test_training.py's crash-safety case: a torn newest step (its
    payload gutted) falls back to the previous intact step; asking for the
    torn step explicitly raises; when no step loads, the last error is
    raised, not None."""
    ck = TrainCheckpointer(tmp_path / "ckpt", max_to_keep=5)
    state1 = {"params": {"w": np.arange(8, dtype=np.float32)}, "step": 1}
    state2 = {"params": {"w": np.arange(8, dtype=np.float32) * 2}, "step": 2}
    ck.save(1, state1)
    ck.save(2, state2)
    assert ck.latest_step() == 2
    for path in (tmp_path / "ckpt" / "2").rglob("*"):
        if path.is_file():
            path.write_bytes(b"")  # torn write: zero-length payloads
    restored = ck.restore(template=state1)
    assert restored["step"] == 1
    np.testing.assert_array_equal(restored["params"]["w"], state1["params"]["w"])
    with pytest.raises(ValueError):
        ck.restore(step=2, template=state1)
    (tmp_path / "ckpt" / "1" / checkpoint.STATE_FILE).write_bytes(b"\x81")  # truncated
    with pytest.raises(ValueError):
        ck.restore()
    assert TrainCheckpointer(tmp_path / "empty").restore() is None


def test_checkpoint_keeps_the_newest_and_clears(tmp_path):
    ck = TrainCheckpointer(tmp_path / "ckpt")  # max_to_keep=3, the reference's default
    for step in range(5):
        ck.save(step, {"epoch": step})
    assert ck.all_steps() == [2, 3, 4]
    ck.save(4, {"epoch": 40})  # a step saved again replaces it
    assert ck.restore()["epoch"] == 40 and not list((tmp_path / "ckpt").glob(".*"))
    ck.clear()
    assert not (tmp_path / "ckpt").exists()
    assert TrainCheckpointer(tmp_path / "ckpt").latest_step() is None


@pytest.mark.parametrize("fusion", [1, 2])
def test_train_mlp_resume_matches_reference(tmp_path, mlp_data, fusion):
    """tests/test_training.py:163-190's kill-and-restart resume, in both
    packages from the same init, at epoch_fusion 1 and 2: a run of 1 epoch,
    then a run of 3 that resumes after it and trains 2 more, then a run of 3
    that trains none and returns the checkpoint's params bit for bit. The
    saved steps equal the reference's after each run: a checkpoint a fused
    block, the fusion normalised to a divisor of the epochs LEFT (at fusion
    2 the resumed run is one block and saves step 2 alone). The resumed
    run's losses are the reference's resumed run's within MLP_LOSS_ATOL
    (the minibatch stream restarts: its first epoch draws epoch 0's order)."""
    x, y = mlp_data
    init = _mlp_init(x)[1]
    ck = TrainCheckpointer(tmp_path / "port")
    ref_ck = ref_checkpoint.TrainCheckpointer(tmp_path / "ref")

    def cfg(cls, epochs):
        return cls(epochs=epochs, batch_size=64, hidden_dim=HIDDEN, learning_rate=3e-3,
                   epoch_fusion=fusion)

    runs = []
    for epochs in (1, 3, 3):
        got = train.train_mlp(x, y, cfg(TrainerConfig, epochs), seed=0, checkpointer=ck,
                              device="cpu", params=init)
        want = ref_train.train_mlp(x, y, cfg(RefTrainerConfig, epochs), seed=0,
                                   checkpointer=ref_ck)
        assert ck.all_steps() == ref_ck.all_steps()
        assert got.steps == want.steps
        np.testing.assert_allclose(got.losses, want.losses, atol=MLP_LOSS_ATOL, rtol=0)
        runs.append(got)
    ref_ck.close()
    first, resumed, again = runs
    per_epoch = first.steps
    assert per_epoch == 19 and resumed.steps == 2 * per_epoch and again.steps == 0
    assert ck.all_steps() == ([0, 2] if fusion == 2 else [0, 1, 2])
    _assert_trees_equal(again.params, resumed.params)
    assert again.eval_metrics == resumed.eval_metrics  # the same params, evaluated


@pytest.mark.parametrize("family", ["gnn", "attention"])
def test_rankers_resume_from_a_checkpoint(tmp_path, rank_data, family):
    """train_gnn and train_attention with a checkpointer: 1 epoch, then a
    run of 2 that trains 1 more, then one that trains none and returns the
    checkpoint's params bit for bit. The first run is an uninterrupted
    run's first epoch, bit for bit."""
    ds = rank_data[0]
    fn = {"gnn": lambda **kw: train.train_gnn(ds, rank_data[1], **kw),
          "attention": lambda **kw: train.train_attention(ds, **kw)}[family]

    def run(epochs, checkpointer=None):
        return fn(config=TrainerConfig(epochs=epochs, batch_size=32, hidden_dim=HIDDEN),
                  checkpointer=checkpointer, device="cpu", seed=1)

    ck = TrainCheckpointer(tmp_path / family)
    first = run(1, ck)
    resumed = run(2, ck)
    again = run(2, ck)
    whole = run(2)
    assert first.steps == resumed.steps == 5 and again.steps == 0
    assert ck.all_steps() == [0, 1]
    np.testing.assert_array_equal(first.losses, whole.losses[:5])
    assert np.isfinite(resumed.losses).all()
    _assert_trees_equal(again.params, resumed.params)
