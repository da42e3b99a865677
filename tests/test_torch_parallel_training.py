"""train_attention's tensor- and pipeline-parallel paths against the
reference's runs from the same initial params, the pipeline tree's round
trip, the edge-sharded graph embed, and the mesh across two processes
(gloo, on the CPU) against one process at dp doubled, for train_attention
and train_gnn. The MoE trainings are in tests/test_torch_parallel.py, so
that the two files' reference runs land on different workers.

The reference runs on tests/conftest.py's 8 virtual CPU devices; the port
runs its meshes in one process over ``devices=["cpu"] * n``
(parallel/mesh.py)."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.config.config import TrainerConfig as RefTrainerConfig
from dragonfly2_tpu.models.graphsage import GraphSAGERanker as RefGraphSAGE
from dragonfly2_tpu.models.attention import AttentionRanker as RefRanker
from dragonfly2_tpu.parallel import mesh as ref_mesh
from dragonfly2_tpu.records.features import RankingDataset as RefRankingDataset
from dragonfly2_tpu.training import data as ref_data
from dragonfly2_tpu.training import train as ref_train
from dragonfly2_tpu_torch.config.config import TrainerConfig
from dragonfly2_tpu_torch.models.attention import PipelineRanker
from dragonfly2_tpu_torch.models.convert import params_from_flax, params_to_flax
from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
from dragonfly2_tpu_torch.parallel import mesh
from dragonfly2_tpu_torch.records import synth
from dragonfly2_tpu_torch.records.features import RankingDataset, downloads_to_ranking_dataset
from dragonfly2_tpu_torch.training import train
from dragonfly2_tpu_torch.training import embed_graph_sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_parallel_strategies.py's trainings, cut to one block: hidden
# 32, 4 heads (head dim 8), batch 16, 2 epochs of 3 steps over 51 rows
PAR_CFG = dict(hidden_dim=32, batch_size=16, epochs=2, attention_num_layers=1)
# bf16 compute in both; the losses drift apart by bf16 rounding at every
# layer, and on the tp path the row-parallel products sum bf16 partials in
# each package's own order (tests/test_torch_sp.py's bound)
LOSS_ATOL = 2e-3
# tests/test_torch_sp.py's rule for the trained params: within 2 * steps *
# lr everywhere (AdamW moves an element by at most ~lr a step), and on the
# bulk the median difference under a fifth of the median distance the
# reference moved the tensor, except where the true gradient is 0: the
# biases that shift a row's scores alike and the key third of qkv's bias
PARAM_MEDIAN_SHARE = 0.2
# eval top-1 picks may flip on near-tied bf16 scores
EVAL_ROWS = 2
# the two-process leg: each process, and the test waiting on it, gives up
# after this many seconds
DCN_TIMEOUT_S = 120


def tiny_rank_data(n=64, p=8, f=12, seed=0):
    """tests/test_parallel_strategies.py's dataset, built for each package."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, p)) < 0.9
    fields = dict(
        child=rng.standard_normal((n, f)).astype(np.float32),
        parents=rng.standard_normal((n, p, f)).astype(np.float32),
        same_idc=(rng.random((n, p)) < 0.5).astype(np.float32),
        loc_match=rng.random((n, p)).astype(np.float32),
        mask=mask,
        throughput=(rng.standard_normal((n, p)) * mask).astype(np.float32),
        child_host_idx=rng.integers(0, 16, n).astype(np.int32),
        parent_host_idx=rng.integers(0, 16, (n, p)).astype(np.int32),
    )
    return RankingDataset(**fields), RefRankingDataset(**fields)


def cpu_mesh(n, **axes):
    return mesh.make_mesh(n, devices=["cpu"] * n, **axes)


def reference_run(ref_ds, cfg: dict, ref_m, apply_init=None):
    """The reference's train_attention and its initial params, as numpy."""
    result = ref_train.train_attention(ref_ds, RefTrainerConfig(**cfg), mesh=ref_m, seed=0)
    if apply_init is None:
        init = RefRanker(hidden_dim=cfg["hidden_dim"], num_layers=cfg["attention_num_layers"],
                         moe_experts=cfg.get("attention_moe_experts", 0)).init(
            jax.random.key(0), ref_ds.child[:2], ref_ds.parents[:2],
            ref_train._pair_feats(ref_ds, np.arange(2)), ref_ds.mask[:2], mesh=ref_m)
    else:
        init = apply_init
    return jax.device_get(result), jax.device_get(init)


def hold_to_reference(got, want, init, cfg: dict, ref_ds, shift_invariant=("score.bias",
                                                                           "LayerNorm_0.bias")):
    """tests/test_torch_sp.py's comparison: losses, the trained params and
    the eval metrics."""
    assert got.steps == want.steps == len(got.losses)
    np.testing.assert_allclose(got.losses, want.losses, atol=LOSS_ATOL, rtol=0)
    assert np.isfinite(got.losses).all()
    lr = RefTrainerConfig().learning_rate
    got_p, want_p, init_p = (params_from_flax(t) for t in (got.params, want.params, init))
    assert set(got_p) == set(want_p)
    hidden = cfg["hidden_dim"]
    for name, want_v in want_p.items():
        err = np.abs(got_p[name].numpy() - want_v.numpy())
        assert err.shape == want_v.shape, name
        assert err.max() <= 2 * got.steps * lr, name
        if name in shift_invariant:
            continue
        moved = np.abs(want_v.numpy() - init_p[name].numpy())
        if name.endswith("qkv.bias"):
            keep = np.r_[0:hidden, 2 * hidden:3 * hidden]
            err, moved = err[..., keep], moved[..., keep]
        assert np.median(err) <= PARAM_MEDIAN_SHARE * np.median(moved), name
    eval_idx, _ = ref_train._train_eval_split(
        np.random.default_rng(0).permutation(len(ref_ds.mask)), 0.2)
    n_rows = int((ref_ds.mask[eval_idx].sum(-1) >= 2).sum())
    assert set(got.eval_metrics) == set(want.eval_metrics)
    for key in ("precision", "recall", "regret"):
        assert abs(got.eval_metrics[key] - want.eval_metrics[key]) <= EVAL_ROWS / n_rows + 1e-6, key


# ------------------------------------------------------------ tp and pp


@pytest.fixture(scope="module")
def data_pair():
    return tiny_rank_data()


@pytest.fixture(scope="module")
def ref_tp_runs(data_pair):
    """The reference's tp trainings, each run once: dp 4 x tp 2, and tp 8,
    which does not divide the 4 heads (GSPMD takes any tp that divides the
    column widths)."""
    _, ref_ds = data_pair
    cfg = dict(PAR_CFG, attention_tp=True)
    return {shape: reference_run(ref_ds, cfg, ref_mesh.make_mesh(8, **shape_axes))
            for shape, shape_axes in (("dp4xtp2", {"dp": 4, "tp": 2}),
                                      ("tp8", {"dp": 1, "tp": 8}))}


@pytest.mark.parametrize("shape,axes", [("dp4xtp2", {"dp": 4, "tp": 2}),
                                        ("tp8", {"dp": 1, "tp": 8})])
def test_tensor_parallel_training_matches_reference(data_pair, ref_tp_runs, shape, axes):
    port_ds, ref_ds = data_pair
    want, init = ref_tp_runs[shape]
    cfg = dict(PAR_CFG, attention_tp=True)
    got = train.train_attention(port_ds, TrainerConfig(**cfg), mesh=cpu_mesh(8, **axes),
                                device="cpu", params=init)
    hold_to_reference(got, want, init, cfg, ref_ds)


def test_tensor_parallel_block_matches_one_device():
    """The tp block (head groups through their own attention, row-parallel
    sums) gives the one-device scores, float32, and its gradients."""
    from dragonfly2_tpu_torch.models.attention import AttentionRanker

    port_ds, _ = tiny_rank_data(n=8)
    rows = train.take(port_ds, np.arange(8))
    model = AttentionRanker(32, 4, 2, torch.float32, in_features=26).reset_parameters(
        torch.Generator().manual_seed(0))
    inputs = [torch.from_numpy(rows[k]) for k in ("child", "parents", "pair", "mask")]
    want = model(*inputs)
    want.sum().backward()
    want_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    for tp in (2, 3, 8):
        model.zero_grad()
        m = cpu_mesh(tp, dp=1, tp=tp)
        got = model(*inputs, mesh=m, tp_attention_fns=train.tp_attention_fns(m, "ring")[0])
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        got.sum().backward()
        for name, p in model.named_parameters():
            torch.testing.assert_close(p.grad, want_grads[name], atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def ref_pp_run(data_pair):
    _, ref_ds = data_pair
    cfg = dict(PAR_CFG, attention_pp=True, attention_pp_microbatches=2)
    ref_m = ref_mesh.make_mesh(2, dp=1, pp=2)
    sample = {"child": ref_ds.child[:2], "parents": ref_ds.parents[:2],
              "pair": ref_train._pair_feats(ref_ds, np.arange(2)), "mask": ref_ds.mask[:2]}
    _, init = ref_train._build_pp_ranker(RefTrainerConfig(**cfg), ref_m, sample, 0)
    return reference_run(ref_ds, cfg, ref_m, apply_init=init)


def test_pipeline_training_matches_reference(data_pair, ref_pp_run):
    port_ds, ref_ds = data_pair
    want, init = ref_pp_run
    cfg = dict(PAR_CFG, attention_pp=True, attention_pp_microbatches=2)
    got = train.train_attention(port_ds, TrainerConfig(**cfg), mesh=cpu_mesh(2, dp=1, pp=2),
                                device="cpu", params=init)
    # the reference's tree: {"embed", "blocks" [pp, ...], "ln", "score"}, each {"params": ...}
    assert jax.tree_util.tree_map(np.shape, got.params) == jax.tree_util.tree_map(
        np.shape, want.params)
    assert got.params["blocks"]["params"]["qkv"]["kernel"].shape == (2, 32, 96)
    hold_to_reference(got, want, init, cfg, ref_ds, shift_invariant=("score.bias", "ln.bias"))


def test_pipeline_tree_round_trips_and_masked_rows_stay_finite(ref_pp_run):
    """The pp tree crosses models/convert.py both ways unchanged; the
    microbatch padding's fully masked rows keep the gradients finite."""
    _, init = ref_pp_run
    model = PipelineRanker(32, 2, 4, in_features=26)
    model.load_state_dict(params_from_flax(init))
    back = params_to_flax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(init)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(init)):
        np.testing.assert_array_equal(got, want)
    port_ds, _ = tiny_rank_data(n=5)  # 5 rows over 4 microbatches: 3 padded rows
    rows = train.take(port_ds, np.arange(5))
    scores = model(*(torch.from_numpy(rows[k]) for k in ("child", "parents", "pair", "mask")),
                   mesh=cpu_mesh(2, dp=1, pp=2))
    scores[torch.from_numpy(rows["mask"])].sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    with pytest.raises(ValueError, match="pp = 2"):
        model(*(torch.from_numpy(rows[k]) for k in ("child", "parents", "pair", "mask")))


# ------------------------------------------------------------- the embed


def test_embed_graph_sharded_matches_reference():
    """tests/test_training.py:92-106's setup (hidden 32, edges padded to
    edge_bucket(E, 512), dp 4 x graph 2) from the reference's initial
    params: the port's sharded embed against the reference's, and against
    the port's own GraphSAGERanker.embed, within that test's bf16
    tolerance."""
    from dragonfly2_tpu.records import synth as ref_synth
    from dragonfly2_tpu.records.features import downloads_to_ranking_dataset as ref_dataset

    _, graph = ref_dataset(ref_synth.gen_download_records(
        ref_synth.make_cluster(80, seed=11), 200, num_tasks=16))
    ga = ref_data.graph_arrays(graph, pad_edges_to=ref_data.edge_bucket(graph.edge_src.shape[0],
                                                                        512))
    ref_model = RefGraphSAGE(hidden_dim=32)
    params = jax.device_get(ref_model.init(
        jax.random.key(0), ga, np.zeros(2, np.int32), np.zeros((2, 3), np.int32),
        np.zeros((2, 3, 2), np.float32)))
    want = np.asarray(ref_train.embed_graph_sharded(ref_model, params, ga,
                                                    ref_mesh.make_mesh(8, graph=2)), np.float32)
    m = cpu_mesh(8, dp=4, graph=2)
    model = GraphSAGERanker(32, in_features=ga["node_feats"].shape[1])
    got = embed_graph_sharded(model, params, ga, m)
    assert got.shape == want.shape and got.device == m.first_device
    got = got.detach()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)
    model.load_state_dict(params_from_flax(params))
    own = model.embed(*(torch.from_numpy(ga[k]) for k in ("node_feats", "edge_src", "edge_dst",
                                                           "edge_feats")))
    np.testing.assert_allclose(got.float().numpy(), own.detach().float().numpy(), rtol=2e-2,
                               atol=2e-2)
    # params=None: the model's own weights; the edges pad to a multiple of mesh.size
    again = embed_graph_sharded(model, None, {k: ga[k][:-3] if k.startswith("edge") else ga[k]
                                              for k in ga}, cpu_mesh(3, dp=3))
    assert torch.isfinite(again.float()).all() and again.shape == got.shape


# ------------------------------------------------- two processes (dcn)


_DCN_WORKER = r"""
import json, sys
import torch
from dragonfly2_tpu_torch.config.config import TrainerConfig
from dragonfly2_tpu_torch.parallel.mesh import initialize_distributed, make_hybrid_mesh
from dragonfly2_tpu_torch.records import synth
from dragonfly2_tpu_torch.records.features import downloads_to_ranking_dataset
from dragonfly2_tpu_torch.training import train

port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfg = TrainerConfig(**json.loads(sys.argv[4]))
initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
m = make_hybrid_mesh(dcn_dp=2, dp=1, devices=["cpu"])
assert m.dcn == 2 and m.dcn_rank == rank and m.shape["dp"] == 1
ds, graph = downloads_to_ranking_dataset(
    synth.gen_download_records(synth.make_cluster(80, seed=11), 200, num_tasks=16))
att = train.train_attention(ds, cfg, mesh=m, device="cpu")
gnn = train.train_gnn(ds, graph, cfg, mesh=m, device="cpu")
with open(out, "w") as f:
    json.dump({"attention": [att.losses, att.eval_metrics],
               "gnn": [gnn.losses, gnn.eval_metrics]}, f)
torch.distributed.destroy_process_group()
"""

# batch 30 splits 15 + 15 rows; hidden 32; one attention block
DCN_CFG = dict(hidden_dim=32, batch_size=30, epochs=2, attention_num_layers=1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_match_one_at_dp_doubled(tmp_path):
    """make_hybrid_mesh(dcn_dp=2, dp=1) in two gloo processes: each trains
    on its half of every batch, the loss divided by both halves' valid
    rows and the gradients all-reduced; the losses and the eval match one
    process on a dp 2 mesh."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one thread a process
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DCN_WORKER, str(port), str(rank), str(tmp_path / f"{rank}.json"),
         json.dumps(DCN_CFG)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        logs = [p.communicate(timeout=DCN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    runs = [json.loads((tmp_path / f"{rank}.json").read_text()) for rank in range(2)]
    assert runs[0] == runs[1]  # the processes agree to the last bit
    ds, graph = downloads_to_ranking_dataset(
        synth.gen_download_records(synth.make_cluster(80, seed=11), 200, num_tasks=16))
    cfg = TrainerConfig(**DCN_CFG)
    one = {"attention": train.train_attention(ds, cfg, mesh=cpu_mesh(2, dp=2), device="cpu"),
           "gnn": train.train_gnn(ds, graph, cfg, mesh=cpu_mesh(2, dp=2), device="cpu")}
    for key, result in one.items():
        losses, metrics = runs[0][key]
        assert len(losses) == result.steps > 4, key
        np.testing.assert_allclose(losses, result.losses, atol=LOSS_ATOL, rtol=0, err_msg=key)
        for name in ("precision", "recall"):
            assert metrics[name] == pytest.approx(result.eval_metrics[name], abs=0.05), key


def test_hybrid_mesh_needs_dcn_to_match_the_processes(tmp_path):
    """Across processes, dcn_dp must be the number of processes; the model
    axes never cross them."""
    code = _DCN_WORKER.split("port, rank")[0] + r"""
import sys
port, rank = int(sys.argv[1]), int(sys.argv[2])
initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
try:
    make_hybrid_mesh(dcn_dp=4, dp=1, devices=["cpu"])
except ValueError as e:
    print("REFUSED", e)
torch.distributed.destroy_process_group()
"""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one thread a process
    procs = [subprocess.Popen([sys.executable, "-c", code, str(port), str(rank)], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for rank in range(2)]
    try:
        logs = [p.communicate(timeout=DCN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0 and "REFUSED dcn_dp=4 must equal the 2 processes" in log, log


def test_shard_batch_takes_each_process_block():
    """The global batch padded to dcn x dp and cut into the processes'
    contiguous blocks, by a mesh that records a group of two."""
    m = cpu_mesh(2, dp=2)
    m.dcn, m.dcn_rank = 2, 1  # what make_hybrid_mesh records in process 1 of 2
    tree = {"mask": np.ones((5, 3), bool), "x": np.arange(5, dtype=np.float32)}
    got = mesh.shard_batch(m, tree)
    np.testing.assert_array_equal(got["x"].numpy(), [4, 4, 4, 4])  # rows 4..7 of 8, padded
    np.testing.assert_array_equal(got["mask"].numpy().all(-1), [True, False, False, False])
    stacked = mesh.shard_stacked_batches(m, {"x": np.arange(10, dtype=np.float32).reshape(2, 5)})
    np.testing.assert_array_equal(stacked["x"].numpy(), [[4, 4, 4, 4], [9, 9, 9, 9]])


def test_config_flags_and_mesh_axes_follow_the_reference(data_pair):
    """A mesh axis whose flag is off trains the plain model; a flag without
    a mesh is ignored; the pp tree only with the flag and pp > 1."""
    port_ds, _ = data_pair
    cfg = TrainerConfig(**PAR_CFG)
    plain = train.train_attention(port_ds, cfg, mesh=cpu_mesh(1, dp=1), device="cpu")
    for axes in ({"tp": 2}, {"pp": 2}, {"ep": 2}):
        got = train.train_attention(port_ds, cfg, mesh=cpu_mesh(2, dp=1, **axes), device="cpu")
        assert set(got.params) == {"params"} and "mlp_up" in got.params["params"]["block_0"]
        assert got.losses == plain.losses, axes
    flags = dataclasses.replace(cfg, attention_tp=True, attention_pp=True)
    one = train.train_attention(port_ds, cfg, device="cpu")
    ignored = train.train_attention(port_ds, flags, device="cpu")
    assert ignored.losses == one.losses and set(ignored.params) == {"params"}
