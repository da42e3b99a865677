"""The port's ml serving (registry/serving.py) against the reference's.

Both packages serve one GraphSAGE ranker published to one shared
filesystem bucket: the reference's flax init (hidden 32, 2 layers) crosses
into the port through models/convert.py, and every input is made from a
numpy seed. Held equal:

- the pure serving functions (``_loc_match_fraction``,
  ``_ensemble_scores`` with its constant rows, ``gnn_score``,
  ``mlp_apply``, ``_gnn_embed``, ``_gnn_embed_subset``) within FLOAT32_TOL
  at compute_dtype float32 and BF16_TOL at bf16;
- ``_ml_schedule_from_packed`` on the same packed buffers: identical
  selections at float32; at bf16, identical on every row whose margin (the
  least gap between consecutive valid ensemble scores down to the cut at
  ``limit``, on the reference's side) exceeds MARGIN_TOL, the rows inside
  it counted;
- the registry's bytes (params bit for bit either way), the activation
  gate (tests/test_activation_gate.py's cases), the refresh mailbox and
  worker (tests/test_serving_pipeline.py's), and ModelInfer for gnn and
  mlp over the wire.
"""

from __future__ import annotations

import asyncio
import gc
import statistics
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.graphsage import GraphSAGERanker as RefRanker
from dragonfly2_tpu.models.mlp import ProbeRTTRegressor as RefMLP
from dragonfly2_tpu.objectstorage.backends import FilesystemBackend as RefBackend
from dragonfly2_tpu.ops import evaluator as ref_ev
from dragonfly2_tpu.records.features import CandidateFeatures as RefFeatures
from dragonfly2_tpu.registry import serving as ref_serving
from dragonfly2_tpu.registry.bucket import BucketModelRegistry as RefRegistry
from dragonfly2_tpu.registry.registry import ModelEvaluation as RefEvaluation
from dragonfly2_tpu.rpc.inference import InferenceRPCServer as RefInferenceServer
from dragonfly2_tpu_torch.models import convert
from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
from dragonfly2_tpu_torch.models.mlp import ProbeRTTRegressor
from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend
from dragonfly2_tpu_torch.ops import evaluator as ev
from dragonfly2_tpu_torch.records.features import NUM_HOST_FEATURES, NUM_PAIR_FEATURES
from dragonfly2_tpu_torch.registry import (
    BucketModelRegistry,
    MLEvaluator,
    ModelEvaluation,
    ModelServer,
)
from dragonfly2_tpu_torch.registry import serving
from dragonfly2_tpu_torch.registry.registry import (
    MODEL_TYPE_GNN,
    MODEL_TYPE_MLP,
    STATE_ACTIVE,
    STATE_BAD,
)
from dragonfly2_tpu_torch.rpc.inference import InferenceClient, InferenceRPCServer
from dragonfly2_tpu_torch.state.fsm import PeerState
from dragonfly2_tpu_torch.telemetry import metrics as m

FLOAT32_TOL = 1e-5
BF16_TOL = 3e-2  # as tests/test_torch_graphsage.py: each side rounds to bf16 in its own order
MARGIN_TOL = 1.2e-2  # twice the largest bf16 ensemble-score gap to the reference seen, 5.5e-3
HIDDEN, N_NODES, EDGES = 32, 64, 256
NAME, HOST = "ranker", "h"
DTYPES = {"float32": (jnp.float32, torch.float32, FLOAT32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
LIMIT = 4


def _graph(n_nodes=N_NODES, edges=EDGES, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "node_feats": rng.normal(size=(n_nodes, NUM_HOST_FEATURES)).astype(np.float32),
        "edge_src": rng.integers(0, n_nodes - 1, edges).astype(np.int32),
        "edge_dst": rng.integers(0, n_nodes - 1, edges).astype(np.int32),
        "edge_feats": rng.normal(size=(edges, 2)).astype(np.float32),
    }


def _ref_params(model, graph, seed=0):
    n = graph["node_feats"].shape[0]
    child = np.zeros(4, np.int32)
    cands = np.arange(16, dtype=np.int32).reshape(4, 4) % n
    pair = np.zeros((4, 4, 2), np.float32)
    return jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.key(seed), graph, child, cands, pair))


def _poison(params):
    bad = jax.tree_util.tree_map(lambda a: np.asarray(a).copy(), params)
    jax.tree_util.tree_leaves(bad)[0].ravel()[0] = np.nan
    return bad


def _pair(dtype_name, hidden=HIDDEN, seed=0):
    """The reference's ranker and flax params, the port's module with them."""
    jdt, tdt, tol = DTYPES[dtype_name]
    ref = RefRanker(hidden_dim=hidden, compute_dtype=jdt)
    params = _ref_params(ref, _graph(), seed)
    port = GraphSAGERanker(hidden, 2, tdt)
    port.load_state_dict(convert.graphsage_params_from_flax(params))
    return ref, params, port.eval(), tol


def _t(a) -> torch.Tensor:
    """A reference array as a tensor of its dtype (bf16 included)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _feats(b=64, k=8, n_hosts=N_NODES, seed=0, valid_frac=0.8):
    """A random candidate batch with every filter rule in play: the
    reference's CandidateFeatures fields, host slots, blocklist, in-degree
    and cycle flags; row 0 holds one valid candidate, row 1 candidates of
    equal host (equal logits), row 2 none."""
    rng = np.random.default_rng(seed)
    f = RefFeatures.zeros(b, k)
    f.valid[:] = rng.random((b, k)) < valid_frac
    f.valid[0] = False
    f.valid[0, 3] = True
    f.valid[1] = True
    f.valid[2] = False
    f.finished_pieces[:] = rng.integers(0, 64, (b, k))
    f.child_finished_pieces[:] = rng.integers(0, 32, b)
    f.total_piece_count[:] = 64
    f.upload_count[:] = rng.integers(0, 100, (b, k))
    f.upload_failed_count[:] = rng.integers(0, 5, (b, k))
    f.upload_limit[:] = rng.integers(1, 20, (b, k))
    f.upload_used[:] = rng.integers(0, 10, (b, k))
    f.host_type[:] = rng.integers(0, 2, (b, k))
    f.peer_state[:] = int(PeerState.SUCCEEDED)
    f.parent_idc[:] = rng.integers(0, 4, (b, k))
    f.child_idc[:] = rng.integers(0, 4, b)
    f.parent_location[:] = rng.integers(0, 3, f.parent_location.shape)
    f.child_location[:] = rng.integers(0, 3, f.child_location.shape)
    f.parent_host_id[:] = np.arange(1, b * k + 1).reshape(b, k)
    f.child_host_id[:] = 0
    f.numeric[:] = rng.normal(size=f.numeric.shape)
    fd = f.as_dict()
    child = rng.integers(0, n_hosts, b).astype(np.int32)
    cands = rng.integers(0, n_hosts, (b, k)).astype(np.int32)
    cands[1] = cands[1, 0]
    aux = {
        "blocklist": rng.random((b, k)) < 0.05,
        "in_degree": rng.integers(0, 3, (b, k)).astype(np.int32),
        "can_add_edge": rng.random((b, k)) < 0.95,
    }
    return fd, child, cands, aux


def _pack(fd, child, cands, aux):
    buf = ev.pack_eval_batch(fd, child_host_slot=child, cand_host_slot=cands, **aux)
    np.testing.assert_array_equal(buf, ref_ev.pack_eval_batch(
        fd, child_host_slot=child, cand_host_slot=cands, **aux))
    b, k = fd["valid"].shape
    return buf, (b, k, fd["piece_costs"].shape[-1], fd["parent_location"].shape[-1],
                 fd["numeric"].shape[-1])


# ---------------------------------------------------------- pure functions


def test_loc_match_fraction_matches_reference():
    fd, *_ = _feats(seed=3)
    want = ref_serving._loc_match_fraction(fd["parent_location"], fd["child_location"])
    got = serving._loc_match_fraction(torch.from_numpy(fd["parent_location"]),
                                      torch.from_numpy(fd["child_location"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("algorithm", ["default", "nt"])
def test_ensemble_scores_match_reference_with_constant_rows(algorithm):
    fd, *_ = _feats(seed=4)
    fd["has_rtt"][:] = True
    fd["avg_rtt_ns"][:] = np.random.default_rng(4).random(fd["avg_rtt_ns"].shape) * 1e9
    rng = np.random.default_rng(5)
    logits = rng.normal(size=fd["valid"].shape).astype(np.float32)
    logits[1] = 0.75  # equal logits: variance 0
    want = np.asarray(ref_serving._ensemble_scores(fd, jnp.asarray(logits), algorithm))
    got = serving._ensemble_scores(ev.feats_to_tensors(fd, "cpu"), torch.from_numpy(logits),
                                   algorithm).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    _close(got, want, FLOAT32_TOL)
    # the constant rows take the reference's rsqrt(1e-6) path: one valid
    # candidate and equal logits score their blend exactly
    blend = ev.evaluate(ev.feats_to_tensors(fd, "cpu"), algorithm).numpy()
    np.testing.assert_array_equal(got[0, 3], blend[0, 3])
    np.testing.assert_array_equal(got[1], blend[1])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_gnn_serving_functions_match_reference(dtype_name):
    ref, params, port, tol = _pair(dtype_name)
    g = _graph(seed=1)
    want_emb = ref_serving._gnn_embed(ref, params, g)
    emb = serving._gnn_embed(port, g)
    _close(emb, want_emb, tol, "embed")

    fd, child, cands, _ = _feats(seed=2)
    pair = np.stack([fd["parent_idc"] == fd["child_idc"][:, None],
                     np.random.default_rng(2).random(fd["valid"].shape)], -1).astype(np.float32)
    want = ref_serving.gnn_score(ref, params, np.asarray(want_emb), child, cands, pair)
    _close(serving.gnn_score(port, _t(want_emb), child, cands, pair),
           want, tol, "gnn_score")
    # slots past the table clamp to its last row, as a JAX gather reads them
    far = cands + N_NODES
    _close(serving.gnn_score(port, _t(want_emb), child, far, pair),
           ref_serving.gnn_score(ref, params, np.asarray(want_emb), child, far, pair), tol,
           "gnn_score past the table")

    # the incremental program over a frontier, and the table left as it was
    from dragonfly2_tpu_torch.ops.segment import gather_coo_subgraph

    dirty = np.array([3, 17, 40])
    sub = gather_coo_subgraph(g["edge_src"], g["edge_dst"], dirty, N_NODES, max_frac=1.0)
    feats = np.where(sub["edge_pad"][:, None], 0.0,
                     g["edge_feats"][sub["edge_index"]]).astype(np.float32)
    table = torch.from_numpy(np.random.default_rng(9).normal(
        size=tuple(emb.shape)).astype(np.float32))
    before = table.clone()
    args = (g["node_feats"][sub["nodes"]], sub["edge_src"], sub["edge_dst"], feats,
            sub["target_local"], sub["target_global"])
    got = serving._gnn_embed_subset(port, table, *args)
    want = ref_serving._gnn_embed_subset(ref, params, table.numpy(), *args)
    assert torch.equal(table, before), "embed_subset wrote into the served table"
    _close(got, want, tol, "embed_subset")
    targets = sub["target_global"][sub["target_global"] < N_NODES]
    outside = np.ones(N_NODES, bool)
    outside[targets] = False
    np.testing.assert_array_equal(got.numpy()[outside], table.numpy()[outside])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_mlp_apply_matches_reference(dtype_name):
    jdt, tdt, tol = DTYPES[dtype_name]
    x = np.random.default_rng(6).normal(size=(40, NUM_PAIR_FEATURES)).astype(np.float32)
    ref = RefMLP(hidden_dim=32, compute_dtype=jdt)
    params = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.key(1), x))
    port = ProbeRTTRegressor(32, 3, tdt)
    port.load_state_dict(convert.mlp_params_from_flax(params))
    _close(serving.mlp_apply(port, x), ref_serving.mlp_apply(ref, params, x), tol)


def _margins(scores, mask, limit):
    """Per row: the least gap between consecutive valid scores, sorted
    down, from the first to the (limit + 1)-th (inf where no cut or tie
    can move the selection)."""
    out = np.full(scores.shape[0], np.inf)
    for i in range(scores.shape[0]):
        s = np.sort(scores[i][mask[i]])[::-1][: limit + 1]
        if s.size > 1:
            out[i] = np.min(s[:-1] - s[1:])
    return out


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ml_schedule_from_packed_matches_reference(dtype_name, seed):
    ref, params, port, _ = _pair(dtype_name, seed=seed)
    emb = np.asarray(ref_serving._gnn_embed(ref, params, _graph(seed=seed)))
    fd, child, cands, aux = _feats(seed=10 + seed)
    buf, dims = _pack(fd, child, cands, aux)
    want = np.asarray(ref_serving._ml_schedule_from_packed(
        ref, params, emb, buf.copy(), *dims, LIMIT))
    got = serving._ml_schedule_from_packed(port, _t(emb), buf, *dims, LIMIT)
    got = got.numpy()
    assert got.shape == want.shape == (dims[0], LIMIT, 2)
    assert np.isfinite(got[..., 1][got[..., 0] >= 0]).all()
    rows_equal = (got[..., 0] == want[..., 0]).all(-1)
    if dtype_name == "float32":
        assert rows_equal.all()
        _close(got, want, FLOAT32_TOL)
        return
    # bf16: the margin rule, on the reference's ensemble scores and mask
    f = ref_ev.unpack_eval_batch(jnp.asarray(buf), *dims)
    scores = np.asarray(ref_serving._ensemble_scores(f, ref_serving.gnn_score(
        ref, params, emb, f["child_host_slot"], f["cand_host_slot"],
        np.stack([np.asarray((f["parent_idc"] == f["child_idc"][:, None])
                             & (f["child_idc"][:, None] != 0), np.float32),
                  np.asarray(ref_serving._loc_match_fraction(f["parent_location"],
                                                             f["child_location"]))], -1))))
    mask = np.asarray(ref_ev.filter_candidates(f, f["blocklist"], f["in_degree"],
                                               f["can_add_edge"]))
    wide = _margins(scores, mask, LIMIT) > MARGIN_TOL
    print(f"bf16: {int((~wide).sum())} of {len(wide)} rows inside the margin "
          f"{MARGIN_TOL}; {int((~rows_equal).sum())} rows differ")
    assert wide.sum() >= dims[0] // 4
    assert rows_equal[wide].all()


# ------------------------------------------------ registry and ModelServer


@pytest.fixture()
def buckets(tmp_path):
    return (RefRegistry(RefBackend(tmp_path), "models"),
            BucketModelRegistry(FilesystemBackend(tmp_path), "models"))


def test_reference_published_version_is_served_bit_for_bit(buckets):
    ref_reg, reg = buckets
    ref = RefRanker(hidden_dim=HIDDEN)
    params = _ref_params(ref, _graph())
    mv = ref_reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, params, RefEvaluation(),
                                      metadata={"hidden_dim": HIDDEN})
    ref_reg.activate(mv.model_id, mv.version)
    server = ModelServer(reg, NAME, HOST, MODEL_TYPE_GNN, device="cpu")
    assert server.refresh() and server.version == mv.version
    assert server.model.hidden_dim == HIDDEN and server.model.compute_dtype == torch.bfloat16
    want = convert.graphsage_params_from_flax(params)
    assert set(server.params) == set(want)
    for key, value in want.items():
        assert torch.equal(server.params[key], value), key
    # the served module scores with exactly those weights
    model, served, version = server.snapshot()
    assert model is server.model and served is server.params and version == mv.version
    assert all(p.data_ptr() == served[k].data_ptr() for k, p in model.state_dict().items())
    assert not server.refresh()  # same version: nothing to do


def test_port_published_version_loads_in_the_reference(buckets):
    ref_reg, reg = buckets
    model = GraphSAGERanker(HIDDEN, 2).reset_parameters(torch.Generator().manual_seed(3))
    tree = convert.graphsage_params_to_flax(model)
    mv = reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, tree, ModelEvaluation(),
                                  metadata={"hidden_dim": HIDDEN})
    reg.activate(mv.model_id, mv.version)
    ref_server = ref_serving.ModelServer(ref_reg, NAME, HOST, MODEL_TYPE_GNN,
                                         _ref_params(RefRanker(hidden_dim=HIDDEN), _graph()))
    assert ref_server.refresh()
    back = convert.graphsage_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                     ref_server.params))
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key
    server = ModelServer(reg, NAME, HOST, MODEL_TYPE_GNN, device="cpu")
    assert server.refresh()
    g = _graph(seed=4)
    _close(server.embed_hosts(g), ref_server.embed_hosts(g), BF16_TOL)


def test_refresh_builds_a_module_per_version_and_follows_the_metadata(buckets):
    """A committed snapshot's module is never written by a later refresh,
    and a version of another width is served at its own width."""
    _, reg = buckets
    server = ModelServer(reg, NAME, HOST, MODEL_TYPE_GNN, device="cpu",
                         model=GraphSAGERanker(16, 2, torch.float32))
    for seed, hidden in ((0, 16), (1, 16), (2, 24)):
        tree = convert.graphsage_params_to_flax(GraphSAGERanker(hidden, 2).reset_parameters(
            torch.Generator().manual_seed(seed)))
        mv = reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, tree, ModelEvaluation(),
                                      metadata={"hidden_dim": hidden})
        reg.activate(mv.model_id, mv.version)
        before = server.snapshot()
        kept = None if before[1] is None else {k: v.clone() for k, v in before[1].items()}
        assert server.refresh()
        assert server.model is not before[0]
        assert server.model.hidden_dim == hidden
        assert server.model.compute_dtype == torch.float32  # the template's knob stays
        if kept is not None:
            assert all(torch.equal(before[1][k], v) for k, v in kept.items())
    mlp = ModelServer(reg, "rtt", HOST, MODEL_TYPE_MLP, device="cpu")
    tree = convert.mlp_params_to_flax(ProbeRTTRegressor(48, 3).reset_parameters(
        torch.Generator().manual_seed(5)))
    mv = reg.create_model_version("rtt", MODEL_TYPE_MLP, HOST, tree, ModelEvaluation(),
                                  metadata={"hidden_dim": 48})
    reg.activate(mv.model_id, mv.version)
    assert mlp.refresh() and mlp.model.hidden_dim == 48
    assert mlp.infer_mlp(np.zeros((3, NUM_PAIR_FEATURES), np.float32)).shape == (3,)


# ---------------------------------------------------------- activation gate


def _served(reg, ref_reg=None, graph=None, poisoned_first=False):
    """The port's server and evaluator over a reference-initialized
    version (the reference's registry publishes it when given)."""
    graph = graph or _graph()
    ref = RefRanker(hidden_dim=16)
    params = _ref_params(ref, graph)
    publisher = ref_reg or reg
    evaluation = RefEvaluation() if ref_reg else ModelEvaluation()
    mv = publisher.create_model_version(
        NAME, MODEL_TYPE_GNN, HOST, _poison(params) if poisoned_first else params, evaluation,
        metadata={"hidden_dim": 16})
    publisher.activate(mv.model_id, mv.version)
    server = ModelServer(reg, NAME, HOST, MODEL_TYPE_GNN, device="cpu")
    assert server.refresh()
    return server, MLEvaluator(server, metrics_registry=m.Registry()), params, mv


def test_canary_batch_is_the_reference_batch():
    want = ref_serving._canary_probe()
    got = serving._canary_probe()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_nan_poisoned_version_never_becomes_serving_snapshot(buckets):
    ref_reg, reg = buckets
    graph = _graph()
    server, evaluator, params, mv = _served(reg, ref_reg, graph)
    try:
        evaluator.refresh_embeddings(dict(graph), wait=True)
        assert evaluator.committed_versions[-1] == (server.version, 1)
        good = server.version
        mv2 = ref_reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, _poison(params),
                                           RefEvaluation(), metadata={"hidden_dim": 16})
        ref_reg.activate(mv2.model_id, mv2.version)
        assert server.refresh() and server.version == mv2.version
        # on the worker, never in this caller
        evaluator.refresh_embeddings(dict(graph))
        deadline = time.monotonic() + 60
        while evaluator.refresh_count < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert evaluator.refresh_count == 2
        assert evaluator.rejection_count == 1
        assert evaluator._metrics.activation_rejected.value("nonfinite_params") == 1
        assert evaluator._metrics.activation_accepted.value() == 1
        snap = evaluator.serving_snapshot()
        assert snap.params_version == good
        assert all(p == good for p, _ in evaluator.committed_versions)
        states = {v.version: v.state for v in reg.list_versions(mv.model_id)}
        assert states == {1: STATE_ACTIVE, 2: STATE_BAD}
        assert reg.active_version(mv.model_id).version == 1
        with pytest.raises(ValueError):
            reg.activate(mv.model_id, 2)
        mv3 = reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, params, ModelEvaluation(),
                                       metadata={"hidden_dim": 16})
        assert mv3.version == 3
        reg.activate(mv3.model_id, 3)
        assert server.refresh()
        evaluator.refresh_embeddings(dict(graph), wait=True)
        assert evaluator.serving_snapshot().params_version == 3
        assert evaluator.rejection_count == 1
        # the gate runs only on refresh: scheduling adds none
        fd, child, cands, aux = _feats()
        buf, dims = _pack(fd, child, cands, aux)
        runs = evaluator.gate_runs
        for _ in range(5):
            out = evaluator.schedule_from_packed(buf, *dims).numpy()
            assert out.shape[-1] == 2 and np.isfinite(out[..., 1][out[..., 0] >= 0]).all()
        assert evaluator.gate_runs == runs
        assert evaluator.last_used_versions[0] == 3
    finally:
        evaluator.close()


def test_rejected_version_stays_rejected_across_refreshes(buckets):
    _, reg = buckets
    graph = _graph()
    server, evaluator, params, mv = _served(reg, graph=graph)
    try:
        evaluator.refresh_embeddings(dict(graph), wait=True)
        mv2 = reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, _poison(params),
                                       ModelEvaluation(), metadata={"hidden_dim": 16})
        reg.activate(mv2.model_id, mv2.version)
        assert server.refresh()
        evaluator.refresh_embeddings(dict(graph), wait=True)
        assert evaluator.rejection_count == 1
        runs = evaluator.gate_runs
        for _ in range(3):  # the server still holds the rejected version
            evaluator.refresh_embeddings(dict(graph), wait=True)
        assert evaluator.gate_runs == runs
        assert evaluator.rejection_count == 1
        assert evaluator.serving_snapshot().params_version == 1
        assert evaluator.serving_snapshot().emb_version >= 2
    finally:
        evaluator.close()


def test_gate_with_no_last_good_stays_on_rule_fallback(buckets):
    _, reg = buckets
    graph = _graph()
    server, evaluator, _, _ = _served(reg, graph=graph, poisoned_first=True)
    try:
        evaluator.refresh_embeddings(dict(graph), wait=True)
        assert evaluator.rejection_count == 1
        assert evaluator.serving_snapshot() is None
        fd, child, cands, aux = _feats()
        buf, dims = _pack(fd, child, cands, aux)
        out = evaluator.schedule_from_packed(buf, *dims).numpy()
        assert out.shape[-1] == 2 and np.isfinite(out[..., 1][out[..., 0] >= 0]).all()
        want = ev.schedule_from_packed(buf, *dims, device="cpu").numpy()
        np.testing.assert_array_equal(out, want)  # the rule blend served
        assert evaluator.last_used_versions is None
    finally:
        evaluator.close()


def test_gate_agrees_with_the_reference_on_a_blown_up_version():
    """A version with finite weights whose embeddings overflow is rejected
    as "nonfinite_embeddings" by both packages, and a healthy one passes
    both gates."""
    graph = _graph()
    params = _ref_params(RefRanker(hidden_dim=16), graph)
    verdicts = []
    for scale in (1e20, 1.0):
        scaled = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(scale), params)
        ref = RefRanker(hidden_dim=16)
        gate = ref_serving.MLEvaluator.__new__(ref_serving.MLEvaluator)
        gate.gate_runs, gate._base_alg = 0, "default"
        verdicts.append(gate._activation_gate(ref, scaled,
                                              ref_serving._gnn_embed(ref, scaled, graph)))
        port = GraphSAGERanker(16, 2)
        port.load_state_dict(convert.graphsage_params_from_flax(scaled))
        gate = MLEvaluator.__new__(MLEvaluator)
        gate.gate_runs, gate.device, gate._base_alg = 0, torch.device("cpu"), "default"
        verdicts.append(gate._activation_gate(port, dict(port.state_dict()),
                                              serving._gnn_embed(port, graph)))
    assert verdicts == ["nonfinite_embeddings"] * 2 + [None] * 2


def test_schedule_transports_match_the_reference(buckets):
    """The dict and packed-dict transports (``schedule``,
    ``schedule_packed``) and the packed buffer (``schedule_from_packed``)
    on committed snapshots of one float32 version, against the
    reference's evaluator; before a commit, the rule fallback."""
    ref_reg, reg = buckets
    graph = _graph()
    params = _ref_params(RefRanker(hidden_dim=16), graph)
    mv = ref_reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, params, RefEvaluation(),
                                      metadata={"hidden_dim": 16})
    ref_reg.activate(mv.model_id, mv.version)
    ref_server = ref_serving.ModelServer(ref_reg, NAME, HOST, MODEL_TYPE_GNN, params,
                                         model=RefRanker(hidden_dim=16, compute_dtype=jnp.float32))
    server = ModelServer(reg, NAME, HOST, MODEL_TYPE_GNN, device="cpu",
                         model=GraphSAGERanker(16, 2, torch.float32))
    assert ref_server.refresh() and server.refresh()
    ref_eval = ref_serving.MLEvaluator(ref_server, metrics_registry=m.Registry())
    evaluator = MLEvaluator(server, metrics_registry=m.Registry())
    fd, child, cands, aux = _feats(seed=21)
    buf, dims = _pack(fd, child, cands, aux)
    try:
        for committed in (False, True):
            if committed:
                ref_eval.refresh_embeddings(dict(graph), wait=True)
                evaluator.refresh_embeddings(dict(graph), wait=True)
                assert evaluator.last_used_versions is None
            want = ref_eval.schedule(fd, child, cands, limit=LIMIT, **aux)
            got = evaluator.schedule(fd, child, cands, limit=LIMIT, **aux)
            for key in ("selected", "selected_valid", "mask"):
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), key)
            _close(got["selected_scores"][got["selected_valid"]],
                   np.asarray(want["selected_scores"])[np.asarray(want["selected_valid"])],
                   FLOAT32_TOL)
            packed = evaluator.schedule_packed(fd, child, cands, limit=LIMIT, **aux).numpy()
            want_packed = np.asarray(ref_eval.schedule_packed(fd, child, cands, limit=LIMIT,
                                                              **aux))
            np.testing.assert_array_equal(packed[..., 0], want_packed[..., 0])
            from_buf = evaluator.schedule_from_packed(buf, *dims, limit=LIMIT).numpy()
            np.testing.assert_array_equal(from_buf, packed)
        assert evaluator.last_used_versions == ref_eval.last_used_versions == (mv.version, 1)
    finally:
        ref_eval.close()
        evaluator.close()


# -------------------------------------------------- mailbox and the worker


def test_mailbox_unions_frontiers_and_full_sync_sticks(buckets):
    _, reg = buckets
    server, evaluator, _, _ = _served(reg)
    try:
        g = _graph()
        evaluator._merge_request(dict(g, dirty_slots=np.array([1, 5], np.int32),
                                      full_sync=False))
        evaluator._merge_request(dict(g, dirty_slots=np.array([5, 9], np.int32),
                                      full_sync=False))
        req = evaluator._take_request()
        np.testing.assert_array_equal(req["dirty_slots"], [1, 5, 9])
        assert req["full_sync"] is False
        # a request without a frontier means full, and full survives a merge
        evaluator._merge_request(dict(g))
        evaluator._merge_request(dict(g, dirty_slots=np.array([2], np.int32), full_sync=False))
        req = evaluator._take_request()
        assert req["full_sync"] is True
        evaluator._merge_request(dict(g, dirty_slots=np.array([2], np.int32), full_sync=True))
        evaluator._merge_request(dict(g, dirty_slots=np.array([3], np.int32), full_sync=False))
        assert evaluator._take_request()["full_sync"] is True
        assert evaluator._take_request() is None
        # the reference merges the same way
        ref_ev_obj = ref_serving.MLEvaluator.__new__(ref_serving.MLEvaluator)
        ref_ev_obj._req_mu, ref_ev_obj._request = threading.Lock(), None
        for port_ev, ref_obj in ((evaluator, ref_ev_obj),):
            for req in (dict(g, dirty_slots=np.array([4], np.int32), full_sync=False), dict(g)):
                port_ev._merge_request(req)
                ref_obj._merge_request(req)
            a, b = port_ev._take_request(), ref_obj._request
            assert a["full_sync"] == b["full_sync"]
    finally:
        evaluator.close()


def test_a_failed_refresh_forces_the_next_one_full(buckets, monkeypatch):
    _, reg = buckets
    server, evaluator, _, _ = _served(reg)
    try:
        g = _graph()
        evaluator.INCREMENTAL_MAX_FRAC = 1.0
        evaluator.refresh_embeddings(dict(g), wait=True)
        real = serving._gnn_embed_subset

        def broken(*args):
            raise RuntimeError("injected")

        monkeypatch.setattr(serving, "_gnn_embed_subset", broken)
        evaluator.refresh_embeddings(dict(g, dirty_slots=np.array([3], np.int32),
                                          full_sync=False), wait=True)
        assert evaluator._need_full and evaluator.refresh_count == 1
        monkeypatch.setattr(serving, "_gnn_embed_subset", real)
        evaluator.refresh_embeddings(dict(g, dirty_slots=np.array([4], np.int32),
                                          full_sync=False), wait=True)
        assert evaluator.incremental_refresh_count == 0  # went full
        assert not evaluator._need_full and evaluator.refresh_count == 2
    finally:
        evaluator.close()


def test_async_refresh_commits_off_thread_and_worker_dies_with_evaluator(buckets, tmp_path):
    _, reg = buckets
    graph = _graph()
    server, evaluator, _, _ = _served(reg, graph=graph)
    assert evaluator._committed is None
    evaluator.refresh_embeddings(dict(graph))  # wait=False: enqueue only
    deadline = time.monotonic() + 60
    while evaluator._committed is None and time.monotonic() < deadline:
        time.sleep(0.01)
    snap = evaluator._committed
    assert snap is not None, "background refresh never committed"
    assert snap.emb_version == 1 and snap.params_version == server.version
    worker = evaluator._worker
    assert worker is not None and worker.is_alive()
    assert worker.name.startswith("ml-embed-refresh")
    evaluator.close()
    assert not worker.is_alive()
    assert evaluator._committed is not None
    # a closed evaluator computes a late request inline, spawning nothing
    evaluator.refresh_embeddings(dict(graph))
    assert evaluator._worker is None and evaluator._request is None
    assert evaluator._committed.emb_version == 2

    # dropping the last reference signals the worker to exit
    reg2 = BucketModelRegistry(FilesystemBackend(tmp_path / "gc"), "models")
    _, ev2, _, _ = _served(reg2, graph=graph)
    ev2.refresh_embeddings(dict(graph))
    worker2 = ev2._worker
    assert worker2 is not None
    del ev2
    gc.collect()
    worker2.join(timeout=5)
    assert not worker2.is_alive(), "worker outlived its GC'd evaluator"


def test_refresh_serve_race_consistent_versions(buckets):
    """A thread hammers refresh_embeddings (a params flip mid-run) while
    schedule_from_packed serves in a loop: every call serves a
    (params_version, emb_version) pair committed as a unit, and no call
    waits out a full refresh."""
    _, reg = buckets
    n_nodes, edges = 2048, 16384
    graph = _graph(n_nodes, edges)
    server, evaluator, params, _ = _served(reg, graph=graph)
    rng = np.random.default_rng(7)
    evaluator.refresh_embeddings(dict(graph), wait=True)
    t_full = []
    for _ in range(2):
        t0 = time.perf_counter()
        evaluator.refresh_embeddings(dict(graph, full_sync=True), wait=True)
        t_full.append(time.perf_counter() - t0)
    refresh_bound = max(min(t_full), 0.05)
    fd, child, cands, aux = _feats(n_hosts=n_nodes)
    buf, dims = _pack(fd, child, cands, aux)
    blocking_before = evaluator.refresh_blocking_s
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            i += 1
            evaluator.refresh_embeddings(dict(
                graph, dirty_slots=rng.integers(0, n_nodes, 8).astype(np.int32),
                full_sync=i % 7 == 0))
            time.sleep(0.001)

    thread = threading.Thread(target=hammer, name="race-hammer")
    thread.start()
    used, tick_s = [], []
    try:
        for i in range(40):
            if i == 20:
                mv = reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, params,
                                              ModelEvaluation(), metadata={"hidden_dim": 16})
                reg.activate(mv.model_id, mv.version)
                assert server.refresh()
            t0 = time.perf_counter()
            out = evaluator.schedule_from_packed(buf, *dims)
            tick_s.append(time.perf_counter() - t0)
            assert out.shape[-1] == 2
            used.append(evaluator.last_used_versions)
        deadline = time.perf_counter() + 20.0
        while (not any(p and p[0] == server.version for p in used)
               and time.perf_counter() < deadline):
            time.sleep(0.02)
            evaluator.schedule_from_packed(buf, *dims)
            used.append(evaluator.last_used_versions)
    finally:
        stop.set()
        thread.join(timeout=10)
    evaluator.close()
    committed = set(evaluator.committed_versions)
    assert all(pair in committed for pair in used)
    assert any(p and p[0] == server.version for p in used)
    assert evaluator.refresh_count > 2
    assert statistics.median(tick_s) < refresh_bound
    assert evaluator.refresh_blocking_s - blocking_before < 0.5


def test_incremental_refresh_matches_full_on_the_frontier(buckets):
    """The scheduler's dirty frontier -> the incremental path; its table
    equals a full refresh's on the frontier's targets within FLOAT32_TOL
    and bit for bit elsewhere; a params flip goes full."""
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
    from dragonfly2_tpu_torch.ops.segment import gather_coo_subgraph

    _, reg = buckets
    svc = SchedulerService(device="cpu", metrics_registry=m.Registry())
    sim = ClusterSimulator(svc, num_hosts=32, num_tasks=4, seed=5)
    for _ in range(8):
        sim.run_round(new_downloads=6)
    g1 = svc.serving_graph_arrays()
    tree = convert.graphsage_params_to_flax(GraphSAGERanker(16, 2).reset_parameters(
        torch.Generator().manual_seed(0)))
    mv = reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, tree, ModelEvaluation(),
                                  metadata={"hidden_dim": 16})
    reg.activate(mv.model_id, mv.version)
    server = ModelServer(reg, NAME, HOST, MODEL_TYPE_GNN, device="cpu",
                         model=GraphSAGERanker(16, 2, torch.float32))
    assert server.refresh()
    evaluator = MLEvaluator(server, metrics_registry=m.Registry())
    try:
        evaluator.INCREMENTAL_MAX_FRAC = 1.0
        evaluator.refresh_embeddings(g1, wait=True)
        old = evaluator._host_emb.clone()
        for _ in range(4):
            sim.run_round(new_downloads=4)
        g2 = svc.serving_graph_arrays()
        assert g2["node_feats"].shape == g1["node_feats"].shape and len(g2["dirty_slots"])
        evaluator.refresh_embeddings(g2, wait=True)
        assert evaluator.incremental_refresh_count == 1
        assert evaluator.committed_versions[-1][1] == 2
        full = server.embed_hosts(g2)
        n = g2["node_feats"].shape[0]
        sub = gather_coo_subgraph(g2["edge_src"], g2["edge_dst"], g2["dirty_slots"], n,
                                  max_frac=1.0)
        targets = sub["target_global"][sub["target_global"] < n]
        inc = evaluator._host_emb
        _close(inc[targets], full[targets].numpy(), FLOAT32_TOL)
        outside = np.ones(n, bool)
        outside[targets] = False
        assert torch.equal(inc[outside], old[outside])
        mv2 = reg.create_model_version(NAME, MODEL_TYPE_GNN, HOST, tree, ModelEvaluation(),
                                       metadata={"hidden_dim": 16})
        reg.activate(mv2.model_id, mv2.version)
        assert server.refresh()
        sim.run_round(new_downloads=4)
        evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
        assert evaluator.incremental_refresh_count == 1  # a params flip goes full
        assert evaluator._committed.params_version == server.version
    finally:
        evaluator.close()


# ------------------------------------------------------ ModelInfer over wire


def test_model_infer_gnn_and_mlp_match_the_reference(buckets):
    ref_reg, reg = buckets
    graph = _graph()
    gnn_params = _ref_params(RefRanker(hidden_dim=HIDDEN), graph)
    x = np.random.default_rng(8).normal(size=(12, NUM_PAIR_FEATURES)).astype(np.float32)
    mlp_params = jax.tree_util.tree_map(np.asarray, RefMLP(hidden_dim=32).init(
        jax.random.key(2), x))
    for name, kind, params, meta in (("gnn", MODEL_TYPE_GNN, gnn_params, HIDDEN),
                                     ("mlp", MODEL_TYPE_MLP, mlp_params, 32)):
        mv = ref_reg.create_model_version(name, kind, HOST, params, RefEvaluation(),
                                          metadata={"hidden_dim": meta})
        ref_reg.activate(mv.model_id, mv.version)
    emb = np.random.default_rng(9).normal(size=(N_NODES, HIDDEN)).astype(np.float32)
    fd, child, cands, _ = _feats(b=6)
    gnn_in = {"host_emb": emb, "child_host": child, "cand_host": cands,
              "pair_feats": np.random.default_rng(3).random((6, 8, 2)).astype(np.float32)}
    port_servers = {
        "gnn": ModelServer(reg, "gnn", HOST, MODEL_TYPE_GNN, device="cpu"),
        "mlp": ModelServer(reg, "mlp", HOST, MODEL_TYPE_MLP, device="cpu"),
    }
    ref_servers = {
        "gnn": ref_serving.ModelServer(ref_reg, "gnn", HOST, MODEL_TYPE_GNN, gnn_params),
        "mlp": ref_serving.ModelServer(ref_reg, "mlp", HOST, MODEL_TYPE_MLP, mlp_params),
    }

    async def ask(server_cls, servers):
        server = server_cls(servers, refresh_ttl_s=0.0)
        host, port = await server.start()
        client = await InferenceClient(host, port).connect()
        try:
            return (await client.model_infer("gnn", gnn_in),
                    await client.model_infer("mlp", {"features": x}))
        finally:
            await client.close()
            await server.stop()

    got = asyncio.new_event_loop().run_until_complete(ask(InferenceRPCServer, port_servers))
    want = asyncio.new_event_loop().run_until_complete(ask(RefInferenceServer, ref_servers))
    assert got[0]["scores"].shape == (6, 8) and got[1]["rtt"].shape == (12,)
    _close(got[0]["scores"], want[0]["scores"], BF16_TOL, "gnn")
    _close(got[1]["rtt"], want[1]["rtt"], BF16_TOL, "mlp")
