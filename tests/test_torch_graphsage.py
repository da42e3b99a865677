"""models/graphsage.py and models/mlp.py against the reference's flax models.

The reference's params (flax init from a jax key) cross into the port
through models/convert.py; both then run on the same numpy inputs, a
synth trace's host graph at small widths. Tolerances: compute_dtype
float32 within FLOAT32_TOL (the semantics: same layers, same aggregation,
same gelu), bf16 within BF16_TOL (each side rounds its products and gelus
to bf16 in its own order). The flax <-> torch round trips are exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models import graphsage as ref_sage
from dragonfly2_tpu.models import mlp as ref_mlp
from dragonfly2_tpu.ops.segment import gather_coo_subgraph as ref_gather
from dragonfly2_tpu.records import synth
from dragonfly2_tpu.records.features import downloads_to_ranking_dataset, topology_to_pairs
from dragonfly2_tpu.training import data as ref_data
from dragonfly2_tpu_torch.models import convert
from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker, SAGELayer
from dragonfly2_tpu_torch.models.mlp import ProbeRTTRegressor, mse_loss
from dragonfly2_tpu_torch.ops.segment import gather_coo_subgraph
from dragonfly2_tpu_torch.training import data

FLOAT32_TOL = 1e-5
BF16_TOL = 3e-2  # absolute and relative, on outputs of order 1
HIDDEN = 32
DTYPES = {"float32": (jnp.float32, torch.float32, FLOAT32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def trace():
    # sparse enough that a frontier's 2-hop targets are a part of the graph
    cluster = synth.make_cluster(400, seed=5)
    records = synth.gen_download_records(cluster, 150, num_tasks=60, max_parents=8)
    ds, graph = downloads_to_ranking_dataset(records, max_parents=8)
    return ds, graph


def _tensors(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def _batch(ds, rows=16):
    idx = np.arange(rows)
    pair = np.concatenate([ds.same_idc[idx, :, None], ds.loc_match[idx, :, None]],
                          axis=-1).astype(np.float32)
    return ds.child_host_idx[idx], ds.parent_host_idx[idx], pair


def _models(dtype_name, trace, hidden=HIDDEN, layers=2):
    jdt, tdt, tol = DTYPES[dtype_name]
    ds, graph = trace
    seg = ref_data.graph_arrays(graph, pad_edges_to=ref_data.edge_bucket(len(graph.edge_src),
                                                                         256))
    child, parents, pair = _batch(ds)
    ref_model = ref_sage.GraphSAGERanker(hidden_dim=hidden, num_layers=layers,
                                         compute_dtype=jdt)
    params = ref_model.init(jax.random.key(0), seg, child, parents, pair)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = GraphSAGERanker(hidden, layers, tdt)
    port.load_state_dict(convert.graphsage_params_from_flax(params))
    return ref_model, params, port, seg, tol


def _close(got: torch.Tensor, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_sage_layer_matches_reference_on_both_paths(dtype_name, trace):
    jdt, tdt, tol = DTYPES[dtype_name]
    _, graph = trace
    seg = ref_data.graph_arrays(graph)
    dense = ref_data.dense_graph_arrays(graph)
    n = seg["node_feats"].shape[0]
    layer = ref_sage.SAGELayer(HIDDEN, jdt)
    args = (seg["node_feats"], seg["edge_src"], seg["edge_dst"], seg["edge_feats"], n)
    params = jax.tree_util.tree_map(np.asarray, layer.init(jax.random.key(1), *args))
    port = SAGELayer(seg["node_feats"].shape[1], HIDDEN, compute_dtype=tdt)
    port.load_state_dict(convert.params_from_flax(params))
    t = _tensors(seg)
    want = layer.apply(params, *args)
    _close(port(t["node_feats"], t["edge_src"], t["edge_dst"], t["edge_feats"], n), want,
           tol, "segment")
    want = layer.apply(params, *args, adj=dense["adj"], edge_mean=dense["edge_mean"])
    td = _tensors(dense)
    got = port(t["node_feats"], t["edge_src"], t["edge_dst"], t["edge_feats"], n,
               adj=td["adj"], edge_mean=td["edge_mean"])
    _close(got, want, tol, "dense")


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_ranker_embed_score_and_forward_match_reference(dtype_name, trace):
    ref_model, params, port, seg, tol = _models(dtype_name, trace)
    ds, graph = trace
    child, parents, pair = _batch(ds)
    t = _tensors(seg)
    emb_want = ref_model.apply(params, seg["node_feats"], seg["edge_src"], seg["edge_dst"],
                               seg["edge_feats"], method="embed")
    emb = port.embed(t["node_feats"], t["edge_src"], t["edge_dst"], t["edge_feats"])
    assert emb.dtype == port.compute_dtype
    _close(emb, emb_want, tol, "embed")

    dense = ref_data.dense_graph_arrays(graph)
    dense_want = ref_model.apply(params, dense, child, parents, pair)
    dense_got = port(_tensors(dense), torch.from_numpy(child), torch.from_numpy(parents),
                     torch.from_numpy(pair))
    _close(dense_got, dense_want, tol, "dense forward")

    want = ref_model.apply(params, seg, child, parents, pair)
    got = port(t, torch.from_numpy(child), torch.from_numpy(parents), torch.from_numpy(pair))
    assert got.dtype == torch.float32 and got.shape == parents.shape
    _close(got, want, tol, "forward")
    # score alone, from the reference's own embeddings
    emb_np = np.asarray(emb_want, np.float32)
    want = ref_model.apply(params, emb_np[child], emb_np[parents], pair, method="score")
    got = port.score(torch.from_numpy(emb_np[child]), torch.from_numpy(emb_np[parents]),
                     torch.from_numpy(pair))
    _close(got, want, tol, "score")


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_embed_subset_matches_reference_with_padded_targets(dtype_name, trace):
    ref_model, params, port, seg, tol = _models(dtype_name, trace)
    n = seg["node_feats"].shape[0]  # the last row is the sink
    dirty = np.array([1, 5, 9])
    sub = ref_gather(seg["edge_src"], seg["edge_dst"], dirty, n, max_frac=1.0)
    got_sub = gather_coo_subgraph(seg["edge_src"], seg["edge_dst"], dirty, n, max_frac=1.0)
    for key in sub:
        np.testing.assert_array_equal(got_sub[key], sub[key], err_msg=key)
    assert (sub["target_global"] == n).any()  # padding targets must be dropped
    nodes = seg["node_feats"][sub["nodes"]]
    feats = np.where(sub["edge_pad"][:, None], 0.0,
                     seg["edge_feats"][sub["edge_index"]]).astype(np.float32)
    table = np.random.default_rng(0).standard_normal((n, HIDDEN)).astype(np.float32)
    want = ref_model.apply(params, nodes, sub["edge_src"], sub["edge_dst"], feats,
                           jnp.asarray(table),
                           sub["target_local"], sub["target_global"], method="embed_subset")
    got = port.embed_subset(torch.from_numpy(nodes), torch.from_numpy(sub["edge_src"]),
                            torch.from_numpy(sub["edge_dst"]), torch.from_numpy(feats),
                            torch.from_numpy(table), torch.from_numpy(sub["target_local"]),
                            torch.from_numpy(sub["target_global"]))
    assert got.shape == table.shape and got.dtype == torch.float32
    _close(got, want, tol, "embed_subset")
    targets = sub["target_global"][sub["target_global"] < n]
    untouched = np.setdiff1d(np.arange(n), targets)
    np.testing.assert_array_equal(got.numpy()[untouched], table[untouched])
    # the fresh rows are the full embed's rows (the subgraph holds every input)
    full = port.embed(*(torch.from_numpy(seg[k]) for k in
                        ("node_feats", "edge_src", "edge_dst", "edge_feats")))
    _close(got[torch.from_numpy(targets)], full[torch.from_numpy(targets)].float().numpy(),
           tol, "subset vs full")


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_probe_rtt_regressor_and_mse_match_reference(dtype_name):
    jdt, tdt, tol = DTYPES[dtype_name]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    y = rng.standard_normal(50).astype(np.float32)
    mask = (rng.random(50) > 0.3).astype(np.float32)
    model = ref_mlp.ProbeRTTRegressor(hidden_dim=HIDDEN, compute_dtype=jdt)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(2), x))
    port = ProbeRTTRegressor(HIDDEN, compute_dtype=tdt)
    port.load_state_dict(convert.mlp_params_from_flax(params))
    got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (50,)
    _close(got, model.apply(params, x), tol, "forward")
    for m in (None, mask):
        want = ref_mlp.mse_loss(model, params, x, y, None if m is None else jnp.asarray(m))
        loss = mse_loss(port, torch.from_numpy(x), torch.from_numpy(y),
                        None if m is None else torch.from_numpy(m))
        _close(loss, want, tol, "mse")


def test_probe_rtt_regressor_on_topology_pairs():
    """topology_to_pairs' 8 columns feed the regressor as they come."""
    from dragonfly2_tpu.records.schema import (DestHostRecord, NetworkStat,
                                               NetworkTopologyRecord, ProbesRecord,
                                               SrcHostRecord)

    recs = [NetworkTopologyRecord(
        id=f"r{i}", host=SrcHostRecord(id=f"s{i}", network=NetworkStat(idc="a")),
        dest_hosts=[DestHostRecord(id=f"d{j}", network=NetworkStat(idc="a" if j else "b"),
                                   probes=ProbesRecord(average_rtt=1_000_000 * (j + 1)))
                    for j in range(3)]) for i in range(4)]
    x, _ = topology_to_pairs(recs)
    model = ref_mlp.ProbeRTTRegressor(hidden_dim=HIDDEN, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(4), x))
    port = ProbeRTTRegressor(HIDDEN, compute_dtype=torch.float32)
    port.load_state_dict(convert.mlp_params_from_flax(params))
    _close(port(torch.from_numpy(x)), model.apply(params, x), FLOAT32_TOL)


def test_flax_round_trips_are_exact(trace):
    _, params, port, _, _ = _models("bfloat16", trace)
    back = convert.graphsage_params_to_flax(port)
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert "bias" not in back["params"]["sage_0"]["neigh"]
    assert "bias" not in back["params"]["sage_1"]["edge"]
    for model, to_flax, from_flax in (
        (GraphSAGERanker(16, 3), convert.graphsage_params_to_flax,
         convert.graphsage_params_from_flax),
        (ProbeRTTRegressor(16, 4), convert.mlp_params_to_flax, convert.mlp_params_from_flax),
    ):
        model.reset_parameters(torch.Generator().manual_seed(0))
        state = from_flax(to_flax(model))
        assert sorted(state) == sorted(model.state_dict())
        for key, value in model.state_dict().items():
            assert torch.equal(state[key], value), key


def test_init_is_flax_lecun_normal_from_the_generator():
    a = GraphSAGERanker(64).reset_parameters(torch.Generator().manual_seed(7))
    b = GraphSAGERanker(64).reset_parameters(torch.Generator().manual_seed(7))
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    w = a.head_1.weight.detach()
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std and 0.7 < float(w.std()) / (1.0 / w.shape[1]) ** 0.5 < 1.3
    assert a.head_1.bias.abs().sum() == 0 and a.sage_0.neigh.bias is None


def test_graph_inputs_match_reference(trace):
    ds, graph = trace
    e = len(graph.edge_src)
    assert data.edge_bucket(e) == ref_data.edge_bucket(e)
    assert data.DENSE_ADJ_MAX_NODES == ref_data.DENSE_ADJ_MAX_NODES
    for got, want in ((data.graph_arrays(graph, pad_edges_to=data.edge_bucket(e, 256)),
                       ref_data.graph_arrays(graph, pad_edges_to=ref_data.edge_bucket(e, 256))),
                      (data.graph_arrays(graph), ref_data.graph_arrays(graph)),
                      (data.dense_graph_arrays(graph), ref_data.dense_graph_arrays(graph))):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    got = list(data.rank_batches(ds, 48, np.random.default_rng(1)))
    want = list(ref_data.rank_batches(ds, 48, np.random.default_rng(1)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for field in ("child_idx", "parent_idx", "pair_feats", "throughput", "mask"):
            np.testing.assert_array_equal(getattr(g, field), np.asarray(getattr(w, field)))
