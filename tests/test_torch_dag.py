"""The port's task DAG (graph/dag.py) and its native loader
(dragonfly2_tpu_torch/native) against the reference's: seeded edge
sequences with cycles, deletions and the batched legality paths give the
same accept/reject answers and the same adjacency, with the native library
and with the numpy BFS; the torch twins of batch_reachable and
batch_can_add_edge give the reference's answers and the TaskDAG's.
Tolerance: none (bool and int results)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu import native as ref_native
from dragonfly2_tpu.graph import dag as ref_dag
from dragonfly2_tpu_torch import native
from dragonfly2_tpu_torch.graph import dag


@pytest.fixture(params=["native", "numpy"])
def lib_mode(request, monkeypatch):
    """Both host paths: the native library, and the numpy BFS the DAG
    keeps where the library is absent."""
    if request.param == "native":
        assert native.ensure_built() and ref_native.ensure_built()
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    return request.param


def _same(port, ref):
    for name in ("adj", "present", "in_degree", "out_degree"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)


def _drive(d, rng, steps=600):
    """Seeded adds (many closing cycles), deletions and batched queries;
    returns every answer in order."""
    answers = []
    cap = d.capacity
    for v in range(0, cap, 3):
        d.add_vertex(v)
    for _ in range(steps):
        op = rng.random()
        u, v = (int(x) for x in rng.integers(0, cap, 2))
        if op < 0.55:
            try:
                d.add_edge(u, v)
                answers.append(("add", True))
            except dag.DAGError:
                answers.append(("add", False))
            except ref_dag.DAGError:
                answers.append(("add", False))
        elif op < 0.62:
            d.ensure_vertex(u)
        elif op < 0.66:
            d.delete_vertex(u)
        elif op < 0.70:
            d.delete_in_edges(u)
        elif op < 0.73:
            d.delete_out_edges(u)
        elif op < 0.78:
            d.delete_edge(u, v)
        elif op < 0.86:
            n = int(rng.integers(1, 70))  # both sides of the scalar/vector cut at 32
            parents = rng.integers(-2, cap + 2, n)
            children = rng.integers(-2, cap + 2, n)
            answers.append(("pairs", d.can_add_edges_pairs(parents, children).tolist()))
        elif op < 0.90:
            answers.append(("reach", d.reachable(u, v)))
        elif op < 0.95:
            groups = [rng.integers(0, cap, int(rng.integers(0, 6))) for _ in range(3)]
            children = rng.choice(cap, 3, replace=False)
            answers.append(("grouped", [g.tolist() for g in d.add_edges_grouped(groups, children)]))
        else:
            parents = [int(x) for x in rng.integers(-1, cap + 1, int(rng.integers(0, 6)))]
            answers.append(("single", d.add_edges_single(parents, u)))
    answers.append(("from", d.add_edges_from(rng.integers(0, cap, 8), int(rng.integers(cap))).tolist()))
    answers.append(("counts", d.vertex_count(), d.edge_count()))
    return answers


@pytest.mark.parametrize("seed", [0, 1])
def test_task_dag_matches_the_reference(lib_mode, seed):
    port, ref = dag.TaskDAG(128), ref_dag.TaskDAG(128)
    got = _drive(port, np.random.default_rng(seed))
    want = _drive(ref, np.random.default_rng(seed))
    assert got == want
    assert sum(1 for a in got if a == ("add", False)) > 10  # cycles and duplicates were refused
    _same(port, ref)
    rng = np.random.default_rng(seed)
    assert (sorted(port.random_vertices(10, np.random.default_rng(1)).tolist())
            == sorted(ref.random_vertices(10, np.random.default_rng(1)).tolist()))
    for _ in range(50):
        u, v = (int(x) for x in rng.integers(0, 128, 2))
        assert port.can_add_edge(u, v) == ref.can_add_edge(u, v)


def test_capacity_must_be_a_multiple_of_64():
    with pytest.raises(ValueError):
        dag.TaskDAG(100)


def test_native_loader_builds_into_the_port(tmp_path):
    assert native.available()
    path = native._lib_path()
    assert path.parent.name == "_build" and path.parent.parent.name == "dragonfly2_tpu_torch"
    assert path.exists()
    rng = np.random.default_rng(3)
    d = dag.TaskDAG(64)
    for v in range(64):
        d.add_vertex(v)
    for u, v in rng.integers(0, 64, (90, 2)):
        if d.can_add_edge(int(u), int(v)):
            d.add_edge(int(u), int(v))
    srcs, dsts = rng.integers(0, 64, 200), rng.integers(0, 64, 200)
    got = native.dag_reachable_batch(d.adj, srcs, dsts)
    np.testing.assert_array_equal(got, ref_native.dag_reachable_batch(d.adj, srcs, dsts))
    assert got.any() and not got.all()
    assert native.dag_reachable(d.adj, int(srcs[0]), int(dsts[0])) == bool(got[0])
    with pytest.raises(ValueError, match="out of range"):
        native.dag_reachable_batch(d.adj, np.array([64]), np.array([0]))


def _random_graphs(rng, b, p, density):
    adj = rng.random((b, p, p)) < density
    adj &= np.triu(np.ones((p, p), bool), 1)[None]  # acyclic, like a task DAG
    return adj, rng.random((b, p)) < 0.9


@pytest.mark.parametrize("max_depth", [0, 3])
def test_batch_twins_match_the_reference(max_depth):
    rng = np.random.default_rng(7 + max_depth)
    b, p, q = 4, 64, 9
    adj, present = _random_graphs(rng, b, p, 0.04)
    src = rng.integers(-2, p + 2, (b, q)).astype(np.int32)  # out of range too
    dst = rng.integers(-2, p + 2, (b, q)).astype(np.int32)
    want = np.asarray(ref_dag.batch_reachable(jnp.asarray(adj), jnp.asarray(src),
                                              jnp.asarray(dst), max_depth=max_depth))
    got = dag.batch_reachable(torch.from_numpy(adj), torch.from_numpy(src),
                              torch.from_numpy(dst), max_depth=max_depth)
    np.testing.assert_array_equal(got.numpy(), want)
    parent = rng.integers(-2, p + 2, (b, q)).astype(np.int32)
    child = rng.integers(-1, p + 1, b).astype(np.int32)
    want = np.asarray(ref_dag.batch_can_add_edge(jnp.asarray(adj), jnp.asarray(present),
                                                 jnp.asarray(parent), jnp.asarray(child),
                                                 max_depth=max_depth))
    got = dag.batch_can_add_edge(torch.from_numpy(adj), torch.from_numpy(present),
                                 torch.from_numpy(parent), torch.from_numpy(child),
                                 max_depth=max_depth)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_twins_agree_with_the_task_dags():
    """stacked_adjacency of live TaskDAGs, through the twins, gives each
    DAG's own can_add_edge answers (native cycle checks)."""
    rng = np.random.default_rng(11)
    dags = []
    for _ in range(3):
        d = dag.TaskDAG(64)
        for v in range(60):
            d.add_vertex(v)
        for u, v in rng.integers(0, 60, (150, 2)):
            if d.can_add_edge(int(u), int(v)):
                d.add_edge(int(u), int(v))
        dags.append(d)
    adj, present = dag.stacked_adjacency(dags, device="cpu")
    assert adj.shape == (3, 64, 64) and adj.dtype == torch.bool
    parent = rng.integers(0, 64, (3, 12))
    child = rng.integers(0, 64, 3)
    got = dag.batch_can_add_edge(adj, present, torch.from_numpy(parent), torch.from_numpy(child))
    want = np.array([[d.can_add_edge(int(p), int(c)) for p in row]
                     for d, row, c in zip(dags, parent, child)])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.stack([d.can_add_edges_pairs(row, np.full(12, c))
                               for d, row, c in zip(dags, parent, child)]))
