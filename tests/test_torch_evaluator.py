"""The port's rule-arm evaluator (ops/evaluator.py) and evaluator batch
(records/features.py) against the reference's, on tests/test_evaluator.py's
batch fixture built by both packages from the same seeds.

Tolerance: selections, indices, masks, packed bytes and every int field
identical; scores within 1e-6 (the reference's jitted programs may fuse a
multiply and an add into one rounding on its CPU backend)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import evaluator as ref
from dragonfly2_tpu.records import features as ref_features
from dragonfly2_tpu.records import synth as ref_synth
from dragonfly2_tpu_torch.ops import evaluator as ev
from dragonfly2_tpu_torch.records import features, synth

SCORE_ATOL = 1e-6
ALGORITHMS = ("default", "nt")


def _fixture(module_synth, module_features):
    cluster = module_synth.make_cluster(64, seed=7)
    records = module_synth.gen_download_records(cluster, 32)
    feats = module_features.downloads_to_eval_batch(records, batch_tasks=32, batch_candidates=20)
    rng = np.random.default_rng(1)
    feats.peer_state = rng.integers(0, 10, feats.peer_state.shape).astype(np.int8)
    feats.has_rtt = rng.random(feats.has_rtt.shape) < 0.5
    feats.avg_rtt_ns = (rng.random(feats.avg_rtt_ns.shape) * 2e9).astype(np.float32)
    zero = rng.random(feats.upload_limit.shape) < 0.1
    feats.upload_limit[zero] = 0
    return feats


@pytest.fixture(scope="module")
def batch():
    """tests/test_evaluator.py's fixture, from the port's synth and
    features: (numpy dict, port tensors)."""
    fd = _fixture(synth, features).as_dict()
    return fd, ev.feats_to_tensors(fd, "cpu")


@pytest.fixture(scope="module")
def aux(batch):
    fd, _ = batch
    rng = np.random.default_rng(5)
    b, k = fd["valid"].shape
    return {"blocklist": rng.random((b, k)) < 0.2,
            "in_degree": rng.integers(0, 3, (b, k)).astype(np.int32),
            "can_add_edge": rng.random((b, k)) < 0.8}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_eval_batch_matches_the_reference(batch):
    fd, _ = batch
    want = _fixture(ref_synth, ref_features).as_dict()
    assert list(fd) == list(want)
    for name, value in want.items():
        assert fd[name].dtype == value.dtype, name
        np.testing.assert_array_equal(fd[name], value, err_msg=name)


def test_topology_pairs_match_the_reference():
    from dragonfly2_tpu.records import schema as ref_schema
    from dragonfly2_tpu_torch.records import schema

    def records(mod):
        rng = np.random.default_rng(4)
        out = []
        for i in range(6):
            src = mod.SrcHostRecord(id=f"h{i}", type="super" if i % 3 == 0 else "normal")
            src.network.idc = f"idc-{i % 2}"
            src.network.location = f"as|cn|z{i % 3}"
            src.network.tcp_connection_count = int(rng.integers(0, 50))
            dests = []
            for j in range(4):
                dst = mod.DestHostRecord(id=f"d{i}-{j}", type="normal")
                dst.network.idc = f"idc-{j % 2}"
                dst.network.location = f"as|cn|z{j % 3}"
                dst.network.upload_tcp_connection_count = int(rng.integers(0, 9))
                dst.probes.average_rtt = int(rng.integers(-1, 3)) * 1_500_000
                dests.append(dst)
            out.append(mod.NetworkTopologyRecord(id=f"t{i}", host=src, dest_hosts=dests))
        return out

    x, y = features.topology_to_pairs(records(schema))
    rx, ry = ref_features.topology_to_pairs(records(ref_schema))
    assert features.NUM_PAIR_FEATURES == ref_features.NUM_PAIR_FEATURES
    assert x.shape[1] == features.NUM_PAIR_FEATURES and 0 < x.shape[0] < 24  # rtt <= 0 skipped
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)


def test_per_feature_scores_match(batch):
    fd, t = batch
    cases = [
        ("piece_score", ("finished_pieces", "child_finished_pieces", "total_piece_count")),
        ("upload_success_score", ("upload_count", "upload_failed_count")),
        ("free_upload_score", ("upload_limit", "upload_used")),
        ("host_type_score", ("host_type", "peer_state")),
        ("idc_affinity_score", ("parent_idc", "child_idc")),
        ("location_affinity_score", ("parent_location", "child_location")),
        ("probe_score", ("avg_rtt_ns", "has_rtt")),
    ]
    for fn, names in cases:
        want = np.asarray(getattr(ref, fn)(*(jnp.asarray(fd[n]) for n in names)))
        got = getattr(ev, fn)(*(t[n] for n in names)).numpy()
        assert got.dtype == want.dtype == np.float32, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_evaluate_matches(batch, algorithm):
    fd, t = batch
    want = np.asarray(ref.evaluate(fd, algorithm))
    got = ev.evaluate(t, algorithm).numpy()
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)


def test_is_bad_node_matches_both_branches(batch):
    fd, t = batch
    want = np.asarray(ref.is_bad_node(fd["piece_costs"], fd["piece_cost_count"], fd["peer_state"]))
    got = ev.is_bad_node(t["piece_costs"], t["piece_cost_count"], t["peer_state"]).numpy()
    np.testing.assert_array_equal(got, want)
    # nanosecond-scale rings at every count, both the 20x-mean branch and
    # the 3-sigma one, with outliers planted at the newest slot
    rng = np.random.default_rng(3)
    costs = rng.lognormal(20, 0.3, (256, 32, 32)).astype(np.float32)
    count = rng.integers(0, 33, (256, 32)).astype(np.int32)
    rows = np.arange(256)[:, None]
    newest = np.maximum(count - 1, 0)
    costs[rows, np.arange(32), newest] *= rng.choice([1.0, 2.0, 4.0, 25.0], (256, 32))
    state = rng.choice([5, 6, 7, 0, 8], (256, 32)).astype(np.int8)
    want = np.asarray(ref.is_bad_node(costs, count, state))
    got = ev.is_bad_node(_t(costs), _t(count), _t(state)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want[state == 5].mean() < 1  # both verdicts present among running peers


@pytest.mark.parametrize("with_aux", [False, True])
def test_filter_candidates_matches(batch, aux, with_aux):
    fd, t = batch
    args = (aux["blocklist"], aux["in_degree"], aux["can_add_edge"]) if with_aux else ()
    want = np.asarray(ref.filter_candidates(fd, *args))
    got = ev.filter_candidates(t, *(_t(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)


def _assert_selection(got, want):
    idx, valid, scores = ev.unpack_selection(got)
    ridx, rvalid, rscores = ref.unpack_selection(want)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(valid, rvalid)
    np.testing.assert_allclose(scores[valid], rscores[rvalid], atol=SCORE_ATOL, rtol=0)
    assert np.isneginf(scores[~valid]).all() and np.isneginf(rscores[~rvalid]).all()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_schedule_candidate_parents_and_packed_match(batch, aux, algorithm):
    fd, t = batch
    ta = {name: _t(a) for name, a in aux.items()}
    for args, targs in (((), ()), ((aux["blocklist"], aux["in_degree"], aux["can_add_edge"]),
                                   (ta["blocklist"], ta["in_degree"], ta["can_add_edge"]))):
        want = ref.schedule_candidate_parents(fd, *args, algorithm=algorithm, limit=4)
        got = ev.schedule_candidate_parents(t, *targs, algorithm=algorithm, limit=4)
        for name in ("mask", "selected", "selected_valid"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                                   atol=SCORE_ATOL, rtol=0)
        valid = np.asarray(want["selected_valid"])
        np.testing.assert_allclose(got["selected_scores"].numpy()[valid],
                                   np.asarray(want["selected_scores"])[valid],
                                   atol=SCORE_ATOL, rtol=0)
        _assert_selection(
            ev.schedule_candidate_parents_packed(t, *targs, algorithm=algorithm, limit=4).numpy(),
            np.asarray(ref.schedule_candidate_parents_packed(fd, *args, algorithm=algorithm,
                                                             limit=4)))


def test_select_with_scores_matches_with_hostile_scores(batch, aux):
    fd, t = batch
    rng = np.random.default_rng(3)
    scores = rng.random(fd["valid"].shape).astype(np.float32)
    scores[::3, 0] = np.nan
    scores[1::3, 1] = -np.inf
    scores[2::3, 2] = np.inf
    want = ref.select_with_scores(fd, scores, aux["blocklist"], limit=4)
    got = ev.select_with_scores(t, _t(scores), _t(aux["blocklist"]), limit=4)
    for name in ("mask", "selected", "selected_valid", "selected_scores"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    _assert_selection(ev.select_with_scores_packed(t, _t(scores), limit=4).numpy(),
                      np.asarray(ref.select_with_scores_packed(fd, scores, limit=4)))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_find_success_parent_matches(batch, aux, algorithm):
    fd, t = batch
    want = ref.find_success_parent(fd, None, aux["in_degree"], algorithm=algorithm)
    got = ev.find_success_parent(t, None, _t(aux["in_degree"]), algorithm=algorithm)
    np.testing.assert_array_equal(got["found"].numpy(), np.asarray(want["found"]))
    found = np.asarray(want["found"])
    assert found.any()
    np.testing.assert_array_equal(got["parent"].numpy()[found], np.asarray(want["parent"])[found])
    np.testing.assert_allclose(got["score"].numpy()[found], np.asarray(want["score"])[found],
                               atol=SCORE_ATOL, rtol=0)


def test_pack_selection_round_trip():
    rng = np.random.default_rng(8)
    values = rng.random((6, 4)).astype(np.float32)
    indices = rng.integers(0, 20, (6, 4)).astype(np.int32)
    valid = rng.random((6, 4)) < 0.6
    want = np.asarray(ref._pack_selection(jnp.asarray(values), jnp.asarray(indices),
                                          jnp.asarray(valid)))
    got = ev._pack_selection(_t(values), _t(indices), _t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    idx, ok, vals = ev.unpack_selection(got)
    assert torch.equal(ok, _t(valid)) and torch.equal(idx[ok], _t(indices)[ok])
    assert torch.equal(vals, _t(values))


def _padded(fd, rows):
    """The fixture padded to a bucket row count (pad rows valid=False): the
    reference's packed entry only ever sees the scheduler's buckets."""
    return {name: np.concatenate([v, np.zeros((rows - v.shape[0],) + v.shape[1:], v.dtype)])
            for name, v in fd.items()}


def test_pack_eval_batch_is_byte_identical(batch, aux):
    fd, _ = batch
    b, k = fd["valid"].shape
    extras = dict(aux, child_host_slot=np.arange(b, dtype=np.int32),
                  cand_host_slot=np.tile(np.arange(k, dtype=np.int32), (b, 1)))
    for kwargs in ({}, extras):
        got = ev.pack_eval_batch(fd, **kwargs)
        want = ref.pack_eval_batch(fd, **kwargs)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    c, l, n = (fd["piece_costs"].shape[-1], fd["parent_location"].shape[-1],
               fd["numeric"].shape[-1])
    assert ev._packed_layout(b, k, c, l, n) == ref._packed_layout(b, k, c, l, n)
    # the unpack: bit casts back to every field (int64 as its int32 wrap)
    out = ev.unpack_eval_batch(_t(ev.pack_eval_batch(fd, **extras)), b, k, c, l, n)
    for name, want in fd.items():
        want = want.astype(np.int32) if want.dtype == np.int64 else want
        np.testing.assert_array_equal(out[name].numpy().astype(want.dtype), want, err_msg=name)
    for name in ("blocklist", "in_degree", "can_add_edge", "child_host_slot", "cand_host_slot"):
        np.testing.assert_array_equal(out[name].numpy(), extras[name], err_msg=name)


def test_int64_identity_fields_wrap_like_the_reference(batch):
    """Host id hashes above 2^31 reach the device as numpy's C wrap of
    int64 to int32, in the dict path and in the packed transport alike."""
    fd, _ = batch
    fd = {name: v.copy() for name, v in fd.items()}
    fd["parent_host_id"][:, 0] = (1 << 31) + 7 + np.arange(fd["valid"].shape[0])
    fd["child_host_id"][:] = (1 << 33) + 7 + np.arange(fd["valid"].shape[0])  # low words differ
    t = ev.feats_to_tensors(fd, "cpu")
    assert t["parent_host_id"].dtype == torch.int32
    np.testing.assert_array_equal(t["parent_host_id"].numpy(), fd["parent_host_id"].astype(np.int32))
    np.testing.assert_array_equal(ev.filter_candidates(t).numpy(),
                                  np.asarray(ref.filter_candidates(fd)))
    b, k = fd["valid"].shape
    c, l, n = (fd["piece_costs"].shape[-1], fd["parent_location"].shape[-1],
               fd["numeric"].shape[-1])
    out = ev.unpack_eval_batch(_t(ev.pack_eval_batch(fd)), b, k, c, l, n)
    np.testing.assert_array_equal(out["child_host_id"].numpy(), fd["child_host_id"].astype(np.int32))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_schedule_from_packed_matches(batch, aux, algorithm):
    fd, _ = batch
    fd = _padded(fd, 64)
    b, k = fd["valid"].shape
    c, l, n = (fd["piece_costs"].shape[-1], fd["parent_location"].shape[-1],
               fd["numeric"].shape[-1])
    extra = {name: np.concatenate([a, np.zeros((b - a.shape[0], k), a.dtype)])
             for name, a in aux.items()}
    for limit in (4, 15):
        buf = ev.pack_eval_batch(fd, **extra)
        got = ev.schedule_from_packed(buf, b, k, c, l, n, algorithm=algorithm, limit=limit,
                                      device="cpu")
        want = np.asarray(ref.schedule_from_packed(buf.copy(), b, k, c, l, n,
                                                   algorithm=algorithm, limit=limit))
        assert got.shape == (b, limit, 2) and got.dtype == torch.float32
        _assert_selection(got.numpy(), want)
        # the same buffer already on the device runs where it lies
        again = ev.schedule_from_packed(_t(buf), b, k, c, l, n, algorithm=algorithm, limit=limit)
        assert torch.equal(again, got)
        # and the dict transport selects the same parents
        direct = ev.schedule_candidate_parents_packed(
            ev.feats_to_tensors(fd, "cpu"), *(_t(extra[x]) for x in
                                              ("blocklist", "in_degree", "can_add_edge")),
            algorithm=algorithm, limit=limit)
        assert torch.equal(direct, got)


def test_schedule_from_packed_runs_on_the_card_unless_asked_for_the_cpu(batch):
    fd, _ = batch
    buf = ev.pack_eval_batch(_padded(fd, 64))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ev.schedule_from_packed(buf, 64, 20, 32, 5, 12)
