"""cluster/probes.py against dragonfly2_tpu/cluster/probes.py.

One seeded stream of ProbeFinished batches goes into both stores; held
exactly: the rings, cursors, counts, probed counts and the host mirror of
the averages (the fold rounds as the reference's does), the (B, K) RTT
gather, the least-probed picks for the same seed, the snapshot's records
and a warm pass from a scenario link model. The store runs on the CPU
here (``device="cpu"``); without CUDA the default device raises."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.cluster import probes as ref
from dragonfly2_tpu.records import synth as ref_synth
from dragonfly2_tpu.scenarios import builtin_scenarios as ref_scenarios
from dragonfly2_tpu.scenarios.engine import ScenarioEngine as RefEngine
from dragonfly2_tpu_torch.cluster import probes
from dragonfly2_tpu_torch.records import synth
from dragonfly2_tpu_torch.scenarios import builtin_scenarios
from dragonfly2_tpu_torch.scenarios.engine import ScenarioEngine
from dragonfly2_tpu_torch.utils import prng

HOSTS = 48


def _stores(max_pairs=512):
    return (probes.ProbeStore(max_pairs=max_pairs, max_hosts=HOSTS, device="cpu"),
            ref.ProbeStore(max_pairs=max_pairs, max_hosts=HOSTS))


def _fill(got, want, seed=0, batches=12):
    rng = np.random.default_rng(seed)
    for _ in range(batches):
        m = 16
        src = rng.integers(0, HOSTS, m)
        dst = rng.integers(0, HOSTS, m)
        rtt = (rng.lognormal(15, 1.5, m)).astype(np.float32)
        got.enqueue(src, dst, rtt)
        want.enqueue(src, dst, rtt)


def _assert_same_state(got, want):
    for name in ("ring", "cursor", "count", "probed_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.average.view(np.uint32), want.average.view(np.uint32))
    assert got._pair_index == want._pair_index
    assert got._pairs_by_src == want._pairs_by_src and got._pair_dst == want._pair_dst


def test_store_state_matches_reference_over_an_enqueue_stream():
    got, want = _stores()
    _fill(got, want)
    _assert_same_state(got, want)
    assert got.ring.device.type == "cpu" and got._next > 100


def test_gather_candidate_rtt_matches_reference():
    got, want = _stores()
    _fill(got, want, seed=1)
    rng = np.random.default_rng(2)
    child = rng.integers(0, HOSTS, 33)
    cand = rng.integers(0, HOSTS, (33, 15))
    g_avg, g_has = got.gather_candidate_rtt(child, cand)
    w_avg, w_has = want.gather_candidate_rtt(child, cand)
    np.testing.assert_array_equal(g_avg, w_avg)
    np.testing.assert_array_equal(g_has, w_has)
    assert g_has.any() and not g_has.all()
    empty = probes.ProbeStore(max_pairs=8, max_hosts=HOSTS, device="cpu")
    avg, has = empty.gather_candidate_rtt(child, cand)
    assert avg.shape == (33, 15) and not has.any()
    for s, d in list(want._pair_index)[:20]:
        assert got.average_rtt(s, d) == want.average_rtt(s, d)


@pytest.mark.parametrize("seed", [0, 7, 12345, 2**30 - 1])
def test_find_probed_hosts_matches_reference_for_the_same_seed(seed):
    got, want = _stores()
    _fill(got, want, seed=3, batches=4)
    alive = np.random.default_rng(seed % 97).random(HOSTS + 5) > 0.3  # longer than the table
    for k in (5, 50, 100):
        g = got.find_probed_hosts(alive, prng.key(seed), k=k)
        w = want.find_probed_hosts(alive, jax.random.key(seed), k=k)
        np.testing.assert_array_equal(g, np.asarray(w))
        assert len(g) == min(k, int(alive[:HOSTS].sum()))


def test_snapshot_records_match_reference():
    got, want = _stores()
    _fill(got, want, seed=4)
    host_info = {slot: {"id": f"host-{slot}", "hostname": f"h{slot}", "ip": f"10.0.0.{slot}",
                        "port": 8002, "type": "super" if slot % 7 == 0 else "normal",
                        "location": "a|b", "idc": f"idc{slot % 3}"}
                 for slot in range(HOSTS) if slot % 5}  # some hosts unknown
    g = got.snapshot(host_info, now_ns=123)
    w = want.snapshot(host_info, now_ns=123)
    assert g and [dataclasses.asdict(r) for r in g] == [dataclasses.asdict(r) for r in w]
    assert max(len(r.dest_hosts) for r in g) <= 5


def test_warm_from_link_model_matches_reference():
    hosts = synth.make_cluster(12, seed=0).hosts
    ref_hosts = ref_synth.make_cluster(12, seed=0).hosts
    eng = ScenarioEngine(builtin_scenarios()["bandwidth_skew"], hosts, seed=1)
    ref_eng = RefEngine(ref_scenarios()["bandwidth_skew"], ref_hosts, seed=1)
    got, want = _stores(max_pairs=256)
    n = probes.warm_from_link_model(got, [(h, i) for i, h in enumerate(hosts)], eng.rtt_ns,
                                    pairs_per_src=3)
    m = ref.warm_from_link_model(want, [(h, i) for i, h in enumerate(ref_hosts)],
                                 ref_eng.rtt_ns, pairs_per_src=3)
    assert n == m == 12 * 3
    _assert_same_state(got, want)
    assert (got.average[: got._next] > 0).all()
    assert probes.warm_from_link_model(got, [(hosts[0], 0)], eng.rtt_ns) == 0


def test_the_store_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probes.ProbeStore(max_pairs=8, max_hosts=8)
    store = probes.ProbeStore(max_pairs=8, max_hosts=8, device="cpu")
    store.enqueue(np.array([0]), np.array([1]), np.array([5.0], np.float32))
    with pytest.raises(RuntimeError, match="probe pair table full"):
        for d in range(2, 10):
            store.pair_index(0, d)
