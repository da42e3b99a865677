"""The port's SoA cluster state (state/cluster.py) against the reference's:
the same scripted mutations applied to both packages give identical
columns, free lists, id maps, dirty tracking and host epochs, and
gather_candidates gives identical features. Tolerance: none (numpy on both
sides); the wall-clock ``*_updated_at`` columns are compared only where a
script pins them."""

import numpy as np
import pytest

from dragonfly2_tpu.state import cluster as ref_cluster
from dragonfly2_tpu.state.fsm import PeerEvent as RefPeerEvent
from dragonfly2_tpu_torch.state import cluster
from dragonfly2_tpu_torch.state.fsm import HostType, PeerEvent, TaskEvent

CLOCK_COLUMNS = ("host_updated_at", "task_updated_at", "peer_updated_at")

# valid event paths from PENDING, by name (the FSM allows each in order)
_PATHS = (
    ("REGISTER_NORMAL", "DOWNLOAD", "DOWNLOAD_SUCCEEDED"),
    ("REGISTER_SMALL", "DOWNLOAD_BACK_TO_SOURCE", "DOWNLOAD_SUCCEEDED", "DOWNLOAD_FAILED"),
    ("REGISTER_TINY", "DOWNLOAD", "LEAVE"),
    ("REGISTER_EMPTY",),
    (),
)


def _script(state, fsm, seed: int, steps: int = 400):
    """A seeded sequence of every mutator, the same on either package's
    ClusterState (numpy draws only, so both see the same calls)."""
    rng = np.random.default_rng(seed)
    hosts, tasks, peers = [], [], []
    for i in range(24):
        loc = rng.integers(0, 4, cluster.MAX_LOC) if i % 4 else None
        state.upsert_host(
            f"h{i}", id_hash=int(rng.integers(1, 1 << 62)),
            host_type=fsm.HostType(int(rng.integers(0, 4))), idc=int(rng.integers(0, 3)),
            location=loc, upload_limit=int(rng.integers(0, 60)),
            upload_count=int(rng.integers(0, 1 << 40)), upload_failed=int(rng.integers(0, 9)),
            numeric=rng.random(cluster.NUM_HOST_FEATURES).astype(np.float32) if i % 3 else None,
        )
        hosts.append(f"h{i}")
    for i in range(6):
        state.upsert_task(f"t{i}", total_pieces=int(rng.integers(0, 64)),
                          content_length=int(rng.integers(0, 1 << 34)))
        tasks.append(f"t{i}")
    for step in range(steps):
        op = int(rng.integers(0, 10))
        if op <= 2 or not peers:
            pid = f"p{step}"
            live_hosts = [h for h in hosts if state.host_index(h) is not None]
            state.add_peer(pid, state.task_index(tasks[int(rng.integers(len(tasks)))]),
                           state.host_index(live_hosts[int(rng.integers(len(live_hosts)))]))
            path = _PATHS[int(rng.integers(len(_PATHS)))]
            for name in path[: int(rng.integers(0, len(path) + 1))]:
                state.peer_event(state.peer_index(pid), fsm.PeerEvent[name])
            peers.append(pid)
        elif op == 3:
            idx = state.peer_index(peers[int(rng.integers(len(peers)))])
            if idx is not None:
                state.record_piece(idx, int(rng.integers(0, 200)), float(rng.lognormal(18, 1)))
        elif op == 4:
            live = [state.peer_index(p) for p in peers if state.peer_index(p) is not None]
            if live:
                n = int(rng.integers(1, 80))
                who = np.asarray(live)[rng.integers(0, len(live), n)]
                if rng.random() < 0.3:
                    who[:] = who[0]  # the single-peer batch shape
                state.record_pieces_batch(who, rng.integers(0, 300, n),
                                          rng.lognormal(18, 1, n).astype(np.float32), now=1000.0)
        elif op == 5:
            idx = state.peer_index(peers[int(rng.integers(len(peers)))])
            if idx is not None:
                state.adopt_pieces(idx, rng.integers(0, 4200, int(rng.integers(0, 9))).tolist())
        elif op == 6:
            state.remove_peer(peers.pop(int(rng.integers(len(peers)))))
        elif op == 7:
            i = int(rng.integers(len(hosts)))
            if rng.random() < 0.5:
                state.remove_host(hosts[i])
            else:
                state.upsert_host(hosts[i], id_hash=int(rng.integers(1, 1 << 62)),
                                  upload_limit=int(rng.integers(1, 60)))
        elif op == 8:
            t = state.task_index(tasks[int(rng.integers(len(tasks)))])
            event = ("DOWNLOAD_SUCCEEDED" if state.task_state[t] == 1 else "DOWNLOAD")
            state.task_event(t, fsm.TaskEvent[event])
        else:
            state.host_upload_used[int(rng.integers(state.max_hosts))] = int(rng.integers(0, 5))
    state.peer_updated_at[:] = 0.0
    for i, pid in enumerate(peers):
        idx = state.peer_index(pid)
        if idx is not None:
            state.peer_updated_at[idx] = 100.0 * (i % 3)
    reaped = state.gc_peers(ttl_seconds=150.0, now=300.0)
    return reaped


class _RefFSM:
    from dragonfly2_tpu.state.fsm import HostType, PeerEvent, TaskEvent  # noqa: F401


class _PortFSM:
    HostType, PeerEvent, TaskEvent = HostType, PeerEvent, TaskEvent


def _states(seed, **dims):
    ref = ref_cluster.ClusterState(**dims)
    port = cluster.ClusterState(**dims)
    assert _script(ref, _RefFSM, seed) == _script(port, _PortFSM, seed)
    return ref, port


def _columns(state):
    return {name: v for name, v in vars(state).items() if isinstance(v, np.ndarray)}


DIMS = dict(max_hosts=32, max_tasks=8, max_peers=160, piece_bitset_words=64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_mutations_give_identical_columns(seed):
    ref, port = _states(seed, **DIMS)
    want, got = _columns(ref), _columns(port)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if name in CLOCK_COLUMNS[:2]:
            continue  # wall clock, unpinned
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert port.host_epoch == ref.host_epoch
    assert port.counts() == ref.counts()
    assert port._peer_by_id == ref._peer_by_id and port._host_by_id == ref._host_by_id
    assert port._task_by_id == ref._task_by_id
    assert port._peer_free._free == ref._peer_free._free
    assert port.peer_dirty.any()
    for idx in range(DIMS["max_peers"]):
        np.testing.assert_array_equal(port.peer_piece_costs_ordered(idx),
                                      ref.peer_piece_costs_ordered(idx))
        np.testing.assert_array_equal(port.peer_finished_pieces(idx),
                                      ref.peer_finished_pieces(idx))


def test_gather_candidates_is_identical():
    ref, port = _states(4, **DIMS)
    rng = np.random.default_rng(4)
    live = np.flatnonzero(port.peer_alive)
    b, k = 16, 15
    child = live[rng.integers(0, live.size, b)]
    cand = rng.integers(0, DIMS["max_peers"], (b, k))
    valid = rng.random((b, k)) < 0.7
    rtt = (rng.random((b, k)) * 1e9).astype(np.float64)
    has = rng.random((b, k)) < 0.5
    for args in ((child, cand, valid), (child, cand, valid, rtt, has)):
        got = port.gather_candidates(*args).as_dict()
        want = ref.gather_candidates(*args).as_dict()
        assert list(got) == list(want)
        for name, value in want.items():
            assert got[name].dtype == value.dtype, name
            np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_ordered_costs_batch_is_identical():
    rng = np.random.default_rng(6)
    costs = rng.random((40, 7, 32)).astype(np.float32)
    cursor = rng.integers(0, 32, (40, 7))
    count = rng.integers(0, 33, (40, 7))
    np.testing.assert_array_equal(cluster._ordered_costs_batch(costs, cursor, count, 32),
                                  ref_cluster._ordered_costs_batch(costs, cursor, count, 32))


def test_capacity_and_fsm_errors_match():
    for module in (ref_cluster, cluster):
        s = module.ClusterState(max_hosts=2, max_tasks=2, max_peers=2)
        s.upsert_host("a", id_hash=1)
        s.upsert_host("b", id_hash=2)
        with pytest.raises(module.CapacityError):
            s.upsert_host("c", id_hash=3)
    s = cluster.ClusterState(max_hosts=2, max_tasks=2, max_peers=2)
    p = s.add_peer("p", s.upsert_task("t"), s.upsert_host("h", id_hash=1))
    from dragonfly2_tpu_torch.state.fsm import InvalidTransition

    with pytest.raises(InvalidTransition):
        s.peer_event(p, PeerEvent.DOWNLOAD_SUCCEEDED)
    assert RefPeerEvent.DOWNLOAD_SUCCEEDED == PeerEvent.DOWNLOAD_SUCCEEDED
