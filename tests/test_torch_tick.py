"""The port's fused tick (ops/tick.py) against the reference's.

The reference SchedulerService drives ClusterSimulator as
tests/test_fused_tick.py does (topologies None, bandwidth_skew and chaos,
seeds 3 and 17); every chunk it sends through
``dragonfly2_tpu.ops.tick.fused_tick_chunk`` is recorded (monkeypatched
here, in the test only) with its staging buffer and mirrored columns, and
fed to the port's twin on the CPU. The flat outputs must be identical: the
selection indices, every int segment and the shadow buffer byte for byte,
the scores and ledger floats within 1e-6. The mirror, the host halves of
the transport and the traps where the reference's semantics differ from
torch's defaults are pinned on their own.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import evaluator as ref_ev
from dragonfly2_tpu.ops import tick as ref_tick
from dragonfly2_tpu.state import cluster as ref_cluster
from dragonfly2_tpu_torch.cluster import scheduler as port_scheduler
from dragonfly2_tpu_torch.ops import evaluator as ev
from dragonfly2_tpu_torch.ops import tick
from dragonfly2_tpu_torch.state import cluster

FLOAT_ATOL = 1e-6


def _port_cols(cols: dict) -> dict:
    return {name: torch.from_numpy(np.array(v, copy=True)) for name, v in cols.items()}


def _compare_out(got: np.ndarray, want: np.ndarray, b, k, limit, emit_led, where=""):
    """Int segments byte for byte, float segments within FLOAT_ATOL, and
    the selection's indices (channel 0) exactly."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32, where
    g = tick.decode_out(got, b, k, limit, emit_led)
    w = ref_tick.decode_out(want, b, k, limit, emit_led)
    for name, value in w.items():
        if value.dtype == np.int32:
            np.testing.assert_array_equal(g[name], value, err_msg=f"{where} {name}")
    np.testing.assert_array_equal(g["selection"][..., 0], w["selection"][..., 0],
                                  err_msg=f"{where} selected indices")
    valid = w["selection"][..., 0] >= 0
    np.testing.assert_allclose(g["selection"][..., 1][valid], w["selection"][..., 1][valid],
                               atol=FLOAT_ATOL, rtol=0, err_msg=f"{where} scores")
    assert np.isneginf(g["selection"][..., 1][~valid]).all()
    if emit_led:
        np.testing.assert_allclose(g["led_feats"], w["led_feats"], atol=FLOAT_ATOL, rtol=0,
                                   err_msg=f"{where} led_feats")


def _run_sim(topology, seed, rounds=10):
    from dragonfly2_tpu.cluster.scheduler import SchedulerService
    from dragonfly2_tpu.cluster.simulator import ClusterSimulator
    from dragonfly2_tpu.config.config import Config
    from dragonfly2_tpu.scenarios import builtin_scenarios

    cfg = Config()
    cfg.scheduler.vectorized_control = True
    cfg.scheduler.fused_tick = True
    svc = SchedulerService(config=cfg, seed=seed + 100)
    assert svc._tick_mirror is not None
    sim = ClusterSimulator(svc, num_hosts=40, num_tasks=5, seed=seed,
                           scenario=builtin_scenarios()[topology] if topology else None,
                           deterministic_peer_ids=True)
    for _ in range(rounds):
        sim.run_round(new_downloads=5)
    return svc


@pytest.mark.parametrize("topology", [None, "bandwidth_skew", "chaos"])
def test_recorded_chunks_match_the_reference(topology, monkeypatch):
    real = ref_tick.fused_tick_chunk
    seen = {"chunks": 0, "selected": 0}

    def spy(inbuf, cols, *args, **kwargs):
        staged = inbuf.copy()  # the reference freezes the buffer it is given
        cols_np = {name: np.asarray(v) for name, v in cols.items()}
        out = real(inbuf, cols, *args, **kwargs)
        want = np.array(out[0] if isinstance(out, tuple) else out)
        b, k, c, l, n = args
        emit_led = kwargs.get("emit_led", True)
        limit = kwargs["limit"]
        algorithm = kwargs.get("algorithm", "default")
        pcols = _port_cols(cols_np)
        where = f"{topology} chunk {seen['chunks']}"
        got = tick.fused_tick_chunk(staged.copy(), pcols, b, k, c, l, n, algorithm=algorithm,
                                    limit=limit, emit_led=emit_led)
        _compare_out(got.numpy(), want, b, k, limit, emit_led, where)
        # the shadow transport: both programs' device-built buffers, byte
        # for byte, and the packed path on them gives the fused selection
        want_out, want_buf = real(staged.copy(), cols, b, k, c, l, n, algorithm=algorithm,
                                  limit=limit, emit_led=True, emit_packed=True)
        got_out, got_buf = tick.fused_tick_chunk(staged.copy(), pcols, b, k, c, l, n,
                                                 algorithm=algorithm, limit=limit,
                                                 emit_led=True, emit_packed=True)
        assert got_buf.dtype == torch.uint8
        np.testing.assert_array_equal(got_buf.numpy(), np.asarray(want_buf), err_msg=where)
        _compare_out(got_out.numpy(), np.asarray(want_out), b, k, limit, True, where)
        shadow = ev.schedule_from_packed(got_buf, b, k, c, l, n, algorithm=algorithm,
                                         limit=limit)
        fused = tick.decode_out(got_out.numpy(), b, k, limit, True)["selection"]
        np.testing.assert_array_equal(shadow.numpy(), fused, err_msg=f"{where} shadow")
        ref_shadow = np.asarray(ref_ev.schedule_from_packed(np.asarray(want_buf).copy(), b, k,
                                                            c, l, n, algorithm=algorithm,
                                                            limit=limit))
        np.testing.assert_array_equal(shadow.numpy()[..., 0], ref_shadow[..., 0])
        seen["chunks"] += 1
        seen["selected"] += int((fused[..., 0] >= 0).sum())
        return out

    monkeypatch.setattr(ref_tick, "fused_tick_chunk", spy)
    for seed in (3, 17):
        _run_sim(topology, seed)
    assert seen["chunks"] >= 20 and seen["selected"] > 0, seen


# ------------------------------------------------------------ the mirror


def copy_state(src, module):
    """A ClusterState of ``module`` holding every column, id map and free
    list of ``src``: what puts both packages on the same inputs."""
    dst = module.ClusterState(max_hosts=src.max_hosts, max_tasks=src.max_tasks,
                              max_peers=src.max_peers,
                              piece_cost_capacity=src.piece_cost_capacity,
                              piece_bitset_words=src.piece_bitset_words)
    for name, value in vars(src).items():
        if isinstance(value, np.ndarray):
            getattr(dst, name)[...] = value
    for name in ("_host_by_id", "_task_by_id", "_peer_by_id"):
        setattr(dst, name, dict(getattr(src, name)))
    for name in ("_host_id", "_task_id", "_peer_id"):
        setattr(dst, name, list(getattr(src, name)))
    for name in ("_host_free", "_task_free", "_peer_free"):
        getattr(dst, name)._free = list(getattr(src, name)._free)
    dst.host_epoch = src.host_epoch
    return dst


def _assert_cols_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        value = np.asarray(value)
        assert got[name].numpy().dtype == value.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)


@pytest.fixture(scope="module")
def sim_service():
    return _run_sim("chaos", 3, rounds=6)


def test_mirror_sync_matches_the_reference(sim_service):
    """A fresh mirror of each package over the same state (every peer row
    and task dirty), then the same mutations and an incremental sync."""
    svc = sim_service
    ref_state, state = copy_state(svc.state, ref_cluster), copy_state(svc.state, cluster)
    # identity hashes above 2^31: the mirrors wrap them to int32 alike
    for st in (ref_state, state):
        st.host_id_hash[:8] = (1 << 40) + np.arange(8) * ((1 << 31) + 5)
        st.host_epoch += 1
        st.peer_dirty[:] = True
    cap = svc._dag_capacity
    qmask = np.zeros(state.max_hosts, bool)
    qmask[3] = True
    ref_mirror = ref_tick.TickMirror(ref_state, cap)
    mirror = tick.TickMirror(state, cap, device="cpu")
    tasks = list(svc._slot_pidx)
    want = ref_mirror.sync(svc._slot_pidx, ref_state.task_index, set(tasks), qmask)
    got = mirror.sync(svc._slot_pidx, state.task_index, set(tasks), qmask)
    _assert_cols_equal(got, want)
    assert got["host_id_hash"][1].item() == np.int64(ref_state.host_id_hash[1]).astype(np.int32)
    assert not state.peer_dirty.any()

    live = np.flatnonzero(state.peer_alive)
    for st in (ref_state, state):
        rng = np.random.default_rng(0)
        st.record_pieces_batch(live[rng.integers(0, live.size, 40)], rng.integers(0, 60, 40),
                               rng.lognormal(18, 1, 40).astype(np.float32), now=1.0)
        st.host_upload_used[:5] += 1
    assert not np.array_equal(got["peer_ring"].numpy(), ref_state.peer_piece_costs)
    want = ref_mirror.sync(svc._slot_pidx, ref_state.task_index, set(tasks[:2]), qmask)
    got2 = mirror.sync(svc._slot_pidx, state.task_index, set(tasks[:2]), qmask)
    _assert_cols_equal(got2, want)
    # the first sync's cols are frozen: the second sync wrote into the
    # mirrors, not into what the first one returned
    assert not torch.equal(got["peer_ring"], got2["peer_ring"])
    assert not torch.equal(got["host_upload_used"], got2["host_upload_used"])


def test_mirror_sync_copies_the_host_columns():
    """The snapshot trap: on the CPU torch.from_numpy shares memory, so a
    mirror that did not copy would let a host mutation after sync reach
    the chunk."""
    state = cluster.ClusterState(max_hosts=64, max_tasks=4, max_peers=64)
    h = state.upsert_host("h", id_hash=(1 << 31) + 9, upload_limit=7)
    t = state.upsert_task("t", total_pieces=4)
    state.add_peer("p", t, h)
    mirror = tick.TickMirror(state, 64, device="cpu")
    qmask = np.zeros(64, bool)
    cols = mirror.sync({}, state.task_index, set(), qmask)
    before = {name: v.clone() for name, v in cols.items()}
    state.host_upload_used[h] = 6
    state.host_upload_limit[h] = 1
    state.host_numeric[h] = 3.0
    state.task_total_pieces[t] = 99
    qmask[h] = True
    for name, value in cols.items():
        assert torch.equal(value, before[name]), name
    assert cols["host_id_hash"][h].item() == np.int32(np.int64((1 << 31) + 9).astype(np.int32))


def test_mirror_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for machines without one")
    state = cluster.ClusterState(max_hosts=8, max_tasks=2, max_peers=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tick.TickMirror(state, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tick.warm_cols(state, 64)


def test_scatter_rows_drops_like_the_reference():
    """mode="drop": pad indices (== the row count) drop, a negative one
    wraps first; torch's index_put_ would raise on the pads."""
    col = np.arange(64 * 3, dtype=np.int32).reshape(64, 3)
    idx = np.full(64, 64, np.int32)
    idx[:5] = [3, 0, 63, -1, 10]
    rows = np.arange(64 * 3, dtype=np.int32).reshape(64, 3) + 1000
    want = np.asarray(ref_tick._scatter_rows(jnp.asarray(col), idx, rows, 64))
    got = tick._scatter_rows(torch.from_numpy(col.copy()), idx, rows)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[63] == rows[3]).all()  # -1 wrapped to the last row
    tick.warm_scatters(cluster.ClusterState(max_hosts=8, max_tasks=2, max_peers=8), 64, "cpu")


# ------------------------------------------- transport halves and traps


def _inputs(rng, b, k, tasks, slots, peers):
    samples = rng.integers(-1, slots, (b, k))
    samples[0] = -1  # a row with no sample at all
    samples[1, :3] = slots + 5  # past the slot table: the reference clips
    task_row = rng.integers(-1, tasks, b)
    task_row[2] = -1
    child = rng.integers(0, peers, b)
    child[3] = -1  # wraps to the last peer row, as a JAX gather reads it
    return (samples, rng.integers(0, 3, (b, k)), task_row, child,
            rng.random((b, k)) < 0.2, rng.random((b, k)) < 0.8)


def test_build_inbuf_and_decode_out_match():
    rng = np.random.default_rng(1)
    for b, bsz in ((40, 64), (64, 64)):
        args = _inputs(rng, b, 15, 4, 64, 100)
        got = tick.build_inbuf(bsz, *args)
        np.testing.assert_array_equal(got, ref_tick.build_inbuf(bsz, *args))
        assert got.shape == (bsz, tick.inbuf_row_bytes(15)) == (bsz, ref_tick.inbuf_row_bytes(15))
        dec = tick._decode_inbuf(torch.from_numpy(got), bsz, 15)
        np.testing.assert_array_equal(dec["samples"][:b].numpy(), args[0])
        assert (dec["samples"][b:] == -1).all()
        np.testing.assert_array_equal(dec["child_peer"][:b].numpy(), args[3])
    arr = rng.standard_normal(64 * 4 * 2 + 4 * 64 * 15 + 1 + 64 * 15 * 8).astype(np.float32)
    for emit_led in (False, True):
        n = sum(s for _, s, _, _ in tick.out_layout(64, 15, 4, emit_led))
        assert tick.out_layout(64, 15, 4, emit_led) == ref_tick.out_layout(64, 15, 4, emit_led)
        got, want = tick.decode_out(arr[:n], 64, 15, 4, emit_led), \
            ref_tick.decode_out(arr[:n], 64, 15, 4, emit_led)
        for name in want:
            np.testing.assert_array_equal(got[name].view(np.uint8), want[name].view(np.uint8))
    assert tick._bucket_rows(65) == ref_tick._bucket_rows(65) == 256


def _small_state(seed):
    """A seeded state with hosts, tasks, peers, cost rings, a quarantine
    and identity hashes above 2^31, built in both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for module in (ref_cluster, cluster):
        st = module.ClusterState(max_hosts=48, max_tasks=6, max_peers=128)
        r = np.random.default_rng(seed)
        for i in range(40):
            st.upsert_host(f"h{i}", id_hash=int(r.integers(1, 1 << 62)),
                           host_type=int(r.integers(0, 2)), idc=int(r.integers(0, 3)),
                           location=r.integers(0, 3, cluster.MAX_LOC),
                           upload_limit=int(r.integers(0, 8)),
                           upload_count=int(r.integers(0, 20)), upload_failed=int(r.integers(0, 4)),
                           numeric=r.random(cluster.NUM_HOST_FEATURES).astype(np.float32))
        for i in range(6):
            st.upsert_task(f"t{i}", total_pieces=int(r.integers(0, 40)))
        for i in range(120):
            p = st.add_peer(f"p{i}", int(r.integers(0, 6)), int(r.integers(0, 40)))
            st.peer_state[p] = int(r.integers(0, 10))
            for _ in range(int(r.integers(0, 40))):
                st.record_piece(p, int(r.integers(0, 50)), float(r.lognormal(18, 0.5)))
        st.remove_peer("p7")
        out.append(st)
    slot = {f"t{i}": np.where(rng.random(64) < 0.7, rng.integers(0, 128, 64), -1).astype(np.int32)
            for i in range(6)}
    return out, slot


@pytest.mark.parametrize("algorithm", ["default", "nt"])
def test_pad_rows_and_negative_rows_run_like_the_reference(algorithm):
    """The index trap: pad rows (samples -1), task_row -1, samples past the
    slot table and a child row of -1 read exactly what the reference's
    clips and JAX gathers read, and nothing raises."""
    (ref_state, state), slot = _small_state(2)
    ref_mirror = ref_tick.TickMirror(ref_state, 64)
    mirror = tick.TickMirror(state, 64, device="cpu")
    qmask = np.zeros(48, bool)
    qmask[[1, 5, 9]] = True
    want_cols = ref_mirror.sync(slot, ref_state.task_index, set(slot), qmask)
    cols = mirror.sync(slot, state.task_index, set(slot), qmask)
    rng = np.random.default_rng(3)
    for b in (20, 64):
        inbuf = tick.build_inbuf(64, *_inputs(rng, b, 15, 6, 64, 128))
        for emit_led in (False, True):
            want = np.asarray(ref_tick.fused_tick_chunk(
                inbuf.copy(), want_cols, 64, 15, 32, 5, 12, algorithm=algorithm, limit=4,
                emit_led=emit_led))
            got = tick.fused_tick_chunk(inbuf, cols, 64, 15, 32, 5, 12, algorithm=algorithm,
                                        limit=4, emit_led=emit_led)
            _compare_out(got.numpy(), want, 64, 15, 4, emit_led, f"b={b}")
            dec = tick.decode_out(got.numpy(), 64, 15, 4, emit_led)
            assert dec["quarantine_skipped"][0] > 0
            assert (dec["cand_slots"][b:] == -1).all()  # bit casts keep -1 (a NaN pattern)
    # stable compaction: the valid candidates keep their sample order
    valid = dec["cand_valid"].astype(bool)
    for row in range(64):
        slots = dec["cand_slots"][row][valid[row]]
        assert (slots >= 0).all()
    assert valid.any()


def test_scheduler_helpers_match():
    from dragonfly2_tpu.cluster import scheduler as ref_scheduler

    live = np.arange(3, 40, 2)
    for m, k in ((5, 15), (3, 40)):
        got = port_scheduler._sample_rows(np.random.default_rng(9), live, m, k)
        want = ref_scheduler._sample_rows(np.random.default_rng(9), live, m, k)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for n in (1, 63, 64, 65, 300, 1024, 1025, 5000):
        assert port_scheduler._bucket_rows(n) == ref_scheduler._bucket_rows(n)
        assert port_scheduler._chunk_stride(n) == ref_scheduler._chunk_stride(n)
        assert port_scheduler._round_up_64(n) == ref_scheduler._round_up_64(n)
    a = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(port_scheduler._pad_rows(a, 5), ref_scheduler._pad_rows(a, 5))
    assert port_scheduler._chunk_stride(1024) == 256
