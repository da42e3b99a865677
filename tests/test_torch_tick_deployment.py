"""The scheduler tick's recorded deployment, and the port's tick on it.

``chip_smoke.py``'s scheduler-tick phase runs the port's fused tick over a
deployment recorded from the reference's own replay, so that its traffic
(task groups, peer states, cost rings, DAG edges, blocklists, quarantine)
is the simulator's and not a guess. The recording is made once, on the
CPU, by this file run as a script (it needs JAX; a few minutes):

    JAX_PLATFORMS=cpu python -m tests.test_torch_tick_deployment

It replays ``ClusterSimulator`` against the reference ``SchedulerService``
as bench_loop.py's default run does (10,000 hosts, 512 tasks, seed 0, 64
downloads a round, its Config and GC cadence, a probe round every 50)
until its 1,000,000 pieces have flowed, then starts BURST downloads in
one round and records that round's fused tick as ``_tick_fused``
receives it: every column of the ClusterState, every task's DAG and slot
map, the quarantine mask, and the waiting peers in the tick's order with
their DAG slots and blocklists resolved to peer rows. bench_loop's ticks
hold about 64 waiting peers; the burst gives one of TICK_WAITING, and the
first 64 of its rows stand for bench_loop's tick.
``chip_smoke.load_tick_deployment`` loads the file with the port alone.

The tests check that the file holds a consistent deployment and that the
port's tick over it, on the CPU, gives the reference's: selections and
every int segment identical, scores and ledger rows within 1e-6
(test_torch_tick.FLOAT_ATOL).
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import pytest
import torch

import chip_smoke

RECORDING = pathlib.Path(chip_smoke.TICK_RECORDING)
HOSTS, TASKS, SEED, DOWNLOADS_PER_ROUND, PIECES = 10_000, 512, 0, 64, 1_000_000
BURST = chip_smoke.TICK_WAITING


def _state_arrays(st) -> dict:
    """Every column of a ClusterState, rows of the live entities only (a
    dead row keeps its constructor default on load), and its id maps and
    free lists."""
    dims = [getattr(st, d) for d in chip_smoke.TICK_STATE_DIMS]
    out = {"state.dims": np.array(dims, np.int64),
           "state.host_epoch": np.array(st.host_epoch, np.int64)}
    live = {"host": np.flatnonzero(st.host_alive), "task": np.flatnonzero(st.task_alive),
            "peer": np.flatnonzero(st.peer_alive)}
    for kind, rows in live.items():
        out[f"state.{kind}_rows"] = rows
        ids = getattr(st, f"_{kind}_id")
        out[f"state.{kind}_ids"] = np.array([ids[r] for r in rows], dtype=str)
        out[f"state.{kind}_free"] = np.array(getattr(st, f"_{kind}_free")._free, np.int64)
    for name, value in vars(st).items():
        if isinstance(value, np.ndarray):
            kind = name.split("_", 1)[0]
            out[f"col.{name}"] = value[live[kind]] if kind in live else value
    return out


def record(path: pathlib.Path = RECORDING) -> dict:
    """Replay the reference as bench_loop.py does, record one burst tick."""
    from dragonfly2_tpu.cluster import scheduler as ref_sched
    from dragonfly2_tpu.cluster.probes import ProbeStore
    from dragonfly2_tpu.cluster.simulator import ClusterSimulator
    from dragonfly2_tpu.config.config import Config

    cfg = Config()  # bench_loop.run's phase 1, as it sets it
    cfg.scheduler.max_hosts = max(16384, 1 << (HOSTS - 1).bit_length())
    cfg.scheduler.max_tasks = max(4096, 2 * TASKS)
    cfg.scheduler.peer_gc_interval_seconds = 0.5
    cfg.scheduler.peer_ttl_seconds = 2.0
    cfg.scheduler.piece_download_timeout_seconds = 30.0
    cfg.scheduler.task_gc_interval_seconds = 5.0
    probes = ProbeStore(max_pairs=1 << 17, max_hosts=cfg.scheduler.max_hosts)
    svc = ref_sched.SchedulerService(config=cfg, probes=probes)
    assert svc._tick_mirror is not None  # the fused tick is on
    sim = ClusterSimulator(svc, num_hosts=HOSTS, num_tasks=TASKS, seed=SEED)

    captured: dict = {}
    real_tick, real_qmask = svc._tick_fused, svc._quarantined_slot_mask

    def qmask_spy():
        mask = real_qmask()
        captured.setdefault("qmask", mask.copy())
        return mask

    def tick_spy(work, responses, k, b):
        if captured.get("armed") and "work" not in captured:
            st = svc.state
            captured["arrays"] = _state_arrays(st)
            captured["work"] = [
                (p.peer_id, svc._peer_meta[p.peer_id].task_id, svc._peer_meta[p.peer_id].dag_slot,
                 sorted(r for r in (st.peer_index(x) for x in p.blocklist) if r is not None))
                for p in work
            ]
            captured["dags"] = {t: {n: v.copy() for n, v in vars(d).items()
                                    if isinstance(v, np.ndarray)} for t, d in svc._dags.items()}
            captured["slot_pidx"] = {t: v.copy() for t, v in svc._slot_pidx.items()}
            captured["k"] = k
            svc._quarantined_slot_mask = qmask_spy
        return real_tick(work, responses, k, b)

    svc._tick_fused = tick_spy
    start = time.perf_counter()
    rounds = 0
    while "work" not in captured:  # bench_loop.replay's loop, then the burst round
        burst = sim.stats.pieces >= PIECES
        for _ in range(BURST if burst else DOWNLOADS_PER_ROUND):
            sim.start_download()
        sim.consume_seed_triggers()
        captured["armed"] = burst
        for resp in svc.tick():
            sim._act(resp)
        rounds += 1
        if rounds % 50 == 0:
            sim.run_probe_round(sources=8)
        svc.run_gc()
        assert not burst or "work" in captured, "the burst round ran no fused tick"

    out = captured["arrays"]
    work = captured["work"]
    out["qmask"] = captured.get("qmask", np.zeros(svc.state.max_hosts, bool))
    out["waiting.peer_ids"] = np.array([w[0] for w in work], dtype=str)
    out["waiting.task_ids"] = np.array([w[1] for w in work], dtype=str)
    out["waiting.dag_slot"] = np.array([w[2] for w in work], np.int64)
    out["waiting.block_ptr"] = np.cumsum([0] + [len(w[3]) for w in work]).astype(np.int64)
    out["waiting.block_rows"] = np.array([r for w in work for r in w[3]], np.int64)
    tasks = sorted(captured["dags"])
    out["dag.task_ids"] = np.array(tasks, dtype=str)
    for name in ("adj", "present", "in_degree", "out_degree"):
        out[f"dag.{name}"] = np.stack([captured["dags"][t][name] for t in tasks])
    out["dag.slot_pidx"] = np.stack([captured["slot_pidx"][t] for t in tasks])
    out["meta"] = np.array([HOSTS, TASKS, SEED, DOWNLOADS_PER_ROUND, PIECES, BURST,
                            captured["k"], rounds, sim.stats.pieces, sim.stats.completed],
                           np.int64)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"recorded {len(work)} waiting peers over {len(tasks)} task DAGs, "
          f"{int(svc.state.peer_alive.sum())} live peers, {int(out['qmask'].sum())} quarantined "
          f"hosts, {sim.stats.pieces} pieces in {rounds} rounds "
          f"({time.perf_counter() - start:.0f} s) -> {path} ({path.stat().st_size} bytes)")
    return out


# ------------------------------------------------------------------ tests


@pytest.fixture(scope="module")
def dep():
    return chip_smoke.load_tick_deployment()


def test_recording_holds_a_consistent_deployment(dep):
    st, waiting = dep["state"], dep["waiting"]
    meta = dep["meta"]
    assert tuple(meta[:6]) == (HOSTS, TASKS, SEED, DOWNLOADS_PER_ROUND, PIECES, BURST)
    assert meta[6] == chip_smoke.TICK_K
    assert (st.max_hosts, st.max_tasks, st.max_peers) == (16384, 4096, 65536)
    assert waiting.size >= BURST and np.unique(waiting).size == waiting.size
    assert st.peer_alive[waiting].all()
    for row in waiting:
        task_id, slot = dep["peer_slot"][int(row)]
        assert dep["slot_pidx"][task_id][slot] == row
        assert dep["dags"][task_id].present[slot]
        assert st.task_index(task_id) == st.peer_task[row]
    for row, blocked in dep["blocklists"].items():
        assert st.peer_alive[list(blocked)].all()
    # the ids map back to their rows, and no live row is on a free list
    assert all(st.peer_index(st._peer_id[r]) == r for r in np.flatnonzero(st.peer_alive))
    assert not set(st._peer_free._free) & set(np.flatnonzero(st.peer_alive).tolist())
    # the waiting peers are new; the parents they can pick have cost rings
    assert dep["edges"] > 0 and st.peer_piece_cost_count[st.peer_alive].max() > 0


@pytest.mark.parametrize("rows", [64, 256])
def test_port_tick_matches_the_reference_on_the_recording(dep, rows):
    """bench_loop's tick (the first 64 waiting rows) and a chunk of the
    burst, through both packages on the CPU from the same inputs."""
    from dragonfly2_tpu.ops import tick as ref_tick
    from dragonfly2_tpu.state import cluster as ref_cluster
    from dragonfly2_tpu_torch.cluster.scheduler import _bucket_rows
    from dragonfly2_tpu_torch.ops import tick

    from tests.test_torch_tick import _compare_out, copy_state

    st, slot_pidx, qmask = dep["state"], dep["slot_pidx"], dep["qmask"]
    ref_state = copy_state(st, ref_cluster)
    st.peer_dirty[:] = ref_state.peer_dirty[:] = True
    cap = chip_smoke.TICK_DAG_CAPACITY
    k, limit = chip_smoke.TICK_K, chip_smoke.TICK_LIMIT
    cols = tick.TickMirror(st, cap, device="cpu").sync(slot_pidx, st.task_index,
                                                       set(slot_pidx), qmask)
    ref_cols = ref_tick.TickMirror(ref_state, cap).sync(slot_pidx, ref_state.task_index,
                                                        set(slot_pidx), qmask)
    inp = chip_smoke._tick_inputs(dep, dep["waiting"][:rows], k, np.random.default_rng(rows))
    bsz = _bucket_rows(rows)
    inbuf = chip_smoke._tick_inbuf(inp, 0, rows, bsz)
    got = tick.fused_tick_chunk(inbuf, cols, bsz, k, 32, 5, 12, limit=limit,
                                emit_led=True).numpy()
    want = np.asarray(ref_tick.fused_tick_chunk(inbuf, ref_cols, bsz, k, 32, 5, 12, limit=limit,
                                                emit_led=True))
    _compare_out(got, want, bsz, k, limit, True, where=f"recorded rows {rows}")
    selected = tick.decode_out(got, bsz, k, limit, True)["selection"][..., 0] >= 0
    assert selected.any()


if __name__ == "__main__":
    torch.set_num_threads(4)
    record()
