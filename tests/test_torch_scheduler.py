"""The port's SchedulerService and ClusterSimulator against the reference's.

Both packages' services are driven through their own entries by their own
ClusterSimulator on paired seeds, at tests/test_fused_tick.py's size (40
hosts, 5 tasks, 10 rounds of 5 downloads), the port on the CPU
(``device="cpu"``). Held equal: every response's parent ids, exactly, and
their scores within 1e-6 (the reference's jitted blend fuses
multiply-adds, so scores agree to rounding, not bit for bit); the whole
SimStats (``pieces``, ``completed``, ``piece_cost_ns_total`` among them);
the decision ledger's replay-determined columns (floats within 1e-6); and
the TraceStorage download rows, clock fields excepted. The constructor's
refusals of what is not ported yet are pinned at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from dragonfly2_tpu.cluster.probes import ProbeStore as RefProbeStore
from dragonfly2_tpu.cluster.probes import warm_from_link_model as ref_warm
from dragonfly2_tpu.cluster.scheduler import SchedulerService as RefService
from dragonfly2_tpu.cluster.simulator import ClusterSimulator as RefSimulator
from dragonfly2_tpu.config.config import Config as RefConfig
from dragonfly2_tpu.records.storage import TraceStorage as RefStorage
from dragonfly2_tpu.scenarios import builtin_scenarios as ref_scenarios
from dragonfly2_tpu_torch.cluster import scheduler as port_scheduler
from dragonfly2_tpu_torch.cluster.probes import ProbeStore
from dragonfly2_tpu_torch.cluster.probes import warm_from_link_model as warm_port
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
from dragonfly2_tpu_torch.config.config import Config
from dragonfly2_tpu_torch.records.storage import TraceStorage
from dragonfly2_tpu_torch.scenarios import builtin_scenarios

SCORE_ATOL = 1e-6
PROBE_EVERY = 3  # rounds between probe rounds, where a case has probes
# download-record columns read from the wall clock at the service's calls
CLOCK_SUFFIXES = (".created_at", ".updated_at")
CLOCK_COLUMNS = ("created_at", "updated_at", "cost")


def _run(port: bool, topology, seed: int, tmp_path, fused=True, vectorized=True,
         algorithm="default", rounds=10, probes=False, warm=False):
    cfg = Config() if port else RefConfig()
    cfg.scheduler.vectorized_control = vectorized
    cfg.scheduler.fused_tick = fused
    cfg.evaluator.algorithm = algorithm
    storage_cls = TraceStorage if port else RefStorage
    storage = storage_cls(tmp_path / ("port" if port else "ref"))
    if port:
        store = ProbeStore(max_pairs=1 << 12, max_hosts=cfg.scheduler.max_hosts,
                           device="cpu") if probes else None
        svc = SchedulerService(config=cfg, storage=storage, probes=store, seed=seed + 100,
                               device="cpu")
        scenario = builtin_scenarios()[topology] if topology else None
        sim_cls = ClusterSimulator
    else:
        store = RefProbeStore(max_pairs=1 << 12,
                              max_hosts=cfg.scheduler.max_hosts) if probes else None
        svc = RefService(config=cfg, storage=storage, probes=store, seed=seed + 100)
        scenario = ref_scenarios()[topology] if topology else None
        sim_cls = RefSimulator
    # the probed nt arm gathers RTTs on the host: the fused tick stays off
    fusable = fused and vectorized and not (probes and algorithm == "nt")
    assert (svc._tick_mirror is not None) == fusable
    sim = sim_cls(svc, num_hosts=40, num_tasks=5, seed=seed, scenario=scenario,
                  deterministic_peer_ids=True)
    if port and probes:  # count the candidates that carried a measured RTT
        gather, store.rtt_hits = store.gather_candidate_rtt, 0

        def counted(child_slots, cand_slots):
            avg, has = gather(child_slots, cand_slots)
            store.rtt_hits += int(has.sum())
            return avg, has

        store.gather_candidate_rtt = counted
    if warm:
        slotted = [(h, svc.state.host_index(h.id)) for h in sim.cluster.hosts
                   if svc.state.host_index(h.id) is not None]
        (warm_port if port else ref_warm)(store, slotted, sim.engine.rtt_ns)
    selections = []
    for i in range(rounds):
        for resp in sim.run_round(new_downloads=5):
            if hasattr(resp, "candidate_parents"):
                selections.append((resp.peer_id, [(p.peer_id, p.score)
                                                  for p in resp.candidate_parents]))
        if probes and i % PROBE_EVERY == PROBE_EVERY - 1:
            sim.run_probe_round(sources=4)
    if probes:
        svc.snapshot_topology(now_ns=1)
    storage.flush()
    return selections, sim.stats, svc, storage


def _download_rows(storage) -> tuple[list[str], list[list[str]]]:
    header = list(storage.downloads.header)
    keep = [i for i, name in enumerate(header)
            if name not in CLOCK_COLUMNS and not name.endswith(CLOCK_SUFFIXES)]
    rows = []
    for path in storage.downloads.all_paths():
        lines = path.read_text().splitlines()[1:]
        for line in lines:
            cells = line.split(",")
            rows.append([cells[i] for i in keep])
    return [header[i] for i in keep], rows


CASES = [
    (topology, seed, fused, True, "default")
    for topology in (None, "bandwidth_skew", "chaos")
    for seed in (3, 17)
    for fused in (True, False)
] + [
    ("chaos", 3, False, False, "default"),  # the per-peer loop fill
    ("bandwidth_skew", 17, True, True, "nt"),  # the nt blend, without probes
]


@pytest.mark.parametrize("topology,seed,fused,vectorized,algorithm", CASES)
def test_service_matches_reference_on_paired_seeds(topology, seed, fused, vectorized,
                                                   algorithm, tmp_path):
    _assert_paired(topology, seed, tmp_path, fused=fused, vectorized=vectorized,
                   algorithm=algorithm)


# with a probe store and a probe round every PROBE_EVERY rounds: the nt arm
# on measured RTTs (unfused), one store warmed from the scenario's link model
# first, and bench_loop.py's configuration (default, fused, probed)
PROBED_CASES = [
    (None, 5, "nt", False),
    ("bandwidth_skew", 17, "nt", True),
    ("chaos", 3, "nt", False),
    (None, 3, "default", False),
]


@pytest.mark.parametrize("topology,seed,algorithm,warm", PROBED_CASES)
def test_probed_service_matches_reference_on_paired_seeds(topology, seed, algorithm, warm,
                                                          tmp_path):
    _, svc, storage, ref_svc, ref_storage = _assert_paired(
        topology, seed, tmp_path, algorithm=algorithm, probes=True, warm=warm)
    # the probe store's device state and its host mirror, exactly
    for name in ("ring", "cursor", "count", "probed_count"):
        np.testing.assert_array_equal(getattr(svc.probes, name).numpy(),
                                      np.asarray(getattr(ref_svc.probes, name)), err_msg=name)
    np.testing.assert_array_equal(svc.probes.average, ref_svc.probes.average)
    assert svc.probes._next == ref_svc.probes._next > 0
    # the networktopology rows snapshot_topology wrote
    got = [line for path in storage.topologies.all_paths()
           for line in path.read_text().splitlines()]
    want = [line for path in ref_storage.topologies.all_paths()
            for line in path.read_text().splitlines()]
    assert len(got) > 1 and got == want
    if algorithm == "nt":  # measured RTTs reached the blend
        assert svc.probes.rtt_hits > 0


def _assert_paired(topology, seed, tmp_path, **kw):
    """Both services on one seed: selections, SimStats, counts, the
    decision ledger and the download rows held equal."""
    want, want_stats, ref_svc, ref_storage = _run(False, topology, seed, tmp_path, **kw)
    got, got_stats, svc, storage = _run(True, topology, seed, tmp_path, **kw)
    assert want, "the reference produced no selection"
    assert [p for p, _ in got] == [p for p, _ in want]
    for (peer, g), (_, w) in zip(got, want):
        assert [pid for pid, _ in g] == [pid for pid, _ in w], peer
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=SCORE_ATOL,
                                   rtol=0, err_msg=peer)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)
    assert got_stats.pieces > 0 and got_stats.completed > 0
    assert svc.counts() == ref_svc.counts()

    # the decision ledger: every replay-determined column
    got_led = svc.decisions.deterministic_columns()
    want_led = ref_svc.decisions.deterministic_columns()
    assert sorted(got_led) == sorted(want_led)
    for name, w in want_led.items():
        g = got_led[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=SCORE_ATOL, rtol=0, equal_nan=True,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert svc.decisions.counters() == ref_svc.decisions.counters()

    # the trace store: the same download rows, clock fields excepted
    got_header, got_rows = _download_rows(storage)
    want_header, want_rows = _download_rows(ref_storage)
    assert got_header == want_header
    assert len(got_rows) == len(want_rows) == storage.downloads.count() > 0
    assert got_rows == want_rows
    return got, svc, storage, ref_svc, ref_storage


def test_tick_phases_are_recorded():
    """The flight recorder sees the fused tick's phase split, as the
    reference's does (tests/test_flight_recorder.py pins the names)."""
    svc = SchedulerService(seed=1, device="cpu")
    sim = ClusterSimulator(svc, num_hosts=30, num_tasks=3, seed=1, deterministic_peer_ids=True)
    for _ in range(4):
        sim.run_round(new_downloads=6)
    phases = set().union(*svc.recorder.snapshot())
    assert {"report_ingest", "pre_schedule", "candidate_fill", "legality_recheck", "pack",
            "fused_dispatch", "d2h_wait", "emit", "control_dispatch",
            "fused_device_call"} <= phases
    assert svc.slo is not None and svc.decisions.counters()["decisions"] > 0


def test_warmup_runs_every_bucket_of_the_packed_and_fused_entries(monkeypatch):
    """warmup() runs each device entry at every eval bucket (64, 256,
    1024); the entry wrappers, asked to, count one signature per bucket."""
    from dragonfly2_tpu_torch.telemetry import flight
    from dragonfly2_tpu_torch.telemetry import metrics

    monkeypatch.setattr(flight, "TRACK_SIGNATURES", True)

    # (fused_tick, entry, position of its b argument)
    for fused, entry, b_arg in ((False, "scheduler.evaluator.schedule_from_packed", 1),
                                (True, "scheduler.tick.fused_tick_chunk", 2)):
        cfg = Config()
        cfg.scheduler.fused_tick = fused
        svc = SchedulerService(config=cfg, device="cpu", metrics_registry=metrics.Registry())
        wrapper = flight.entry_wrappers()[entry]
        before = wrapper.stats()["calls"]
        svc.warmup()
        buckets = {sig[0][1][b_arg] for sig in wrapper._seen}
        assert {64, 256, 1024} <= buckets
        assert wrapper.stats()["calls"] >= before + 3


@pytest.mark.parametrize(
    "kwargs,item",
    [
        (dict(ml_evaluator=object()), "A7"),
        (dict(algorithm="ml"), "A7"),
        (dict(algorithm="plugin"), "A9"),
    ],
)
def test_unported_options_raise_naming_their_roadmap_item(kwargs, item):
    cfg = Config()
    if "algorithm" in kwargs:
        cfg.evaluator.algorithm = kwargs.pop("algorithm")
    with pytest.raises(NotImplementedError, match=item):
        SchedulerService(config=cfg, device="cpu", **kwargs)


def test_flight_dump_and_probe_round_wait_for_their_modules():
    svc = SchedulerService(device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        svc.flight_dump()
    sim = ClusterSimulator(svc, num_hosts=8, num_tasks=2, seed=0)
    assert sim.run_probe_round() == 0  # no probes: nothing to probe, as the reference


def test_the_service_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SchedulerService()
    svc = SchedulerService(device="cpu")
    assert svc.device == torch.device("cpu")
    assert svc._tick_mirror.peer_scalars.device.type == "cpu"


def test_drain_reads_back_tensors_and_passes_arrays():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    a = port_scheduler._to_host(t)
    assert isinstance(a, np.ndarray) and a.shape == (2, 3)
    assert port_scheduler._to_host(a) is a


def test_the_probe_store_must_be_on_the_service_device():
    class Elsewhere:
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="probe store is on cuda"):
        SchedulerService(probes=Elsewhere(), device="cpu")
