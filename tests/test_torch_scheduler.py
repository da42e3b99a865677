"""The port's SchedulerService and ClusterSimulator against the reference's.

Both packages' services are driven through their own entries by their own
ClusterSimulator on paired seeds, at tests/test_fused_tick.py's size (40
hosts, 5 tasks, 10 rounds of 5 downloads), the port on the CPU
(``device="cpu"``). Held equal: every response's parent ids, exactly, and
their scores within 1e-6 (the reference's jitted blend fuses
multiply-adds, so scores agree to rounding, not bit for bit); the whole
SimStats (``pieces``, ``completed``, ``piece_cost_ns_total`` among them);
the decision ledger's replay-determined columns (floats within 1e-6); and
the TraceStorage download rows, clock fields excepted. The ml arm and the
ml shadow arm run over one GraphSAGE ranker (the reference's flax init,
hidden 32, compute_dtype float32) published to one shared bucket, their
embeddings refreshed inline every ML_REFRESH_EVERY rounds; the shadow
arm's ledger counters and the SLO's shadow-regret observations are held
equal too. The constructor's refusals of what is not ported yet are
pinned at the end.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.cluster.probes import ProbeStore as RefProbeStore
from dragonfly2_tpu.cluster.probes import warm_from_link_model as ref_warm
from dragonfly2_tpu.cluster.scheduler import SchedulerService as RefService
from dragonfly2_tpu.cluster.simulator import ClusterSimulator as RefSimulator
from dragonfly2_tpu.config.config import Config as RefConfig
from dragonfly2_tpu.models.graphsage import GraphSAGERanker as RefRanker
from dragonfly2_tpu.objectstorage.backends import FilesystemBackend as RefBackend
from dragonfly2_tpu.records.storage import TraceStorage as RefStorage
from dragonfly2_tpu.registry.bucket import BucketModelRegistry as RefRegistry
from dragonfly2_tpu.registry.registry import ModelEvaluation as RefEvaluation
from dragonfly2_tpu.registry.serving import MLEvaluator as RefMLEvaluator
from dragonfly2_tpu.registry.serving import ModelServer as RefModelServer
from dragonfly2_tpu.scenarios import builtin_scenarios as ref_scenarios
from dragonfly2_tpu.telemetry import metrics as ref_metrics
from dragonfly2_tpu_torch.cluster import scheduler as port_scheduler
from dragonfly2_tpu_torch.cluster.probes import ProbeStore
from dragonfly2_tpu_torch.cluster.probes import warm_from_link_model as warm_port
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
from dragonfly2_tpu_torch.config.config import Config
from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend
from dragonfly2_tpu_torch.records.features import NUM_HOST_FEATURES
from dragonfly2_tpu_torch.records.storage import TraceStorage
from dragonfly2_tpu_torch.registry import GNN_MODEL_NAME, BucketModelRegistry, MLEvaluator, ModelServer
from dragonfly2_tpu_torch.registry.registry import MODEL_TYPE_GNN
from dragonfly2_tpu_torch.scenarios import builtin_scenarios
from dragonfly2_tpu_torch.telemetry import metrics

SCORE_ATOL = 1e-6
PROBE_EVERY = 3  # rounds between probe rounds, where a case has probes
# download-record columns read from the wall clock at the service's calls
CLOCK_SUFFIXES = (".created_at", ".updated_at")
CLOCK_COLUMNS = ("created_at", "updated_at", "cost")
ML_HIDDEN = 32
ML_REFRESH_EVERY = 3  # rounds between the ml evaluator's inline refreshes
ML_HOST = "sched-host-1"


def _publish_ranker(bucket_dir):
    """The reference's flax init of the ranker, published by the
    reference's BucketModelRegistry under GNN_MODEL_NAME and activated;
    returns the params (the reference server's template)."""
    graph = {"node_feats": np.zeros((4, NUM_HOST_FEATURES), np.float32),
             "edge_src": np.zeros(2, np.int32), "edge_dst": np.zeros(2, np.int32),
             "edge_feats": np.zeros((2, 2), np.float32)}
    params = jax.tree_util.tree_map(np.asarray, RefRanker(hidden_dim=ML_HIDDEN).init(
        jax.random.key(0), graph, np.zeros(1, np.int32), np.zeros((1, 2), np.int32),
        np.zeros((1, 2, 2), np.float32)))
    reg = RefRegistry(RefBackend(bucket_dir), "models")
    mv = reg.create_model_version(GNN_MODEL_NAME, MODEL_TYPE_GNN, ML_HOST, params,
                                  RefEvaluation(), metadata={"hidden_dim": ML_HIDDEN})
    reg.activate(mv.model_id, mv.version)
    return params


def _ml_evaluator(port: bool, bucket_dir, template):
    """Each package's server and MLEvaluator over the published ranker, at
    compute_dtype float32 (whole paired replays are held equal at float32
    only: bf16 near-ties may flip a selection)."""
    if port:
        server = ModelServer(BucketModelRegistry(FilesystemBackend(bucket_dir), "models"),
                             GNN_MODEL_NAME, ML_HOST, MODEL_TYPE_GNN, device="cpu",
                             model=GraphSAGERanker(ML_HIDDEN, 2, torch.float32))
        evaluator = MLEvaluator(server, metrics_registry=metrics.Registry())
    else:
        server = RefModelServer(RefRegistry(RefBackend(bucket_dir), "models"), GNN_MODEL_NAME,
                                ML_HOST, MODEL_TYPE_GNN, template,
                                model=RefRanker(hidden_dim=ML_HIDDEN, compute_dtype=jnp.float32))
        evaluator = RefMLEvaluator(server, metrics_registry=ref_metrics.Registry())
    assert server.refresh()
    return evaluator


def _run(port: bool, topology, seed: int, tmp_path, fused=True, vectorized=True,
         algorithm="default", rounds=10, probes=False, warm=False, ml=None):
    """One service run; ``ml`` (the published ranker's params, see
    _publish_ranker) attaches each package's MLEvaluator."""
    cfg = Config() if port else RefConfig()
    cfg.scheduler.vectorized_control = vectorized
    cfg.scheduler.fused_tick = fused
    cfg.evaluator.algorithm = algorithm
    storage_cls = TraceStorage if port else RefStorage
    storage = storage_cls(tmp_path / ("port" if port else "ref"))
    evaluator = None if ml is None else _ml_evaluator(port, tmp_path / "bucket", ml)
    if port:
        store = ProbeStore(max_pairs=1 << 12, max_hosts=cfg.scheduler.max_hosts,
                           device="cpu") if probes else None
        svc = SchedulerService(config=cfg, storage=storage, probes=store, seed=seed + 100,
                               device="cpu", ml_evaluator=evaluator)
        scenario = builtin_scenarios()[topology] if topology else None
        sim_cls = ClusterSimulator
    else:
        store = RefProbeStore(max_pairs=1 << 12,
                              max_hosts=cfg.scheduler.max_hosts) if probes else None
        svc = RefService(config=cfg, storage=storage, probes=store, seed=seed + 100,
                         ml_evaluator=evaluator)
        scenario = ref_scenarios()[topology] if topology else None
        sim_cls = RefSimulator
    # the probed nt arm gathers RTTs on the host and the ml arm keeps its
    # own transport: the fused tick stays off
    fusable = (fused and vectorized and algorithm in ("default", "nt")
               and not (probes and algorithm == "nt"))
    assert (svc._tick_mirror is not None) == fusable
    sim = sim_cls(svc, num_hosts=40, num_tasks=5, seed=seed, scenario=scenario,
                  deterministic_peer_ids=True)
    regret = []  # the SLO's shadow-regret observations, in order
    observe = svc.slo.observe

    def observed(sli, good=0.0, bad=0.0):
        if sli == "shadow_regret":
            regret.append((good, bad))
        observe(sli, good=good, bad=bad)

    svc.slo.observe = observed
    if evaluator is not None:
        # the first commit and the warm, before any peer is served: the
        # ml shadow arm is ready from the first tick in both packages
        evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
        svc.warmup()
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
        if evaluator is not None and i % ML_REFRESH_EVERY == ML_REFRESH_EVERY - 1:
            evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
    if probes:
        svc.snapshot_topology(now_ns=1)
    if evaluator is not None:
        evaluator.close()
        svc.regret = regret
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


def _assert_paired(topology, seed, tmp_path, atol=SCORE_ATOL, **kw):
    """Both services on one seed: selections, SimStats, counts, the
    decision ledger and the download rows held equal (scores and the
    ledger's floats within ``atol``)."""
    want, want_stats, ref_svc, ref_storage = _run(False, topology, seed, tmp_path, **kw)
    got, got_stats, svc, storage = _run(True, topology, seed, tmp_path, **kw)
    assert want, "the reference produced no selection"
    assert [p for p, _ in got] == [p for p, _ in want]
    for (peer, g), (_, w) in zip(got, want):
        assert [pid for pid, _ in g] == [pid for pid, _ in w], peer
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=atol,
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
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, equal_nan=True,
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


ML_SCORE_ATOL = 1e-5  # the ml arm's ensemble scores at float32
# the ml arm (unfused: it keeps its own transport), and the default arm
# with an ml evaluator attached, whose ml shadow re-scores each tick's
# batch (fused: from the fused program's device-built buffer; unfused: from
# a copy of the packed staging buffer)
ML_CASES = [
    (None, 3, "ml", False),
    ("bandwidth_skew", 17, "ml", False),
    (None, 3, "default", True),
    ("chaos", 17, "default", False),
]


@pytest.mark.parametrize("topology,seed,algorithm,fused", ML_CASES)
def test_ml_arms_match_reference_on_paired_seeds(topology, seed, algorithm, fused, tmp_path):
    params = _publish_ranker(tmp_path / "bucket")
    _, svc, _, ref_svc, _ = _assert_paired(topology, seed, tmp_path, atol=ML_SCORE_ATOL,
                                           algorithm=algorithm, fused=fused, ml=params)
    counters = svc.decisions.counters()
    # the active arm of each applied decision, and the shadow arm's work
    arms = set(svc.decisions.deterministic_columns()["arm"].tolist()) - {-1}
    if algorithm == "ml":
        assert arms == {2} and svc.ml_evaluator.last_used_versions is not None
    else:
        assert arms == {0} and svc.ml_evaluator.last_used_versions is None
    assert counters["shadow_compared"] > 0
    assert svc._shadow_ml_ready == ref_svc._shadow_ml_ready == (algorithm != "ml")
    assert svc.regret == ref_svc.regret and sum(g + b for g, b in svc.regret) > 0
    assert svc._slo_prev_shadow == ref_svc._slo_prev_shadow
    ml = svc.ml_evaluator
    assert (ml.refresh_count, ml.incremental_refresh_count) == (
        ref_svc.ml_evaluator.refresh_count, ref_svc.ml_evaluator.incremental_refresh_count)
    assert ml.committed_versions == ref_svc.ml_evaluator.committed_versions


def test_a_late_snapshot_warms_the_shadow_arm_off_the_tick(tmp_path):
    """A snapshot committed after warmup: the rule tick spawns the
    eval-warmup-shadow thread, serves no shadow until it lands, then
    shadows every tick."""
    params = _publish_ranker(tmp_path / "bucket")
    evaluator = _ml_evaluator(True, tmp_path / "bucket", params)
    svc = SchedulerService(device="cpu", ml_evaluator=evaluator,
                           metrics_registry=metrics.Registry())
    sim = ClusterSimulator(svc, num_hosts=30, num_tasks=3, seed=1, deterministic_peer_ids=True)
    try:
        svc.warmup()
        assert not svc._shadow_ml_ready  # nothing committed yet
        sim.run_round(new_downloads=6)
        evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
        sim.run_round(new_downloads=6)
        thread = svc._shadow_warm_thread
        assert thread is not None and thread.name == "eval-warmup-shadow"
        thread.join(timeout=30)
        assert svc._shadow_ml_ready
        before = svc.decisions.counters()["shadow_compared"]
        sim.run_round(new_downloads=6)
        assert svc.decisions.counters()["shadow_compared"] > before
        assert "shadow_score" in svc.recorder.snapshot(1)[0]
    finally:
        evaluator.close()


@pytest.mark.parametrize("case", ["ml_evaluator_elsewhere", "ml_without_evaluator", "plugin"])
def test_unported_options_raise_naming_their_roadmap_item(case, tmp_path):
    """algorithm="plugin" waits for A9. The ml arm is ported: an evaluator
    on another device than the service's raises, and algorithm="ml" with
    no evaluator runs the rule blend, unfused, as the reference does."""
    if case == "plugin":
        cfg = Config()
        cfg.evaluator.algorithm = "plugin"
        with pytest.raises(NotImplementedError, match="A9"):
            SchedulerService(config=cfg, device="cpu")
    elif case == "ml_evaluator_elsewhere":
        class Elsewhere:
            device = torch.device("cuda", 0)

        with pytest.raises(ValueError, match="ml evaluator is on cuda"):
            SchedulerService(ml_evaluator=Elsewhere(), device="cpu")
    else:
        _, svc, _, _, _ = _assert_paired(None, 3, tmp_path, algorithm="ml")
        assert svc.ml_evaluator is None and svc._tick_mirror is None
        assert set(svc.decisions.deterministic_columns()["arm"].tolist()) - {-1} == {0}


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
