"""Scenario-matrix A/B harness: {default, ml, random[, nt]} x scenarios.

Port of dragonfly2_tpu/scenarios/ab.py. Each evaluator runs across a grid
of structured scenarios (scenarios/spec.builtin_scenarios) with PAIRED
seeds: every arm of one (scenario, seed) cell sees the same host
population, task set, arrival order and injected fault schedule. The
report gives per-scenario cost ratios with small-sample confidence
intervals.

The ml arm's model is trained ONCE, on traces a scenario-driven replay
produced (schedule -> Download/NetworkTopology CSV -> announcer -> trainer
-> registry -> served MLEvaluator: the whole loop), then evaluated across
every scenario.

Determinism: arms never read the wall clock for decisions (fault
schedules are counter-hashed, the scheduler's rng is seeded, interval GC
is not driven), so re-running ``run_matrix`` with the same config gives
the same result outside the ``timing`` sub-objects;
``deterministic_view`` strips those. Every service, probe store, trainer
and served model runs on ``device`` (CUDA unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import tempfile
import time

import numpy as np

from dragonfly2_tpu_torch.scenarios.spec import ScenarioSpec, builtin_scenarios

# two-sided 95% Student-t critical values by degrees of freedom
_T95 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228}


@dataclasses.dataclass
class MatrixConfig:
    hosts: int = 600
    tasks: int = 24
    target_pieces: int = 8000
    downloads_per_round: int = 32
    seeds: tuple = (11, 12, 13)
    evaluators: tuple = ("default", "ml", "random")
    probe_every: int = 20
    max_rounds: int = 20_000
    # ml arm: one model trained on scenario-heterogeneous traces
    train_scenario: str = "bandwidth_skew"
    train_pieces: int = 12_000
    train_seed: int = 1009
    trainer_epochs: int = 3
    trainer_batch: int = 512
    hidden_dim: int = 32
    refresh_every: int = 10  # rounds between serving-graph embed refreshes


class _RandomScores:
    """Anchor arm: uniform-random candidate scores through the plugin
    path, seeded."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def evaluate(self, fd: dict) -> np.ndarray:
        return self.rng.random(fd["valid"].shape).astype(np.float32)


def _scheduler_config(cfg: MatrixConfig, algorithm: str):
    from dragonfly2_tpu_torch.config.config import Config

    config = Config()
    config.evaluator.algorithm = algorithm
    config.scheduler.max_hosts = max(1024, 1 << (cfg.hosts - 1).bit_length())
    config.scheduler.max_tasks = max(256, 2 * cfg.tasks)
    # hotspot scenarios concentrate downloads on one task; the per-task DAG
    # must hold the deep swarm
    config.scheduler.max_peers_per_task = 1024
    return config


def _run_arm(
    spec: ScenarioSpec, evaluator: str, seed: int, cfg: MatrixConfig, server, device=None,
) -> dict:
    """One (scenario, evaluator, seed) cell: fresh service + simulator,
    replay to the piece target, report costs, injected-event counts and the
    phase breakdown."""
    from dragonfly2_tpu_torch.cluster.probes import ProbeStore, warm_from_link_model
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
    from dragonfly2_tpu_torch.registry import MLEvaluator

    algorithm = {"ml": "ml", "nt": "nt"}.get(evaluator, "default")
    config = _scheduler_config(cfg, algorithm)
    # EVERY arm gets a probe store: run_probe_round draws from the
    # simulator's seeded rng only when a store is attached, so a probe-less
    # arm would diverge in arrival order from its paired siblings. Only the
    # nt algorithm reads the store.
    probes = ProbeStore(max_pairs=1 << 15, max_hosts=config.scheduler.max_hosts, device=device)
    ml = MLEvaluator(server) if evaluator == "ml" else None
    svc = SchedulerService(config=config, probes=probes, ml_evaluator=ml, seed=seed,
                           device=device)
    if evaluator == "random":
        # As in the reference: the anchor is attached after construction,
        # when the service has already taken the fused tick, which never
        # reads it (the reference reads it only on its unfused transport;
        # the port's service has no plugin transport yet, ROADMAP A9). The
        # arm therefore scores with the rule blend in both packages.
        svc.plugin_evaluator = _RandomScores(seed)
    sim = ClusterSimulator(
        svc, num_hosts=cfg.hosts, num_tasks=cfg.tasks, seed=seed, scenario=spec
    )
    if evaluator == "nt":
        # cold-store warmup so the nt arm measures the algorithm, not the
        # probe-coverage ramp; counter-hashed, no rng draws
        slotted = [
            (h, svc.state.host_index(h.id))
            for h in sim.cluster.hosts
            if svc.state.host_index(h.id) is not None
        ]
        warm_from_link_model(probes, slotted, sim.engine.rtt_ns)

    refresh_s = 0.0
    if ml is not None:
        def _refresh() -> None:
            nonlocal refresh_s
            t = time.perf_counter()
            # wait=True: every arm of a cell must see embeddings commit at
            # the same round on every run, which the worker's timing cannot
            # guarantee
            ml.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
            refresh_s += time.perf_counter() - t

        _refresh()  # edge-less warm refresh: ml serves from round 1

    try:
        t0 = time.perf_counter()
        rounds = 0
        while sim.stats.pieces < cfg.target_pieces and rounds < cfg.max_rounds:
            sim.run_round(cfg.downloads_per_round)
            rounds += 1
            if rounds % cfg.probe_every == 0:
                sim.run_probe_round(sources=8)
            if ml is not None and rounds % cfg.refresh_every == 0:
                _refresh()
        wall = time.perf_counter() - t0
    finally:
        if ml is not None:
            ml.close()

    st = sim.stats
    return {
        "pieces": st.pieces,
        "completed": st.completed,
        "back_to_source": st.back_to_source,
        "back_to_source_starved": st.back_to_source_starved,
        "back_to_source_with_parents": st.back_to_source_with_parents,
        "mean_piece_cost_ms": round(
            st.piece_cost_ns_total / max(st.pieces, 1) / 1e6, 4
        ),
        "injected": {
            "piece_failures": st.injected_piece_failures,
            "stalls": st.injected_stalls,
            "crashes": st.injected_crashes,
            "host_leaves": st.injected_host_leaves,
            "scheduler_crashes": st.injected_scheduler_crashes,
            "crash_reannounced_peers": st.crash_reannounced_peers,
            "partition_drops": st.injected_partition_drops,
        },
        "retry_waves": st.retry_waves,
        "rounds": rounds,
        "schedule_digest": sim.engine.schedule_digest(),
        # decision-ledger counters: counts only, so they ride the pinned view
        "decisions": (
            svc.decisions.counters() if svc.decisions is not None else None
        ),
        # everything wall-clock-dependent lives under `timing`
        "timing": {
            "wall_s": round(wall, 2),
            "pieces_per_sec": round(st.pieces / max(wall, 1e-9), 1),
            "phases_p50_ms": svc.recorder.phase_p50s(),
            **({"embed_refresh_s": round(refresh_s, 2)} if refresh_s else {}),
        },
    }


def train_model(cfg: MatrixConfig, workdir: str, scenarios: dict[str, ScenarioSpec],
                device=None):
    """Train and serve the GNN ranker from traces a scenario replay wrote:
    schedule -> CSV traces (+ a topology snapshot from scenario-modeled
    probes) -> announcer upload -> trainer -> registry -> ModelServer.
    Returns (server, info)."""
    from dragonfly2_tpu_torch.cluster.announcer import Announcer
    from dragonfly2_tpu_torch.cluster.probes import ProbeStore
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
    from dragonfly2_tpu_torch.cluster.trainer_service import GNN_MODEL_NAME, TrainerService
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
    from dragonfly2_tpu_torch.records.storage import HostTraceStorage, TraceStorage
    from dragonfly2_tpu_torch.registry import ModelRegistry, ModelServer
    from dragonfly2_tpu_torch.registry.registry import MODEL_TYPE_GNN

    spec = scenarios.get(cfg.train_scenario) or builtin_scenarios()[cfg.train_scenario]
    config = _scheduler_config(cfg, "default")
    storage = TraceStorage(f"{workdir}/traces")
    probes = ProbeStore(max_pairs=1 << 15, max_hosts=config.scheduler.max_hosts, device=device)
    svc = SchedulerService(config=config, storage=storage, probes=probes,
                           seed=cfg.train_seed, device=device)
    sim = ClusterSimulator(
        svc, num_hosts=cfg.hosts, num_tasks=cfg.tasks,
        seed=cfg.train_seed, scenario=spec,
    )
    t0 = time.perf_counter()
    rounds = 0
    while sim.stats.pieces < cfg.train_pieces and rounds < cfg.max_rounds:
        sim.run_round(cfg.downloads_per_round)
        rounds += 1
        if rounds % cfg.probe_every == 0:
            sim.run_probe_round(sources=8)
    svc.snapshot_topology(now_ns=1)

    registry = ModelRegistry(f"{workdir}/registry")
    tcfg = TrainerConfig(
        epochs=cfg.trainer_epochs, batch_size=cfg.trainer_batch,
        hidden_dim=cfg.hidden_dim,
    )
    trainer = TrainerService(
        HostTraceStorage(f"{workdir}/trainer-data"), registry, tcfg, device=device
    )
    announcer = Announcer("ab-sched", storage, trainer, interval_seconds=0)
    if not announcer.maybe_announce():
        raise RuntimeError("scenario trace announce+train failed")
    active = registry.active_version(registry.model_id(GNN_MODEL_NAME, "ab-sched"))
    if active is None:
        raise RuntimeError("no active GNN version after scenario training")

    feat_dim = svc.state.host_numeric.shape[1]
    server = ModelServer(registry, GNN_MODEL_NAME, "ab-sched", MODEL_TYPE_GNN,
                         model=GraphSAGERanker(hidden_dim=cfg.hidden_dim, in_features=feat_dim),
                         device=device)
    if not server.refresh():
        raise RuntimeError("model server refresh failed")
    info = {
        "train_scenario": cfg.train_scenario,
        "train_pieces": sim.stats.pieces,
        "precision": round(active.evaluation.precision, 4),
        "recall": round(active.evaluation.recall, 4),
        "f1": round(active.evaluation.f1_score, 4),
        "hidden_dim": cfg.hidden_dim,
        "timing": {"train_wall_s": round(time.perf_counter() - t0, 2)},
    }
    return server, info


def _ratio_stats(numerator: list[float], denominator: list[float]) -> dict:
    """Paired per-seed ratios + mean + 95% t-CI. `resolvable` = the CI
    excludes 1.0: the gap is distinguishable from a tie at this replicate
    count (in either direction)."""
    ratios = [n / max(d, 1e-12) for n, d in zip(numerator, denominator)]
    mean = statistics.fmean(ratios)
    out = {"per_seed": [round(r, 4) for r in ratios], "mean": round(mean, 4)}
    if len(ratios) >= 2:
        sd = statistics.stdev(ratios)
        half = _T95.get(len(ratios) - 1, 1.96) * sd / math.sqrt(len(ratios))
        lo, hi = mean - half, mean + half
        out["ci95"] = [round(lo, 4), round(hi, 4)]
        out["resolvable"] = bool(lo > 1.0 or hi < 1.0)
    else:
        out["ci95"] = [round(mean, 4), round(mean, 4)]
        out["resolvable"] = False
    return out


def run_matrix(
    scenarios: dict[str, ScenarioSpec] | None = None,
    cfg: MatrixConfig | None = None,
    workdir: str | None = None,
    log=None,
    device=None,
) -> dict:
    """Run the scenario x evaluator x seed grid; returns the artifact dict.
    ``log`` (optional callable) receives one progress line per arm."""
    cfg = cfg or MatrixConfig()
    scenarios = scenarios or builtin_scenarios()
    workdir = workdir or tempfile.mkdtemp(prefix="bench-scenarios-")
    log = log or (lambda _line: None)

    server, model_info = None, None
    if "ml" in cfg.evaluators:
        server, model_info = train_model(cfg, workdir, scenarios, device=device)
        log(f"trained ml model on {cfg.train_scenario}: "
            f"precision={model_info['precision']} recall={model_info['recall']}")

    out_scenarios: dict[str, dict] = {}
    for name, spec in scenarios.items():
        arms: dict[str, dict] = {}
        for evaluator in cfg.evaluators:
            per_seed = {}
            for seed in cfg.seeds:
                result = _run_arm(spec, evaluator, seed, cfg, server, device=device)
                per_seed[str(seed)] = result
                log(f"{name}/{evaluator}/seed={seed}: "
                    f"cost={result['mean_piece_cost_ms']}ms "
                    f"pieces={result['pieces']} "
                    f"wall={result['timing']['wall_s']}s")
            arms[evaluator] = {"seeds": per_seed}

        def _costs(evaluator: str) -> list[float]:
            return [
                arms[evaluator]["seeds"][str(s)]["mean_piece_cost_ms"]
                for s in cfg.seeds
            ]

        summary: dict = {
            "spec": spec.to_dict(),
            "arms": arms,
            "mean_piece_cost_ms": {
                ev: round(statistics.fmean(_costs(ev)), 4) for ev in cfg.evaluators
            },
        }
        # ratio > 1: the left evaluator picks CHEAPER parents than the right
        # one (cost of right / cost of left)
        if "ml" in cfg.evaluators and "default" in cfg.evaluators:
            summary["ml_vs_default"] = _ratio_stats(_costs("default"), _costs("ml"))
        if "default" in cfg.evaluators and "random" in cfg.evaluators:
            summary["default_vs_random"] = _ratio_stats(_costs("random"), _costs("default"))
        if "nt" in cfg.evaluators and "default" in cfg.evaluators:
            summary["nt_vs_default"] = _ratio_stats(_costs("default"), _costs("nt"))
        out_scenarios[name] = summary

    return {
        "config": dataclasses.asdict(cfg),
        "model": model_info,
        "scenarios": out_scenarios,
    }


def deterministic_view(result: dict):
    """The artifact minus every wall-clock-dependent field: drops `timing`
    sub-objects recursively. Two runs of the same (config, scenarios)
    compare equal under this view."""
    if isinstance(result, dict):
        return {
            k: deterministic_view(v) for k, v in result.items() if k != "timing"
        }
    if isinstance(result, list):
        return [deterministic_view(v) for v in result]
    return result
