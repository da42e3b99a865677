"""Port of dragonfly2_tpu/megascale/soak.py: ``run_megascale`` (with
``device``), ``deterministic_view``, ``peak_rss_mb`` and the report
blocks. ``resolve_scenario`` lives in scenarios/spec.py (re-exported
here), so that a dfdaemon resolving its ``--scenario`` loads no torch;
this module imports the engine only inside the functions that run it.
The wire-skew mode goes through the port's own ``rpc/wireskew.py``.

Megascale run harness: one entry point the soak tests and the chip smoke
share, so both measure the same replay.

``run_megascale`` builds a scale-sized scheduler + event-batch engine
for a named megascale scenario ("planet" | "soak" | any builtin), drives
it for a number of rounds (default: one full compressed day plus a drain
tail), and returns the report dict — SimStats + MegaStats counters,
per-region completion percentiles, origin-traffic fraction,
quarantine/failover event counts, engine step-phase p50s, and peak RSS.
Everything except the ``timing`` sub-object is deterministic in
(scenario, hosts, seed); the determinism test pins that.
"""

from __future__ import annotations

import dataclasses
import time

from dragonfly2_tpu_torch.scenarios.spec import resolve_scenario  # noqa: F401


def peak_rss_mb() -> float | None:
    """VmHWM from /proc (peak resident set of this process), in MiB; where
    /proc has no VmHWM (some kernels' does not), getrusage's ru_maxrss, the
    same peak in KiB."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    import resource

    peak_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return round(peak_kib / 1024.0, 1) if peak_kib else None


def _sync(svc) -> None:
    """Wait for the card's queued work, so that a host-clock reading
    after it counts the device seconds the replay caused."""
    import torch

    replicas = getattr(svc, "replicas", None) or [svc]
    for dev in {r.device for r in replicas}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def run_megascale(
    scenario: str = "soak",
    num_hosts: int = 50_000,
    num_tasks: int = 96,
    seed: int = 7,
    rounds: int | None = None,
    arrivals_per_round: int | None = None,
    algorithm: str = "default",
    retire_after_rounds: int | None = 24,
    probe_every: int = 0,
    drain_rounds: int = 12,
    max_peers_per_task: int | None = None,
    wire_skew: dict | None = None,
    fleet_replicas: int | None = None,
    device=None,
) -> dict:
    """One megascale replay. `arrivals_per_round` defaults to ~1.5 total
    downloads per host spread over the day; `rounds` defaults to one
    compressed day plus `drain_rounds` of trailing arrivals-light rounds
    so in-flight downloads finish. Returns the report dict.

    `wire_skew` (a golden wire-schema dict, tools/dfwire_schema.json)
    turns on the mixed-version soak mode: every message-shaped
    control-plane exchange round-trips the real codec degraded to the
    N-1 snapshot (rpc/wireskew.SkewProxy) — the rolling-upgrade
    soak then replays the whole compressed day over cross-version frames
    and the report grows a `wire_skew` block (frame counts per type +
    any codec mismatches) the skew gate asserts empty.

    `fleet_replicas` switches the control plane to a SchedulerFleet of
    that many task-sharded scheduler replicas behind one hashring
    (megascale/fleet.py) driven by the FleetEventBatchEngine; the report
    grows a deterministic `fleet` block (per-shard counts/digests/tail,
    handoff counters, crash-victim recovery) and a wall-derived
    `timing.fleet` block (modeled parallel wall + aggregate pieces/s).
    `fleet_replicas=1` is bit-identical to the plain run except for the
    extra fleet columns — the K=1 equivalence oracle test pins that.

    The scheduler (or every replica of the fleet) runs on ``device``:
    None is the card (``device.resolve_device``), and raises where there
    is none; nothing falls back to the CPU. ``timing``'s clocks read the
    host after the card's queued work has finished."""
    spec = resolve_scenario(scenario)
    day = spec.traffic.day_rounds or 96
    if rounds is None:
        rounds = day + drain_rounds
    # a short run must still mostly be a LOADED run: clamp the drain
    # tail so an explicit --rounds below the default drain length does
    # not silently degrade into an all-idle replay
    drain_rounds = min(drain_rounds, max(rounds // 4, 1))
    if arrivals_per_round is None:
        arrivals_per_round = max(1, int(num_hosts * 1.5) // max(day, 1))
    # live-peer bound: arrivals x (retirement window + in-flight slack),
    # plus flash-crowd bursts and seed registrations
    window = (retire_after_rounds or rounds) + 16
    peak = arrivals_per_round * max(
        spec.traffic.peak_multiplier, 1.0
    ) + arrivals_per_round * spec.flash.arrival_multiplier * (
        1 if spec.flash.events_per_day else 0
    )
    max_live = int(peak * window) + 8192
    if max_peers_per_task is None:
        # hottest-swarm bound: top Zipf task share x arrivals x live
        # window, next power of two, clamped — a hot task past this cap
        # spills its overflow to origin (the refused-registration path),
        # exactly the tradeoff a production per-task peer limit makes
        hottest = int(arrivals_per_round * 0.15 * window * 2)
        max_peers_per_task = min(8192, max(2048, 1 << hottest.bit_length()))
    from dragonfly2_tpu_torch.megascale.engine import (
        EventBatchEngine,
        megascale_service,
    )

    if fleet_replicas is not None:
        from dragonfly2_tpu_torch.megascale.fleet import megascale_fleet

        svc = megascale_fleet(
            num_hosts, num_tasks=num_tasks, max_live_peers=max_live,
            algorithm=algorithm, seed=seed,
            max_peers_per_task=max_peers_per_task, replicas=fleet_replicas,
            device=device,
        )
    else:
        svc = megascale_service(
            num_hosts, num_tasks=num_tasks, max_live_peers=max_live,
            algorithm=algorithm, seed=seed,
            max_peers_per_task=max_peers_per_task, device=device,
        )
    front = svc
    if wire_skew is not None:
        from dragonfly2_tpu_torch.rpc.wireskew import SkewProxy

        front = SkewProxy(svc, wire_skew)
    # warm the eval-bucket device programs during setup: a lazy first
    # call mid-day lands its seconds on whichever shard first
    # ticks the new batch shape, skewing the fleet's per-shard capacity
    # ledger with one-off cold-start noise (production replicas warm
    # their caches before joining the serving ring for the same reason)
    svc.warmup()
    _sync(svc)
    t0 = time.perf_counter()
    if fleet_replicas is not None:
        from dragonfly2_tpu_torch.megascale.fleet import FleetEventBatchEngine

        sim = FleetEventBatchEngine(
            front, fleet=svc, num_hosts=num_hosts, num_tasks=num_tasks,
            seed=seed, scenario=spec, retire_after_rounds=retire_after_rounds,
        )
    else:
        sim = EventBatchEngine(
            front, num_hosts=num_hosts, num_tasks=num_tasks, seed=seed,
            scenario=spec, retire_after_rounds=retire_after_rounds,
        )
    _sync(svc)
    setup_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    for r in range(rounds):
        sim.run_round(arrivals_per_round if r < rounds - drain_rounds else 1)
        if probe_every and (r + 1) % probe_every == 0:
            sim.run_probe_round(sources=8)
    _sync(svc)
    wall = time.perf_counter() - t1

    st = sim.stats
    # Scheduler-kill recovery, measured from timeline data rather than
    # asserted from end aggregates: per kill round, the pieces-per-round
    # dip and the simulated time until the rate recovers to >=90% of its
    # pre-kill baseline (telemetry/timeline.recovery_time).
    from dragonfly2_tpu_torch.telemetry.timeline import recovery_time

    tl = sim.timeline.timeline()
    recovery = [
        {
            "round": r,
            "sim_minutes": round(r * sim.minutes_per_round, 2),
            **recovery_time(tl, "pieces", r, baseline_window=8,
                            threshold=0.9),
        }
        for r in sim._crash_rounds
    ]
    for entry in recovery:
        if entry["recovery_intervals"] is not None:
            entry["recovery_sim_minutes"] = round(
                entry["recovery_intervals"] * sim.minutes_per_round, 2
            )
    report = {
        "scenario": scenario,
        "hosts": num_hosts,
        "tasks": num_tasks,
        "seed": seed,
        "rounds": rounds,
        "arrivals_per_round": arrivals_per_round,
        "algorithm": algorithm,
        "stats": dataclasses.asdict(st),
        "mega": dataclasses.asdict(sim.mega),
        **sim.region_report(),
        "fault_schedule_digest": sim.fault_schedule_digest(),
        # the per-round soak timeline (deterministic, event-clocked) +
        # its annotated fault events and the measured kill recovery
        "timeline": tl,
        "timeline_events": list(sim.timeline.events),
        # pure preview of the kill schedule (scenarios/engine.crash_rounds)
        # — must equal the rounds the timeline actually marked, or the
        # engine and the annotation have drifted
        "expected_crash_rounds": (
            sim.engine.crash_rounds(rounds) if sim.engine is not None else []
        ),
        "minutes_per_round": sim.minutes_per_round,
        "recovery": recovery,
        "fault_families": {
            # the soak acceptance gate: every family nonzero in one run
            "chaos": st.injected_scheduler_crashes + st.injected_partition_drops,
            "corruption": st.injected_corruptions,
            "churn": st.injected_crashes + st.injected_host_leaves,
            "flash_crowds": sim.mega.flash_arrivals,
        },
        "quarantine": {
            "corruption_reports": st.injected_corruptions,
            "quarantined_hosts_final": svc.quarantine.active_count(),
        },
        "failover": {
            "scheduler_crashes": st.injected_scheduler_crashes,
            "crash_reannounced_peers": st.crash_reannounced_peers,
            "partition_drops": st.injected_partition_drops,
        },
        "scheduler_counts": svc.counts(),
        # decision provenance (telemetry/decisions.py): deterministic
        # counters + divergence/regret aggregates and the ledger's
        # deterministic-column digest — the paired-seed determinism test
        # pins the digest identical across runs (wall-clock columns are
        # excluded from it by construction)
        "decisions": _decision_report(svc),
        # SLO engine output (telemetry/slo.py): final verdict, alert
        # fire/clear log on the event clock, per-objective budget
        # remaining — deterministic in (scenario, hosts, seed), so it
        # rides deterministic_view and the paired-seed test pins it;
        # tools/dfslo.py reproduces the same block offline from the
        # `timeline` array above
        "slo": _slo_report(sim),
        # tail attribution (telemetry/tailtrace.py): per-region TTC
        # decomposition quantiles, phase shares, dominant-phase
        # histogram, kill-window attribution over the crash rounds,
        # exemplars and the paired-seed-pinned digest — deterministic,
        # so it rides deterministic_view; tools/dftail.py recomputes
        # the window/dominant view offline from this block alone
        "tail": _tail_report(sim),
        "timing": {
            "setup_s": round(setup_s, 2),
            "wall_s": round(wall, 2),
            "pieces_per_sec": round(st.pieces / max(wall, 1e-9), 1),
            "events_per_sec": round(sim.mega.piece_events / max(wall, 1e-9), 1),
            "step_phases_p50_ms": sim.recorder.phase_p50s(),
            "tick_phases_p50_ms": svc.recorder.phase_p50s(),
            "peak_rss_mb": peak_rss_mb(),
        },
        # counted cost cards of the device entries this run called
        # (telemetry/costcard.py; platform-dependent like `timing`, so
        # deterministic_view strips it)
        "costcards": _drained_costcards(),
    }
    if fleet_replicas is not None:
        # sharded-control-plane block (megascale/fleet.py): handoff
        # counters, per-shard counts/decision digests/tail attribution,
        # the crash-victim schedule with per-victim recovery measured on
        # the victim shard's own piece series — deterministic, rides
        # deterministic_view; the wall-derived scaling numbers (modeled
        # parallel wall, aggregate pieces/s — the 1-vs-K artifact) go
        # under `timing` with the other clock-dependent fields
        report["fleet"] = sim.fleet_report()
        report["timing"]["fleet"] = sim.fleet_timing(wall)
    if wire_skew is not None:
        # mixed-version wire evidence: which frame types actually crossed
        # the skewed codec, and any round-trip mismatch (must be empty —
        # the skew soak gate asserts on it)
        report["wire_skew"] = front.report()
    return report


def _tail_report(sim) -> dict:
    """The megascale run's tail block (telemetry/tailtrace.report),
    windowed over the rounds the scheduler actually died plus the
    per-round phase matrix — the offline basis tools/dftail.py replays
    the window attribution from."""
    report = sim.tail.report(crash_rounds=sim._crash_rounds)
    report["round_phase_ms"] = sim.tail.round_phase_matrix_ms()
    report["round_slow_ms"] = sim.tail.round_slow_matrix_ms()
    report["crash_rounds"] = [int(r) for r in sim._crash_rounds]
    return report


def _slo_report(sim) -> dict:
    """The megascale run's SLO block: the engine's flattened report
    (telemetry/slo.slo_report) — verdict, pages/tickets fired, budget
    burn, the alert transition log keyed by event-clock round."""
    from dragonfly2_tpu_torch.telemetry.slo import slo_report

    return slo_report(sim.slo)


def _decision_report(svc) -> dict | None:
    """Deterministic decision-ledger block for the megascale report:
    the ledger's flattened report MINUS the wall-derived TTC keys (the
    paired-seed determinism test compares this block), plus the
    deterministic-column digest."""
    led = getattr(svc, "decisions", None)
    if led is None:
        return None
    r = led.report()
    return {
        key: r[key] for key in (
            "decisions", "joined", "shadow_compared", "shadow_top1_disagree",
            "top1_disagreement", "rank_corr", "n_disagreements",
            "regret_fail_rate", "regret_fail_rate_by_arm",
        )
    } | {"columns_digest": led.deterministic_digest()}


def _drained_costcards() -> dict:
    """Drain pending cost-card captures and return the ledger dump —
    the report assembly is the megascale run's off-hot-path drain
    point (the engine's tick path only notes new signatures; the capture
    replays them on zeros here)."""
    from dragonfly2_tpu_torch.telemetry import costcard

    costcard.capture_pending()
    return costcard.ledger().dump()


def deterministic_view(report: dict) -> dict:
    """The report minus wall-clock/platform-dependent fields (same
    contract as scenarios/ab.deterministic_view). The `timeline` array
    STAYS — its samples are event-clocked by construction, and the
    determinism test pinning this view is what keeps them that way.
    `wire_skew` is excluded too: the block is deterministic but only a
    skew-mode run carries it, and the documented contract is that a
    skew run's view compares EQUAL to the plain run's."""
    return {
        k: v for k, v in report.items()
        if k not in ("timing", "costcards", "wire_skew")
    }
