"""Port of dragonfly2_tpu/procworld/sample.py, whole: pure functions that
equal the reference's on the same observations.

Timeline synthesis for the real-process planet — megascale sample
schema, fed through the SAME SLO machinery.

The replay contract is exacting: ``tools/dfslo.py`` re-derives every
SLI from the recorded samples via ``feed_megascale_sample`` on a fresh
``SLOEngine`` and diffs the result against the recorded ``slo_*``
columns — any drift is an exit-2 failure. So the planet does not invent
its own sample shape or its own feeding order; this module builds
samples carrying the exact keys ``EventBatchEngine._timeline_sample``
records and calls the exact same ``feed_megascale_sample`` per round.
The simulator and the process planet then share one verdict plane, one
offline replayer, and one dashboard family — which is what makes the
sim-vs-real divergence report (procworld/divergence.py) a like-for-like
comparison instead of a format translation.

This module is replay-facing: no wall clocks, no process-global
randomness, no set-ordered iteration — every value
derives from the observations the supervisor recorded and the event
clock (round index) they were recorded at.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from dragonfly2_tpu_torch.telemetry.metrics import Registry
from dragonfly2_tpu_torch.telemetry.slo import (
    SLOEngine,
    feed_megascale_sample,
    megascale_slo_specs,
    slo_report,
)


@dataclasses.dataclass
class RoundObservation:
    """What the planet's day loop measured in one compressed-day round —
    already reduced to event-clock facts (counts and millisecond
    durations), never raw wall timestamps."""

    round_idx: int
    completed: int = 0            # downloads finished this round
    pieces: int = 0               # piece transfers this round
    origin_pieces: int = 0        # pieces the origin served (back-to-source)
    reannounce_backlog: int = 0   # in-flight downloads disrupted by a kill
    scheduler_crash: int = 0      # 1 when a scheduler was SIGKILLed
    breaker_open: int = 0
    corruptions: int = 0
    refused_registrations: int = 0
    # region -> measured per-download TTC in ms (the loop's wall deltas,
    # recorded as plain numbers before they reach this module)
    ttc_ms: Mapping[str, list] = dataclasses.field(default_factory=dict)


def quantile(values: list, q: float) -> float | None:
    """Nearest-rank quantile over a small sample list — deterministic,
    no interpolation surprises across platforms."""
    if not values:
        return None
    ordered = sorted(float(v) for v in values)
    rank = min(len(ordered) - 1, max(0, int(q * len(ordered))))
    return round(ordered[rank], 2)


def build_sample(obs: RoundObservation, *, minutes_per_round: float,
                 regions: list[str]) -> dict:
    """One timeline sample in the exact megascale schema (see
    ``EventBatchEngine._timeline_sample``): same keys, same derivations,
    with the columns only the simulator can fill (decision ledger,
    tail-plane hint) carried as their documented empty values."""
    pieces = int(obs.pieces)
    return {
        "sim_minutes": round(obs.round_idx * minutes_per_round, 2),
        "pieces": pieces,
        "completed": int(obs.completed),
        "origin_fraction": (
            round(obs.origin_pieces / pieces, 6) if pieces > 0 else 0.0
        ),
        "quarantine_active": 0,
        "breaker_open": int(obs.breaker_open),
        "reannounce_backlog": int(obs.reannounce_backlog),
        "refused_registrations": int(obs.refused_registrations),
        "corruptions": int(obs.corruptions),
        "scheduler_crash": 1 if obs.scheduler_crash else 0,
        "decisions": 0,
        "shadow_divergence": None,
        "decision_regret_fail": None,
        "ttc_ms_p50": {
            r: quantile(list(obs.ttc_ms.get(r, [])), 0.50) for r in regions
        },
        "ttc_ms_p95": {
            r: quantile(list(obs.ttc_ms.get(r, [])), 0.95) for r in regions
        },
        "tail_dominant_phase": None,
    }


def synthesize_timeline(observations: list, *, minutes_per_round: float,
                        regions: list[str]) -> tuple[list[dict], dict]:
    """Build the full recorded timeline: per-round samples in megascale
    schema with their ``slo_*`` verdict columns appended from a live
    ``SLOEngine`` stepped on the event clock — the exact sequence the
    megascale engine performs, so an offline ``replay_timeline`` of the
    output reproduces every column bit for bit. Returns ``(timeline,
    slo_block)`` where ``slo_block`` is the run's ``slo_report``."""
    regions = sorted(regions)
    engine = SLOEngine(
        megascale_slo_specs(regions),
        name="procworld",
        minutes_per_unit=minutes_per_round,
        registry=Registry(),  # isolated: a harness run must not clobber
                              # the host process's live gauges
    )
    timeline: list[dict] = []
    for obs in sorted(observations, key=lambda o: o.round_idx):
        sample = build_sample(
            obs, minutes_per_round=minutes_per_round, regions=regions
        )
        step = feed_megascale_sample(
            engine, {**sample, "t": float(obs.round_idx)}
        )
        sample["slo_verdict"] = step["verdict_code"]
        sample["slo_alerts_firing"] = step["alerts_firing"]
        sample["slo_pages_fired"] = step["pages_fired"]
        sample["slo_tickets_fired"] = step["tickets_fired"]
        timeline.append({"t": float(obs.round_idx), **sample})
    return timeline, slo_report(engine)


def announce_page_rounds(timeline: list, slo_block: dict) -> list[float]:
    """Event-clock times at which the announce-stability page FIRED,
    read from the recorded alert log (the same log dfslo replays) —
    the page-at-the-kill assertion reads this, not test-local state."""
    return sorted(
        float(entry["t"]) for entry in slo_block.get("alert_log", [])
        if entry.get("slo") == "announce_stability"
        and entry.get("severity") == "page"
        and entry.get("event") == "fired"
    )
