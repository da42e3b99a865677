"""Port of dragonfly2_tpu/procworld/divergence.py, whole: the same bands
and report, a pure function of the two run dicts (two arguments name
their sources in the port's own words).

Sim-vs-real divergence report — the capstone of the process planet.

The same ScenarioSpec runs twice: once through ``run_megascale`` (the
modeled daemon inside EventBatchEngine) and once through the process
planet (real schedulers, real dfdaemons, real sockets, real SIGKILL).
This module compares the two runs metric by metric and emits a report
in which every comparison carries its OWN tolerance band and the
argument for that band — the bands travel in the artifact, so the test
that gates on them asserts ``within`` flags it can audit, instead of
hardcoding numbers whose provenance is lost.

Three comparison kinds:

- ``ratio``  — real/sim; right for throughput-like magnitudes where the
  planes differ by modeled-vs-loopback transport but not by structure.
- ``delta``  — real − sim; right for bounded fractions.
- ``equal``  — invariants both planes must agree on exactly (lost
  downloads, page-at-the-kill, final verdict): value 1.0 on agreement.

This module is replay-facing: the report is a pure function of the two
run dicts — no wall clocks, no randomness, no set-ordered iteration — so
re-running it over a checked-in artifact reproduces the shipped verdicts
bit for bit.
"""

from __future__ import annotations

from typing import Mapping

# name -> (lo, hi, argument). The ttc entry is a per-region template.
# These are the DEFAULT bands; the report embeds whichever bands it was
# computed with, and tests assert the embedded ``within`` flags — the
# bands are data in the artifact, not constants in a test.
DEFAULT_BANDS: dict = {
    "ttc_p95_ratio": (
        0.0, 1.5,
        "real transport is loopback TCP while the simulator prices the "
        "scenario's WAN matrix (~85ms RTT, ~20MB/s cross-region per the "
        "analytic model of arXiv 2103.10515), so real p95 TTC must "
        "land well BELOW the modeled p95; the 1.5x ceiling only guards "
        "against the real path being pathologically slower than a "
        "simulated WAN, which would mean a stall bug, not a model gap",
    ),
    "origin_fraction_delta": (
        -0.05, 0.5,
        "a 3-daemon planet pays the first-fetch origin cost once per "
        "content object over a tiny swarm, while the simulator amortizes "
        "it over thousands of modeled peers — real origin share is "
        "structurally inflated by O(1/M); it must never be materially "
        "BELOW sim (that would mean phantom P2P traffic) and may exceed "
        "it by at most the small-swarm inflation bound",
    ),
    "pieces_per_download_ratio": (
        0.25, 4.0,
        "piece count per completed download is payload_size/piece_length "
        "for the planet and the synthetic task-size model for the sim; "
        "the payload is sized to match the modeled mean within one "
        "octave each way, so a ratio outside [0.25, 4] means piece "
        "accounting broke (double counts or lost pieces), not sizing",
    ),
    "lost_downloads": (
        1.0, 1.0,
        "zero lost downloads is THE invariant both planes assert "
        "independently; the comparison must find exact agreement at 0 — "
        "there is no tolerance to argue",
    ),
    "paged_at_kill": (
        1.0, 1.0,
        "the announce-stability page firing AT the kill (and only at "
        "kills) is the alert contract the SLO plane exists for; both "
        "planes feed the same burn rules, so both must page on the kill "
        "rounds and nowhere else",
    ),
    "verdict_match": (
        1.0, 1.0,
        "one verdict plane: megascale_slo_specs + the same burn rules "
        "judge both runs, so the final verdict string must agree — a "
        "mismatch means the planes saw structurally different days",
    ),
    "failover_per_kill": (
        1.0, 1.0,
        "every scheduler kill must produce observable failover on both "
        "planes (daemon redial + re-announce in the planet, "
        "crash_reannounced_peers in the sim); a kill nobody noticed is "
        "a dead assertion",
    ),
}


def _sim_final_ttc_p95(timeline: list, regions: list) -> dict:
    """Last recorded per-region p95 — the megascale sketches are
    cumulative, so the final non-None value is the whole-run p95."""
    final: dict = {r: None for r in regions}
    for sample in timeline:
        p95 = sample.get("ttc_ms_p95")
        if not isinstance(p95, Mapping):
            continue
        for r in regions:
            v = p95.get(r)
            if v is not None:
                final[r] = float(v)
    return final


def _page_rounds(slo_block: Mapping, slo_name: str = "announce_stability"):
    return sorted(
        float(e["t"]) for e in slo_block.get("alert_log", [])
        if e.get("slo") == slo_name and e.get("severity") == "page"
        and e.get("event") == "fired"
    )


def _paged_at_kills_only(page_rounds: list, kill_rounds: list) -> int:
    """1 iff at least one page fired and every page landed on a kill
    round — pages happen at kills, and only at kills."""
    if not page_rounds or not kill_rounds:
        return 0
    kills = {float(k) for k in kill_rounds}
    return 1 if all(float(t) in kills for t in page_rounds) else 0


def compute_divergence(real: Mapping, sim: Mapping,
                       bands: Mapping = DEFAULT_BANDS) -> dict:
    """Build the divergence report.

    ``real`` is the planet's reduced fact sheet (built by
    ``planet.run_procday``): ttc_ms_p95 per region, origin_fraction,
    pieces, completed, lost_downloads, kills, failovers, kill_rounds,
    the run's ``slo`` block and scenario/seed identity.

    ``sim`` is the full ``run_megascale`` report for the same spec.

    Returns ``{"scenario", "seed", "metrics": {name: entry}, and
    "all_within"}`` where each entry is ``{kind, real, sim, value,
    band, argument, within}``.
    """
    metrics: dict = {}

    def add(name: str, band_key: str, kind: str, real_v, sim_v, value):
        lo, hi, argument = bands[band_key]
        within = value is not None and lo <= float(value) <= hi
        metrics[name] = {
            "kind": kind,
            "real": real_v,
            "sim": sim_v,
            "value": None if value is None else round(float(value), 6),
            "band": [lo, hi],
            "argument": argument,
            "within": bool(within),
        }

    # --- per-region TTC p95 ratio (real loopback vs modeled WAN)
    regions = sorted(real.get("ttc_ms_p95", {}))
    sim_p95 = _sim_final_ttc_p95(sim.get("timeline", []), regions)
    for r in regions:
        rv = real["ttc_ms_p95"].get(r)
        sv = sim_p95.get(r)
        ratio = (float(rv) / float(sv)) if rv and sv else None
        add(f"ttc_p95_ratio_{r}", "ttc_p95_ratio", "ratio", rv, sv, ratio)

    # --- origin fraction: real observed vs sim byte-accounted
    mega = sim.get("mega", {})
    ob, pb = mega.get("origin_bytes", 0), mega.get("p2p_bytes", 0)
    sim_of = (float(ob) / float(ob + pb)) if (ob + pb) > 0 else 0.0
    real_of = float(real.get("origin_fraction", 0.0))
    add("origin_fraction_delta", "origin_fraction_delta", "delta",
        round(real_of, 6), round(sim_of, 6), real_of - sim_of)

    # --- piece accounting per completed download
    st = sim.get("stats", {})
    sim_ppd = (st.get("pieces", 0) / max(st.get("completed", 0), 1))
    real_ppd = (real.get("pieces", 0) / max(real.get("completed", 0), 1))
    add("pieces_per_download_ratio", "pieces_per_download_ratio", "ratio",
        round(real_ppd, 3), round(sim_ppd, 3),
        real_ppd / sim_ppd if sim_ppd > 0 else None)

    # --- exact-agreement invariants
    sim_lost = int(st.get("failed", 0))
    real_lost = int(real.get("lost_downloads", 0))
    add("lost_downloads", "lost_downloads", "equal", real_lost, sim_lost,
        1.0 if real_lost == sim_lost == 0 else 0.0)

    real_paged = _paged_at_kills_only(
        _page_rounds(real.get("slo", {})), real.get("kill_rounds", []))
    sim_paged = _paged_at_kills_only(
        _page_rounds(sim.get("slo", {})),
        sim.get("expected_crash_rounds", []))
    add("paged_at_kill", "paged_at_kill", "equal", real_paged, sim_paged,
        1.0 if real_paged == sim_paged == 1 else 0.0)

    real_verdict = real.get("slo", {}).get("verdict_final")
    sim_verdict = sim.get("slo", {}).get("verdict_final")
    add("verdict_match", "verdict_match", "equal", real_verdict,
        sim_verdict, 1.0 if real_verdict == sim_verdict else 0.0)

    real_fo = 1 if (real.get("kills", 0) > 0
                    and real.get("failovers", 0) > 0) else 0
    fo = sim.get("failover", {})
    sim_fo = 1 if (fo.get("scheduler_crashes", 0) > 0
                   and fo.get("crash_reannounced_peers", 0) > 0) else 0
    add("failover_per_kill", "failover_per_kill", "equal", real_fo,
        sim_fo, 1.0 if real_fo == sim_fo == 1 else 0.0)

    return {
        "scenario": real.get("scenario"),
        "seed": real.get("seed"),
        "metrics": metrics,
        "all_within": all(m["within"] for m in metrics.values()),
    }


def publish_divergence(report: Mapping, metrics_ns) -> None:
    """Mirror each numeric comparison onto the
    ``dragonfly_proc_sim_real_divergence`` gauge family (one series per
    metric name) so the proc-observatory dashboard plots the live gap."""
    for name in sorted(report.get("metrics", {})):
        entry = report["metrics"][name]
        if entry.get("value") is not None:
            metrics_ns.sim_real_divergence.labels(name).set(
                float(entry["value"]))
