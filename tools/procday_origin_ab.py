"""Procday days of the process planet, each judged under both origin
accountings: the origin's body bytes in payload pieces (the port's
``procworld/planet.py origin_pieces_of``) and the origin's GET count (the
reference's, which counts each back-to-source's 1-byte range probe as a
piece). Prints one JSON line a day: each accounting's origin share and
final SLO verdict, the simulator's verdict, whether every divergence
metric is within its band (the port's accounting), the per-round
origin pieces, and each kill round's record (``run_procday``'s
``kill_log``: b, the origin copies beyond the round's seeders; the
failovers; the seed downloads and re-announces the inheriting
scheduler's triggers caused).

    python3 tools/procday_origin_ab.py --days 6 --device cpu

runs chip_smoke.py phase 19 (d)'s planet (SCALE_PROC) and its simulator
leg (SCALE_PROC_SIM, once: it is deterministic)."""

import argparse
import dataclasses
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dragonfly2_tpu_torch.megascale.soak import run_megascale  # noqa: E402
from dragonfly2_tpu_torch.procworld import compute_divergence, real_facts  # noqa: E402
from dragonfly2_tpu_torch.procworld import origin as origin_mod  # noqa: E402
from dragonfly2_tpu_torch.procworld import planet  # noqa: E402
from dragonfly2_tpu_torch.procworld.sample import synthesize_timeline  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--days", type=int, default=6)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    origins, gets, observations = [], [], []

    class CountingOrigin(origin_mod.OriginServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            origins.append(self)

    observe = planet.RoundObservation

    def recorded(**kw):
        # built right after the round reads the origin: its GETs so far
        gets.append(origins[-1].gets)
        observations.append(observe(**kw))
        return observations[-1]

    planet.OriginServer, planet.RoundObservation = CountingOrigin, recorded
    sim = None
    for day in range(args.days):
        origins.clear(), gets.clear(), observations.clear()
        with tempfile.TemporaryDirectory() as work:
            run = planet.run_procday(os.path.join(work, "planet"), device=args.device,
                                     **chip_smoke.SCALE_PROC)
        if sim is None:
            sim = run_megascale("procday", seed=run["seed"], rounds=run["rounds"],
                                device=args.device, **chip_smoke.SCALE_PROC_SIM)
        by_gets, prev = [], 0
        for o, g in zip(observations, gets):
            by_gets.append(dataclasses.replace(o, origin_pieces=min(g - prev, o.pieces)))
            prev = g
        _, slo_gets = synthesize_timeline(by_gets, minutes_per_round=run["minutes_per_round"],
                                          regions=sorted(run["ttc_ms_p95"]))
        pieces = sum(o.pieces for o in observations)
        print(json.dumps({
            "day": day,
            "bytes_origin_share": run["origin_fraction"],
            "bytes_verdict": run["slo"]["verdict_final"],
            "gets_origin_share": round(sum(o.origin_pieces for o in by_gets) / pieces, 6),
            "gets_verdict": slo_gets["verdict_final"],
            "sim_origin_share": compute_divergence(real_facts(run), sim)[
                "metrics"]["origin_fraction_delta"]["sim"],
            "sim_verdict": sim["slo"]["verdict_final"],
            "all_within": compute_divergence(real_facts(run), sim)["all_within"],
            "bytes_per_round": [o.origin_pieces for o in observations],
            "gets_per_round": [o.origin_pieces for o in by_gets],
            "lost_downloads": run["stats"]["lost_downloads"],
            "seeds": run["seeds"],
            "reannounces": run["stats"]["reannounces"],
            "kill_log": run["kill_log"],
        }), flush=True)


if __name__ == "__main__":
    main()
