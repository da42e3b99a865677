"""What the trainer's cost-card registration costs a one-block training.

The first training at an (entry, signature) in a process counts its first
step for the cost card (training/train.py ``_register_card``) and times
its block from the step after; a later one finds the card and counts
nothing. This script trains one-block runs in turn, the ledger emptied
before each "registers" run and left holding the card before each
"card held" run, in the order registers, held, held, registers,
``--pairs`` times, and prints each run's samples/s and each mode's
median:

- ``one device``: train_attention with one epoch in one block;
- ``ring`` and ``ulysses``: train_attention on a dp 2 x sp 2 mesh of the
  one card, one epoch (chip_smoke.py's phase 6).

The data is chip_smoke.py's training trace (bench_trainer.py's: 10,000
hosts, 20,000 records, 512 tasks, 20 parents), the config the trainer's
defaults. Builds the kernels first; needs the card.

    python3 tools/train_register_cost.py --pairs 3

Prints the card's name and power limit first (nvidia-smi), a JSON object
a run, then the summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HOSTS, RECORDS, TASKS, MAX_PARENTS, SEED = 10_000, 20_000, 512, 20, 0
MODES = ("registers", "held", "held", "registers")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs", type=int, default=3)
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.ops import build
    from dragonfly2_tpu_torch.parallel.mesh import make_mesh
    from dragonfly2_tpu_torch.records import synth
    from dragonfly2_tpu_torch.records.features import downloads_to_ranking_dataset
    from dragonfly2_tpu_torch.telemetry import costcard
    from dragonfly2_tpu_torch.training import train

    build.build_all([*build.kernel_sources(), build.LAUNCHER])
    cluster = synth.make_cluster(HOSTS, seed=SEED)
    records = synth.gen_download_records(cluster, RECORDS, num_tasks=TASKS,
                                         max_parents=MAX_PARENTS)
    ds, _ = downloads_to_ranking_dataset(records, max_parents=MAX_PARENTS)
    card = torch.device("cuda", 0)
    mesh = make_mesh(4, dp=2, sp=2, devices=[card] * 4)
    config = TrainerConfig(epochs=1, epoch_fusion=1)
    runs = {
        "one device": lambda: train.train_attention(ds, config, seed=SEED),
        "ring": lambda: train.train_attention(ds, config, mesh=mesh, seed=SEED,
                                              sp_strategy="ring"),
        "ulysses": lambda: train.train_attention(ds, config, mesh=mesh, seed=SEED,
                                                 sp_strategy="ulysses"),
    }
    summary = {}
    for label, run in runs.items():
        run()  # warm: the first launches at these shapes
        rates = {"registers": [], "held": []}
        for _ in range(opts.pairs):
            for mode in MODES:
                if mode == "registers":
                    costcard.ledger().reset()
                before = len(costcard.ledger().cards())
                torch.cuda.synchronize()
                result = run()
                counted = len(costcard.ledger().cards()) - before
                if counted != (mode == "registers"):
                    raise SystemExit(f"{label} {mode}: {counted} cards registered")
                rates[mode].append(result.samples_per_sec)
                print(json.dumps({"run": label, "mode": mode, "steps": result.steps,
                                  "samples_per_sec": result.samples_per_sec}), flush=True)
        summary[label] = {mode: {"samples_per_sec": values,
                                 "median": statistics.median(values)}
                          for mode, values in rates.items()}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
