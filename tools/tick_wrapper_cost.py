"""Host cost of the scheduler's entry wrappers on the fused tick.

Two measurements, on the scheduler service of chip_smoke.py's phase 10
(10,000 hosts, 512 tasks, 64 downloads a round, bench_loop's probe store
and a probe round every 50 rounds), on the card unless ``--device cpu``:

``--micro``: the real arguments of the service's last fused_tick_chunk
call, after warmup and the timed rounds, each way of telling a new call
signature timed in microseconds per call (the median of ``--repeats``
runs of ``--calls`` calls): hashing every argument (telemetry/flight.py
``_sig_of``) with the set lookup, the entry's key (ops/tick.py
``_chunk_key``) with the lookup, the whole shipped wrapper around a
function that does nothing, and a bare call of that function.

``--parent DIR``: the service's tick with the package in DIR (an unpacked
earlier commit) and with this checkout's, each in a process of its own,
in the order parent, change, change, parent, ``--pairs`` times; each
process prints the tick p50 and the fused_dispatch phase's p50 over
``--rounds`` timed rounds, host clock, and the summary gives each side's
median of them. ``--no-capture`` runs this checkout's service with the
warmup's cost-card capture (telemetry/costcard.py ``capture_pending``)
made a no-op in place of the parent, to split what the capture leaves
behind in the process from the rest of the change.

    python3 tools/tick_wrapper_cost.py --micro --parent /path/to/parent

Prints the card's name and power limit first (nvidia-smi) and a JSON
object per process, then the summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS, TASKS, DOWNLOADS, SEED = 10_000, 512, 64, 0
PROBE_PAIRS, PROBE_SOURCES, PROBE_EVERY = 1 << 17, 8, 50


def _service(device: str, data_dir: str, hosts: int, tasks: int):
    from dragonfly2_tpu_torch.cluster.probes import ProbeStore
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.records.storage import TraceStorage

    cfg = Config()
    probes = ProbeStore(max_pairs=PROBE_PAIRS, max_hosts=cfg.scheduler.max_hosts, device=device)
    svc = SchedulerService(config=cfg, storage=TraceStorage(data_dir), probes=probes, seed=SEED,
                           device=device)
    sim = ClusterSimulator(svc, num_hosts=hosts, num_tasks=tasks, seed=SEED,
                           deterministic_peer_ids=True)
    return svc, sim


def _round(svc, sim, probe: bool) -> float:
    for _ in range(DOWNLOADS):
        sim.start_download()
    sim.consume_seed_triggers()
    start = time.perf_counter()
    responses = svc.tick()
    tick_ms = (time.perf_counter() - start) * 1e3
    for resp in responses:
        sim._act(resp)
    if probe:
        sim.run_probe_round(sources=PROBE_SOURCES)
    svc.run_gc()
    return tick_ms


def _per_call_us(fn, calls: int, repeats: int) -> float:
    runs = []
    for _ in range(repeats):
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - start) / calls * 1e6)
    return statistics.median(runs)


def _micro(args, kwargs, calls: int, repeats: int) -> dict:
    from dragonfly2_tpu_torch.ops import tick
    from dragonfly2_tpu_torch.telemetry import flight

    wrapper = tick.fused_tick_chunk
    full_seen = {(flight._sig_of(args),
                  flight._sig_of(tuple(sorted(kwargs.items(), key=lambda kv: kv[0]))))}
    key_seen = {tick._chunk_key(*args, **kwargs)}

    def full():
        return (flight._sig_of(args),
                flight._sig_of(tuple(sorted(kwargs.items(), key=lambda kv: kv[0])))) in full_seen

    def key():
        return tick._chunk_key(*args, **kwargs) in key_seen

    def nothing(*a, **k):
        return None

    real = wrapper.__wrapped__
    wrapper.__wrapped__ = nothing
    try:
        wrapped_us = _per_call_us(lambda: wrapper(*args, **kwargs), calls, repeats)
    finally:
        wrapper.__wrapped__ = real
    return {
        "sig_of_us": _per_call_us(full, calls, repeats),
        "chunk_key_us": _per_call_us(key, calls, repeats),
        "wrapper_us": wrapped_us,
        "bare_call_us": _per_call_us(lambda: nothing(*args, **kwargs), calls, repeats),
        "cols": len(args[1]),
    }


def child(opts) -> None:
    sys.path.insert(0, opts.tree)
    import torch

    from dragonfly2_tpu_torch.ops import tick

    package = os.path.dirname(sys.modules["dragonfly2_tpu_torch.ops.tick"].__file__)
    if opts.no_capture:
        from dragonfly2_tpu_torch.telemetry import costcard

        costcard.capture_pending = list  # warmup drains nothing
    last = {}
    if opts.micro:
        real = tick.fused_tick_chunk.__wrapped__

        def spy(*a, **k):
            last["call"] = (a, k)
            return real(*a, **k)

        tick.fused_tick_chunk.__wrapped__ = spy
    with tempfile.TemporaryDirectory() as data_dir:
        svc, sim = _service(opts.device, data_dir, opts.hosts, opts.tasks)
        svc.warmup()
        for i in range(opts.warm_rounds):
            _round(svc, sim, probe=False)
        if opts.device != "cpu":
            torch.cuda.synchronize()
        ticks = [_round(svc, sim, probe=i % PROBE_EVERY == 0)
                 for i in range(1, opts.rounds + 1)]
        out = {
            "tree": opts.label, "package": package, "rounds": opts.rounds,
            "modules": len(sys.modules),
            "tick_p50_ms": statistics.median(ticks),
            "fused_dispatch_p50_ms": svc.recorder.phase_p50s(opts.rounds)["fused_dispatch"],
        }
        if opts.micro:
            tick.fused_tick_chunk.__wrapped__ = real
            out["micro"] = _micro(*last["call"], opts.calls, opts.repeats)
    print("RESULT " + json.dumps(out), flush=True)


def _run(opts, tree: str, label: str, micro: bool, no_capture: bool = False) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--tree", tree, "--label", label,
           "--device", opts.device, "--hosts", str(opts.hosts), "--tasks", str(opts.tasks),
           "--rounds", str(opts.rounds),
           "--warm-rounds", str(opts.warm_rounds), "--calls", str(opts.calls),
           "--repeats", str(opts.repeats)] + (["--micro"] if micro else []) + (
               ["--no-capture"] if no_capture else [])
    # the child must import the package from ``tree`` alone
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=opts.timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{label} ({tree}) failed with exit code {proc.returncode}")
    result = json.loads(lines[-1][len("RESULT "):])
    print(json.dumps(result), flush=True)
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="a directory holding the earlier dragonfly2_tpu_torch")
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--micro", action="store_true")
    parser.add_argument("--no-capture", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--hosts", type=int, default=HOSTS)
    parser.add_argument("--tasks", type=int, default=TASKS)
    parser.add_argument("--rounds", type=int, default=300)
    parser.add_argument("--warm-rounds", type=int, default=20)
    parser.add_argument("--calls", type=int, default=20_000)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--timeout", type=float, default=600)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--tree", default=HERE, help=argparse.SUPPRESS)
    parser.add_argument("--label", default="change", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.child:
        child(opts)
        return
    if opts.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu for a CPU run)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    summary = {}
    if opts.micro:
        summary["micro"] = _run(opts, HERE, "change", micro=True)["micro"]
    if opts.parent or opts.no_capture:
        other = "no capture" if opts.no_capture else "parent"
        sides = {other: [], "change": []}
        for _ in range(opts.pairs):
            for label in (other, "change", "change", other):
                tree = os.path.abspath(opts.parent) if label == "parent" else HERE
                sides[label].append(_run(opts, tree, label, micro=False,
                                         no_capture=label == "no capture"))
        for label, runs in sides.items():
            summary[label] = {
                "tick_p50_ms": [r["tick_p50_ms"] for r in runs],
                "fused_dispatch_p50_ms": [r["fused_dispatch_p50_ms"] for r in runs],
                "tick_p50_median_ms": statistics.median(r["tick_p50_ms"] for r in runs),
                "fused_dispatch_p50_median_ms": statistics.median(
                    r["fused_dispatch_p50_ms"] for r in runs),
            }
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
