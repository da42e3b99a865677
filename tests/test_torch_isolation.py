"""The torch port stands alone: importing every module of
dragonfly2_tpu_torch, chip_smoke.py, the port's measurement scripts
tools/{tick_wrapper,train_register}_cost.py and its workload drivers
tools/torch_*.py loads no jax, flax, dragonfly2_tpu or tools.dflint module."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pathlib, pkgutil, sys
import dragonfly2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dragonfly2_tpu_torch.__path__, "dragonfly2_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import tools.tick_wrapper_cost
import tools.train_register_cost
drivers = sorted(p.stem for p in pathlib.Path("tools").glob("torch_*.py"))
for driver in drivers:
    importlib.import_module(f"tools.{driver}")
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "dragonfly2_tpu")
    or m == "tools.dflint" or m.startswith("tools.dflint.")
)
print(f"MODULES={len(names)}")
print(f"NAMES={','.join(names)}")
print(f"TORCH={'torch' in sys.modules}")
print(f"DRIVERS={','.join(drivers)}")
print(f"BAD={','.join(bad)}")
"""


def test_port_imports_no_jax_flax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = dict(line.partition("=")[::2] for line in out.stdout.splitlines())
    assert int(lines["MODULES"]) >= 20  # every module of the slice was imported
    names = set(lines["NAMES"].split(","))
    for module in ("ops.topk", "ops.evaluator", "ops.tick", "state.cluster", "graph.dag",
                   "native", "cluster.scheduler", "records.features",
                   # slice 7: the scheduler service and what it imports
                   "config.config", "records.schema", "records.storage", "records.synth",
                   "cluster.messages", "cluster.quarantine", "cluster.simulator",
                   "ops.segment", "telemetry", "telemetry.metrics", "telemetry.series",
                   "telemetry.flight", "telemetry.decisions", "telemetry.slo",
                   "rpc.resilience", "scenarios", "scenarios.spec", "scenarios.engine",
                   # slice 16: probes, the segment reductions and the graph models
                   "utils.prng", "ops.ewma", "cluster.probes", "models", "models.graphsage",
                   "models.mlp", "models.convert", "training.data",
                   # slice 19: the processes, their wire servers and clients
                   "version", "cmd", "rpc.server", "rpc.client", "rpc.mux", "rpc.wire",
                   "cluster.service_v1", "utils.retry", "utils.vsock", "utils.hashring",
                   "utils.certs",
                   # slice 20: the dfdaemon, its CLIs and what they import
                   "client", "client.storage", "client.source", "client.object_sources",
                   "client.piece_manager", "client.dispatcher", "client.upload",
                   "client.conductor", "client.daemon", "client.transport", "client.proxy",
                   "client.cli", "utils.container", "utils.gc", "utils.hoststat",
                   "telemetry.timeline", "telemetry.tailtrace",
                   # slice 21: the manager, its jobs and dynconfig
                   "manager", "manager.models", "manager.auth", "manager.searcher",
                   "manager.oauth", "manager.service", "manager.rpc", "manager.rest",
                   "manager.console", "cluster.jobs", "cluster.image_preheat",
                   "utils.dflog", "utils.dynconfig", "utils.plugins",
                   # slice 22: object storage, the shared caches, the cost cards
                   "objectstorage", "objectstorage.backends", "objectstorage.signing",
                   "objectstorage.remote", "objectstorage.service", "utils.cache",
                   "utils.dfpath", "telemetry.costcard",
                   # slice 23: the scale labs
                   "megascale", "megascale.topology", "megascale.engine", "megascale.soak",
                   "megascale.fleet", "procworld", "procworld.origin", "procworld.sample",
                   "procworld.divergence", "procworld.supervisor", "procworld.planet",
                   "rpc.wireskew",
                   # slice 24: tensor, pipeline and expert parallelism
                   "parallel", "parallel.mesh", "parallel.tensor", "parallel.pipeline",
                   "parallel.moe"):
        assert f"dragonfly2_tpu_torch.{module}" in names, module
    assert lines["TORCH"] == "True"
    assert {"torch_stress", "torch_llm_prefetch"} <= set(lines["DRIVERS"].split(","))
    assert lines["BAD"] == "", f"port pulled in: {lines['BAD']}"
