"""The reference's operator tools over the port's artifacts, unchanged:
tools/dfwhy.py explains a decision from the port's DecisionLedger dump (and
from its flight-recorder body) as it does from the reference's on the same
seeded rounds, and tools/fsck.py scans a port daemon's storage after a
download (exit 0), then finds one flipped byte (exit 1). Each tool runs as
an operator runs it, a process of its own. (tools/dfslo.py and
tools/dftail.py are held on the port's reports by
tests/test_torch_megascale.py and tests/test_torch_procworld.py.)"""

import asyncio
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name: str, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", f"tools.{name}", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def _ledger_run(package: str):
    """tests/test_decisions.py's scenario-lab replay (bandwidth_skew, 48
    hosts, 4 tasks, seed 5, 8 downloads a round until 8 decisions joined),
    peer ids deterministic, in one package; returns the service."""
    if package == "ref":
        from dragonfly2_tpu.cluster.scheduler import SchedulerService
        from dragonfly2_tpu.cluster.simulator import ClusterSimulator
        from dragonfly2_tpu.scenarios.spec import builtin_scenarios
        from dragonfly2_tpu.telemetry import metrics

        svc = SchedulerService(metrics_registry=metrics.Registry())
    else:
        from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
        from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
        from dragonfly2_tpu_torch.scenarios.spec import builtin_scenarios
        from dragonfly2_tpu_torch.telemetry import metrics

        svc = SchedulerService(metrics_registry=metrics.Registry(), device="cpu")
    sim = ClusterSimulator(svc, num_hosts=48, num_tasks=4, seed=5,
                           scenario=builtin_scenarios()["bandwidth_skew"],
                           deterministic_peer_ids=True)
    rounds = 0
    while svc.decisions.counters()["joined"] < 8 and rounds < 400:
        sim.run_round(8)
        rounds += 1
    return svc


@pytest.fixture(scope="module")
def ledger_dumps(tmp_path_factory):
    root = tmp_path_factory.mktemp("ledgers")
    paths = {}
    for package in ("ref", "port"):
        svc = _ledger_run(package)
        paths[package] = root / f"{package}.json"
        paths[package].write_text(json.dumps(svc.decisions.dump(last_n=256)))
        if package == "port":  # the /debug/flight body: rows under decisions.<name>.rows
            paths["port-flight"] = root / "port-flight.json"
            paths["port-flight"].write_text(json.dumps(svc.flight_dump(), default=str))
    return paths


def _wall_free(text: str) -> str:
    """An explanation less its wall-clock figure (a decision's ttc_ms)."""
    return re.sub(r"ttc_ms=[0-9.]+", "ttc_ms=*", text)


def test_dfwhy_explains_the_ports_decision_as_the_references(ledger_dumps):
    ref_rows = json.loads(ledger_dumps["ref"].read_text())["rows"]
    port_rows = json.loads(ledger_dumps["port"].read_text())["rows"]
    assert [r["peer"] for r in port_rows] == [r["peer"] for r in ref_rows]
    target = next(r for r in reversed(port_rows) if r["chosen_parent"] is not None)
    runs = {package: _tool("dfwhy", str(ledger_dumps[package]), "--peer", target["peer"],
                           "--last")
            for package in ("ref", "port", "port-flight")}
    for package, run in runs.items():
        assert run.returncode == 0, (package, run.stderr)
    port_out = runs["port"].stdout
    assert f"peer={target['peer']}" in port_out and target["chosen_parent"] in port_out
    assert port_out.count("cand[") == len(target["candidates"])
    assert "outcome=" in port_out and "score=" in port_out
    assert _wall_free(port_out) == _wall_free(runs["ref"].stdout)
    assert runs["port-flight"].stdout == port_out  # the flight body carries the same rows


def test_dfwhy_exit_codes_on_the_ports_dump(ledger_dumps, tmp_path):
    port = str(ledger_dumps["port"])
    rows = json.loads(ledger_dumps["port"].read_text())["rows"]
    target = next(r for r in rows if r["chosen_parent"] is not None)
    run = _tool("dfwhy", port, "--peer", target["peer"], "--parent", target["chosen_parent"])
    assert run.returncode == 0 and target["chosen_parent"] in run.stdout
    listed = _tool("dfwhy", port, "--list")
    assert listed.returncode == 0 and target["peer"] in listed.stdout
    assert _tool("dfwhy", port, "--peer", "nope").returncode == 1
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    assert _tool("dfwhy", str(empty), "--peer", "x").returncode == 2


def test_fsck_scans_a_port_daemons_storage(tmp_path):
    """After the port's prefetch rig (a seed back-sources 2 shards, 2 hosts
    pull them P2P): fsck passes every host's store, then fails the one
    whose shard had a byte flipped, naming the task and its piece."""
    from tools import torch_llm_prefetch

    result, _ = asyncio.run(torch_llm_prefetch.run(2, 192 * 1024, 2, 64 * 1024, str(tmp_path),
                                                   device="cpu"))
    assert result["fleet_offload_pct"] == 100.0
    hosts = sorted(p for p in tmp_path.iterdir() if p.is_dir())
    assert [h.name for h in hosts] == ["h0", "h1", "seed"]
    for host in hosts:
        run = _tool("fsck", str(host))
        assert run.returncode == 0, (host.name, run.stdout, run.stderr)
        assert "BAD" not in run.stdout
    data = sorted((tmp_path / "h1").glob("*/data"))[0]
    raw = bytearray(data.read_bytes())
    raw[100_000] ^= 0x01  # one byte of the second piece
    data.write_bytes(bytes(raw))
    run = _tool("fsck", str(tmp_path / "h1"), "--json")
    assert run.returncode == 1, run.stdout
    report = json.loads(run.stdout)
    task = data.parent.name
    kinds = {(f["task_id"], f["kind"], f["piece"]) for f in report["findings"]}
    assert (task, "piece_digest", 1) in kinds
    assert any(k[:2] == (task, "task_digest") for k in kinds)
    assert all(k[0] == task for k in kinds)  # the other shard is clean
    for host in ("h0", "seed"):  # the other stores still pass
        assert _tool("fsck", str(tmp_path / host)).returncode == 0
