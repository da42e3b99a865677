"""The port's launchers as processes (``python -m dragonfly2_tpu_torch.cmd``)
on the CPU (``--device cpu``), over 127.0.0.1.

A trainer process and a scheduler process (the ml arm, the announce loop
to the trainer, the inference and metrics ports) print their READY lines;
peers play over the wire through the port's client (hosts announce, first
peers back-source, later ones take the tick's parents, probe rounds feed
the topology); the announce loop reaches the trainer, which publishes gnn
and mlp; the scheduler's ml arm starts serving the GNN version; SIGTERM
stops both with exit 0 within 10 s, the trace rows flushed. Then what the
launchers refuse: the manager and dfdaemon (A9's later parts), their
manager edges, and a default device without a card.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED_ID = "sched-under-test"


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, **extra)
    return env


def _cmd(*args):
    return [sys.executable, "-m", "dragonfly2_tpu_torch.cmd", *args]


def _spawn(args, log_path, timeout=60.0, env=None):
    """Start a launcher; return (process, READY line split, seconds to READY)."""
    start = time.monotonic()
    log = open(log_path, "w")
    proc = subprocess.Popen(_cmd(*args), cwd=REPO, env=env or _env(), stdout=subprocess.PIPE,
                            stderr=log, text=True)
    log.close()
    line: list[str] = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout)
    if not line or not line[0].startswith("READY"):
        proc.kill()
        proc.wait()
        raise AssertionError(f"no READY from {args[0]}: {line}; log:\n{open(log_path).read()}")
    return proc, line[0].split(), time.monotonic() - start


def _stop(proc) -> tuple[int, float]:
    start = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    return rc, time.monotonic() - start


async def _play(host, port, n_hosts=24, tasks=4, peers_per_task=12, probe_sources=12):
    """Downloads and probe rounds over the wire, as daemons would send them."""
    from dragonfly2_tpu_torch.cluster import messages as msg
    from dragonfly2_tpu_torch.rpc import client

    conn = await client.SchedulerConnection(host, port).connect()
    piece, pieces = 1 << 20, 4
    answered = 0
    try:
        hosts = [msg.HostInfo(host_id=f"h-{i}", hostname=f"node-{i}", ip=f"10.2.0.{i + 1}",
                              idc=f"idc-{i % 3}", location=f"eu|z{i % 2}", port=8002,
                              download_port=8001)
                 for i in range(n_hosts)]
        for h in hosts:
            await conn.send(msg.AnnounceHostRequest(host=h))

        async def download(peer_id, task_id, h):
            nonlocal answered
            queue = conn.subscribe(peer_id)
            await conn.send(msg.RegisterPeerRequest(
                peer_id=peer_id, task_id=task_id, host=hosts[h], url=f"https://o.example/{task_id}",
                content_length=piece * pieces, piece_length=piece))
            answer = await asyncio.wait_for(queue.get(), 30)
            answered += 1
            name = type(answer).__name__
            if name == "NeedBackToSourceResponse":
                await conn.send(msg.DownloadPeerBackToSourceStartedRequest(peer_id=peer_id))
                parent, done = "", msg.DownloadPeerBackToSourceFinishedRequest
            else:
                assert name == "NormalTaskResponse", answer
                parent, done = answer.candidate_parents[0].peer_id, msg.DownloadPeerFinishedRequest
            for n in range(pieces):
                await conn.send(msg.DownloadPieceFinishedRequest(
                    peer_id=peer_id, piece_number=n, length=piece, cost_ns=(3 + h % 7) * 10**6,
                    parent_peer_id=parent))
            await conn.send(done(peer_id=peer_id, content_length=piece * pieces,
                                 piece_count=pieces))
            await conn.stat_peer(peer_id)  # a barrier: the frames above are applied

        for t in range(tasks):
            await download(f"p-{t}-0", f"task-{t}", t)
        for i in range(1, peers_per_task):
            await asyncio.gather(*(download(f"p-{t}-{i}", f"task-{t}", (t * 5 + i) % n_hosts)
                                   for t in range(tasks)))
        for s in range(probe_sources):
            targets = await conn.sync_probes(hosts[s].host_id, count=8)
            await conn.send(msg.ProbeFinishedRequest(host_id=hosts[s].host_id, results=[
                msg.ProbeResult(host_id=t.host_id, rtt_ns=(1 + (s + j) % 9) * 250_000)
                for j, t in enumerate(targets)]))
        await conn.stat_task("task-0")
        return answered
    finally:
        await conn.close()


def _wait(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


def test_scheduler_and_trainer_processes_close_the_loop(tmp_path):
    from dragonfly2_tpu_torch.cluster.trainer_service import GNN_MODEL_NAME, MLP_MODEL_NAME
    from dragonfly2_tpu_torch.registry import ModelRegistry

    config = tmp_path / "trainer.json"
    config.write_text(json.dumps({"trainer": {"epochs": 2, "batch_size": 32, "hidden_dim": 16}}))
    registry_dir, sched_dir = tmp_path / "registry", tmp_path / "sched"
    trainer, t_ready, _ = _spawn(
        ["trainer", "--device", "cpu", "--data-dir", str(tmp_path / "trainer"),
         "--registry-dir", str(registry_dir), "--config", str(config), "--metrics-port", "0"],
        tmp_path / "trainer.log")
    sched = None
    try:
        assert t_ready[0] == "READY" and "METRICS" in t_ready
        sched, s_ready, _ = _spawn(
            ["scheduler", "--device", "cpu", "--data-dir", str(sched_dir),
             "--registry-dir", str(registry_dir), "--algorithm", "ml",
             "--trainer", f"{t_ready[1]}:{t_ready[2]}", "--announce-interval", "2",
             "--network-topology-collect-interval", "1",
             "--ml-refresh-interval", "0.5", "--scheduler-host-id", SCHED_ID,
             "--metrics-port", "0"],
            tmp_path / "sched.log")
        assert s_ready[0] == "READY" and s_ready[3] == "INFER" and s_ready[6] == "METRICS"
        answered = asyncio.run(_play(s_ready[1], int(s_ready[2])))
        assert answered == 4 * 12

        registry = ModelRegistry(registry_dir)
        for name in (GNN_MODEL_NAME, MLP_MODEL_NAME):
            mid = registry.model_id(name, SCHED_ID)
            _wait(lambda mid=mid: registry.active_version(mid), 120, f"{name} to go active")
        gnn = registry.active_version(registry.model_id(GNN_MODEL_NAME, SCHED_ID)).version
        _wait(lambda: f"ml evaluator serving model version {gnn}"
              in (tmp_path / "sched.log").read_text(), 60, "the ml arm to serve the GNN")

        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{s_ready[7]}/metrics", timeout=10) as r:
            scraped = r.read().decode()
        assert "dragonfly_scheduler_tick_seconds_count" in scraped
        assert 'dragonfly_scheduler_announce_peer_total{type="RegisterPeerRequest"} 48.0' in scraped
        assert "dragonfly_scheduler_version{" in scraped
        assert "dragonfly_serving_activation_accepted_total 1.0" in scraped
    finally:
        stopped = [(name, *_stop(p)) for name, p in (("scheduler", sched), ("trainer", trainer))
                   if p is not None]
    for name, rc, seconds in stopped:
        assert rc == 0 and seconds < 10, (name, rc, seconds, (tmp_path / f"{name[:5]}.log"))
    rows = sum(len(p.read_text().splitlines()) - 1 for p in sched_dir.glob("download*.csv"))
    assert rows >= 48


@pytest.mark.parametrize("argv,env,needle", [
    (["manager"], {}, "ROADMAP A9 part 3"),
    (["dfdaemon", "--data-dir", "d", "--scheduler", "127.0.0.1:1"], {}, "ROADMAP A9 part 2"),
    (["scheduler", "--device", "cpu", "--manager", "127.0.0.1:1"], {}, "ROADMAP A9 part 3"),
    (["trainer", "--device", "cpu", "--data-dir", "d", "--registry-dir", "r", "--tls-issue"], {},
     "ROADMAP A9 part 3"),
    (["scheduler"], {"CUDA_VISIBLE_DEVICES": ""}, "torch.cuda.is_available() is False"),
    (["trainer", "--data-dir", "d", "--registry-dir", "r"], {"CUDA_VISIBLE_DEVICES": ""},
     "torch.cuda.is_available() is False"),
], ids=["manager", "dfdaemon", "scheduler-manager", "trainer-tls-issue", "scheduler-no-card",
        "trainer-no-card"])
def test_launcher_refusals_exit_nonzero(tmp_path, argv, env, needle):
    out = subprocess.run(_cmd(*argv), cwd=tmp_path, env=_env(**env), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and needle in out.stderr, out.stderr
    assert "READY" not in out.stdout


def test_version_and_tls_dir_without_material(tmp_path):
    out = subprocess.run(_cmd("--version"), cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0
    assert out.stdout.startswith("dragonfly2-tpu-torch v") and "torch" in out.stdout
    out = subprocess.run(_cmd("scheduler", "--device", "cpu", "--tls-dir", str(tmp_path / "tls")),
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no cert material" in out.stderr
