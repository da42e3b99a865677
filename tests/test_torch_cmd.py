"""The port's launchers as processes (``python -m dragonfly2_tpu_torch.cmd``)
on the CPU (``--device cpu``), over 127.0.0.1.

A trainer process and a scheduler process (the ml arm, the announce loop
to the trainer, the inference and metrics ports) print their READY lines;
peers play over the wire through the port's client (hosts announce, first
peers back-source, later ones take the tick's parents, probe rounds feed
the topology); the announce loop reaches the trainer, which publishes gnn
and mlp; the scheduler's ml arm starts serving the GNN version; SIGTERM
stops both with exit 0 within 10 s, the trace rows flushed. Then the data
plane: a scheduler process, two dfdaemon processes and the reference's
dfdaemon (READY lines of one format), files pulled through the daemons'
proxies and by a dfget process, each verified, the origin fetched once;
a dfdaemon dialing an mTLS scheduler with --tls-dir. Then what the launchers refuse: the manager, every manager edge and the
dfdaemon's object storage (A9 part 3), a megascale scenario (A11), and a
default device without a card.
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


DFDAEMON = ["dfdaemon", "--data-dir", "d", "--scheduler", "127.0.0.1:1"]


@pytest.mark.parametrize("argv,env,needle", [
    (["manager"], {}, "ROADMAP A9 part 3"),
    (DFDAEMON + ["--manager", "127.0.0.1:1"], {}, "ROADMAP A9 part 3"),
    (DFDAEMON + ["--object-storage"], {}, "ROADMAP A9 part 3"),
    (DFDAEMON + ["--tls-issue"], {}, "ROADMAP A9 part 3"),
    (DFDAEMON + ["--scenario", "soak"], {}, "ROADMAP A11"),
    (["scheduler", "--device", "cpu", "--manager", "127.0.0.1:1"], {}, "ROADMAP A9 part 3"),
    (["trainer", "--device", "cpu", "--data-dir", "d", "--registry-dir", "r", "--tls-issue"], {},
     "ROADMAP A9 part 3"),
    (["scheduler"], {"CUDA_VISIBLE_DEVICES": ""}, "torch.cuda.is_available() is False"),
    (["trainer", "--data-dir", "d", "--registry-dir", "r"], {"CUDA_VISIBLE_DEVICES": ""},
     "torch.cuda.is_available() is False"),
], ids=["manager", "dfdaemon-manager", "dfdaemon-object-storage", "dfdaemon-tls-issue",
        "dfdaemon-megascale-scenario", "scheduler-manager", "trainer-tls-issue",
        "scheduler-no-card", "trainer-no-card"])
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


# ------------------------------------------------------------ data plane


class _Origin:
    """Blobs over HTTP with Range support, counting data GETs."""

    def __init__(self, blobs: dict):
        import http.server

        self.blobs, self.gets = blobs, 0
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_HEAD(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(outer.blobs[self.path])))
                self.end_headers()

            def do_GET(self):
                outer.gets += 1
                data, status = outer.blobs[self.path], 200
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    start, _, end = rng[len("bytes="):].partition("-")
                    data = data[int(start or 0):int(end) + 1 if end else len(data)]
                    status = 206
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"


def _via_proxy(port: int, url: str) -> tuple[str, bytes]:
    import urllib.request

    req = urllib.request.Request(url)
    req.set_proxy(f"127.0.0.1:{port}", "http")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.headers.get("X-Dragonfly-Via"), resp.read()


def _loads_torch(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def test_dfdaemon_processes_serve_a_swarm(tmp_path):
    import hashlib

    import numpy as np

    blob = np.random.default_rng(0).integers(0, 256, 600_000, dtype=np.uint8).tobytes()
    origin = _Origin({"/blobs/layer": blob})
    url, sha = origin.base + "/blobs/layer", hashlib.sha256(blob).hexdigest()
    sched = None
    daemons: dict = {}
    stopped = []
    try:
        sched, s_ready, _ = _spawn(
            ["scheduler", "--device", "cpu", "--data-dir", str(tmp_path / "traces")],
            tmp_path / "sched.log")
        addr = f"{s_ready[1]}:{s_ready[2]}"
        for name in ("df-a", "df-b"):
            daemons[name] = _spawn(
                ["dfdaemon", "--data-dir", str(tmp_path / name), "--scheduler", addr,
                 "--hostname", name, "--proxy", "--proxy-rule", "/blobs/", "--metrics-port", "0"],
                tmp_path / f"{name}.log")
        ref_args = ["dfdaemon", "--data-dir", str(tmp_path / "ref"), "--scheduler", addr,
                    "--hostname", "df-ref", "--proxy", "--proxy-rule", "/blobs/",
                    "--metrics-port", "0"]
        start = time.monotonic()
        with open(tmp_path / "ref.log", "w") as log:
            ref = subprocess.Popen([sys.executable, "-m", "dragonfly2_tpu.cmd", *ref_args],
                                   cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=log,
                                   text=True)
        daemons["df-ref"] = (ref, ref.stdout.readline().split(), time.monotonic() - start)
        shapes = {name: [w if not w.isdigit() else "N" for w in ready]
                  for name, (_, ready, _) in daemons.items()}
        assert shapes["df-a"] == shapes["df-ref"] == [
            "READY", "127.0.0.1", "N", "PROXY", "N", "METRICS", "N"], shapes
        for name in ("df-a", "df-b"):
            assert not _loads_torch(daemons[name][0].pid), f"{name} loaded torch"

        via, body = _via_proxy(int(daemons["df-a"][1][4]), url)
        assert via == "p2p" and hashlib.sha256(body).hexdigest() == sha
        gets = origin.gets
        for name in ("df-b", "df-ref"):
            via, body = _via_proxy(int(daemons[name][1][4]), url)
            assert via == "p2p" and hashlib.sha256(body).hexdigest() == sha, name
        out = tmp_path / "dfget.bin"
        got = subprocess.run(
            [sys.executable, "-m", "dragonfly2_tpu_torch.client.cli", "dfget", url, "-o", str(out),
             "--scheduler", addr, "--data-dir", str(tmp_path / "dfget"), "--no-back-source",
             "--ip", "127.0.0.2"],
            cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
        assert got.returncode == 0, got.stderr
        assert hashlib.sha256(out.read_bytes()).hexdigest() == sha
        assert origin.gets == gets, "a later peer went to the origin"
    finally:
        for name, (proc, _, _) in daemons.items():
            stopped.append((name, *_stop(proc)))
        if sched is not None:
            stopped.append(("scheduler", *_stop(sched)))
        origin.server.shutdown()
        origin.server.server_close()
    for name, rc, seconds in stopped:
        assert rc == 0 and seconds < 10, (name, rc, seconds)
    rows = sum(len(p.read_text().splitlines()) - 1
               for p in (tmp_path / "traces").glob("download*.csv"))
    assert rows >= 4  # df-a, df-b, df-ref and dfget finished downloads


def test_dfdaemon_dials_a_tls_scheduler(tmp_path):
    """--tls-dir with the material in place: the scheduler serves mTLS and
    the dfdaemon dials it over mTLS; a pull through its proxy is
    scheduled (back to the origin, as the task's first peer)."""
    import hashlib

    from dragonfly2_tpu_torch.utils import certs

    certs.self_signed_material(tmp_path / "tls", "cluster")
    blob = bytes(range(256)) * 4000
    origin = _Origin({"/blobs/one": blob})
    procs = []
    try:
        sched, s_ready, _ = _spawn(
            ["scheduler", "--device", "cpu", "--tls-dir", str(tmp_path / "tls")],
            tmp_path / "sched.log")
        procs.append(("scheduler", sched))
        daemon, d_ready, _ = _spawn(
            ["dfdaemon", "--data-dir", str(tmp_path / "d"), "--scheduler",
             f"{s_ready[1]}:{s_ready[2]}", "--hostname", "tls-node", "--proxy",
             "--proxy-rule", "/blobs/", "--tls-dir", str(tmp_path / "tls")],
            tmp_path / "daemon.log")
        procs.append(("dfdaemon", daemon))
        via, body = _via_proxy(int(d_ready[4]), origin.base + "/blobs/one")
        assert via == "p2p" and hashlib.sha256(body).digest() == hashlib.sha256(blob).digest()
        assert "back-to-source" not in (tmp_path / "daemon.log").read_text()  # no schedule timeout
    finally:
        stopped = [(name, *_stop(p)) for name, p in reversed(procs)]
        origin.server.shutdown()
        origin.server.server_close()
    for name, rc, seconds in stopped:
        assert rc == 0 and seconds < 10, (name, rc, seconds)
