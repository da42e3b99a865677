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
import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
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
    stopped: list = []
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
        gnn_id = registry.model_id(GNN_MODEL_NAME, SCHED_ID)
        for name in (GNN_MODEL_NAME, MLP_MODEL_NAME):
            mid = registry.model_id(name, SCHED_ID)
            _wait(lambda mid=mid: registry.active_version(mid), 120, f"{name} to go active")
        gnn = registry.active_version(gnn_id).version
        _wait(lambda: f"ml evaluator serving model version {gnn}"
              in (tmp_path / "sched.log").read_text(), 60, "the ml arm to serve the GNN")

        # The trainer publishes a new version at every upload (every 2 s),
        # so stop it first: no version comes after its exit, and once the
        # ml arm serves the last one, its activations are all counted.
        stopped.append(("trainer", *_stop(trainer)))
        trainer = None
        gnn = registry.active_version(gnn_id).version
        _wait(lambda: f"ml evaluator serving model version {gnn}"
              in (tmp_path / "sched.log").read_text(), 60, "the ml arm to serve the last GNN")
        served = set(re.findall(r"ml evaluator serving model version (\d+)",
                                (tmp_path / "sched.log").read_text()))

        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{s_ready[7]}/metrics", timeout=10) as r:
            scraped = r.read().decode()
        assert "dragonfly_scheduler_tick_seconds_count" in scraped
        assert 'dragonfly_scheduler_announce_peer_total{type="RegisterPeerRequest"} 48.0' in scraped
        assert "dragonfly_scheduler_version{" in scraped
        # one accepted activation for each version the ml arm said it served
        assert f"dragonfly_serving_activation_accepted_total {float(len(served))}" in scraped
    finally:
        stopped += [(name, *_stop(p)) for name, p in (("scheduler", sched), ("trainer", trainer))
                    if p is not None]
    for name, rc, seconds in stopped:
        assert rc == 0 and seconds < 10, (name, rc, seconds, (tmp_path / f"{name[:5]}.log"))
    rows = sum(len(p.read_text().splitlines()) - 1 for p in sched_dir.glob("download*.csv"))
    assert rows >= 48


def test_sigterm_during_a_training_exits_promptly(tmp_path):
    """A trainer given SIGTERM in the middle of a training ends it at the
    next step and exits 0 within 10 s (the port's stop event; the
    reference's trainer runs the training out first), publishing nothing."""
    from dragonfly2_tpu_torch.records import synth
    from dragonfly2_tpu_torch.records.storage import TraceStorage
    from dragonfly2_tpu_torch.registry import ModelRegistry
    from dragonfly2_tpu_torch.rpc.client import TrainerClient

    cluster = synth.make_cluster(24, seed=1)
    store = TraceStorage(tmp_path / "traces")
    for rec in synth.gen_download_records(cluster, 120, num_tasks=8):
        store.create_download(rec)
    store.flush()
    downloads = b"".join(p.read_bytes() for p in store.downloads.all_paths())
    config = tmp_path / "trainer.json"
    # far more epochs than the test lasts: only the abort ends this training
    config.write_text(json.dumps({"trainer": {"epochs": 1_000_000, "batch_size": 32,
                                              "hidden_dim": 16}}))
    # one intra-op thread: the endless training must not starve the
    # tests that share the machine
    trainer, ready, _ = _spawn(
        ["trainer", "--device", "cpu", "--data-dir", str(tmp_path / "trainer"),
         "--registry-dir", str(tmp_path / "registry"), "--config", str(config)],
        tmp_path / "trainer.log", env=_env(OMP_NUM_THREADS="1"))
    try:
        def upload():
            client = TrainerClient(ready[1], int(ready[2]))
            with contextlib.suppress(Exception):  # the trainer dies mid-answer
                asyncio.run(client.train("sched-1", "127.0.0.1", "sched-node",
                                         {"download": downloads}))

        threading.Thread(target=upload, daemon=True).start()
        _wait(lambda: any((tmp_path / "trainer").rglob("*download*")), 30, "the upload to land")
        time.sleep(2.0)  # the stream's end marker is in: the training is under way
    finally:
        rc, seconds = _stop(trainer)
    assert rc == 0 and seconds < 10, (rc, seconds, (tmp_path / "trainer.log").read_text())
    assert "aborted: the trainer is stopping" in (tmp_path / "trainer.log").read_text()
    assert not list(ModelRegistry(tmp_path / "registry").list_models())


DFDAEMON = ["dfdaemon", "--data-dir", "d", "--scheduler", "127.0.0.1:1"]


@pytest.mark.parametrize("argv,env,needle", [
    # a signed vendor backend without its credentials: the reference's
    # startup refusal (cmd.py _object_storage_options)
    (DFDAEMON + ["--object-storage", "--object-storage-backend", "s3",
                 "--object-storage-endpoint", "127.0.0.1:9"],
     {"DRAGONFLY_OBJ_ACCESS_KEY": "", "DRAGONFLY_OBJ_SECRET_KEY": ""},
     "needs DRAGONFLY_OBJ_ACCESS_KEY and DRAGONFLY_OBJ_SECRET_KEY"),
    (DFDAEMON + ["--scenario", "soak"], {}, "ROADMAP A11"),
    (["scheduler"], {"CUDA_VISIBLE_DEVICES": ""}, "torch.cuda.is_available() is False"),
    (["trainer", "--data-dir", "d", "--registry-dir", "r"], {"CUDA_VISIBLE_DEVICES": ""},
     "torch.cuda.is_available() is False"),
], ids=["dfdaemon-object-storage", "dfdaemon-megascale-scenario", "scheduler-no-card",
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


# ------------------------------------------------------------ data plane


class _Origin:
    """Blobs over HTTP with Range support, counting data GETs and the
    bytes they sent."""

    def __init__(self, blobs: dict):
        import http.server

        self.blobs, self.gets, self.sent = blobs, 0, 0
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
                outer.sent += len(data)

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


# ------------------------------------------------------------- the manager


def _rest(base: str, method: str, path: str, body=None, token=None):
    import urllib.request

    req = urllib.request.Request(base + path, method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_manager_preheats_through_its_cluster(tmp_path):
    """A manager process (SQLite file), a scheduler on the CPU registered
    with it (keepalive, dynconfig), a seed and a normal dfdaemon that take
    their scheduler list from the manager (no --scheduler): a file preheat
    posted to the manager's REST reaches SUCCESS, the seed holds the file,
    a pull through the other daemon's proxy is p2p with each origin byte
    fetched once, and every process exits 0 within 10 s of SIGTERM."""
    import hashlib

    import numpy as np

    from dragonfly2_tpu_torch.utils import idgen

    blob = np.random.default_rng(1).integers(0, 256, 900_000, dtype=np.uint8).tobytes()
    origin = _Origin({"/blobs/warm": blob})
    url = origin.base + "/blobs/warm"
    procs: list = []
    try:
        mgr, m_ready, _ = _spawn(
            ["manager", "--db", str(tmp_path / "manager.db"), "--metrics-port", "0"],
            tmp_path / "manager.log")
        procs.append(("manager", mgr))
        assert m_ready[0] == "READY" and m_ready[3] == "RPC" and m_ready[5] == "METRICS"
        base, rpc = f"http://{m_ready[1]}:{m_ready[2]}", f"{m_ready[1]}:{m_ready[4]}"
        token = _rest(base, "POST", "/api/v1/users/signin",
                      {"name": "root", "password": "dragonfly"})["token"]
        _rest(base, "POST", "/api/v1/clusters", {
            "name": "c1", "is_default": True,
            "scheduler_cluster_config": {"candidate_parent_limit": 4}}, token)
        sched, s_ready, _ = _spawn(
            ["scheduler", "--device", "cpu", "--data-dir", str(tmp_path / "traces"),
             "--manager", rpc, "--hostname", "sched-a", "--keepalive-interval", "0.5",
             "--dynconfig-interval", "1"],
            tmp_path / "sched.log")
        procs.append(("scheduler", sched))
        _wait(lambda: [s for s in _rest(base, "GET", "/api/v1/schedulers", token=token)
                       if s["state"] == "active" and s["port"] == int(s_ready[2])],
              30, "the manager to list the scheduler active")
        daemons = {}
        for name, extra in (("seed", ["--host-type", "super"]),
                            ("df-b", ["--proxy", "--proxy-rule", "/blobs/"])):
            proc, ready, _ = _spawn(
                ["dfdaemon", "--data-dir", str(tmp_path / name), "--manager", rpc,
                 "--hostname", name, "--dynconfig-interval", "1", *extra],
                tmp_path / f"{name}.log")
            procs.append((name, proc))
            daemons[name] = ready
        for name in daemons:
            assert json.loads((tmp_path / name / "dynconfig.json").read_text())["schedulers"][0][
                "port"] == int(s_ready[2])

        job = _rest(base, "POST", "/api/v1/jobs",
                    {"type": "preheat", "args": {"type": "file", "url": url,
                                                 "piece_length": 256 << 10}})
        assert job["state"] == "PENDING", job
        assert job["result"]["task_ids"] == [idgen.task_id_v1(url)]
        done = _wait(lambda: (lambda j: j if j["state"] != "PENDING" else None)(
            _rest(base, "GET", f"/api/v1/jobs/{job['id']}")), 60, "the preheat to finish")
        assert done["state"] == "SUCCESS", done
        # the seed fetched each byte once, after client/source.py's
        # one-byte `Range: bytes=0-0` probe
        assert origin.sent == len(blob) + 1

        via, body = _via_proxy(int(daemons["df-b"][4]), url)
        assert via == "p2p" and hashlib.sha256(body).digest() == hashlib.sha256(blob).digest()
        assert origin.sent == len(blob) + 1  # df-b took the seed's pieces
    finally:
        stopped = [(name, *_stop(p)) for name, p in reversed(procs)]
        origin.server.shutdown()
        origin.server.server_close()
    for name, rc, seconds in stopped:
        assert rc == 0 and seconds < 10, (name, rc, seconds, (tmp_path / f"{name}.log"))


def test_tls_issue_certifies_against_the_manager(tmp_path):
    """--tls-issue with --manager: the scheduler certifies into an empty
    --tls-dir through the manager's IssueCertificate RPC (with the
    enrollment token), then serves mTLS; a wrong token is refused."""
    procs: list = []
    try:
        mgr, m_ready, _ = _spawn(
            ["manager", "--cert-dir", str(tmp_path / "ca"), "--tls-enrollment-token", "enroll"],
            tmp_path / "manager.log")
        procs.append(("manager", mgr))
        rpc = f"{m_ready[1]}:{m_ready[4]}"
        out = subprocess.run(
            _cmd("scheduler", "--device", "cpu", "--tls-dir", str(tmp_path / "bad"),
                 "--tls-issue", "--manager", rpc, "--tls-enrollment-token", "wrong"),
            cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "enrollment token" in out.stderr
        sched, s_ready, _ = _spawn(
            ["scheduler", "--device", "cpu", "--tls-dir", str(tmp_path / "tls"), "--tls-issue",
             "--manager", rpc, "--tls-enrollment-token", "enroll"],
            tmp_path / "sched.log")
        procs.append(("scheduler", sched))
        assert s_ready[0] == "READY"
        assert (tmp_path / "tls" / "ca.pem").read_bytes() == (
            tmp_path / "ca" / "ca.pem").read_bytes()
    finally:
        stopped = [(name, *_stop(p)) for name, p in reversed(procs)]
    for name, rc, seconds in stopped:
        assert rc == 0 and seconds < 10, (name, rc, seconds)


PROC_EXIT_S = 10.0  # SIGTERM to exit 0, every process test below


def test_dfdaemon_object_storage_on_a_signed_s3_stub_with_dfstore(tmp_path):
    """cmd.py dfdaemon --object-storage --object-storage-backend s3 on the
    chip smoke's signing S3 stub (credentials from DRAGONFLY_OBJ_*): the
    READY line names OBJSTORE; dfstore --endpoint puts an object that lands
    in the stub through signed requests and gets it back; the daemon
    exits 0 within PROC_EXIT_S of SIGTERM."""
    import chip_smoke
    from dragonfly2_tpu_torch.objectstorage.service import DfstoreClient

    stub = chip_smoke._S3Stub()
    daemon = None
    try:
        env = _env(DRAGONFLY_OBJ_ACCESS_KEY=chip_smoke.OBJ_ACCESS,
                   DRAGONFLY_OBJ_SECRET_KEY=chip_smoke.OBJ_SECRET)
        daemon, ready, _ = _spawn(
            ["dfdaemon", "--data-dir", str(tmp_path / "d"), "--scheduler", "127.0.0.1:1",
             "--object-storage", "--object-storage-backend", "s3",
             "--object-storage-endpoint", stub.endpoint,
             "--object-storage-region", chip_smoke.OBJ_REGION],
            tmp_path / "dfdaemon.log", env=env)
        endpoint = f"http://{ready[1]}:{ready[ready.index('OBJSTORE') + 1]}"
        DfstoreClient(endpoint).create_bucket("b")
        data = np.random.default_rng(22).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
        (tmp_path / "put.bin").write_bytes(data)
        cli = [sys.executable, "-m", "dragonfly2_tpu_torch.client.cli", "dfstore"]
        where = ["--endpoint", endpoint, "--bucket", "b", "--key", "dir/obj.bin"]
        put = subprocess.run([*cli, "put", *where, "--path", str(tmp_path / "put.bin")],
                             cwd=REPO, env=_env(), capture_output=True, timeout=120)
        assert put.returncode == 0, put.stderr
        assert stub.object("b", "dir/obj.bin") == data and stub.refused == 0
        got = subprocess.run([*cli, "get", *where], cwd=REPO, env=_env(), capture_output=True,
                             timeout=120)
        assert got.returncode == 0 and got.stdout == data, got.stderr
    finally:
        if daemon is not None:
            rc, seconds = _stop(daemon)
            assert rc == 0 and seconds < PROC_EXIT_S, (rc, seconds)
        stub.stop()


def test_debug_flight_on_a_cpu_scheduler_answers_every_section(tmp_path):
    """/debug/flight on a --device cpu scheduler's metrics port answers 200
    with every section of flight.DUMP_SECTIONS (its warmup's cost cards
    among them); a bad section answers 400; SIGTERM exits 0 within
    PROC_EXIT_S."""
    import urllib.error
    import urllib.request

    from dragonfly2_tpu_torch.telemetry import flight

    proc, ready, _ = _spawn(["scheduler", "--device", "cpu", "--data-dir", str(tmp_path / "s"),
                             "--metrics-port", "0"], tmp_path / "scheduler.log")
    try:
        base = f"http://127.0.0.1:{ready[ready.index('METRICS') + 1]}/debug/flight"

        def fetch():
            with urllib.request.urlopen(base, timeout=60) as resp:
                assert resp.status == 200
                return json.loads(resp.read())

        # the server warms up in the background after READY: the fused
        # tick's cards land with it (or with this dump's drain)
        dump = _wait(lambda: (lambda d: d if any(
            c["entry"] == "scheduler.tick.fused_tick_chunk" for c in d["costcards"]["cards"])
            else None)(fetch()), 60, "the fused tick's cost cards")
        assert set(dump) - {"truncated"} == {"generated_at_ns", *flight.DUMP_SECTIONS}
        assert not dump["costcards"]["capture_errors"]
        with pytest.raises(urllib.error.HTTPError) as bad:
            urllib.request.urlopen(base + "?section=bogus", timeout=60)
        assert bad.value.code == 400
    finally:
        rc, seconds = _stop(proc)
    assert rc == 0 and seconds < PROC_EXIT_S, (rc, seconds, (tmp_path / "scheduler.log").read_text())
