"""The port's dfdaemon in swarms over 127.0.0.1, against the reference's.

After tests/test_minicluster.py: a counting HTTP origin, a
SchedulerRPCServer (either package's SchedulerService, the port's on the
CPU) and Daemons of either package. The first peer of a task back-sources;
later peers pull every piece from parents the scheduler picked, so the
origin's data GETs do not grow; every file's sha256 is the origin's.

- Mixed swarms: port daemons through the reference's scheduler, reference
  daemons through the port's, and port children (``back_source_allowed=
  False``) pulling from reference parents and the reverse.
- The conductor's paths: tiny, small and empty scopes; a parent that
  vanished; a corrupt parent piece rejected and reported; the seed-peer
  trigger; a scheduler restart; the probe cycle.
- The proxy's P2P hijack and ``direct:`` rules, with a Range request.
- dfget / dfcache / dfstore, after tests/test_client_cli.py.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import http.server
import threading
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu.client.daemon import Daemon as RefDaemon
from dragonfly2_tpu.cluster.probes import ProbeStore as RefProbeStore
from dragonfly2_tpu.cluster.scheduler import SchedulerService as RefService
from dragonfly2_tpu.config.config import Config as RefConfig
from dragonfly2_tpu.records.storage import TraceStorage as RefTraceStorage
from dragonfly2_tpu.rpc import server as ref_server
from dragonfly2_tpu_torch.client import cli
from dragonfly2_tpu_torch.client.daemon import Daemon
from dragonfly2_tpu_torch.client.transport import ProxyRule
from dragonfly2_tpu_torch.cluster.probes import ProbeStore
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.config.config import Config
from dragonfly2_tpu_torch.records.storage import TraceStorage
from dragonfly2_tpu_torch.rpc import server

DAEMONS = {"port": Daemon, "reference": RefDaemon}
PIECE = 32 * 1024


class Origin:
    """One blob over HTTP with Range support, counting data GETs."""

    def __init__(self, payload: bytes, path: str = "/blob.bin"):
        self.payload, self.path = payload, path
        self.get_count = 0
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_HEAD(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(outer.payload)))
                self.end_headers()

            def do_GET(self):
                outer.get_count += 1
                data, status = outer.payload, 200
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    start, _, end = rng[len("bytes="):].partition("-")
                    start = int(start or 0)
                    end = int(end) if end else len(data) - 1
                    data, status = data[start:end + 1], 206
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def url(self, path: str | None = None) -> str:
        return f"http://127.0.0.1:{self.port}{path or self.path}"

    @property
    def sha(self) -> str:
        return hashlib.sha256(self.payload).hexdigest()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


@pytest.fixture
def origin():
    server = Origin(np.random.default_rng(0).integers(0, 256, 300_000, dtype=np.uint8).tobytes())
    yield server
    server.stop()


def _service(package: str, tmp_path):
    if package == "port":
        cfg = Config()
        cfg.scheduler.max_hosts, cfg.scheduler.max_tasks = 64, 64
        return SchedulerService(config=cfg, storage=TraceStorage(tmp_path / "traces"),
                                probes=ProbeStore(max_pairs=4096, max_hosts=64, device="cpu"),
                                device="cpu")
    cfg = RefConfig()
    cfg.scheduler.max_hosts, cfg.scheduler.max_tasks = 64, 64
    return RefService(config=cfg, storage=RefTraceStorage(tmp_path / "traces"),
                      probes=RefProbeStore(max_pairs=4096, max_hosts=64))


def _server(package: str, service, **kw):
    mod = server if package == "port" else ref_server
    return mod.SchedulerRPCServer(service, tick_interval=0.01, **kw)


def _sha(ts) -> str:
    with open(ts.data_path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


async def _swarm(tmp_path, scheduler: str, daemons: list):
    """A scheduler of one package and started daemons of the packages
    named, each with its own hostname (the scheduler keys hosts on
    host-id-v2(ip, hostname))."""
    service = _service(scheduler, tmp_path)
    srv = _server(scheduler, service)
    host, port = await srv.start()
    started = []
    for i, package in enumerate(daemons):
        d = DAEMONS[package](tmp_path / f"d{i}", [(host, port)], hostname=f"{package}-{i}")
        await d.start()
        started.append(d)
    return service, srv, started


async def _teardown(srv, daemons, leave=True):
    for d in daemons:
        await d.stop(leave=leave)
    await srv.stop()


# ------------------------------------------------------------- swarms


@pytest.mark.parametrize("scheduler,daemons", [
    ("reference", ("port", "port", "port")),
    ("port", ("reference", "reference", "reference")),
    ("port", ("reference", "port", "port")),
    ("reference", ("port", "reference", "reference")),
    ("port", ("port", "reference", "port")),
], ids=["port-daemons-reference-scheduler", "reference-daemons-port-scheduler",
        "port-children-of-a-reference-parent", "reference-children-of-a-port-parent",
        "mixed-through-the-port"])
def test_mixed_swarm_moves_every_piece_between_peers(tmp_path, origin, scheduler, daemons):
    async def run():
        service, srv, ds = await _swarm(tmp_path, scheduler, list(daemons))
        try:
            first = await ds[0].download(origin.url(), piece_length=PIECE)
            assert _sha(first) == origin.sha
            gets = origin.get_count
            assert gets > 0
            for d in ds[1:]:
                ts = await d.download(origin.url(), piece_length=PIECE,
                                      back_source_allowed=False)
                assert _sha(ts) == origin.sha and len(ts.meta.pieces) == 10
            assert origin.get_count == gets, "a later peer went to the origin"
            # the last DownloadPeerFinished lands after its download returns
            for _ in range(100):
                if len(service.storage.list_downloads()) >= len(ds):
                    break
                await asyncio.sleep(0.05)
            assert len(service.storage.list_downloads()) >= len(ds)
            counts = service.counts()
            assert counts["hosts"] == len(ds) and counts["tasks"] == 1
        finally:
            await _teardown(srv, ds)

    asyncio.run(run())


@pytest.mark.parametrize("payload,piece_length,label", [
    (b"tiny!" * 20, 4 << 20, "tiny"), (bytes(range(256)) * 12, 4096, "small")],
    ids=["tiny", "small"])
def test_tiny_and_small_scopes(tmp_path, payload, piece_length, label):
    async def run():
        src = Origin(payload)
        service, srv, ds = await _swarm(tmp_path, "port", ["port", "reference"])
        try:
            ts1 = await ds[0].download(src.url(), piece_length=piece_length)
            assert _sha(ts1) == src.sha and len(ts1.meta.pieces) == 1
            gets = src.get_count
            ts2 = await ds[1].download(src.url(), piece_length=piece_length,
                                       back_source_allowed=False)
            assert _sha(ts2) == src.sha and src.get_count == gets, label
        finally:
            await _teardown(srv, ds)
            src.stop()

    asyncio.run(run())


def test_empty_task_fast_path(tmp_path):
    async def run():
        empty = tmp_path / "empty.bin"
        empty.write_bytes(b"")
        service, srv, ds = await _swarm(tmp_path, "port", ["port"])
        try:
            ts = await ds[0].download(f"file://{empty}")
            assert ts.meta.done and ts.meta.content_length == 0
        finally:
            await _teardown(srv, ds)

    asyncio.run(run())


def test_child_recovers_when_parent_vanishes(tmp_path, origin):
    async def run():
        service, srv, ds = await _swarm(tmp_path, "port", ["port", "port"])
        try:
            await ds[0].download(origin.url(), piece_length=2 * PIECE)
            await ds[0].stop(leave=False)  # a crash: the scheduler still lists the parent
            gets = origin.get_count
            ts = await ds[1].download(origin.url(), piece_length=2 * PIECE)
            assert _sha(ts) == origin.sha
            assert origin.get_count > gets, "the child never fell back to the origin"
        finally:
            await _teardown(srv, ds[1:])

    asyncio.run(run())


@pytest.mark.parametrize("parent", ["port", "reference"])
def test_child_rejects_a_corrupt_parent_piece(tmp_path, origin, parent):
    """The parent's piece 1 rots on disk after its download; the port
    child rejects the bytes before commit, reports the parent, and still
    completes with the origin's bytes."""

    async def run():
        service, srv, ds = await _swarm(tmp_path, "port", [parent, "port"])
        try:
            ts1 = await ds[0].download(origin.url(), piece_length=2 * PIECE)
            with open(ts1.data_path, "r+b") as f:
                f.seek(2 * PIECE + 100)
                f.write(b"\xff\x00\xff\x00garbage")
            gets = origin.get_count
            ts2 = await ds[1].download(origin.url(), piece_length=2 * PIECE)
            assert _sha(ts2) == origin.sha, "corrupt parent bytes reached the child"
            assert origin.get_count > gets
            assert int(service.state.host_upload_failed.sum()) >= 1, "never reported"
        finally:
            await _teardown(srv, ds)

    asyncio.run(run())


def test_seed_peer_trigger(tmp_path, origin):
    """A first-seen task triggers the seed host (ObtainSeeds): a peer that
    may not back-source still gets the file, through the seed."""

    async def run():
        service = _service("port", tmp_path)
        srv = _server("port", service)
        host, port = await srv.start()
        seed = Daemon(tmp_path / "seed", [(host, port)], hostname="seed-1", host_type="super")
        normal = Daemon(tmp_path / "n1", [(host, port)], hostname="normal-1")
        try:
            await seed.start()
            assert seed.is_seed
            for _ in range(100):
                if service._seed_hosts:
                    break
                await asyncio.sleep(0.05)
            assert service._seed_hosts == [seed.host_id]
            await normal.start()
            ts = await normal.download(origin.url(), piece_length=PIECE,
                                       back_source_allowed=False, schedule_timeout=30.0)
            assert _sha(ts) == origin.sha and origin.get_count > 0
            held = seed.storage.find_completed_task(ts.meta.task_id)
            assert held is not None and held.meta.done
        finally:
            await _teardown(srv, [normal, seed])

    asyncio.run(run())


def test_daemon_survives_scheduler_restart(tmp_path, origin):
    async def run():
        service = _service("port", tmp_path)
        srv = _server("port", service)
        host, port = await srv.start()
        d = Daemon(tmp_path / "d", [(host, port)], hostname="restart-peer")
        srv2 = None
        try:
            await d.start()
            assert _sha(await d.download(origin.url(), piece_length=2 * PIECE)) == origin.sha
            await srv.stop()  # the scheduler restarts on the same port
            srv2 = server.SchedulerRPCServer(_service("port", tmp_path / "s2"), host=host,
                                             port=port, tick_interval=0.01)
            await srv2.start()
            second = Origin(bytes(reversed(origin.payload)))
            try:
                ts = await asyncio.wait_for(d.download(second.url(), piece_length=2 * PIECE), 40)
                assert _sha(ts) == second.sha
                assert srv2.service.counts()["hosts"] >= 1  # re-announced
            finally:
                second.stop()
        finally:
            await d.stop()
            if srv2 is not None:
                await srv2.stop()

    asyncio.run(run())


def test_probe_cycle_over_the_wire(tmp_path):
    async def run():
        service, srv, ds = await _swarm(tmp_path, "port", ["port", "port", "port"])
        try:
            for d in ds:
                await d._ensure_announced(await d.pool.for_task(d.host_id))
            probed = 0
            for d in ds:
                probed += await d.sync_probes_once(count=2)
            assert probed > 0 and service.probes._next > 0
        finally:
            await _teardown(srv, ds, leave=False)

    asyncio.run(run())


# ---------------------------------------------------------------- proxy


def test_proxy_hijack_and_direct_rules(tmp_path, origin):
    async def run():
        service = _service("port", tmp_path)
        srv = _server("port", service)
        host, port = await srv.start()
        rules = [ProxyRule(regex=r"direct\.bin", direct=True), ProxyRule(regex=r"\.bin$")]
        d = Daemon(tmp_path / "d", [(host, port)], hostname="proxy-host", proxy=True,
                   proxy_rules=rules, registry_mirror=f"http://127.0.0.1:{origin.port}")
        await d.start()

        def via_proxy(url: str, headers=None):
            req = urllib.request.Request(url, headers=headers or {})
            req.set_proxy(f"{d.proxy.host}:{d.proxy.port}", "http")
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, resp.headers.get("X-Dragonfly-Via"), resp.read()

        try:
            status, via, body = await asyncio.to_thread(via_proxy, origin.url())
            assert (status, via, body) == (200, "p2p", origin.payload)
            gets = origin.get_count
            # the same task again: the daemon's store answers, not the origin
            status, via, body = await asyncio.to_thread(
                via_proxy, origin.url(), {"Range": "bytes=100-199"})
            assert (status, via, body) == (206, "p2p", origin.payload[100:200])
            assert origin.get_count == gets
            status, via, body = await asyncio.to_thread(via_proxy, origin.url("/direct.bin"))
            assert (status, via, body) == (200, "direct", origin.payload)
            status, via, body = await asyncio.to_thread(via_proxy, origin.url("/other.txt"))
            assert via == "direct"
            assert d.proxy.stats["p2p"] == 2 and d.proxy.stats["direct"] == 2
        finally:
            await d.stop()
            await srv.stop()

    asyncio.run(run())


# ----------------------------------------------------------------- CLIs


def test_dfcache_import_stat_export_delete_and_dfstore(tmp_path, capsys):
    blob = tmp_path / "in.bin"
    blob.write_bytes(b"hello dragonfly" * 100)
    data_dir = str(tmp_path / "cache")
    assert cli.main(["dfcache", "import", "--data-dir", data_dir, "--path", str(blob)]) == 0
    task_id = capsys.readouterr().out.strip()
    assert cli.main(["dfcache", "stat", "--data-dir", data_dir, "--task-id", task_id]) == 0
    assert "done=True" in capsys.readouterr().out
    out = tmp_path / "out.bin"
    assert cli.main(["dfcache", "export", "--data-dir", data_dir, "--task-id", task_id,
                     "-o", str(out)]) == 0
    assert out.read_bytes() == blob.read_bytes()
    assert cli.main(["dfstore", "sum", "--data-dir", data_dir, "--task-id", task_id]) == 0
    assert capsys.readouterr().out.strip() == hashlib.sha256(blob.read_bytes()).hexdigest()
    assert cli.main(["dfstore", "get", "--data-dir", data_dir, "--task-id", task_id]) == 0
    assert capsys.readouterr().out == blob.read_text()
    # the reference's dfcache reads what the port imported, the same task id
    from dragonfly2_tpu.client import cli as ref_cli

    assert ref_cli.main(["dfcache", "stat", "--data-dir", data_dir, "--task-id", task_id]) == 0
    capsys.readouterr()
    assert cli.main(["dfcache", "delete", "--data-dir", data_dir, "--task-id", task_id]) == 0
    assert cli.main(["dfcache", "stat", "--data-dir", data_dir, "--task-id", task_id]) == 1
    assert cli.main(["dfstore", "put", "--data-dir", data_dir, "--path", str(blob)]) == 0
    assert capsys.readouterr().out.strip() == task_id


def test_dfstore_endpoint_exits_naming_a9_part_3(tmp_path, capsysbinary):
    """dfstore --endpoint, refused before A9 part 3a, now the reference's:
    put, get and sum through a daemon's object-storage service, the same
    bytes and listing from both packages' CLIs against one service; a
    missing key exits 1."""
    from dragonfly2_tpu.client import cli as ref_cli
    from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend
    from dragonfly2_tpu_torch.objectstorage.service import DfstoreClient, ObjectStorageService

    svc = ObjectStorageService(FilesystemBackend(tmp_path / "objects"))
    svc.start()
    try:
        endpoint = f"http://{svc.host}:{svc.port}"
        DfstoreClient(endpoint).create_bucket("b")
        data = np.random.default_rng(22).integers(0, 256, 3000, np.uint8).tobytes()
        blob = tmp_path / "blob.bin"
        blob.write_bytes(data)
        args = ["--endpoint", endpoint, "--bucket", "b"]
        assert cli.main(["dfstore", "put", *args, "--key", "x/one", "--path", str(blob)]) == 0
        assert ref_cli.main(["dfstore", "put", *args, "--key", "x/two", "--path", str(blob)]) == 0
        sums, gets = [], []
        for main in (cli.main, ref_cli.main):
            capsysbinary.readouterr()
            assert main(["dfstore", "sum", *args, "--key", "x/"]) == 0
            sums.append(capsysbinary.readouterr().out.decode().split())
            assert main(["dfstore", "get", *args, "--key", "x/two"]) == 0
            gets.append(capsysbinary.readouterr().out)
        assert sums[0] == sums[1] and sums[0][1::2] == ["x/one", "x/two"]
        assert gets == [data, data]
        assert cli.main(["dfstore", "get", *args, "--key", "missing"]) == 1
    finally:
        svc.stop()


def test_dfget_from_the_origin_then_from_the_swarm(tmp_path, origin, capsys):
    """dfget's in-process daemon back-sources and exits; a running daemon
    then pulls the task from the swarm, and a second dfget with
    --no-back-source and a header gets every piece from that daemon."""

    async def run():
        service, srv, ds = await _swarm(tmp_path, "port", ["port"])
        addr = f"{srv.host}:{srv.port}"
        try:
            args = ["dfget", origin.url(), "--scheduler", addr, "--piece-length", str(PIECE)]
            out1 = tmp_path / "one.bin"
            assert await cli._dfget(cli.build_parser().parse_args(
                args + ["-o", str(out1), "--data-dir", str(tmp_path / "g1")])) == 0
            assert out1.read_bytes() == origin.payload
            await ds[0].download(origin.url(), piece_length=PIECE, back_source_allowed=False)
            gets = origin.get_count
            out2 = tmp_path / "two.bin"
            assert await cli._dfget(cli.build_parser().parse_args(
                args + ["-o", str(out2), "--data-dir", str(tmp_path / "g2"), "--no-back-source",
                        "--ip", "127.0.0.2", "-H", "X-Test: 1"])) == 0
            assert out2.read_bytes() == origin.payload and origin.get_count == gets
        finally:
            await _teardown(srv, ds)

    asyncio.run(run())
    assert "downloaded 300000 bytes" in capsys.readouterr().out


def test_dfget_recursive_with_accept_and_reject(tmp_path, capsys):
    root = tmp_path / "tree"
    (root / "sub" / "deeper").mkdir(parents=True)
    (root / "a.txt").write_bytes(b"a" * 10)
    (root / "b.bin").write_bytes(b"b" * 20)
    (root / "sub" / "c.txt").write_bytes(b"c" * 30)
    (root / "sub" / "deeper" / "d.txt").write_bytes(b"d" * 40)
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(root))
    handler.log_message = lambda *a: None
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    async def run():
        service, srv, ds = await _swarm(tmp_path, "port", [])
        try:
            out = tmp_path / "out"
            rc = await cli._dfget(cli.build_parser().parse_args([
                "dfget", f"http://127.0.0.1:{httpd.server_address[1]}/", "-r",
                "-o", str(out), "--scheduler", f"{srv.host}:{srv.port}",
                "--data-dir", str(tmp_path / "g"), "--accept-regex", r"\.txt$",
                "--reject-regex", "deeper"]))
            return rc, out
        finally:
            await _teardown(srv, ds)

    try:
        rc, out = asyncio.run(run())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert rc == 0
    got = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    assert got == ["a.txt", "sub/c.txt"]
    assert (out / "sub" / "c.txt").read_bytes() == b"c" * 30
