"""The port's data-plane parts against the reference's, on the same inputs.

- ``piece_layout``, ``Bitset`` and the other utils/container.py types on a
  grid of lengths and operations: equal answers and equal words.
- ``PieceDispatcher`` under one seed: the same picks in the same order.
- Piece storage across packages: a task stored by one package's
  ``StorageManager`` is found, read, verified, exported and reloaded by the
  other's, and the two write the same metadata and journal bytes.
- The upload server both ways: each package's ``PieceManager`` fetches
  pieces from the other's ``UploadServer``; the piece list's JSON bytes,
  the long poll and verify-on-serve answer alike.
- ``parse_range``, ``ProxyRule`` and ``parse_client_hello_sni`` on the
  same bytes; the source registry's file and HTTP listings.
- What the port refuses: s3/oss/obs sources and the daemon's manager and
  object-storage edges name ROADMAP A9 part 3.
- A subprocess check that the daemon, the CLIs and ``cmd.py dfdaemon``'s
  path, a megascale ``--scenario soak`` among its options, load no torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import http.server
import json
import os
import random
import ssl
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu.client import dispatcher as ref_dispatcher
from dragonfly2_tpu.client import piece_manager as ref_pm
from dragonfly2_tpu.client import proxy as ref_proxy
from dragonfly2_tpu.client import source as ref_source
from dragonfly2_tpu.client import storage as ref_storage
from dragonfly2_tpu.client import transport as ref_transport
from dragonfly2_tpu.client import upload as ref_upload
from dragonfly2_tpu.utils import container as ref_container
from dragonfly2_tpu.utils import dferrors as ref_dferrors
from dragonfly2_tpu_torch.client import dispatcher, piece_manager, proxy, source, storage
from dragonfly2_tpu_torch.client import transport, upload
from dragonfly2_tpu_torch.utils import container, dferrors, gc, hoststat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "port": (storage, upload, piece_manager),
    "reference": (ref_storage, ref_upload, ref_pm),
}


def _payload(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


# ----------------------------------------------------------- containers


@pytest.mark.parametrize("content_length", [0, 1, 127, 4096, 4097, 300_000, 5 << 20])
@pytest.mark.parametrize("piece_length", [1, 4096, 32 << 10, 4 << 20])
def test_piece_layout_equals_the_reference(content_length, piece_length):
    if content_length // piece_length > 100_000:
        content_length = 100_000 * piece_length - 1
    assert piece_manager.piece_layout(content_length, piece_length) == \
        ref_pm.piece_layout(content_length, piece_length)


def test_piece_layout_unknown_length_raises_like_the_reference():
    with pytest.raises(ValueError):
        piece_manager.piece_layout(-1, 4096)
    with pytest.raises(ValueError):
        ref_pm.piece_layout(-1, 4096)


@pytest.mark.parametrize("nbits", [0, 1, 63, 64, 65, 200, 1000])
def test_bitset_equals_the_reference(nbits):
    rng = random.Random(nbits)
    ours, theirs = container.Bitset(nbits), ref_container.Bitset(nbits)
    for _ in range(400):
        op, bit = rng.choice(("set", "set", "clear", "test")), rng.randrange(2 * nbits + 130)
        got, want = getattr(ours, op)(bit), getattr(theirs, op)(bit)
        assert got == want, (op, bit)
        assert ours.count() == theirs.count()
    np.testing.assert_array_equal(ours.words(), theirs.words())
    other = container.Bitset()
    other.set_words(theirs.words())
    assert [other.test(b) for b in range(2 * nbits + 130)] == \
        [theirs.test(b) for b in range(2 * nbits + 130)]


def test_safeset_and_ring_buffer_equal_the_reference():
    ours, theirs = container.SafeSet([3, 1]), ref_container.SafeSet([3, 1])
    for item in (1, 2, 2, 5):
        assert ours.add(item) == theirs.add(item)
    ours.delete(3)
    theirs.delete(3)
    assert sorted(ours.values()) == sorted(theirs.values()) and len(ours) == len(theirs)
    assert ours.contains(1, 2) and not ours.contains(3)
    ring, ref_ring = container.RingBuffer(3), ref_container.RingBuffer(3)
    for item in range(7):
        assert ring.push(item) == ref_ring.push(item)
    assert ring.items() == ref_ring.items() == [4, 5, 6]
    assert (ring.peek_oldest(), ring.peek_newest()) == (ref_ring.peek_oldest(), ref_ring.peek_newest())
    with pytest.raises(ValueError):
        container.RingBuffer(0)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_dispatcher_picks_equal_under_one_seed(seed):
    ours, theirs = dispatcher.PieceDispatcher(seed), ref_dispatcher.PieceDispatcher(seed)
    rng = random.Random(100 + seed)
    picks, ref_picks = [], []
    for step in range(300):
        parent = f"p{rng.randrange(5)}"
        if rng.random() < 0.3:
            cost = rng.uniform(1e5, 1e8)
            ours.report_cost(parent, cost)
            theirs.report_cost(parent, cost)
        if rng.random() < 0.7:
            ours.put(step, parent)
            theirs.put(step, parent)
        else:
            picks.append(ours.get())
            ref_picks.append(theirs.get())
    while len(theirs):
        picks.append(ours.get())
        ref_picks.append(theirs.get())
    assert picks == ref_picks and ours.get() is None and len(ours) == 0


def test_traffic_shaper_limits_like_the_reference():
    ours = dispatcher.TrafficShaper(total_rate_bps=1e6, mode="plain")
    ours.register_task("t")
    assert ours.acquire("t", 100_000, timeout=1.0)
    assert not ours.acquire("t", 5_000_000, timeout=0.05)
    assert dispatcher.TrafficShaper().acquire("t", 1 << 30)
    with pytest.raises(ValueError):
        dispatcher.TrafficShaper(mode="other")
    sampled = dispatcher.TrafficShaper(total_rate_bps=1e6, mode="sampling")
    ref_sampled = ref_dispatcher.TrafficShaper(total_rate_bps=1e6, mode="sampling")
    for shaper in (sampled, ref_sampled):
        for task, used in (("a", 1000), ("b", 3000)):
            shaper.register_task(task)
            shaper.record(task, used)
    assert sampled._rate_for("a") == ref_sampled._rate_for("a")
    assert sampled._rate_for("b") == ref_sampled._rate_for("b")


def test_gc_runs_tasks_on_their_interval():
    ran = threading.Event()
    collector = gc.GC()
    collector.add(gc.Task(id="t", interval=0.05, timeout=0.05, runner=ran.set))
    with pytest.raises(ValueError):
        collector.add(gc.Task(id="t", interval=0.05, timeout=0.05, runner=ran.set))
    with pytest.raises(ValueError):
        gc.Task(id="bad", interval=1.0, timeout=2.0, runner=ran.set).validate()
    collector.start()
    try:
        assert ran.wait(5.0)
    finally:
        collector.stop()
    with pytest.raises(KeyError):
        collector.run("missing")


def test_hoststat_collects_the_reference_fields(tmp_path):
    from dragonfly2_tpu.utils import hoststat as ref_hoststat

    stats = hoststat.collect(str(tmp_path), upload_port=1)
    ref_stats = ref_hoststat.collect(str(tmp_path), upload_port=1)
    for part in ("cpu", "memory", "disk"):
        got, want = getattr(stats, part), getattr(ref_stats, part)
        assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert stats.cpu.logical_count == ref_stats.cpu.logical_count > 0
    assert stats.memory.total == ref_stats.memory.total > 0
    assert stats.disk.total == ref_stats.disk.total > 0
    assert hoststat.collect(str(tmp_path), upload_port=1) is stats  # the 5 s cache


# --------------------------------------------------------------- storage


def _store(storage_mod, base, payload: bytes, piece_length: int):
    mgr = storage_mod.StorageManager(base)
    ts = mgr.register_task(storage_mod.TaskMetadata(
        task_id="task-x", peer_id="peer-x", url="http://origin/blob",
        piece_length=piece_length, created_at=1.0))
    layout = piece_manager.piece_layout(len(payload), piece_length)
    for n, off, length in reversed(layout):
        ts.write_piece(n, off, payload[off:off + length], cost_ns=n)
    ts.mark_done(len(payload), len(layout))
    return mgr, ts


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_a_stored_task_is_read_by_the_other_package(tmp_path, writer, reader):
    payload = _payload(100_000)
    _, written = _store(PACKAGES[writer][0], tmp_path / "store", payload, 16 << 10)
    mgr = PACKAGES[reader][0].StorageManager(tmp_path / "store")
    ts = mgr.find_completed_task("task-x")
    assert ts is not None and ts.meta.done and ts.meta.total_pieces == 7
    assert ts.meta.digest == written.meta.digest == hashlib.sha256(payload).hexdigest()
    assert ts.compute_digest() == written.meta.digest
    assert ts.read_range(0, len(payload)) == payload
    assert all(ts.verify_piece(n) for n in range(7))
    assert ts.read_piece(3) == payload[3 * (16 << 10):4 * (16 << 10)]
    assert ts.finished_pieces() == list(range(7))
    out = tmp_path / "exported"
    out.write_bytes(ts.data_path.read_bytes())
    assert out.read_bytes() == payload
    assert ts.wait_for_pieces(7, 0.01)  # done answers at once
    # an eviction in one package is seen by the other on reload
    assert ts.evict_piece(2) and not ts.meta.done
    again = PACKAGES[writer][0].StorageManager(tmp_path / "store").get("task-x")
    assert again.finished_pieces() == [0, 1, 3, 4, 5, 6] and not again.meta.done
    assert PACKAGES[writer][0].StorageManager(tmp_path / "store").find_partial_completed_task(
        "task-x") is not None


def test_both_packages_write_the_same_bytes(tmp_path):
    payload = _payload(70_000, seed=3)
    _, ours = _store(storage, tmp_path / "port", payload, 8 << 10)
    _, theirs = _store(ref_storage, tmp_path / "ref", payload, 8 << 10)
    assert ours.data_path.read_bytes() == theirs.data_path.read_bytes()
    assert ours.pieces_path.read_bytes() == theirs.pieces_path.read_bytes()
    ours_meta, theirs_meta = (json.loads(t.meta_path.read_text()) for t in (ours, theirs))
    assert ours_meta.pop("accessed_at") and theirs_meta.pop("accessed_at")
    assert ours_meta == theirs_meta
    assert list(json.loads(ours.meta_path.read_text())) == list(
        json.loads(theirs.meta_path.read_text()))


def test_integrity_errors_raise_the_reference_kinds(tmp_path):
    mgr = storage.StorageManager(tmp_path)
    ts = mgr.register_task(storage.TaskMetadata(task_id="t", peer_id="p", piece_length=4))
    with pytest.raises(dferrors.InvalidArgument):
        ts.write_piece(0, 0, b"abcd", digest="0" * 32)
    ts.write_piece(0, 0, b"abcd")
    with pytest.raises(dferrors.TaskIntegrityError):
        ts.mark_done(8, 2)
    ts.write_piece(1, 4, b"efgh")
    with pytest.raises(dferrors.PieceCorrupted):
        ts.mark_done(8, 2, expected_digest="f" * 64)
    ts.mark_done(8, 2, expected_digest=hashlib.sha256(b"abcdefgh").hexdigest())
    assert ts.meta.done
    # the kinds are the reference's codes, so a caller of either package
    # catches them by name
    assert dferrors.PieceCorrupted.__mro__[1].__name__ == ref_dferrors.PieceCorrupted.__mro__[1].__name__


def test_storage_gc_ttl_and_watermark(tmp_path):
    import time

    mgr = storage.StorageManager(tmp_path, task_ttl=1000.0, disk_gc_threshold_bytes=150_000)
    now = time.time()
    for i in range(3):
        ts = mgr.register_task(storage.TaskMetadata(task_id=f"t{i}", peer_id="p"))
        ts.write_piece(0, 0, b"x" * 100_000)
        ts.mark_done(100_000, 1)
        ts.meta.accessed_at = now + i
    # the watermark evicts least-recently-used completed tasks to 80%
    assert mgr.run_gc() == 2 and [t.meta.task_id for t in mgr.tasks()] == ["t2"]
    mgr.get("t2").meta.accessed_at = now - 2000.0
    assert mgr.run_gc() == 1 and mgr.tasks() == []  # then the TTL


# ---------------------------------------------------------------- upload


def _serve(upload_mod, mgr, **kw):
    server = upload_mod.UploadServer(mgr, **kw)
    server.start()
    return server


def _get(url: str, timeout: float = 10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.mark.parametrize("parent,child", [("reference", "port"), ("port", "reference")])
def test_a_child_fetches_pieces_from_the_other_packages_parent(tmp_path, parent, child):
    payload = _payload(50_000, seed=5)
    parent_mgr, parent_ts = _store(PACKAGES[parent][0], tmp_path / "parent", payload, 8 << 10)
    server = _serve(PACKAGES[parent][1], parent_mgr)
    try:
        child_storage, _, child_pm = PACKAGES[child]
        child_ts = child_storage.StorageManager(tmp_path / "child").register_task(
            child_storage.TaskMetadata(task_id="task-x", peer_id="c", piece_length=8 << 10))
        pm = child_pm.PieceManager()
        for n, off, length in piece_manager.piece_layout(len(payload), 8 << 10):
            digest = parent_ts.meta.pieces[n].digest
            assert pm.download_piece_from_parent(
                child_ts, server.host, server.port, n, off, digest) == length
        child_ts.mark_done(len(payload), 7, expected_digest=parent_ts.meta.digest)
        assert child_ts.read_range(0, len(payload)) == payload
        # a wrong attested digest is the typed corruption, not a commit
        other = child_storage.StorageManager(tmp_path / "child2").register_task(
            child_storage.TaskMetadata(task_id="task-x", peer_id="c2", piece_length=8 << 10))
        with pytest.raises(Exception) as err:
            pm.download_piece_from_parent(other, server.host, server.port, 0, 0, "0" * 32)
        assert type(err.value).__name__ == "PieceCorrupted" and not other.has_piece(0)
    finally:
        server.stop()


def test_upload_routes_answer_the_reference_bytes(tmp_path):
    payload = _payload(40_000, seed=9)
    answers = {}
    for name, (storage_mod, upload_mod, _) in PACKAGES.items():
        mgr, ts = _store(storage_mod, tmp_path / name, payload, 8 << 10)
        server = _serve(upload_mod, mgr)
        base = f"http://{server.host}:{server.port}"
        try:
            answers[name] = [
                _get(f"{base}/healthy")[::2],
                _get(f"{base}/pieces/task-x")[::2],
                _get(f"{base}/pieces/task-x?wait_after=2&timeout=0.1")[::2],
                _get(f"{base}/pieces/none")[::2],
                _get(f"{base}/download/task-x?piece=3")[::2],
                _get(f"{base}/download/task-x?piece=9")[::2],
                _get(f"{base}/download/none")[::2],
                _get(f"{base}/other")[::2],
            ]
            status, headers, body = _get(f"{base}/download/task-x?piece=1")
            answers[name].append((headers["X-Dragonfly-Piece-Digest"],
                                  headers["X-Dragonfly-Piece-Offset"], body))
            req = urllib.request.Request(f"{base}/download/task-x", headers={"Range": "bytes=100-199"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                answers[name].append((resp.status, resp.headers["Content-Range"], resp.read()))
        finally:
            server.stop()
    assert answers["port"] == answers["reference"]
    doc = json.loads(answers["port"][1][1])
    assert doc["done"] and [p["number"] for p in doc["pieces"]] == list(range(5))


def test_long_poll_answers_when_a_piece_lands(tmp_path):
    mgr = storage.StorageManager(tmp_path)
    ts = mgr.register_task(storage.TaskMetadata(task_id="t", peer_id="p", piece_length=4))
    ts.write_piece(0, 0, b"abcd")
    server = _serve(upload, mgr)
    try:
        threading.Timer(0.3, lambda: ts.write_piece(1, 4, b"efgh")).start()
        status, _, body = _get(f"http://{server.host}:{server.port}/pieces/t?wait_after=1&timeout=10")
        assert status == 200 and len(json.loads(body)["pieces"]) == 2
    finally:
        server.stop()


@pytest.mark.parametrize("name", ["port", "reference"])
def test_verify_on_serve_evicts_and_reports_rot(tmp_path, name):
    storage_mod, upload_mod, _ = PACKAGES[name]
    mgr, ts = _store(storage_mod, tmp_path, _payload(20_000), 8 << 10)
    rotted = []
    server = _serve(upload_mod, mgr, on_piece_rot=lambda t, n: rotted.append((t, n)))
    try:
        with open(ts.data_path, "r+b") as f:
            f.seek(8 << 10)
            f.write(b"rot!")
        base = f"http://{server.host}:{server.port}/download/task-x"
        assert _get(f"{base}?piece=1")[0] == 503
        assert _get(f"{base}?piece=1")[0] == 404  # evicted: no longer served
        assert _get(f"{base}?piece=0")[0] == 200
        assert rotted == [("task-x", 1)] and not ts.meta.done
    finally:
        server.stop()


def test_fault_injector_on_the_upload_server(tmp_path):
    from dragonfly2_tpu_torch.scenarios.engine import FaultInjector
    from dragonfly2_tpu_torch.scenarios.spec import builtin_scenarios

    mgr, ts = _store(storage, tmp_path, _payload(20_000), 4 << 10)
    spec = builtin_scenarios()["corruption"]
    server = _serve(upload, mgr, fault_injector=FaultInjector(spec, seed=0))
    try:
        codes = set()
        for n in range(5):
            status, headers, body = _get(
                f"http://{server.host}:{server.port}/download/task-x?piece={n}")
            codes.add(status)
            if status == 200 and body != ts.read_piece(n):
                codes.add("corrupt")
                # a lying parent: the header is consistent with the bad bytes
                assert headers["X-Dragonfly-Piece-Digest"] == hashlib.md5(body).hexdigest()
        assert "corrupt" in codes
    finally:
        server.stop()


# -------------------------------------------------------- proxy helpers


RANGES = ["bytes=0-99", "bytes=500-", "bytes=-100", "bytes=0-5000", "bytes=2000-", None,
          "bytes=-", "weird", "bytes=5-3", "bytes=-0", "bytes=999-999", " bytes=1-2 ", ""]


@pytest.mark.parametrize("total", [0, 1, 1000])
def test_parse_range_equals_the_reference(total):
    for header in RANGES:
        assert transport.parse_range(header, total) == ref_transport.parse_range(header, total), header


def test_proxy_rules_equal_the_reference():
    urls = ["http://reg.io/v2/x/blobs/sha256:abc", "https://a/b.tar", "http://a/b.txt"]
    for kw in ({"regex": r"blobs/sha256", "use_https": True, "redirect": "mirror.local"},
               {"regex": r"\.tar$"}, {"regex": r"b\.", "direct": True}):
        ours, theirs = transport.ProxyRule(**kw), ref_transport.ProxyRule(**kw)
        for url in urls:
            assert ours.matches(url) == theirs.matches(url)
            assert ours.rewrite(url) == theirs.rewrite(url)
    rules = [transport.ProxyRule(regex=r"\.txt$", direct=True), transport.ProxyRule(regex="a/")]
    assert transport.P2PTransport(None, rules).route("http://a/b.txt")[1] is rules[0]
    assert transport.P2PTransport(None, rules).route("http://q/z")[1] is None


def _client_hellos() -> list[bytes]:
    """Real ClientHellos from the ssl module for a few server names."""
    out = []
    for name in ("registry.internal", "a.b.example.com", "x" * 60 + ".io"):
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        incoming, outgoing = ssl.MemoryBIO(), ssl.MemoryBIO()
        tls = ctx.wrap_bio(incoming, outgoing, server_hostname=name)
        with pytest.raises(ssl.SSLWantReadError):
            tls.do_handshake()
        out.append(outgoing.read())
    return out


def test_parse_client_hello_sni_equals_the_reference():
    hellos = _client_hellos()
    rng = np.random.default_rng(1)
    inputs = hellos + [h[:n] for h in hellos for n in (0, 5, 40, 120)] + [
        b"", b"GET / HTTP/1.1\r\n\r\n", b"\x16\x03\x01\x00\x05tiny!",
        *(rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (3, 64, 512)),
        *(bytes(b ^ (1 if i == 50 else 0) for i, b in enumerate(h)) for h in hellos),
    ]
    for data in inputs:
        assert proxy.parse_client_hello_sni(data) == ref_proxy.parse_client_hello_sni(data)
    assert [proxy.parse_client_hello_sni(h) for h in hellos] == [
        "registry.internal", "a.b.example.com", "x" * 60 + ".io"]


def test_sni_proxy_refuses_every_host_by_default():
    proxy_ = proxy.SNIProxy()
    assert proxy_._resolve("registry.internal") is None
    allowed = proxy.SNIProxy(allowed_hosts=["internal"])
    assert allowed._resolve("registry.internal") == ("registry.internal", 443)
    assert allowed._resolve("evil.com") is None
    assert proxy.SNIProxy(resolver=lambda n: {}[n])._resolve("x") is None


# --------------------------------------------------------------- sources


def test_source_listings_equal_the_reference(tmp_path):
    root = tmp_path / "tree"
    (root / "sub").mkdir(parents=True)
    (root / "a.bin").write_bytes(b"a" * 10)
    (root / "sub" / "b.bin").write_bytes(b"b" * 20)
    (root / "loop").symlink_to(root, target_is_directory=True)
    url = f"file://{root}"
    assert source.list_entries(url) == [
        source.URLEntry(**dataclasses.asdict(e)) for e in ref_source.list_entries(url)]
    assert source.content_length(f"{url}/a.bin") == 10
    assert b"".join(source.download(f"{url}/sub/b.bin", None, 5, 10)) == b"b" * 10

    import functools

    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(root))
    handler.log_message = lambda *a: None
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}/"
        ours = source.list_entries(base)
        assert [dataclasses.asdict(e) for e in ours] == [
            dataclasses.asdict(e) for e in ref_source.list_entries(base)]
        assert {e.name for e in ours} >= {"a.bin", "sub"}
        # SimpleHTTPRequestHandler ignores Range: the probe says so, and a
        # ranged read still yields the right bytes
        assert source.supports_range(base + "a.bin") is False
        assert b"".join(source.download(base + "sub/b.bin", None, 3, 4)) == b"b" * 4
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("scheme", ["s3", "oss", "obs"])
def test_object_store_schemes_raise_naming_a9_part_3(scheme):
    """The s3/oss/obs back-source clients, refused before A9 part 3a, now
    the reference's: against a signing stub of the vendor's dialect, with
    the credentials in x-df-* headers, both packages' registries give the
    same length, whole and ranged bytes and directory listing; without an
    endpoint both raise Unavailable."""
    import chip_smoke

    stub = chip_smoke._S3Stub(scheme)
    try:
        blob = np.random.default_rng(22).integers(0, 256, 5000, dtype=np.uint8).tobytes()
        stub.put("bucket", "dir/key one.bin", blob)
        stub.put("bucket", "dir/sub/two.bin", b"two")
        creds = {"x-df-endpoint": stub.endpoint, "x-df-access-key": chip_smoke.OBJ_ACCESS,
                 "x-df-secret-key": chip_smoke.OBJ_SECRET, "x-df-region": chip_smoke.OBJ_REGION}
        url = f"{scheme}://bucket/dir/key%20one.bin"
        for mod in (source, ref_source):
            assert mod.content_length(url, creds) == len(blob)
            assert b"".join(mod.download(url, creds)) == blob
            assert b"".join(mod.download(url, creds, 100, 900)) == blob[100:1000]
            entries = mod.list_entries(f"{scheme}://bucket/dir/", creds)
            assert [(e.name, e.is_dir) for e in entries] == [("key one.bin", False), ("sub", True)]
        assert stub.refused == 0 and stub.ranged == 2
        with pytest.raises(dferrors.Unavailable):
            source.content_length(f"{scheme}://bucket/key")
        with pytest.raises(ref_dferrors.Unavailable):
            ref_source.content_length(f"{scheme}://bucket/key")
    finally:
        stub.stop()


def test_hdfs_and_oras_sources_are_registered():
    from dragonfly2_tpu_torch.client import object_sources

    assert isinstance(source.client_for("hdfs://nn/x"), object_sources.HdfsSource)
    assert isinstance(source.client_for("oras://reg/repo:tag"), object_sources.OrasSource)
    with pytest.raises(dferrors.InvalidArgument):
        source.client_for("gopher://x")
    with pytest.raises(dferrors.InvalidArgument):
        object_sources.OrasSource().list_entries("oras://reg/repo")


@pytest.mark.parametrize("kwargs", [{"object_storage": True}])
def test_daemon_refuses_its_manager_edges(tmp_path, kwargs):
    """Daemon(object_storage=True), refused before A9 part 3a, now builds
    the reference's listener: the object-storage service over the fs
    backend under the data dir, beside the daemon's piece storage, whose
    PUT imports the object as a task and whose GET falls back to it."""
    from dragonfly2_tpu_torch.client.daemon import Daemon
    from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend
    from dragonfly2_tpu_torch.objectstorage.service import DfstoreClient

    d = Daemon(tmp_path, [("127.0.0.1", 1)], **kwargs)
    svc = d.object_storage
    assert isinstance(svc.backend, FilesystemBackend) and svc.storage is d.storage
    assert svc.backend.base == (tmp_path / "objects").absolute()
    svc.start()
    try:
        client = DfstoreClient(f"http://{svc.host}:{svc.port}")
        client.create_bucket("b")
        client.put_object("b", "k", b"payload")
        (tmp_path / "objects" / "b" / "k").unlink()  # the backend loses it
        assert client.get_object("b", "k") == b"payload"
    finally:
        svc.stop()


# ------------------------------------------------------------- isolation


_NO_TORCH = r"""
import sys
import dragonfly2_tpu_torch.client.daemon, dragonfly2_tpu_torch.client.cli
import dragonfly2_tpu_torch.client.proxy, dragonfly2_tpu_torch.client.object_sources
import dragonfly2_tpu_torch.manager.rpc, dragonfly2_tpu_torch.utils.dynconfig
import dragonfly2_tpu_torch.objectstorage, dragonfly2_tpu_torch.objectstorage.remote
import dragonfly2_tpu_torch.objectstorage.signing, dragonfly2_tpu_torch.objectstorage.service
import dragonfly2_tpu_torch.telemetry, dragonfly2_tpu_torch.telemetry.costcard
import dragonfly2_tpu_torch.utils.cache, dragonfly2_tpu_torch.utils.dfpath
from dragonfly2_tpu_torch import cmd
args = cmd.build_parser().parse_args(["dfdaemon", "--data-dir", "d", "--scheduler", "127.0.0.1:1",
                                      "--object-storage", "--object-storage-backend", "s3",
                                      "--object-storage-endpoint", "127.0.0.1:9"])
import os
os.environ.update(DRAGONFLY_OBJ_ACCESS_KEY="ak", DRAGONFLY_OBJ_SECRET_KEY="sk")
from dragonfly2_tpu_torch.client.daemon import Daemon
import tempfile
d = Daemon(tempfile.mkdtemp(), [("127.0.0.1", 1)], object_storage=True, object_storage_backend="s3",
           object_storage_options=cmd._object_storage_options(args))
d.object_storage._httpd.server_close()
from dragonfly2_tpu_torch.telemetry.series import daemon_series, register_version
from dragonfly2_tpu_torch.telemetry import default_registry
register_version(default_registry(), "dfdaemon")
scenario_args = cmd.build_parser().parse_args(["dfdaemon", "--data-dir", "d", "--scheduler",
                                               "127.0.0.1:1", "--scenario", "soak"])
assert cmd._fault_injector(scenario_args).spec.name == "soak"  # a megascale spec
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "dragonfly2_tpu"))
print("BAD=" + ",".join(bad))
"""


def test_the_daemon_and_cli_paths_load_no_torch():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD=", out.stdout
