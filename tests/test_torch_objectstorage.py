"""The port's object storage (dragonfly2_tpu_torch/objectstorage/) against
the reference's: the signers byte for byte, the signed S3/OSS/OBS backends
across the packages on one stub (this repo's chip_smoke stub, which
recomputes every signature with its own code, and the reference's test
handlers), the S3 bucket registry both ways, the daemon's object-storage
service answer for answer, and the cases of the reference's
tests/test_objectstorage.py and tests/test_remote_sources.py
(:442-533,624-761) on the port. Seeded inputs; every comparison exact."""

from __future__ import annotations

import asyncio
import dataclasses
import datetime
import json
import urllib.parse
import urllib.request

import numpy as np
import pytest

import chip_smoke
import test_remote_sources as ref_stubs
from dragonfly2_tpu.objectstorage import backends as ref_backends
from dragonfly2_tpu.objectstorage import service as ref_service
from dragonfly2_tpu.objectstorage import signing as ref_signing
from dragonfly2_tpu.registry.bucket import open_registry as ref_open_registry
from dragonfly2_tpu_torch.client import source
from dragonfly2_tpu_torch.client.storage import StorageManager
from dragonfly2_tpu_torch.objectstorage import backends, service, signing
from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend, new_backend
from dragonfly2_tpu_torch.objectstorage.service import DfstoreClient, ObjectStorageService
from dragonfly2_tpu_torch.registry import ModelEvaluation, open_registry
from dragonfly2_tpu_torch.utils import dferrors

ACCESS, SECRET, REGION = chip_smoke.OBJ_ACCESS, chip_smoke.OBJ_SECRET, chip_smoke.OBJ_REGION
PINNED = datetime.datetime(2026, 7, 30, 12, 0, 0, tzinfo=datetime.timezone.utc)


class _RefStub:
    """The reference's test handlers (tests/test_remote_sources.py:67,218)
    on a server of their own, with its shared secret and region."""

    def __init__(self, scheme: str):
        handler = ref_stubs._S3Handler if scheme == "s3" else ref_stubs._OSSHandler
        attrs = {"store": ref_stubs._Store()}
        if scheme != "s3":
            attrs["scheme"] = scheme.upper()
        self.httpd, self.endpoint = ref_stubs._serve(type("H", (handler,), attrs))
        self.access, self.secret, self.region = (ref_stubs.ACCESS, ref_stubs.SECRET,
                                                 ref_stubs.REGION)

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(params=[(kind, scheme) for kind in ("own", "reference")
                        for scheme in ("s3", "oss", "obs")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def vendor(request):
    kind, scheme = request.param
    stub = chip_smoke._S3Stub(scheme) if kind == "own" else _RefStub(scheme)
    access = getattr(stub, "access", ACCESS)
    secret = getattr(stub, "secret", SECRET)
    region = getattr(stub, "region", REGION)
    opts = dict(endpoint=stub.endpoint, access_key=access, secret_key=secret, region=region)
    yield scheme, opts, stub
    stub.stop()


# ------------------------------------------------------------------ signing


def _seeded_requests(n: int = 24):
    rng = np.random.default_rng(22)
    keys = ["a.bin", "dir with space/a b.txt", "plus+sign.bin", "uni-köln/日本.txt", ""]
    for i in range(n):
        method = ["GET", "PUT", "HEAD", "DELETE", "POST"][rng.integers(5)]
        key = keys[rng.integers(len(keys))]
        query = "&".join(f"{k}={v}" for k, v in (
            ("list-type", "2"), ("prefix", "p/q"), ("max-keys", str(rng.integers(1, 1000))),
            ("acl", ""), ("uploadId", f"u{i}"))[: rng.integers(0, 5)])
        body = rng.integers(0, 256, int(rng.integers(0, 64)), dtype=np.uint8).tobytes()
        headers = {"Content-Type": "application/octet-stream"} if body else {}
        if rng.integers(2):
            headers["x-amz-meta-k"] = f"  v {i}  "
            headers["x-oss-meta-k"] = f"v{i}"
        now = PINNED + datetime.timedelta(seconds=int(rng.integers(0, 10**6)))
        yield method, key, query, body, headers, now


def test_signers_are_byte_identical_to_the_reference():
    import hashlib

    for method, key, query, body, headers, now in _seeded_requests():
        url = "http://127.0.0.1:9000/bucket/" + urllib.parse.quote(key) + (
            "?" + query if query else "")
        payload = hashlib.sha256(body).hexdigest()
        for mod_args in ((ACCESS, SECRET, REGION),):
            got = signing.sign_v4(method, url, dict(headers), payload, *mod_args, now=now)
            want = ref_signing.sign_v4(method, url, dict(headers), payload, *mod_args, now=now)
            assert got == want
            assert (signing.presign_v4(method, url, *mod_args, expires_s=900, now=now)
                    == ref_signing.presign_v4(method, url, *mod_args, expires_s=900, now=now))
        for scheme in ("OSS", "OBS"):
            got = signing.sign_headerstyle(method, "bucket", key, dict(headers), ACCESS, SECRET,
                                           scheme=scheme, query=query, now=now)
            want = ref_signing.sign_headerstyle(method, "bucket", key, dict(headers), ACCESS,
                                                SECRET, scheme=scheme, query=query, now=now)
            assert got == want
    assert signing.EMPTY_SHA256 == ref_signing.EMPTY_SHA256


def test_sigv4_is_deterministic_and_sensitive():
    kwargs = dict(payload_hash=signing.EMPTY_SHA256, access_key=ACCESS,
                  secret_key=SECRET, region=REGION, now=PINNED)
    a = signing.sign_v4("GET", "http://h/x/y?b=2&a=1", {}, **kwargs)
    b = signing.sign_v4("GET", "http://h/x/y?a=1&b=2", {}, **kwargs)
    assert a["Authorization"] == b["Authorization"]
    c = signing.sign_v4("PUT", "http://h/x/y?a=1&b=2", {}, **kwargs)
    assert c["Authorization"] != a["Authorization"]


# ----------------------------------------------------------------- backends


def _exercise_backend(backend):
    """tests/test_remote_sources.py _exercise_backend on the port."""
    import hashlib

    backend.create_bucket("models")
    assert backend.is_bucket_exist("models")
    assert not backend.is_bucket_exist("nope")
    data = b"weights\x00\x01" * 4096
    meta = backend.put_object("models", "gnn/1/model.msgpack", data)
    assert meta.etag == hashlib.md5(data).hexdigest()
    backend.put_object("models", "gnn/2/model.msgpack", b"v2")
    backend.put_object("models", "mlp/1/model.msgpack", b"m1")
    assert backend.get_object("models", "gnn/1/model.msgpack") == data
    assert backend.get_object("models", "gnn/1/model.msgpack", range_=(8, 15)) == data[8:16]
    got = backend.get_object_metadata("models", "gnn/2/model.msgpack")
    assert got.content_length == 2 and got.last_modified_at > 0
    listed = backend.get_object_metadatas("models", prefix="gnn/")
    assert [m.key for m in listed] == ["gnn/1/model.msgpack", "gnn/2/model.msgpack"]
    assert listed[0].content_length == len(data)
    assert backend.is_object_exist("models", "mlp/1/model.msgpack")
    copied = backend.copy_object("models", "mlp/1/model.msgpack", "mlp/2/model.msgpack")
    assert copied.content_length == 2
    assert backend.get_object("models", "mlp/2/model.msgpack") == b"m1"
    assert not backend.put_object_if_absent("models", "mlp/2/model.msgpack", b"other")
    assert backend.put_object_if_absent("models", "mlp/3/model.msgpack", b"m3")
    backend.delete_object("models", "mlp/1/model.msgpack")
    assert not backend.is_object_exist("models", "mlp/1/model.msgpack")
    with pytest.raises(dferrors.NotFound):
        backend.get_object("models", "mlp/1/model.msgpack")
    assert "models" in [b.name for b in backend.get_bucket_metadatas()]


def test_backend_roundtrip(vendor):
    scheme, opts, _ = vendor
    _exercise_backend(new_backend(scheme, **opts))


def test_backends_read_what_the_other_package_wrote(vendor):
    """One stub, both packages: each package's backend reads the other's
    writes with equal bytes, metadata and listings."""
    scheme, opts, _ = vendor
    port, ref = new_backend(scheme, **opts), ref_backends.new_backend(scheme, **opts)
    rng = np.random.default_rng(7)
    port.create_bucket("x")
    blobs = {f"k/{i:02d} {'ü' if i % 3 else ''}.bin": rng.integers(
        0, 256, int(rng.integers(1, 5000)), dtype=np.uint8).tobytes() for i in range(8)}
    for i, (key, data) in enumerate(blobs.items()):
        (port if i % 2 else ref).put_object("x", key, data)
    for key, data in blobs.items():
        assert port.get_object("x", key) == ref.get_object("x", key) == data
        assert (dataclasses.asdict(port.get_object_metadata("x", key))
                == dataclasses.asdict(ref.get_object_metadata("x", key)))
        assert port.get_object("x", key, range_=(1, 3)) == ref.get_object("x", key,
                                                                          range_=(1, 3))
    assert ([dataclasses.asdict(m) for m in port.get_object_metadatas("x", prefix="k/")]
            == [dataclasses.asdict(m) for m in ref.get_object_metadatas("x", prefix="k/")])
    assert ([dataclasses.asdict(b) for b in port.get_bucket_metadatas()]
            == [dataclasses.asdict(b) for b in ref.get_bucket_metadatas()])


def test_bad_credentials_rejected(vendor):
    scheme, opts, _ = vendor
    with pytest.raises(dferrors.PermissionDenied):
        new_backend(scheme, **dict(opts, secret_key="wrong")).create_bucket("models")


def test_s3_presigned_url():
    """GetSignURL parity: a plain HTTP client fetches through the URL (the
    reference's handler checks presigned queries), and the URL equals the
    reference backend's at one instant."""
    stub = _RefStub("s3")
    try:
        opts = dict(endpoint=stub.endpoint, access_key=stub.access, secret_key=stub.secret,
                    region=stub.region)
        backend = new_backend("s3", **opts)
        backend.create_bucket("pub")
        backend.put_object("pub", "file.bin", b"presigned!")
        with urllib.request.urlopen(backend.get_sign_url("pub", "file.bin", "GET", 300),
                                    timeout=10) as resp:
            assert resp.read() == b"presigned!"
    finally:
        stub.stop()


def test_vendor_requires_endpoint(tmp_path):
    assert new_backend("fs", tmp_path).name == "fs"
    for vendor_name in ("s3", "oss", "obs"):
        with pytest.raises(dferrors.Unavailable):
            new_backend(vendor_name)
    with pytest.raises(dferrors.InvalidArgument):
        new_backend("gcs", endpoint="x")
    with pytest.raises(dferrors.InvalidArgument):
        new_backend("s3", endpoint="x")  # no keys


def test_s3_list_follows_continuation_tokens():
    stub = chip_smoke._S3Stub()
    try:
        backend = new_backend("s3", endpoint=stub.endpoint, access_key=ACCESS,
                              secret_key=SECRET, region=REGION)
        backend.create_bucket("big")
        for i in range(2500):  # three 1000-key pages
            stub.put("big", f"p/{i:05d}", b"x")
        listed = backend.get_object_metadatas("big", prefix="p/")
        assert [m.key for m in listed] == [f"p/{i:05d}" for i in range(2500)]
        assert len(backend.get_object_metadatas("big", prefix="p/", limit=1500)) == 1500
    finally:
        stub.stop()


def test_s3_keys_needing_percent_encoding(vendor):
    scheme, opts, _ = vendor
    backend = new_backend(scheme, **opts)
    backend.create_bucket("enc")
    for key in ("dir with space/a b.txt", "plus+sign.bin", "uni-köln/日本.txt"):
        backend.put_object("enc", key, key.encode())
        assert backend.get_object("enc", key) == key.encode()
        assert backend.get_object_metadata("enc", key).content_length == len(key.encode())
        assert backend.copy_object("enc", key, key + ".copy").content_length == len(key.encode())
        assert backend.get_object("enc", key + ".copy") == key.encode()


def test_virtual_hosted_addressing():
    b = new_backend("s3", endpoint="http://s3.example:9000", access_key="a", secret_key="s",
                    virtual_hosted=True)
    r = ref_backends.new_backend("s3", endpoint="http://s3.example:9000", access_key="a",
                                 secret_key="s", virtual_hosted=True)
    for args in (("bkt", "a b/c"), ("bkt", ""), ("", "")):
        assert b._url(*args, query="x=1") == r._url(*args, query="x=1")
    assert b._url("bkt", "k") == "http://bkt.s3.example:9000/k"


# ------------------------------------------------------------- the sources


def test_s3_source_download_range_and_listing(vendor):
    scheme, opts, _ = vendor
    backend = new_backend(scheme, **opts)
    backend.create_bucket("data")
    payload = bytes(range(256)) * 64
    backend.put_object("data", "set/train.bin", payload)
    for k in ("set/b/x.txt", "set/b/y.txt", "other/z.txt"):
        backend.put_object("data", k, b"#")
    hdrs = {"x-df-endpoint": opts["endpoint"], "x-df-access-key": opts["access_key"],
            "x-df-secret-key": opts["secret_key"], "x-df-region": opts["region"]}
    url = f"{scheme}://data/set/train.bin"
    assert source.content_length(url, hdrs) == len(payload)
    assert b"".join(source.download(url, hdrs)) == payload
    assert b"".join(source.download(url, hdrs, offset=100, length=50)) == payload[100:150]
    assert b"".join(source.download(url, hdrs, offset=len(payload) - 7)) == payload[-7:]
    entries = source.list_entries(f"{scheme}://data/set/", hdrs)
    by_name = {e.name: e for e in entries}
    assert set(by_name) == {"train.bin", "b"} and by_name["b"].is_dir
    assert by_name["b"].url.endswith("/b/")


def test_s3_source_needs_endpoint(monkeypatch):
    monkeypatch.delenv("DRAGONFLY_S3_ENDPOINT", raising=False)
    with pytest.raises(dferrors.Unavailable, match="endpoint"):
        source.content_length("s3://b/k", {})
    with pytest.raises(dferrors.InvalidArgument):
        source.content_length("s3://bucket-only", {"x-df-endpoint": "127.0.0.1:9"})


def test_s3_source_reads_credentials_from_the_environment(monkeypatch):
    stub = chip_smoke._S3Stub()
    try:
        stub.put("env", "k", b"from-env")
        monkeypatch.setenv("DRAGONFLY_S3_ENDPOINT", stub.endpoint)
        monkeypatch.setenv("DRAGONFLY_S3_ACCESS_KEY", ACCESS)
        monkeypatch.setenv("DRAGONFLY_S3_SECRET_KEY", SECRET)
        monkeypatch.setenv("DRAGONFLY_S3_REGION", REGION)
        assert b"".join(source.download("s3://env/k")) == b"from-env"
    finally:
        stub.stop()


def test_dfget_recursive_s3_with_header_creds(tmp_path):
    """dfget -r s3://bucket/dir/ with x-df-* headers walks the tree and
    back-sources every file through the signed client, on the port's
    scheduler service on the CPU."""
    from dragonfly2_tpu_torch.client import cli
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.rpc.server import SchedulerRPCServer

    stub = chip_smoke._S3Stub()
    tree = {
        "site/index.html": b"<html>root</html>",
        "site/assets/app.js": b"console.log(1)" * 100,
        "site/assets/deep/style.css": b"body{}" * 50,
    }
    for k, v in tree.items():
        stub.put("web", k, v)

    async def run():
        cfg = Config()
        cfg.scheduler.max_hosts = 16
        cfg.scheduler.max_tasks = 16
        server = SchedulerRPCServer(SchedulerService(config=cfg, device="cpu"),
                                    tick_interval=0.01)
        host, port = await server.start()
        out = tmp_path / "mirror"
        try:
            rc = await cli._dfget(cli.build_parser().parse_args([
                "dfget", "s3://web/site/", "-r", "-o", str(out),
                "--scheduler", f"{host}:{port}", "--data-dir", str(tmp_path / "dfget-data"),
                "--piece-length", str(16 * 1024),
                "-H", f"x-df-endpoint: {stub.endpoint}", "-H", f"x-df-access-key: {ACCESS}",
                "-H", f"x-df-secret-key: {SECRET}", "-H", f"x-df-region: {REGION}"]))
        finally:
            await server.stop()
        return rc, out

    try:
        rc, out = asyncio.run(run())
    finally:
        stub.stop()
    assert rc == 0 and stub.refused == 0
    assert (out / "index.html").read_bytes() == tree["site/index.html"]
    assert (out / "assets" / "app.js").read_bytes() == tree["site/assets/app.js"]
    assert (out / "assets" / "deep" / "style.css").read_bytes() == tree["site/assets/deep/style.css"]


# --------------------------------------------------------------- registry


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_s3_registry_reads_the_other_packages_version(writer):
    stub = chip_smoke._S3Stub()
    try:
        url = "s3://models/fleet?" + urllib.parse.urlencode({
            "endpoint": stub.endpoint, "access_key": ACCESS, "secret_key": SECRET,
            "region": REGION})
        rng = np.random.default_rng(3)
        params = {"params": {"dense": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                                       "bias": np.zeros(3, np.float32)}}}
        if writer == "port":
            w, r = open_registry(url), ref_open_registry(url)
            mv = w.create_model_version("ranker", "gnn", "host-1", params, ModelEvaluation())
        else:
            from dragonfly2_tpu.registry.registry import ModelEvaluation as RefEvaluation

            w, r = ref_open_registry(url), open_registry(url)
            mv = w.create_model_version("ranker", "gnn", "host-1", params, RefEvaluation())
        w.activate(mv.model_id, mv.version)
        assert r.active_version(mv.model_id).version == mv.version
        key = f"fleet/{mv.model_id}/{mv.version}/params.msgpack"
        got = r.load_params(mv.model_id, mv.version)
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got["params"]["dense"][leaf],
                                          params["params"]["dense"][leaf])
        assert stub.object("models", key) is not None and stub.refused == 0
    finally:
        stub.stop()


# ------------------------------------------------------------ the service


def _script(client_call):
    """One scripted request sequence against a service's ``handle``:
    [(method, path, body)]."""
    rng = np.random.default_rng(11)
    blob = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    steps = [
        ("GET", "/healthy", b""),
        ("POST", "/buckets", json.dumps({"name": "blobs"}).encode()),
        ("GET", "/buckets", b""),
        ("PUT", "/buckets/blobs/objects/dir/a%20b.bin", blob),
        ("HEAD", "/buckets/blobs/objects/dir/a%20b.bin", b""),
        ("GET", "/buckets/blobs/objects/dir/a%20b.bin", b""),
        ("POST", "/buckets/blobs/objects/dir/a%20b.bin?copy_to=dir/c.bin", b""),
        ("GET", "/buckets/blobs/metadatas?prefix=dir/", b""),
        ("DELETE", "/buckets/blobs/objects/dir/a%20b.bin", b""),
        ("GET", "/buckets/blobs/objects/dir/a%20b.bin", b""),
        ("GET", "/nope", b""),
        ("DELETE", "/buckets/blobs", b""),
    ]
    return [client_call(*s) for s in steps]


def _answers(svc_cls, fs_cls, storage_cls, root):
    svc = svc_cls(fs_cls(root / "objects"), storage=storage_cls(root / "tasks"))

    def call(method, path, body):
        try:
            status, headers, out = svc.handle(method, path, body)
        except Exception as e:  # noqa: BLE001 - the handler's error mapping
            return type(e).__name__, {}, b""
        if headers.get("Content-Type") == "application/json":
            # file times differ between the two directories: drop them
            doc = json.loads(out)
            for row in doc if isinstance(doc, list) else [doc]:
                row.pop("last_modified_at", None)
                row.pop("created_at", None)
            out = json.dumps(doc).encode()
        return status, headers, out

    try:
        return _script(call)
    finally:
        svc._httpd.server_close()


def test_object_storage_service_answers_as_the_reference(tmp_path):
    from dragonfly2_tpu.client.storage import StorageManager as RefStorageManager

    got = _answers(ObjectStorageService, FilesystemBackend, StorageManager, tmp_path / "port")
    want = _answers(ref_service.ObjectStorageService, ref_backends.FilesystemBackend,
                    RefStorageManager, tmp_path / "ref")
    assert got == want
    # the last DELETE meets a bucket that still holds the copy
    assert [a[0] for a in got] == [200, 200, 200, 200, 200, 200, 200, 200, 200, "NotFound",
                                   "InvalidArgument", "InvalidArgument"]


def test_object_task_id_is_the_reference():
    rng = np.random.default_rng(5)
    for i in range(32):
        bucket, key = f"b{rng.integers(100)}", f"k/{rng.integers(10**6)} ü"
        assert backends.object_task_id(bucket, key) == ref_backends.object_task_id(bucket, key)


@pytest.fixture()
def object_service(tmp_path):
    svc = ObjectStorageService(FilesystemBackend(tmp_path / "objects"),
                               storage=StorageManager(tmp_path / "tasks"))
    svc.start()
    yield svc
    svc.stop()


def test_object_service_http_roundtrip(object_service):
    client = DfstoreClient(f"http://{object_service.host}:{object_service.port}")
    client.create_bucket("blobs")
    assert [b["name"] for b in client.list_buckets()] == ["blobs"]
    payload = bytes(range(256)) * 100
    client.put_object("blobs", "dir/a.bin", payload)
    assert client.get_object("blobs", "dir/a.bin") == payload
    assert client.is_object_exist("blobs", "dir/a.bin")
    assert not client.is_object_exist("blobs", "nope")
    client.copy_object("blobs", "dir/a.bin", "dir/b.bin")
    assert [m["key"] for m in client.object_metadatas("blobs", prefix="dir/")] == [
        "dir/a.bin", "dir/b.bin"]
    client.delete_object("blobs", "dir/a.bin")
    with pytest.raises(dferrors.NotFound):
        client.get_object("blobs", "dir/a.bin")


def test_put_imports_into_p2p_task_storage(object_service):
    client = DfstoreClient(f"http://{object_service.host}:{object_service.port}")
    client.create_bucket("b")
    client.put_object("b", "k.bin", b"shared-bytes")
    ts = object_service.storage.find_completed_task(backends.object_task_id("b", "k.bin"))
    assert ts is not None and ts.meta.done and ts.read_range(0, 12) == b"shared-bytes"
    object_service.backend.delete_object("b", "k.bin")
    assert client.get_object("b", "k.bin") == b"shared-bytes"  # the P2P fallback
    client.put_object("b", "k.bin", b"second")  # a re-PUT replaces the task
    object_service.backend.delete_object("b", "k.bin")
    assert client.get_object("b", "k.bin") == b"second"


def test_daemon_object_storage_fronts_signed_s3(tmp_path):
    stub = chip_smoke._S3Stub()
    s3 = new_backend("s3", endpoint=stub.endpoint, access_key=ACCESS, secret_key=SECRET,
                     region=REGION)
    svc = ObjectStorageService(s3, storage=StorageManager(tmp_path / "pieces"))
    svc.start()
    try:
        client = DfstoreClient(f"http://{svc.host}:{svc.port}")
        client.create_bucket("artifacts")
        payload = b"tarball-bytes" * 2048
        client.put_object("artifacts", "img/layer.tar", payload)
        assert stub.object("artifacts", "img/layer.tar") == payload
        assert client.get_object("artifacts", "img/layer.tar") == payload
        assert [m.key for m in s3.get_object_metadatas("artifacts")] == ["img/layer.tar"]
        assert stub.refused == 0
    finally:
        svc.stop()
        stub.stop()


def test_daemon_object_storage_listener(tmp_path):
    """Daemon(object_storage=True) serves the API beside the upload server
    between start() and stop(), against the port's scheduler service."""
    from dragonfly2_tpu_torch.client.daemon import Daemon
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.rpc.server import SchedulerRPCServer

    async def run():
        cfg = Config()
        cfg.scheduler.max_hosts = 8
        cfg.scheduler.max_tasks = 8
        server = SchedulerRPCServer(SchedulerService(config=cfg, device="cpu"),
                                    tick_interval=0.01)
        host, port = await server.start()
        daemon = Daemon(tmp_path / "d", [(host, port)], hostname="obj-host", object_storage=True)
        await daemon.start()
        try:
            client = DfstoreClient(
                f"http://{daemon.object_storage.host}:{daemon.object_storage.port}")
            client.create_bucket("x")
            client.put_object("x", "y", b"z")
            assert client.get_object("x", "y") == b"z"
        finally:
            await daemon.stop()
            await server.stop()

    asyncio.run(run())


def test_fs_backend_sibling_bucket_prefix_escape(tmp_path):
    be = FilesystemBackend(tmp_path)
    be.create_bucket("a")
    be.create_bucket("ab")
    be.put_object("ab", "secret", b"private")
    with pytest.raises(dferrors.InvalidArgument):
        be.get_object("a", "../ab/secret")
    with pytest.raises(dferrors.InvalidArgument):
        be.put_object("a", "../ab/planted", b"x")


def test_the_service_module_is_the_reference_surface():
    for name in ("ObjectStorageService", "DfstoreClient"):
        assert hasattr(service, name) and hasattr(ref_service, name)
    assert sorted(n for n in dir(DfstoreClient) if not n.startswith("_")) == sorted(
        n for n in dir(ref_service.DfstoreClient) if not n.startswith("_"))
