"""Daemon object-storage HTTP service + dfstore client SDK.

Capability parity with client/daemon/objectstorage/objectstorage.go:724
(the S3-compatible-ish HTTP API the daemon serves: bucket listing, object
GET/PUT/HEAD/DELETE, metadata listing, copy) and client/dfstore/dfstore.go
(the SDK/CLI wrapping that API: GetObject/PutObject/CopyObject/
IsObjectExist/...). P2P integration: PUT imports the object into the
daemon's task storage under a stable object task id so child peers can
pull it over the piece upload server; GET falls back to the local task
cache when the backend misses.

Port of dragonfly2_tpu/objectstorage/service.py, whole; host code, no
torch: the daemon serves it beside its upload server.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dragonfly2_tpu_torch.objectstorage.backends import object_task_id
from dragonfly2_tpu_torch.utils import dferrors


class ObjectStorageService:
    def __init__(self, backend, storage=None, host: str = "127.0.0.1", port: int = 0):
        """`backend` is an objectstorage backend; `storage` optionally a
        client StorageManager for P2P import/serve."""
        self.backend = backend
        self.storage = storage
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _run(self):
                try:
                    status, headers, body = outer.handle(
                        self.command,
                        self.path,
                        self.rfile.read(int(self.headers.get("Content-Length") or 0)),
                    )
                except dferrors.NotFound as e:
                    status, headers, body = 404, {}, str(e).encode()
                except dferrors.InvalidArgument as e:
                    status, headers, body = 400, {}, str(e).encode()
                except Exception as e:  # noqa: BLE001 - surface as 500
                    status, headers, body = 500, {}, f"{type(e).__name__}: {e}".encode()
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _run

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> tuple[str, int]:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.host, self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    # -------------------------------------------------------------- routes

    def handle(self, method: str, path: str, body: bytes):
        path, _, query = path.partition("?")
        params = dict(urllib.parse.parse_qsl(query))
        parts = [urllib.parse.unquote(p) for p in path.split("/") if p]

        if parts == ["healthy"]:
            return 200, {}, b"ok"
        if parts == ["buckets"]:
            if method == "GET":
                return self._json([vars(b) for b in self.backend.get_bucket_metadatas()])
            if method == "POST":
                name = json.loads(body or b"{}").get("name", "")
                self.backend.create_bucket(name)
                return 200, {}, b"{}"
        if len(parts) == 2 and parts[0] == "buckets":
            if method == "DELETE":
                self.backend.delete_bucket(parts[1])
                return 200, {}, b"{}"
        if len(parts) == 3 and parts[0] == "buckets" and parts[2] == "metadatas":
            metas = self.backend.get_object_metadatas(parts[1], prefix=params.get("prefix", ""))
            return self._json([vars(m) for m in metas])
        if len(parts) >= 4 and parts[0] == "buckets" and parts[2] == "objects":
            bucket, key = parts[1], "/".join(parts[3:])
            return self._object(method, bucket, key, body, params)
        raise dferrors.InvalidArgument(f"no route {method} {path}")

    def _object(self, method: str, bucket: str, key: str, body: bytes, params: dict):
        if method == "PUT":
            meta = self.backend.put_object(bucket, key, body)
            # P2P import (mode=ImportModes in the reference): make the
            # object a completed local task so peers can pull pieces.
            if self.storage is not None:
                self._import_task(bucket, key, body)
            return self._json(vars(meta))
        if method == "HEAD":
            meta = self.backend.get_object_metadata(bucket, key)
            return 200, {
                "Content-Length-Object": str(meta.content_length),
                "Etag": meta.etag,
            }, b""
        if method == "GET":
            try:
                data = self.backend.get_object(bucket, key)
            except dferrors.NotFound:
                data = self._read_task(bucket, key)  # P2P cache fallback
                if data is None:
                    raise
            return 200, {"Content-Type": "application/octet-stream"}, data
        if method == "DELETE":
            self.backend.delete_object(bucket, key)
            if self.storage is not None:
                self.storage.delete_task(object_task_id(bucket, key))
            return 200, {}, b"{}"
        if method == "POST" and "copy_to" in params:
            meta = self.backend.copy_object(bucket, key, params["copy_to"])
            return self._json(vars(meta))
        raise dferrors.InvalidArgument(f"bad object op {method}")

    def _import_task(self, bucket: str, key: str, data: bytes) -> None:
        from dragonfly2_tpu_torch.client.piece_manager import piece_layout
        from dragonfly2_tpu_torch.client.storage import TaskMetadata

        task_id = object_task_id(bucket, key)
        # Overwrite semantics: a re-PUT must replace the P2P copy, never
        # leave peers pulling the previous object's bytes.
        self.storage.delete_task(task_id)
        ts = self.storage.register_task(TaskMetadata(task_id=task_id, peer_id="objstore"))
        layout = piece_layout(len(data), ts.meta.piece_length)
        for n, off, length in layout:
            ts.write_piece(n, off, data[off : off + length])
        ts.mark_done(len(data), len(layout))

    def _read_task(self, bucket: str, key: str) -> bytes | None:
        if self.storage is None:
            return None
        ts = self.storage.find_completed_task(object_task_id(bucket, key))
        if ts is None:
            return None
        return ts.read_range(0, max(ts.meta.content_length, 0))

    @staticmethod
    def _json(obj) -> tuple[int, dict, bytes]:
        return 200, {"Content-Type": "application/json"}, json.dumps(obj).encode()


class DfstoreClient:
    """client/dfstore SDK surface over the daemon's object-storage API."""

    def __init__(self, endpoint: str, timeout: float = 30.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout

    def create_bucket(self, bucket: str) -> None:
        self._request("POST", "/buckets", json.dumps({"name": bucket}).encode())

    def list_buckets(self) -> list[dict]:
        return json.loads(self._request("GET", "/buckets"))

    def put_object(self, bucket: str, key: str, data: bytes) -> dict:
        return json.loads(self._request("PUT", self._object_path(bucket, key), data))

    def get_object(self, bucket: str, key: str) -> bytes:
        return self._request("GET", self._object_path(bucket, key))

    def delete_object(self, bucket: str, key: str) -> None:
        self._request("DELETE", self._object_path(bucket, key))

    def copy_object(self, bucket: str, src: str, dst: str) -> dict:
        quoted = urllib.parse.quote(dst)
        return json.loads(
            self._request("POST", f"{self._object_path(bucket, src)}?copy_to={quoted}")
        )

    def is_object_exist(self, bucket: str, key: str) -> bool:
        try:
            self._request("HEAD", self._object_path(bucket, key))
            return True
        except dferrors.NotFound:
            return False

    def object_metadatas(self, bucket: str, prefix: str = "") -> list[dict]:
        quoted = urllib.parse.quote(prefix)
        return json.loads(self._request("GET", f"/buckets/{bucket}/metadatas?prefix={quoted}"))

    def _object_path(self, bucket: str, key: str) -> str:
        return f"/buckets/{bucket}/objects/{urllib.parse.quote(key)}"

    def _request(self, method: str, path: str, body: bytes | None = None) -> bytes:
        req = urllib.request.Request(self.endpoint + path, data=body, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            if e.code == 404:
                raise dferrors.NotFound(detail) from None
            if e.code == 400:
                raise dferrors.InvalidArgument(detail) from None
            raise dferrors.Unavailable(f"{e.code}: {detail}") from None
