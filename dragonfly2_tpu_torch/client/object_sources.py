"""Object-store / HDFS / OCI back-to-source clients.

Port of dragonfly2_tpu/client/object_sources.py, whole; host code, no
torch.

Capability parity with pkg/source/clients/{s3,oss,hdfs,oras}protocol: the
remaining schemes of the reference's back-source registry, implemented
over stdlib HTTP (no cloud SDK):

- `ObjectStoreSource` (s3/oss/obs): `s3://bucket/key` → signed vendor
  HTTP via `objectstorage.remote`. Credentials come per-request from
  `x-df-endpoint`/`x-df-access-key`/`x-df-secret-key`/`x-df-region`
  headers (the reference's s3 client likewise reads creds from request
  metadata rather than ambient config) with `DRAGONFLY_<SCHEME>_*` env
  fallback.
- `HdfsSource`: `hdfs://namenode:port/path` over the WebHDFS REST API
  (OPEN with offset/length, GETFILESTATUS, LISTSTATUS) — the reference
  links a native Go hdfs client (hdfs_source_client.go:173-211); WebHDFS
  is the transport every Hadoop distro exposes over plain HTTP.
- `OrasSource`: `oras://registry/repo:tag` → OCI distribution pull:
  bearer-token challenge, manifest fetch (oras_source_client.go:104-126),
  first-layer blob download.
"""

from __future__ import annotations

import base64
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterator

from dragonfly2_tpu_torch.client.source import URLEntry
from dragonfly2_tpu_torch.objectstorage.backends import new_backend
from dragonfly2_tpu_torch.utils import dferrors

_CHUNK = 1 << 20
OCI_MANIFEST_ACCEPT = (
    "application/vnd.oci.image.manifest.v1+json, "
    "application/vnd.docker.distribution.manifest.v2+json"
)


def _header(headers: dict | None, name: str) -> str | None:
    if not headers:
        return None
    lowered = {k.lower(): v for k, v in headers.items()}
    return lowered.get(name.lower())


def fetch_bearer_token(
    challenge: str, basic_auth: str | None = None, timeout: float = 30.0
) -> str | None:
    """Resolve a registry `WWW-Authenticate: Bearer ...` challenge into a
    token: parse realm/service/scope, hit the token endpoint (with HTTP
    Basic when `basic_auth` is "user:pass" material), return the token.

    Shared by OrasSource's artifact pulls and the manager's image-preheat
    manifest walk (oras_source_client.go:104 / manager/job/preheat.go
    imageAuthClient) — both speak the same token-challenge protocol."""
    if not challenge.lower().startswith("bearer"):
        return None
    fields = {}
    for item in challenge[len("bearer"):].split(","):
        k, _, v = item.strip().partition("=")
        fields[k.lower()] = v.strip('"')
    realm = fields.get("realm")
    if not realm:
        return None
    query = {k: fields[k] for k in ("service", "scope") if k in fields}
    token_url = realm + ("?" + urllib.parse.urlencode(query) if query else "")
    req = urllib.request.Request(token_url)
    if basic_auth:
        req.add_header(
            "Authorization", "Basic " + base64.b64encode(basic_auth.encode()).decode()
        )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read())
        return body.get("token") or body.get("access_token")
    except (urllib.error.URLError, ValueError):
        return None


# ----------------------------------------------------------- s3/oss/obs


class ObjectStoreSource:
    def __init__(self, scheme: str):
        self.scheme = scheme

    def _split(self, url: str) -> tuple[str, str]:
        parts = urllib.parse.urlsplit(url)
        bucket = parts.netloc
        key = parts.path.lstrip("/")
        if not bucket or not key:
            raise dferrors.InvalidArgument(
                f"{self.scheme} url needs {self.scheme}://bucket/key, got {url!r}"
            )
        return bucket, urllib.parse.unquote(key)

    def _backend(self, headers: dict | None):
        env = os.environ
        up = self.scheme.upper()

        def opt(h: str, e: str) -> str | None:
            return _header(headers, h) or env.get(f"DRAGONFLY_{up}_{e}")

        endpoint = opt("x-df-endpoint", "ENDPOINT")
        if not endpoint:
            raise dferrors.Unavailable(
                f"{self.scheme}:// back-source needs an endpoint: set the "
                f"x-df-endpoint request header or DRAGONFLY_{up}_ENDPOINT"
            )
        return new_backend(
            self.scheme,
            endpoint=endpoint,
            access_key=opt("x-df-access-key", "ACCESS_KEY") or "",
            secret_key=opt("x-df-secret-key", "SECRET_KEY") or "",
            region=opt("x-df-region", "REGION") or "",
        )

    def content_length(self, url: str, headers: dict | None = None) -> int:
        bucket, key = self._split(url)
        return self._backend(headers).get_object_metadata(bucket, key).content_length

    def download(
        self, url: str, headers: dict | None = None, offset: int = 0, length: int = -1
    ) -> Iterator[bytes]:
        bucket, key = self._split(url)
        backend = self._backend(headers)
        if offset or length > 0:
            if length > 0:
                range_ = (offset, offset + length - 1)
            else:
                total = backend.get_object_metadata(bucket, key).content_length
                if offset >= total:
                    return
                range_ = (offset, total - 1)
            data = backend.get_object(bucket, key, range_=range_)
        else:
            data = backend.get_object(bucket, key)
        for i in range(0, len(data), _CHUNK):
            yield data[i : i + _CHUNK]

    def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        """Direct children of `s3://bucket/prefix/`: object keys under the
        prefix collapse at the next '/' (dirs are synthesized the way every
        object-store console does — they don't exist server-side)."""
        parts = urllib.parse.urlsplit(url)
        bucket = parts.netloc
        prefix = urllib.parse.unquote(parts.path.lstrip("/"))
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        backend = self._backend(headers)
        base = f"{self.scheme}://{bucket}/" + urllib.parse.quote(prefix)
        seen: dict[str, URLEntry] = {}
        for meta in backend.get_object_metadatas(bucket, prefix=prefix):
            rest = meta.key[len(prefix):]
            if not rest:
                continue
            name, sep, _ = rest.partition("/")
            is_dir = bool(sep)
            if name not in seen:
                seen[name] = URLEntry(
                    url=base + urllib.parse.quote(name) + ("/" if is_dir else ""),
                    name=name,
                    is_dir=is_dir,
                )
        return list(seen.values())


# ----------------------------------------------------------------- hdfs


class HdfsSource:
    """WebHDFS REST (`http://namenode/webhdfs/v1<path>?op=...`)."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    WEBHDFS_DEFAULT_PORT = 9870  # NameNode HTTP port (not the 8020 RPC port)

    def _base(self, url: str) -> tuple[str, str]:
        parts = urllib.parse.urlsplit(url)
        if not parts.hostname:
            raise dferrors.InvalidArgument(f"hdfs url needs a namenode host: {url!r}")
        port = parts.port or self.WEBHDFS_DEFAULT_PORT
        return f"http://{parts.hostname}:{port}/webhdfs/v1", parts.path or "/"

    def _op(self, url: str, op: str, extra: str = "", headers: dict | None = None):
        base, path = self._base(url)
        user = _header(headers, "x-df-hdfs-user")
        q = f"op={op}" + (f"&{extra}" if extra else "")
        if user:
            q += f"&user.name={urllib.parse.quote(user)}"
        full = base + urllib.parse.quote(path) + "?" + q
        req = urllib.request.Request(full)
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise dferrors.NotFound(f"hdfs {path}: not found") from e
            raise dferrors.Unavailable(f"hdfs {op} {path}: {e}") from e
        except urllib.error.URLError as e:
            raise dferrors.Unavailable(f"hdfs {op} {path}: {e}") from e

    def content_length(self, url: str, headers: dict | None = None) -> int:
        with self._op(url, "GETFILESTATUS", headers=headers) as resp:
            status = json.loads(resp.read())["FileStatus"]
        return int(status["length"])

    def download(
        self, url: str, headers: dict | None = None, offset: int = 0, length: int = -1
    ) -> Iterator[bytes]:
        extra = []
        if offset:
            extra.append(f"offset={offset}")
        if length > 0:
            extra.append(f"length={length}")
        resp = self._op(url, "OPEN", "&".join(extra), headers=headers)
        with resp:
            while True:
                chunk = resp.read(_CHUNK)
                if not chunk:
                    return
                yield chunk

    def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        with self._op(url, "LISTSTATUS", headers=headers) as resp:
            statuses = json.loads(resp.read())["FileStatuses"]["FileStatus"]
        base = url if url.endswith("/") else url + "/"
        out = []
        for st in statuses:
            name = st.get("pathSuffix", "")
            if not name:
                continue
            is_dir = st.get("type") == "DIRECTORY"
            out.append(
                URLEntry(
                    url=base + urllib.parse.quote(name) + ("/" if is_dir else ""),
                    name=name,
                    is_dir=is_dir,
                )
            )
        return out


# ----------------------------------------------------------------- oras


class OrasSource:
    """OCI distribution pull for `oras://registry/repo:tag` artifacts.

    Piece-level back-source fans out one ranged download() per piece
    (piece_manager), so ranged reads use real HTTP Range requests on the
    blob and the token+manifest resolution is cached for `resolve_ttl_s` —
    without both, an N-piece fetch would re-pull the manifest N times and
    skip-read O(N^2) blob bytes."""

    def __init__(self, timeout: float = 30.0, resolve_ttl_s: float = 60.0):
        self.timeout = timeout
        self.resolve_ttl_s = resolve_ttl_s
        # (url, caller-credential-material) -> (resolved_at, result)
        self._resolved: dict[tuple, tuple[float, tuple[str, str, int, str | None]]] = {}

    def _parse(self, url: str) -> tuple[str, str, str, str]:
        parts = urllib.parse.urlsplit(url)
        host = parts.netloc
        path = parts.path.lstrip("/")
        if ":" in path:
            repo, _, tag = path.rpartition(":")
        else:
            repo, tag = path, "latest"
        if not host or not repo:
            raise dferrors.InvalidArgument(
                f"oras url needs oras://registry/repo[:tag], got {url!r}"
            )
        scheme = "http" if self._plain_http(host) else "https"
        return scheme, host, repo, tag

    @staticmethod
    def _plain_http(host: str) -> bool:
        if os.environ.get("DRAGONFLY_ORAS_PLAIN_HTTP"):
            return True
        bare = host.rsplit(":", 1)[0]
        return bare in ("localhost", "127.0.0.1", "::1")

    def _get(self, url: str, headers: dict[str, str]):
        req = urllib.request.Request(url, headers=headers)
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _authed_get(
        self,
        url: str,
        accept: str,
        headers: dict | None,
        token: str | None = None,
        extra: dict[str, str] | None = None,
    ) -> tuple[object, str | None]:
        """GET with bearer-challenge handling (oras_source_client.go:104:
        401 → parse WWW-Authenticate → token endpoint → retry). Returns
        (response, bearer_token_used) so callers can reuse the token."""
        hdrs = {"Accept": accept}
        if extra:
            hdrs.update(extra)
        auth = _header(headers, "Authorization")
        if token:
            hdrs["Authorization"] = f"Bearer {token}"
        elif auth:
            hdrs["Authorization"] = auth
        try:
            return self._get(url, hdrs), token
        except urllib.error.HTTPError as e:
            if e.code != 401:
                raise
            challenge = e.headers.get("WWW-Authenticate", "")
            token = self._fetch_token(challenge, headers)
            if token is None:
                raise dferrors.PermissionDenied(f"oras: unauthorized for {url}") from e
            hdrs["Authorization"] = f"Bearer {token}"
            return self._get(url, hdrs), token

    def _fetch_token(self, challenge: str, headers: dict | None) -> str | None:
        basic = _header(headers, "x-df-oras-auth")  # "user:pass" for login
        return fetch_bearer_token(challenge, basic_auth=basic, timeout=self.timeout)

    def _resolve_blob(
        self, url: str, headers: dict | None
    ) -> tuple[str, str, int, str | None]:
        """→ (blob_url, digest, size, token) of the artifact's first
        layer, cached for `resolve_ttl_s` (per-piece fetches must not
        re-pull the manifest each time). The cache key includes the
        caller's credential material: a bearer token obtained with one
        caller's auth must never be served to a caller presenting
        different (or no) credentials."""
        cache_key = (
            url,
            _header(headers, "Authorization") or "",
            _header(headers, "x-df-oras-auth") or "",
        )
        now = time.monotonic()
        cached = self._resolved.get(cache_key)
        if cached is not None and now - cached[0] < self.resolve_ttl_s:
            return cached[1]
        scheme, host, repo, tag = self._parse(url)
        manifest_url = f"{scheme}://{host}/v2/{repo}/manifests/{tag}"
        try:
            resp, token = self._authed_get(manifest_url, OCI_MANIFEST_ACCEPT, headers)
            with resp:
                manifest = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise dferrors.NotFound(f"oras: no manifest {repo}:{tag}") from e
            raise dferrors.Unavailable(f"oras manifest {repo}:{tag}: {e}") from e
        except urllib.error.URLError as e:
            raise dferrors.Unavailable(f"oras manifest {repo}:{tag}: {e}") from e
        layers = manifest.get("layers") or []
        if not layers:
            raise dferrors.NotFound(f"oras: manifest {repo}:{tag} has no layers")
        layer = layers[0]
        digest = layer["digest"]
        result = (
            f"{scheme}://{host}/v2/{repo}/blobs/{digest}",
            digest,
            int(layer.get("size", -1)),
            token,
        )
        self._resolved[cache_key] = (now, result)
        if len(self._resolved) > 256:
            oldest = min(self._resolved, key=lambda k: self._resolved[k][0])
            del self._resolved[oldest]
        return result

    def content_length(self, url: str, headers: dict | None = None) -> int:
        _, _, size, _ = self._resolve_blob(url, headers)
        return size

    def download(
        self, url: str, headers: dict | None = None, offset: int = 0, length: int = -1
    ) -> Iterator[bytes]:
        blob_url, _, _, token = self._resolve_blob(url, headers)
        extra = {}
        if offset or length > 0:
            end = f"{offset + length - 1}" if length > 0 else ""
            extra["Range"] = f"bytes={offset}-{end}"
        try:
            resp, _ = self._authed_get(
                blob_url, "application/octet-stream", headers, token=token, extra=extra
            )
        except urllib.error.HTTPError as e:
            raise dferrors.Unavailable(f"oras blob: {e}") from e
        with resp:
            if extra and getattr(resp, "status", 200) == 200:
                # The registry ignored Range and sent the whole blob:
                # emulate the range (same guard as HTTPSource — yielding
                # the full entity would corrupt the piece buffer).
                to_skip = offset
                while to_skip > 0:
                    skipped = resp.read(min(_CHUNK, to_skip))
                    if not skipped:
                        return
                    to_skip -= len(skipped)
            remaining = length if length > 0 else -1
            while True:
                chunk = resp.read(_CHUNK if remaining < 0 else min(_CHUNK, remaining))
                if not chunk:
                    return
                yield chunk
                if remaining > 0:
                    remaining -= len(chunk)
                    if remaining <= 0:
                        return

    def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        raise dferrors.InvalidArgument("oras artifacts are not listable directories")
