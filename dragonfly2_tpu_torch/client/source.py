"""Back-to-source protocol clients.

Capability parity with pkg/source (source_client.go:267 `Register` +
per-scheme clients in pkg/source/clients/: http, s3, oss, hdfs, oras):
a scheme->client registry behind one interface (content_length, download,
list_entries, supports_range). Shipped clients: http/https (urllib, Range
requests) and file:// in this module; s3/oss/obs (signed vendor HTTP),
hdfs (WebHDFS), and oras (OCI pull) in `object_sources.py`, registered
lazily on first lookup.

Port of dragonfly2_tpu/client/source.py, whole; the s3/oss/obs clients
it registers raise naming ROADMAP A9 part 3 (object_sources.py).
"""

from __future__ import annotations

import dataclasses
import html.parser
import pathlib
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import BinaryIO, Iterator, Protocol

from dragonfly2_tpu_torch.utils import dferrors

_CHUNK = 1 << 20


@dataclasses.dataclass(frozen=True)
class URLEntry:
    """One child of a directory-ish URL (pkg/source URLEntry: URL, Name,
    IsDir — consumed by dfget's recursive BFS, client/dfget/dfget.go:352)."""

    url: str
    name: str
    is_dir: bool


class SourceClient(Protocol):
    def content_length(self, url: str, headers: dict | None = None) -> int: ...

    def download(
        self, url: str, headers: dict | None = None, offset: int = 0, length: int = -1
    ) -> Iterator[bytes]: ...

    def list_entries(
        self, url: str, headers: dict | None = None
    ) -> list[URLEntry]: ...


_REGISTRY: dict[str, SourceClient] = {}
_defaults_registered = False
_register_lock = threading.Lock()


def register(scheme: str, client: SourceClient, force: bool = False) -> None:
    if scheme in _REGISTRY and not force:
        raise dferrors.AlreadyExists(f"source scheme {scheme} already registered")
    _REGISTRY[scheme] = client


def client_for(url: str) -> SourceClient:
    _register_defaults()
    scheme = urllib.parse.urlsplit(url).scheme.lower()
    client = _REGISTRY.get(scheme)
    if client is None:
        raise dferrors.InvalidArgument(f"no source client for scheme {scheme!r}")
    return client


def content_length(url: str, headers: dict | None = None) -> int:
    return client_for(url).content_length(url, headers)


def download(
    url: str, headers: dict | None = None, offset: int = 0, length: int = -1
) -> Iterator[bytes]:
    return client_for(url).download(url, headers, offset, length)


def list_entries(url: str, headers: dict | None = None) -> list[URLEntry]:
    """Children of a directory URL (source.List, source_client.go:376)."""
    return client_for(url).list_entries(url, headers)


def supports_range(url: str, headers: dict | None = None) -> bool:
    """Whether ranged reads are honored for this URL. Clients without a
    probe are assumed range-capable (file://, object stores)."""
    probe = getattr(client_for(url), "supports_range", None)
    return True if probe is None else probe(url, headers)


# ---------------------------------------------------------------- http(s)


class HTTPSource:
    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    def content_length(self, url: str, headers: dict | None = None) -> int:
        req = urllib.request.Request(url, method="HEAD", headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                cl = resp.headers.get("Content-Length")
                return int(cl) if cl is not None else -1
        except urllib.error.HTTPError as e:
            if e.code == 405:  # no HEAD; unknown length (the reference's
                return -1  # no-content-length fixture exercises this)
            raise dferrors.Unavailable(f"HEAD {url}: {e}") from e
        except urllib.error.URLError as e:
            raise dferrors.Unavailable(f"HEAD {url}: {e}") from e

    def download(
        self, url: str, headers: dict | None = None, offset: int = 0, length: int = -1
    ) -> Iterator[bytes]:
        h = dict(headers or {})
        if offset or length > 0:
            end = f"{offset + length - 1}" if length > 0 else ""
            h["Range"] = f"bytes={offset}-{end}"
        req = urllib.request.Request(url, headers=h)
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.URLError as e:
            raise dferrors.Unavailable(f"GET {url}: {e}") from e
        with resp:
            if "Range" in h and getattr(resp, "status", 200) == 200:
                # The server ignored the Range header and returned the whole
                # entity (python -m http.server, some CDNs): emulate the
                # range by discarding `offset` bytes before yielding.
                # Returning the body as-is would write piece N's buffer
                # starting with the FILE's first bytes — silent corruption.
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


    def supports_range(self, url: str, headers: dict | None = None) -> bool:
        """Probe with `Range: bytes=0-0`: a range-capable server answers
        206, one that ignores Range answers 200 with the full entity (the
        connection is dropped after the status line, so the probe costs a
        round trip, not a download). Lets the piece manager pick parallel
        ranged fetches vs sequential streaming up front — emulating ranges
        per concurrent worker would re-download the file head once per
        piece."""
        h = dict(headers or {})
        h["Range"] = "bytes=0-0"
        req = urllib.request.Request(url, headers=h)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return getattr(resp, "status", 200) == 206
        except urllib.error.HTTPError as e:
            return e.code == 206
        except urllib.error.URLError as e:
            raise dferrors.Unavailable(f"GET {url}: {e}") from e

    def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        """Parse an HTML directory index (nginx/apache autoindex, python
        http.server): every <a href> resolving to a strict child of the
        directory URL becomes an entry; a trailing slash marks a dir."""
        base = url if url.endswith("/") else url + "/"
        req = urllib.request.Request(base, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = resp.read(4 << 20).decode("utf-8", "replace")
        except urllib.error.URLError as e:
            raise dferrors.Unavailable(f"LIST {base}: {e}") from e

        parser = _HrefParser()
        parser.feed(body)
        entries: list[URLEntry] = []
        seen: set[str] = set()
        for href in parser.hrefs:
            if href.startswith(("?", "#")):
                continue
            resolved = urllib.parse.urljoin(base, href)
            resolved, _frag = urllib.parse.urldefrag(resolved)
            if not resolved.startswith(base) or resolved == base:
                continue  # parent links, absolute escapes, self
            rel = resolved[len(base):]
            is_dir = rel.endswith("/")
            name = urllib.parse.unquote(rel.rstrip("/"))
            if "/" in name or name in ("", ".", ".."):
                # only direct children; a percent-encoded '..' or '/' in the
                # decoded name would let a hostile index escape the tree
                continue
            if resolved in seen:
                continue
            seen.add(resolved)
            entries.append(URLEntry(url=resolved, name=name, is_dir=is_dir))
        return entries


class _HrefParser(html.parser.HTMLParser):
    def __init__(self):
        super().__init__()
        self.hrefs: list[str] = []

    def handle_starttag(self, tag, attrs):
        if tag == "a":
            for key, value in attrs:
                if key == "href" and value:
                    self.hrefs.append(value)


# ------------------------------------------------------------------ file


class FileSource:
    def _path(self, url: str) -> pathlib.Path:
        parts = urllib.parse.urlsplit(url)
        return pathlib.Path(urllib.parse.unquote(parts.path))

    def content_length(self, url: str, headers: dict | None = None) -> int:
        path = self._path(url)
        if not path.is_file():
            raise dferrors.NotFound(f"{path} does not exist")
        return path.stat().st_size

    def download(
        self, url: str, headers: dict | None = None, offset: int = 0, length: int = -1
    ) -> Iterator[bytes]:
        path = self._path(url)
        if not path.is_file():
            raise dferrors.NotFound(f"{path} does not exist")
        with open(path, "rb") as f:
            f.seek(offset)
            remaining = length if length > 0 else -1
            while True:
                chunk = f.read(_CHUNK if remaining < 0 else min(_CHUNK, remaining))
                if not chunk:
                    return
                yield chunk
                if remaining > 0:
                    remaining -= len(chunk)
                    if remaining <= 0:
                        return

    def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        path = self._path(url)
        if not path.is_dir():
            raise dferrors.NotFound(f"{path} is not a directory")
        base = url if url.endswith("/") else url + "/"
        entries = []
        for child in sorted(path.iterdir()):
            is_dir = child.is_dir()
            if is_dir and child.is_symlink():
                # Never descend into directory symlinks (same stance as Go's
                # filepath.Walk): a link to an ancestor makes every BFS hop a
                # new, strictly longer URL, so visited-dedup alone can't
                # terminate the walk.
                continue
            entries.append(
                URLEntry(
                    url=base + urllib.parse.quote(child.name) + ("/" if is_dir else ""),
                    name=child.name,
                    is_dir=is_dir,
                )
            )
        return entries


def _register_defaults() -> None:
    """Populate the registry on first lookup, not at import time: the
    object-store / hdfs / oras clients in object_sources.py import THIS
    module for URLEntry, so an import-time registration would touch
    object_sources while it is still half-initialized whenever a user
    imports object_sources first (circular-import crash). Guarded by a
    lock with the flag set LAST: concurrent first lookups (two conductors
    probing content-length on to_thread workers) must not observe a
    half-populated registry."""
    global _defaults_registered
    if _defaults_registered:
        return
    with _register_lock:
        if _defaults_registered:
            return
        _do_register_defaults()
        _defaults_registered = True


def _do_register_defaults() -> None:
    from dragonfly2_tpu_torch.client import object_sources

    for scheme in ("http", "https"):
        if scheme not in _REGISTRY:
            register(scheme, HTTPSource())
    if "file" not in _REGISTRY:
        register("file", FileSource())
    for scheme in ("s3", "oss", "obs"):
        if scheme not in _REGISTRY:
            register(scheme, object_sources.ObjectStoreSource(scheme))
    if "hdfs" not in _REGISTRY:
        register("hdfs", object_sources.HdfsSource())
    if "oras" not in _REGISTRY:
        register("oras", object_sources.OrasSource())
