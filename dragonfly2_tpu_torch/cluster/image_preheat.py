"""Container-image preheat: registry manifest walk -> layer blob URLs.

Port of dragonfly2_tpu/cluster/image_preheat.py, whole.

Capability parity with the manager's image-type preheat
(manager/job/preheat.go:168-286): a preheat URL shaped
like `https://registry/v2/<repo>/manifests/<tag>` is resolved against the
OCI distribution API — bearer token challenge (with optional basic-auth
credentials), manifest GET with the full Accept media-type set, manifest
*lists/indexes* filtered by platform (os+architecture, preheat.go:283-295)
and recursed by digest, and every referenced blob (config + layers,
preheat.go:297-315 m.References()) turned into a `/v2/<repo>/blobs/<digest>`
URL carrying the Authorization token — which the preheat job then fans out
to seed daemons like any other file.

The token-challenge machinery is shared with the oras back-source client
(client/object_sources.py fetch_bearer_token) — same protocol, one
implementation.
"""

from __future__ import annotations

import dataclasses
import json
import re
import urllib.error
import urllib.request

from dragonfly2_tpu_torch.client.object_sources import fetch_bearer_token
from dragonfly2_tpu_torch.utils import dferrors

# preheat.go:69 accessURLPattern
MANIFEST_URL_RE = re.compile(r"^(.+?)://(.+?)/v2/(.+)/manifests/([^/]+)$")

# distribution.ManifestMediaTypes() equivalent (preheat.go:231-234)
MANIFEST_ACCEPT = ", ".join(
    (
        "application/vnd.docker.distribution.manifest.v2+json",
        "application/vnd.docker.distribution.manifest.list.v2+json",
        "application/vnd.oci.image.manifest.v1+json",
        "application/vnd.oci.image.index.v1+json",
        "application/vnd.docker.distribution.manifest.v1+prettyjws",
        "application/vnd.docker.distribution.manifest.v1+json",
    )
)

_LIST_MEDIA_TYPES = (
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.index.v1+json",
)

# A manifest list referring to another list is malformed; one level of
# recursion (list -> per-platform manifests) is all the spec allows, the
# bound just hardens against a hostile registry.
_MAX_WALK_DEPTH = 3

DEFAULT_PLATFORM = "linux/amd64"


@dataclasses.dataclass
class LayerPreheat:
    """One blob to warm: URL + the auth headers the seed daemon needs."""

    url: str
    digest: str
    headers: dict


def is_image_url(url: str) -> bool:
    return MANIFEST_URL_RE.match(url) is not None


def _parse_platform(platform: str) -> tuple[str, str]:
    os_name, _, arch = (platform or DEFAULT_PLATFORM).partition("/")
    return os_name, arch


def _matches_platform(entry: dict, want_os: str, want_arch: str) -> bool:
    plat = entry.get("platform") or {}
    return plat.get("os") == want_os and plat.get("architecture") == want_arch


class ImageResolver:
    """Walks one image reference to its blob list. Stateless between
    calls except the bearer token, which is reused across the manifest
    list -> per-platform manifest -> (caller's) blob requests."""

    def __init__(
        self,
        username: str = "",
        password: str = "",
        timeout: float = 30.0,
        extra_headers: dict | None = None,
    ):
        self.basic_auth = f"{username}:{password}" if username or password else None
        self.timeout = timeout
        self.extra_headers = dict(extra_headers or {})
        self.token: str | None = None

    def _get_json(self, url: str, accept: str) -> dict:
        headers = dict(self.extra_headers)
        headers["Accept"] = accept
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(url, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code != 401 or self.token:
                raise
            challenge = e.headers.get("WWW-Authenticate", "")
            token = fetch_bearer_token(
                challenge, basic_auth=self.basic_auth, timeout=self.timeout
            )
            if token is None:
                raise dferrors.PermissionDenied(
                    f"image preheat: unauthorized for {url}"
                ) from e
            self.token = token
            headers["Authorization"] = f"Bearer {token}"
            with urllib.request.urlopen(
                urllib.request.Request(url, headers=headers), timeout=self.timeout
            ) as resp:
                return json.loads(resp.read())

    def resolve(self, url: str, platform: str = "") -> list[LayerPreheat]:
        m = MANIFEST_URL_RE.match(url)
        if m is None:
            raise dferrors.InvalidArgument(
                f"image preheat url must match .../v2/<repo>/manifests/<tag>: {url!r}"
            )
        scheme, host, repo, tag = m.groups()
        want_os, want_arch = _parse_platform(platform)
        digests: list[str] = []
        seen: set[str] = set()

        def walk(reference: str, depth: int) -> None:
            if depth > _MAX_WALK_DEPTH:
                raise dferrors.InvalidArgument(
                    f"image preheat: manifest list nesting exceeds {_MAX_WALK_DEPTH}"
                )
            manifest_url = f"{scheme}://{host}/v2/{repo}/manifests/{reference}"
            try:
                manifest = self._get_json(manifest_url, MANIFEST_ACCEPT)
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    raise dferrors.NotFound(
                        f"image preheat: no manifest {repo}:{reference}"
                    ) from e
                raise dferrors.Unavailable(
                    f"image preheat manifest {repo}:{reference}: {e}"
                ) from e
            except urllib.error.URLError as e:
                raise dferrors.Unavailable(
                    f"image preheat manifest {repo}:{reference}: {e}"
                ) from e
            media_type = manifest.get("mediaType", "")
            if media_type in _LIST_MEDIA_TYPES or (
                not media_type and "manifests" in manifest
            ):
                entries = [
                    e
                    for e in manifest.get("manifests", [])
                    if _matches_platform(e, want_os, want_arch)
                ]
                if not entries:
                    raise dferrors.NotFound(
                        f"image preheat: no matching manifest for platform "
                        f"{want_os}/{want_arch} in {repo}:{reference}"
                    )
                for entry in entries:
                    walk(entry["digest"], depth + 1)
                return
            # schema1: fsLayers[].blobSum; schema2/OCI: config + layers
            # (m.References() includes the config blob, preheat.go:299)
            refs = [
                d["blobSum"] for d in manifest.get("fsLayers", []) if "blobSum" in d
            ]
            config = manifest.get("config") or {}
            if config.get("digest"):
                refs.append(config["digest"])
            refs.extend(
                layer["digest"]
                for layer in manifest.get("layers", [])
                if "digest" in layer
            )
            if not refs:
                raise dferrors.NotFound(
                    f"image preheat: manifest {repo}:{reference} references no blobs"
                )
            for digest in refs:
                if digest not in seen:
                    seen.add(digest)
                    digests.append(digest)

        walk(tag, 0)
        headers = dict(self.extra_headers)
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        return [
            LayerPreheat(
                url=f"{scheme}://{host}/v2/{repo}/blobs/{digest}",
                digest=digest,
                headers=headers,
            )
            for digest in digests
        ]


def resolve_image_layers(
    url: str,
    username: str = "",
    password: str = "",
    platform: str = "",
    headers: dict | None = None,
    timeout: float = 30.0,
) -> list[LayerPreheat]:
    """One-shot resolve: image manifest URL -> ordered blob list
    (preheat.go:168 getImageLayers)."""
    resolver = ImageResolver(
        username=username, password=password, timeout=timeout, extra_headers=headers
    )
    return resolver.resolve(url, platform=platform)
