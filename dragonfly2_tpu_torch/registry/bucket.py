"""Object-storage-backed model registry.

Capability parity with the reference's CreateModel upload path
(manager/rpcserver/manager_server_v1.go:880-952: model bytes -> an
object-storage bucket; metadata keys laid out per
manager/types/model.go:66-75 ``<id>/<version>/model.graphdef`` +
``<id>/config.pbtxt``): a trainer on host A publishes a version, a
scheduler on host B serves it, and the ONLY thing they share is the
bucket — no common filesystem (the round-3 gap: registry/registry.py is
a local directory).

Speaks the backend protocol from objectstorage/backends.py, so the same
registry runs over the local FilesystemBackend or any signed
S3/OSS/OBS-compatible endpoint (objectstorage/remote.py + signing.py).
Params travel as one msgpack object (flax.serialization — a pytree of
numpy arrays), not an orbax directory tree: a bucket stores blobs, and
one PUT/GET per version keeps publish/fetch atomic per object.

Key layout under an optional prefix:
    <model_id>/model.json             active-version pointer (+ name/type)
    <model_id>/<version>/version.json   metadata + evaluation
    <model_id>/<version>/params.msgpack trained params
    <model_id>/<version>/params.sha256  integrity manifest: sha256 + size
                                        of params.msgpack, written by the
                                        publisher and verified by every
                                        load_params — a torn or bit-rotted
                                        blob raises DataLoss instead of
                                        activating into serving

Port of dragonfly2_tpu/registry/bucket.py with the same blob layout.
Params are encoded and decoded by utils/flax_msgpack.py, byte for byte the
layout flax.serialization writes, so a version published by either package
loads in the other. `open_registry` opens a ``<vendor>://bucket/prefix?endpoint=...``
URL (s3, oss, obs over the signed remote backend, or ``fs://`` with
``base_dir``) here and a plain path as the filesystem ``ModelRegistry``
(registry/registry.py: this registry over the filesystem backend, params
in this layout, not orbax's), so every ``--registry-dir`` flag accepts
either.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.parse
from typing import Any

from dragonfly2_tpu_torch.objectstorage.backends import new_backend
from dragonfly2_tpu_torch.registry.registry import (
    MODEL_TYPE_ATTENTION,
    MODEL_TYPE_GNN,
    MODEL_TYPE_MLP,
    STATE_ACTIVE,
    STATE_BAD,
    STATE_INACTIVE,
    ModelEvaluation,
    ModelVersion,
    _version_from_json,
)
from dragonfly2_tpu_torch.utils import dferrors, flax_msgpack
from dragonfly2_tpu_torch.utils.digest import sha256_from_bytes
from dragonfly2_tpu_torch.utils.idgen import model_id as make_model_id


class BucketModelRegistry:
    """The reference registry's public surface, stored in an object bucket."""

    def __init__(self, backend, bucket: str, prefix: str = ""):
        self.backend = backend
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        if not backend.is_bucket_exist(bucket):
            backend.create_bucket(bucket)

    def _key(self, *parts: str) -> str:
        parts = tuple(str(p) for p in parts)
        return "/".join((self.prefix,) + parts if self.prefix else parts)

    def _get_json(self, *parts: str) -> dict | None:
        try:
            return json.loads(self.backend.get_object(self.bucket, self._key(*parts)))
        except Exception:  # noqa: BLE001 - missing object == missing entry
            return None

    def _put_json(self, data: dict, *parts: str) -> None:
        self.backend.put_object(
            self.bucket, self._key(*parts), json.dumps(data, indent=2).encode()
        )

    # -------------------------------------------------------------- write

    def create_model_version(
        self,
        name: str,
        model_type: str,
        scheduler_host_id: str,
        params: Any,
        evaluation: ModelEvaluation,
        metadata: dict | None = None,
    ) -> ModelVersion:
        """CreateModel semantics (manager_server_v1.go:880-952): next
        version number, params + evaluation uploaded, version starts
        inactive. ``params`` is the flax-layout dict tree (numpy or torch
        leaves; models/convert.py builds it from a module)."""
        if model_type not in (MODEL_TYPE_GNN, MODEL_TYPE_MLP, MODEL_TYPE_ATTENTION):
            raise ValueError(f"unknown model type {model_type!r}")
        mid = make_model_id(name, scheduler_host_id)
        # Version allocation is a conditional create (`If-None-Match: *` /
        # O_EXCL): the version.json RESERVES the number before any params
        # bytes move, so two publishers racing on one bucket get distinct
        # versions instead of silently overwriting each other (ADVICE r4
        # medium; the reference serializes this through the manager DB's
        # auto-increment). A reader can briefly see the reserved INACTIVE
        # version before params.msgpack lands; only activate() makes a
        # version servable, and the publisher activates only after this
        # method returns.
        next_version = max(
            (v.version for v in self.list_versions(mid)), default=0
        ) + 1
        while True:
            mv = ModelVersion(
                model_id=mid,
                name=name,
                type=model_type,
                version=next_version,
                state=STATE_INACTIVE,
                evaluation=evaluation,
                scheduler_host_id=scheduler_host_id,
                created_at=time.time(),
                metadata=metadata or {},
            )
            reserved = self.backend.put_object_if_absent(
                self.bucket,
                self._key(mid, next_version, "version.json"),
                json.dumps(dataclasses.asdict(mv), indent=2).encode(),
            )
            if reserved:
                break
            next_version += 1
        blob = flax_msgpack.serialize(params)
        self.backend.put_object(
            self.bucket, self._key(mid, next_version, "params.msgpack"), blob
        )
        # Integrity manifest BESIDE the params (pkg/digest discipline on
        # the model plane): load_params re-hashes the blob against this,
        # so a torn PUT, truncated GET, or bit-rotted object raises
        # DataLoss instead of deserializing garbage into serving.
        self._put_json(
            {"sha256": sha256_from_bytes(blob), "size": len(blob)},
            mid, next_version, "params.sha256",
        )
        self.backend.put_object_if_absent(
            self.bucket,
            self._key(mid, "model.json"),
            json.dumps(
                {"model_id": mid, "name": name, "type": model_type,
                 "active_version": None},
            ).encode(),
        )
        return mv

    def activate(self, model_id: str, version: int) -> None:
        """Flip the active pointer (manager/service/model.go:109-151).

        The manifest's ``active_version`` pointer is the AUTHORITATIVE
        record — active_version() reads only it — and it is flipped first
        in a single PUT, so a crash mid-activate leaves serving consistent
        and only the denormalized per-version ``state`` fields stale (the
        next activate repairs them). Concurrent activates of the SAME
        model_id are last-writer-wins on the pointer: model_id embeds the
        scheduler_host_id, so each model has exactly one natural activator
        (its owning scheduler's trainer) and the reference's DB
        transaction is not re-created here."""
        vdata = self._get_json(model_id, version, "version.json")
        if vdata is None:
            raise FileNotFoundError(f"{model_id} v{version} not found")
        if vdata.get("state") == STATE_BAD:
            raise ValueError(
                f"{model_id} v{version} is marked bad (failed an integrity "
                "or activation gate); publish a new version instead"
            )
        # A publisher that died between reserving version.json and
        # uploading params leaves a permanently-visible params-less
        # version; activating it would make load_params fail at SERVING
        # time, so the gap is checked here instead.
        if not self.backend.is_object_exist(
            self.bucket, self._key(model_id, version, "params.msgpack")
        ):
            raise FileNotFoundError(
                f"{model_id} v{version} has no params uploaded "
                "(publisher died mid-publish?)"
            )
        manifest = self._get_json(model_id, "model.json") or {}
        manifest["active_version"] = version
        self._put_json(manifest, model_id, "model.json")
        for v in self.list_versions(model_id):
            if v.state == STATE_BAD:
                continue  # bad stays bad; never resurrected to inactive
            state = STATE_ACTIVE if v.version == version else STATE_INACTIVE
            if v.state != state:
                data = self._get_json(model_id, v.version, "version.json")
                data["state"] = state
                self._put_json(data, model_id, v.version, "version.json")

    def mark_version_bad(self, model_id: str, version: int, reason: str = "") -> None:
        """ModelRegistry.mark_version_bad over the bucket layout: flag the
        version, and if it was active fall the pointer back to the newest
        remaining good version (serving recovers to last-good)."""
        data = self._get_json(model_id, version, "version.json")
        if data is None:
            return
        data["state"] = STATE_BAD
        data.setdefault("metadata", {})["bad_reason"] = reason
        self._put_json(data, model_id, version, "version.json")
        manifest = self._get_json(model_id, "model.json")
        if not manifest or manifest.get("active_version") != version:
            return
        # fallback must be LOADABLE, not merely not-bad: a publisher that
        # died before uploading params leaves a params-less version that
        # activate() refuses — falling back onto it would wedge every
        # subsequent refresh on a not-found instead of recovering
        good = [
            v for v in self.list_versions(model_id)
            if v.state != STATE_BAD and self.backend.is_object_exist(
                self.bucket, self._key(model_id, v.version, "params.msgpack")
            )
        ]
        fallback = good[-1].version if good else None
        if fallback is not None:
            vdata = self._get_json(model_id, fallback, "version.json")
            vdata["state"] = STATE_ACTIVE
            self._put_json(vdata, model_id, fallback, "version.json")
        manifest["active_version"] = fallback
        self._put_json(manifest, model_id, "model.json")

    def delete_version(self, model_id: str, version: int) -> None:
        if self._get_json(model_id, version, "version.json") is None:
            return
        manifest = self._get_json(model_id, "model.json")
        if manifest and manifest.get("active_version") == version:
            raise ValueError("cannot delete the active version")
        for leaf in ("version.json", "params.msgpack"):
            self.backend.delete_object(self.bucket, self._key(model_id, version, leaf))

    # --------------------------------------------------------------- read

    def list_models(self) -> list[dict]:
        out = []
        for meta in self.backend.get_object_metadatas(self.bucket, prefix=self.prefix):
            if meta.key.endswith("/model.json"):
                out.append(json.loads(self.backend.get_object(self.bucket, meta.key)))
        return sorted(out, key=lambda m: m["model_id"])

    def list_versions(self, model_id: str) -> list[ModelVersion]:
        prefix = self._key(model_id) + "/"
        out = []
        for meta in self.backend.get_object_metadatas(self.bucket, prefix=prefix):
            if meta.key.endswith("/version.json"):
                out.append(
                    _version_from_json(
                        json.loads(self.backend.get_object(self.bucket, meta.key))
                    )
                )
        return sorted(out, key=lambda v: v.version)

    def active_version(self, model_id: str) -> ModelVersion | None:
        manifest = self._get_json(model_id, "model.json")
        if not manifest or manifest.get("active_version") is None:
            return None
        data = self._get_json(model_id, manifest["active_version"], "version.json")
        return _version_from_json(data) if data else None

    def load_params(self, model_id: str, version: int, template: Any = None) -> Any:
        """One GET; numpy leaves in the flax dict layout (the caller moves
        them to its device). A ``template`` tree must have the same keys
        and leaf shapes as the stored one, as flax's from_bytes demands."""
        blob = self.backend.get_object(
            self.bucket, self._key(model_id, version, "params.msgpack")
        )
        manifest = self._get_json(model_id, version, "params.sha256")
        if manifest:
            # Verify BEFORE deserializing: flax/msgpack would happily
            # restore a truncated blob into a params tree missing leaves,
            # and nothing downstream re-checks byte integrity.
            if len(blob) != manifest.get("size", len(blob)):
                raise dferrors.DataLoss(
                    f"{model_id} v{version}: params.msgpack is {len(blob)} "
                    f"bytes, manifest says {manifest['size']} (torn write?)"
                )
            actual = sha256_from_bytes(blob)
            if actual != manifest.get("sha256"):
                raise dferrors.DataLoss(
                    f"{model_id} v{version}: params sha256 {actual} != "
                    f"manifest {manifest['sha256']} (bit rot or tamper)"
                )
        tree = flax_msgpack.restore(blob)
        if template is not None:
            _check_against_template(template, tree)
        return tree

    def model_id(self, name: str, scheduler_host_id: str) -> str:
        return make_model_id(name, scheduler_host_id)


def _check_against_template(template: Any, tree: Any, path: str = "") -> None:
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(map(str, template)) != set(tree):
            raise ValueError(f"params at {path or '/'} do not match the template's keys")
        for key, sub in template.items():
            _check_against_template(sub, tree[str(key)], f"{path}/{key}")
    elif tuple(getattr(template, "shape", ())) != tuple(getattr(tree, "shape", ())):
        raise ValueError(
            f"params leaf {path} has shape {getattr(tree, 'shape', None)}, "
            f"template {tuple(template.shape)}"
        )


def open_registry(spec) -> BucketModelRegistry:
    """Dispatch a --registry-dir value: a plain path opens the filesystem
    ``ModelRegistry`` (registry/registry.py; params in the bucket layout);
    a ``s3://bucket/prefix?endpoint=H:P&access_key=AK&secret_key=SK
    [&region=R][&virtual_hosted=1]`` (or oss://, obs://) URL opens the
    bucket registry over the signed remote backend;
    ``fs://bucket/prefix?base_dir=DIR`` uses the filesystem backend through
    the same blob layout."""
    spec = str(spec)
    if "://" not in spec:
        from dragonfly2_tpu_torch.registry.registry import ModelRegistry

        return ModelRegistry(spec)
    u = urllib.parse.urlsplit(spec)
    q = {k: v[-1] for k, v in urllib.parse.parse_qs(u.query).items()}
    bucket = u.netloc
    prefix = u.path.strip("/")
    if u.scheme == "fs":
        backend = new_backend("fs", base_dir=q.get("base_dir", "."))
    else:
        backend = new_backend(
            u.scheme,
            endpoint=q.get("endpoint", ""),
            access_key=q.get("access_key", ""),
            secret_key=q.get("secret_key", ""),
            region=q.get("region", ""),
            virtual_hosted=q.get("virtual_hosted", "") in ("1", "true"),
        )
    return BucketModelRegistry(backend, bucket, prefix)
