"""Object-storage backends behind one interface.

Port of dragonfly2_tpu/objectstorage/backends.py (capability parity with
pkg/objectstorage/objectstorage.go:206-211 — the ObjectStorage interface:
bucket CRUD, object CRUD, metadata, existence, sign URLs, with per-vendor
constructors). The filesystem backend is the local store (the model
registry's bucket, tests); ``s3``/``oss``/``obs`` speak the vendor HTTP
dialect through objectstorage/remote.py, signed with stdlib hmac.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import shutil

from dragonfly2_tpu_torch.utils import dferrors


@dataclasses.dataclass
class ObjectMetadata:
    """pkg/objectstorage ObjectMetadata: key, size, etag, content type,
    modified time."""

    key: str
    content_length: int
    etag: str = ""
    content_type: str = ""
    last_modified_at: float = 0.0
    storage_class: str = ""


@dataclasses.dataclass
class BucketMetadata:
    name: str
    created_at: float


class FilesystemBackend:
    """Buckets are directories, objects are files; etag is md5 (matching
    S3 single-part semantics the reference relies on for dfstore digests)."""

    name = "fs"

    def __init__(self, base_dir: str | pathlib.Path):
        self.base = pathlib.Path(base_dir).absolute()
        self.base.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------- buckets

    def create_bucket(self, bucket: str) -> None:
        self._bucket_dir(bucket).mkdir(parents=True, exist_ok=True)

    def delete_bucket(self, bucket: str) -> None:
        d = self._bucket_dir(bucket)
        if any(p.is_file() for p in d.rglob("*")):
            raise dferrors.InvalidArgument(f"bucket {bucket} not empty")
        shutil.rmtree(d, ignore_errors=True)

    def is_bucket_exist(self, bucket: str) -> bool:
        return self._bucket_dir(bucket).is_dir()

    def get_bucket_metadatas(self) -> list[BucketMetadata]:
        out = []
        for d in sorted(self.base.iterdir()):
            if d.is_dir():
                out.append(BucketMetadata(name=d.name, created_at=d.stat().st_mtime))
        return out

    # ------------------------------------------------------------- objects

    def put_object(self, bucket: str, key: str, data: bytes) -> ObjectMetadata:
        path = self._object_path(bucket, key)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_bytes(data)
        tmp.replace(path)
        # etag sidecar: listings must not re-hash every object's bytes
        _etag_path(path).write_text(hashlib.md5(data).hexdigest())
        return self.get_object_metadata(bucket, key)

    def put_object_if_absent(self, bucket: str, key: str, data: bytes) -> bool:
        """Atomic create-if-missing (the S3 `If-None-Match: *` conditional
        PUT): returns False, writing nothing, when the key already exists.
        The bytes are staged to a tmp file and os.link'd into place —
        link fails if the target exists (the CAS) and publishes the fully
        written file in one step, so a concurrent reader can never observe
        a half-written object (a direct O_EXCL open would expose empty/
        partial bytes between create and close)."""
        path = self._object_path(bucket, key)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.{id(data):x}.tmp")
        tmp.write_bytes(data)
        try:
            os.link(tmp, path)
        except FileExistsError:
            return False
        finally:
            tmp.unlink(missing_ok=True)
        _etag_path(path).write_text(hashlib.md5(data).hexdigest())
        return True

    def get_object(self, bucket: str, key: str, range_: tuple[int, int] | None = None) -> bytes:
        path = self._object_path(bucket, key)
        if not path.is_file():
            raise dferrors.NotFound(f"object {bucket}/{key} not found")
        data = path.read_bytes()
        if range_ is not None:
            start, end = range_
            data = data[start : end + 1]
        return data

    def get_object_metadata(self, bucket: str, key: str) -> ObjectMetadata:
        path = self._object_path(bucket, key)
        if not path.is_file():
            raise dferrors.NotFound(f"object {bucket}/{key} not found")
        return ObjectMetadata(
            key=key,
            content_length=path.stat().st_size,
            etag=_etag_of(path),
            last_modified_at=path.stat().st_mtime,
        )

    def get_object_metadatas(self, bucket: str, prefix: str = "", limit: int = 1000) -> list[ObjectMetadata]:
        bucket_dir = self._bucket_dir(bucket)
        if not bucket_dir.is_dir():
            raise dferrors.NotFound(f"bucket {bucket} not found")
        out = []
        for path in sorted(bucket_dir.rglob("*")):
            if not path.is_file() or path.name.endswith((".tmp", ".etag")):
                continue
            key = path.relative_to(bucket_dir).as_posix()
            if not key.startswith(prefix):
                continue
            out.append(
                ObjectMetadata(
                    key=key,
                    content_length=path.stat().st_size,
                    etag=_etag_of(path),
                    last_modified_at=path.stat().st_mtime,
                )
            )
            if len(out) >= limit:
                break
        return out

    def is_object_exist(self, bucket: str, key: str) -> bool:
        return self._object_path(bucket, key).is_file()

    def copy_object(self, bucket: str, src_key: str, dst_key: str) -> ObjectMetadata:
        data = self.get_object(bucket, src_key)
        return self.put_object(bucket, dst_key, data)

    def delete_object(self, bucket: str, key: str) -> None:
        path = self._object_path(bucket, key)
        if path.is_file():
            path.unlink()
        _etag_path(path).unlink(missing_ok=True)

    def get_sign_url(self, bucket: str, key: str, method: str = "GET", expire: float = 300.0) -> str:
        """Filesystem 'signed URL': a file:// URL (callers only need a
        fetchable address; the reference returns a presigned vendor URL)."""
        return f"file://{self._object_path(bucket, key)}"

    # ------------------------------------------------------------- helpers

    def _bucket_dir(self, bucket: str) -> pathlib.Path:
        if not bucket or "/" in bucket or bucket.startswith("."):
            raise dferrors.InvalidArgument(f"bad bucket name {bucket!r}")
        return self.base / bucket

    def _object_path(self, bucket: str, key: str) -> pathlib.Path:
        bucket_dir = self._bucket_dir(bucket)
        path = (bucket_dir / key).resolve()
        if not path.is_relative_to(bucket_dir.resolve()):
            raise dferrors.InvalidArgument(f"key escapes bucket: {key!r}")
        return path


def _etag_path(path: pathlib.Path) -> pathlib.Path:
    return path.with_name(path.name + ".etag")


def _etag_of(path: pathlib.Path) -> str:
    """Sidecar-cached md5; recomputed (and re-persisted) only when the
    sidecar is missing or older than the object."""
    side = _etag_path(path)
    try:
        if side.stat().st_mtime >= path.stat().st_mtime:
            return side.read_text().strip()
    except OSError:
        pass
    etag = hashlib.md5(path.read_bytes()).hexdigest()
    try:
        side.write_text(etag)
    except OSError:
        pass
    return etag


_VENDORS = ("s3", "oss", "obs")


def new_backend(name: str, base_dir: str | pathlib.Path | None = None, **options):
    """pkg/objectstorage New(): vendor dispatch (objectstorage.go:205-212).
    `fs` is the local store; `s3`/`oss`/`obs` speak the vendor HTTP dialect
    directly (signed with stdlib hmac — no SDKs) and need endpoint +
    access_key + secret_key options."""
    if name == "fs":
        if base_dir is None:
            raise dferrors.InvalidArgument("fs backend needs base_dir")
        return FilesystemBackend(base_dir)
    if name in _VENDORS:
        if not options.get("endpoint"):
            raise dferrors.Unavailable(
                f"object-storage vendor {name!r} needs endpoint/access_key/"
                "secret_key options (no ambient cloud credentials here)"
            )
        from dragonfly2_tpu_torch.objectstorage.remote import new_remote_backend

        return new_remote_backend(name, **options)
    raise dferrors.InvalidArgument(f"unknown object storage name {name!r}")


def object_task_id(bucket: str, key: str) -> str:
    """Stable task id for sharing an object through the mesh (the
    reference derives urfs task ids from bucket+key, objectstorage.go)."""
    return hashlib.sha256(f"urfs://{bucket}/{key}".encode()).hexdigest()
