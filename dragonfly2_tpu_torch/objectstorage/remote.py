"""Cloud object-storage backends over raw HTTP (no SDKs).

Capability parity with pkg/objectstorage newS3/newOSS/newOBS
(objectstorage.go:205-212): the same backend protocol `FilesystemBackend`
implements (bucket CRUD, ranged get, put, metadata, prefix list, copy,
delete, presigned URLs), spoken directly to any S3/OSS/OBS-compatible
endpoint with stdlib urllib + the signers in `signing.py`. Path-style
addressing (`endpoint/bucket/key`) so in-proc test servers and minio work
without wildcard DNS; `virtual_hosted=True` switches to
`bucket.endpoint-host/key` for real cloud endpoints.

All three vendors share the request shapes (S3's XML API is the lingua
franca; OSS and OBS both kept it) — only the signing differs, so the
vendor classes are thin shims over `_RemoteBackend`.

Port of dragonfly2_tpu/objectstorage/remote.py, whole; host code, no
torch.
"""

from __future__ import annotations

import base64
import datetime
import email.utils
import hashlib
import hmac
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET

from dragonfly2_tpu_torch.objectstorage.backends import BucketMetadata, ObjectMetadata
from dragonfly2_tpu_torch.objectstorage import signing
from dragonfly2_tpu_torch.utils import dferrors

_TIMEOUT = 30.0


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _parse_time(text: str) -> float:
    """ISO-8601 (list responses) or RFC-1123 (Last-Modified) → epoch;
    0.0 for anything unparseable (a vendor-mangled date must not escape
    the module's dferrors contract and crash the caller)."""
    text = text.strip()
    try:
        return datetime.datetime.fromisoformat(text.replace("Z", "+00:00")).timestamp()
    except ValueError:
        pass
    try:
        return email.utils.parsedate_to_datetime(text).timestamp()
    except (ValueError, TypeError):
        return 0.0


class _RemoteBackend:
    def __init__(
        self,
        endpoint: str,
        access_key: str,
        secret_key: str,
        region: str = "",
        virtual_hosted: bool = False,
        timeout: float = _TIMEOUT,
    ):
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region or "us-east-1"
        self.virtual_hosted = virtual_hosted
        self.timeout = timeout

    # -- vendor hook -------------------------------------------------------
    def _sign(self, method, url, headers, body, bucket, key, query):  # pragma: no cover
        raise NotImplementedError

    def _url(self, bucket: str, key: str = "", query: str = "") -> str:
        if self.virtual_hosted and bucket:
            parts = urllib.parse.urlsplit(self.endpoint)
            base = f"{parts.scheme}://{bucket}.{parts.netloc}"
            path = "/" + urllib.parse.quote(key) if key else "/"
        else:
            base = self.endpoint
            path = "/" + bucket + ("/" + urllib.parse.quote(key) if key else "")
            if not bucket:
                path = "/"
        return base + path + (("?" + query) if query else "")

    def _request(
        self,
        method: str,
        bucket: str = "",
        key: str = "",
        query: str = "",
        headers: dict | None = None,
        body: bytes = b"",
        want_body: bool = True,
        conflict_is_exists: bool = False,
    ):
        url = self._url(bucket, key, query)
        signed = self._sign(method, url, dict(headers or {}), body, bucket, key, query)
        req = urllib.request.Request(url, data=body if body else None, method=method)
        for k, v in signed.items():
            if k.lower() != "host":  # urllib sets Host from the URL
                req.add_header(k, v)
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read(2048).decode("utf-8", "replace")
            except OSError:
                pass
            if e.code == 404:
                raise dferrors.NotFound(f"{method} {bucket}/{key}: {detail or e}") from e
            if e.code in (401, 403):
                raise dferrors.PermissionDenied(
                    f"{method} {bucket}/{key}: {detail or e}"
                ) from e
            if conflict_is_exists and e.code in (409, 412):
                # Only a request that CARRIED a conditional-create header
                # reads conflict as "key exists": 412 PreconditionFailed
                # (S3 If-None-Match), 409 FileAlreadyExists (OSS/OBS
                # forbid-overwrite). An unscoped mapping would turn e.g.
                # 409 BucketNotEmpty on DELETE into a nonsense
                # AlreadyExists.
                raise dferrors.AlreadyExists(
                    f"{method} {bucket}/{key}: {detail or e}"
                ) from e
            raise dferrors.Unavailable(f"{method} {bucket}/{key}: {detail or e}") from e
        except urllib.error.URLError as e:
            raise dferrors.Unavailable(f"{method} {url}: {e}") from e
        with resp:
            data = resp.read() if want_body else b""
            return resp.status, dict(resp.headers), data

    # -- buckets -----------------------------------------------------------
    def create_bucket(self, bucket: str) -> None:
        self._request("PUT", bucket)

    def delete_bucket(self, bucket: str) -> None:
        self._request("DELETE", bucket)

    def is_bucket_exist(self, bucket: str) -> bool:
        try:
            self._request("HEAD", bucket, want_body=False)
            return True
        except dferrors.NotFound:
            return False

    def get_bucket_metadatas(self) -> list[BucketMetadata]:
        _, _, data = self._request("GET")
        root = ET.fromstring(data)
        out = []
        for el in root.iter():
            if _strip_ns(el.tag) == "Bucket":
                name = created = None
                for child in el:
                    if _strip_ns(child.tag) == "Name":
                        name = child.text or ""
                    elif _strip_ns(child.tag) == "CreationDate":
                        created = _parse_time(child.text or "")
                if name:
                    out.append(BucketMetadata(name=name, created_at=created or 0.0))
        return out

    # -- objects -----------------------------------------------------------
    def put_object(self, bucket: str, key: str, data: bytes) -> ObjectMetadata:
        _, headers, _ = self._request("PUT", bucket, key, body=data)
        return ObjectMetadata(
            key=key,
            content_length=len(data),
            etag=headers.get("ETag", "").strip('"'),
            last_modified_at=0.0,
        )

    # header carrying the create-if-absent condition; vendor-specific
    # (S3: If-None-Match per the 2024 conditional-write API; OSS/OBS
    # ignore If-None-Match on PUT and use their forbid-overwrite headers,
    # answering 409 FileAlreadyExists)
    _conditional_create_header = ("If-None-Match", "*")

    def put_object_if_absent(self, bucket: str, key: str, data: bytes) -> bool:
        """Conditional create: the PUT carries the vendor's create-if-
        absent header; an existing key answers 412 (S3) / 409 (OSS/OBS),
        both mapped to AlreadyExists."""
        name, value = self._conditional_create_header
        try:
            self._request(
                "PUT", bucket, key, headers={name: value}, body=data,
                conflict_is_exists=True,
            )
        except dferrors.AlreadyExists:
            return False
        return True

    def get_object(
        self, bucket: str, key: str, range_: tuple[int, int] | None = None
    ) -> bytes:
        headers = {}
        if range_ is not None:
            headers["Range"] = f"bytes={range_[0]}-{range_[1]}"
        _, _, data = self._request("GET", bucket, key, headers=headers)
        return data

    def get_object_metadata(self, bucket: str, key: str) -> ObjectMetadata:
        _, headers, _ = self._request("HEAD", bucket, key, want_body=False)
        lm = headers.get("Last-Modified", "")
        return ObjectMetadata(
            key=key,
            content_length=int(headers.get("Content-Length", 0)),
            etag=headers.get("ETag", "").strip('"'),
            last_modified_at=_parse_time(lm) if lm else 0.0,
            content_type=headers.get("Content-Type", ""),
        )

    def get_object_metadatas(
        self, bucket: str, prefix: str = "", limit: int = 0
    ) -> list[ObjectMetadata]:
        """List objects under `prefix`, following IsTruncated /
        NextContinuationToken pages until `limit` keys (0 = unbounded) —
        a single un-paged request silently caps at the server's 1000-key
        page and a recursive download would miss everything past it."""
        out: list[ObjectMetadata] = []
        token = ""
        while True:
            page = 1000 if limit <= 0 else min(1000, limit - len(out))
            params = {"list-type": "2", "prefix": prefix, "max-keys": str(page)}
            if token:
                params["continuation-token"] = token
            _, _, data = self._request(
                "GET", bucket, query=urllib.parse.urlencode(params)
            )
            root = ET.fromstring(data)
            truncated, token = False, ""
            for el in root.iter():
                tag = _strip_ns(el.tag)
                if tag == "IsTruncated":
                    truncated = (el.text or "").strip().lower() == "true"
                elif tag == "NextContinuationToken":
                    token = (el.text or "").strip()
                elif tag == "Contents":
                    meta = {}
                    for child in el:
                        meta[_strip_ns(child.tag)] = child.text or ""
                    out.append(
                        ObjectMetadata(
                            key=meta.get("Key", ""),
                            content_length=int(meta.get("Size", 0) or 0),
                            etag=meta.get("ETag", "").strip('"'),
                            last_modified_at=(
                                _parse_time(meta["LastModified"])
                                if meta.get("LastModified")
                                else 0.0
                            ),
                            storage_class=meta.get("StorageClass", ""),
                        )
                    )
            if not truncated or not token or (limit > 0 and len(out) >= limit):
                return out[:limit] if limit > 0 else out

    def is_object_exist(self, bucket: str, key: str) -> bool:
        try:
            self.get_object_metadata(bucket, key)
            return True
        except dferrors.NotFound:
            return False

    def copy_object(self, bucket: str, src_key: str, dst_key: str) -> ObjectMetadata:
        # servers URL-decode the copy-source header, so the source key
        # must be percent-encoded like the request path ('a+b.txt' sent
        # raw would be decoded to 'a b.txt' -> NoSuchKey)
        src = f"/{bucket}/" + urllib.parse.quote(src_key)
        self._request(
            "PUT", bucket, dst_key, headers={self._copy_source_header(): src}
        )
        return self.get_object_metadata(bucket, dst_key)

    def delete_object(self, bucket: str, key: str) -> None:
        self._request("DELETE", bucket, key)

    def _copy_source_header(self) -> str:
        return "x-amz-copy-source"


class S3Backend(_RemoteBackend):
    """AWS SigV4 (header signing; query signing for get_sign_url)."""

    def _sign(self, method, url, headers, body, bucket, key, query):
        payload_hash = hashlib.sha256(body or b"").hexdigest()
        return signing.sign_v4(
            method,
            url,
            headers,
            payload_hash,
            self.access_key,
            self.secret_key,
            self.region,
        )

    def get_sign_url(
        self, bucket: str, key: str, method: str = "GET", expire: float = 300.0
    ) -> str:
        return signing.presign_v4(
            method,
            self._url(bucket, key),
            self.access_key,
            self.secret_key,
            self.region,
            int(expire),
        )


class _HeaderStyleBackend(_RemoteBackend):
    _scheme = "OSS"

    def _sign(self, method, url, headers, body, bucket, key, query):
        if body:
            headers["Content-MD5"] = base64.b64encode(
                hashlib.md5(body).digest()
            ).decode()
            # Sign an explicit type: urllib would otherwise add its own
            # Content-Type to the wire request, and Content-Type is part of
            # the OSS/OBS string-to-sign — the server-side recompute would
            # see a header the signature never covered.
            headers.setdefault("Content-Type", "application/octet-stream")
        return signing.sign_headerstyle(
            method,
            bucket,
            key,
            headers,
            self.access_key,
            self.secret_key,
            scheme=self._scheme,
            query=query,
        )

    def get_sign_url(
        self, bucket: str, key: str, method: str = "GET", expire: float = 300.0
    ) -> str:
        # OSS/OBS presigned form: Expires + Signature query params over the
        # same string-to-sign with Date replaced by the expiry epoch.
        expires = str(int(time.time() + expire))
        resource = f"/{bucket}/{key}"
        string_to_sign = f"{method.upper()}\n\n\n{expires}\n{resource}"
        sig = base64.b64encode(
            hmac.new(
                self.secret_key.encode(), string_to_sign.encode(), hashlib.sha1
            ).digest()
        ).decode()
        # Aliyun names the query param OSSAccessKeyId; Huawei OBS keeps
        # plain AccessKeyId for its temporary-URL auth.
        ak_param = "OSSAccessKeyId" if self._scheme == "OSS" else "AccessKeyId"
        query = urllib.parse.urlencode(
            {ak_param: self.access_key, "Expires": expires, "Signature": sig}
        )
        return self._url(bucket, key) + "?" + query


class OSSBackend(_HeaderStyleBackend):
    _scheme = "OSS"
    _conditional_create_header = ("x-oss-forbid-overwrite", "true")

    def _copy_source_header(self) -> str:
        return "x-oss-copy-source"


class OBSBackend(_HeaderStyleBackend):
    _scheme = "OBS"
    _conditional_create_header = ("x-obs-forbid-overwrite", "true")

    def _copy_source_header(self) -> str:
        return "x-obs-copy-source"


_VENDOR_CLASSES = {"s3": S3Backend, "oss": OSSBackend, "obs": OBSBackend}


def new_remote_backend(name: str, **options):
    """Vendor dispatch for the cloud backends (objectstorage.go:205-212).
    Required options: endpoint, access_key, secret_key; optional: region,
    virtual_hosted, timeout."""
    cls = _VENDOR_CLASSES.get(name)
    if cls is None:
        raise dferrors.InvalidArgument(f"unknown remote object-storage vendor {name!r}")
    missing = [k for k in ("endpoint", "access_key", "secret_key") if not options.get(k)]
    if missing:
        raise dferrors.InvalidArgument(
            f"object-storage vendor {name!r} needs options {missing}"
        )
    allowed = {"endpoint", "access_key", "secret_key", "region", "virtual_hosted", "timeout"}
    return cls(**{k: v for k, v in options.items() if k in allowed})
