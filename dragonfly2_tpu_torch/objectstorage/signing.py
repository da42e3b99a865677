"""Request signing for the cloud object-storage dialects.

Capability parity with the reference's vendored SDK auth (pkg/objectstorage
newS3/newOSS/newOBS, objectstorage.go:205-212 — there the AWS/Aliyun/Huawei
SDKs sign requests internally). This image has no cloud SDKs, so the
signatures are implemented directly over stdlib hmac/hashlib:

- AWS Signature Version 4 (`sign_v4`, `presign_v4`) — S3 and any
  S3-compatible endpoint (minio, ceph-rgw). Header signing for API calls,
  query signing for GetSignURL parity (objectstorage.go:169 Method +
  expire).
- OSS/OBS header signing (`sign_headerstyle`) — HMAC-SHA1 over the
  canonicalized resource string; Aliyun OSS uses the `OSS ak:sig`
  authorization scheme with `x-oss-*` canonical headers, Huawei OBS the
  `OBS ak:sig` scheme with `x-obs-*` headers (OBS's "Provisional
  authentication" is S3-v2-shaped; both collapse to one routine
  parameterized on prefix).

Everything is deterministic given `now`, so tests verify against servers
that *recompute* the signature with the shared secret rather than just
checking a header exists.

Port of dragonfly2_tpu/objectstorage/signing.py, whole: the same bytes
for the same inputs (tests/test_torch_objectstorage.py holds both).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import urllib.parse

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()

_SIGNED_SUBRESOURCES = frozenset(
    # Query params that are part of the canonicalized resource in the
    # v2-style (OSS/OBS) string-to-sign.
    {
        "acl", "uploads", "uploadId", "partNumber", "location", "logging",
        "website", "lifecycle", "delete", "cors", "restore", "tagging",
        "versioning", "versions", "versionId", "policy", "requestPayment",
        "response-content-type", "response-content-language",
        "response-expires", "response-cache-control",
        "response-content-disposition", "response-content-encoding",
    }
)


def _utcnow(now: datetime.datetime | None) -> datetime.datetime:
    return now if now is not None else datetime.datetime.now(datetime.timezone.utc)


# ------------------------------------------------------------------ SigV4


def _v4_quote(value: str, safe: str = "-_.~") -> str:
    return urllib.parse.quote(value, safe=safe)


def _canonical_query(query: str) -> str:
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    encoded = sorted((_v4_quote(k), _v4_quote(v)) for k, v in pairs)
    return "&".join(f"{k}={v}" for k, v in encoded)


def _signing_key(secret_key: str, date: str, region: str, service: str) -> bytes:
    k = hmac.new(("AWS4" + secret_key).encode(), date.encode(), hashlib.sha256).digest()
    for part in (region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


def _v4_scope(date: str, region: str, service: str) -> str:
    return f"{date}/{region}/{service}/aws4_request"


def sign_v4(
    method: str,
    url: str,
    headers: dict[str, str],
    payload_hash: str,
    access_key: str,
    secret_key: str,
    region: str,
    service: str = "s3",
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """Return `headers` plus Host/x-amz-date/x-amz-content-sha256/
    Authorization for an AWS SigV4 header-signed request."""
    ts = _utcnow(now)
    amz_date = ts.strftime("%Y%m%dT%H%M%SZ")
    date = ts.strftime("%Y%m%d")
    parts = urllib.parse.urlsplit(url)

    out = dict(headers)
    out["Host"] = parts.netloc
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash

    lowered = {k.lower(): " ".join(v.split()) for k, v in out.items()}
    signed_names = ";".join(sorted(lowered))
    canonical_headers = "".join(f"{k}:{lowered[k]}\n" for k in sorted(lowered))
    canonical_request = "\n".join(
        (
            method.upper(),
            # For service=s3 the canonical URI is the path exactly as sent
            # on the wire (already percent-encoded by the caller), NOT
            # re-encoded — re-quoting would turn %20 into %2520 and every
            # real S3-compatible endpoint would answer
            # SignatureDoesNotMatch for keys needing encoding.
            parts.path or "/",
            _canonical_query(parts.query),
            canonical_headers,
            signed_names,
            payload_hash,
        )
    )
    scope = _v4_scope(date, region, service)
    string_to_sign = "\n".join(
        (
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        )
    )
    signature = hmac.new(
        _signing_key(secret_key, date, region, service),
        string_to_sign.encode(),
        hashlib.sha256,
    ).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}"
    )
    return out


def presign_v4(
    method: str,
    url: str,
    access_key: str,
    secret_key: str,
    region: str,
    expires_s: int = 300,
    service: str = "s3",
    now: datetime.datetime | None = None,
) -> str:
    """Query-string presigned URL (GetSignURL parity, objectstorage.go:169:
    the returned URL carries the auth, so plain HTTP clients can use it)."""
    ts = _utcnow(now)
    amz_date = ts.strftime("%Y%m%dT%H%M%SZ")
    date = ts.strftime("%Y%m%d")
    parts = urllib.parse.urlsplit(url)
    scope = _v4_scope(date, region, service)

    query = urllib.parse.parse_qsl(parts.query, keep_blank_values=True)
    query += [
        ("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
        ("X-Amz-Credential", f"{access_key}/{scope}"),
        ("X-Amz-Date", amz_date),
        ("X-Amz-Expires", str(int(expires_s))),
        ("X-Amz-SignedHeaders", "host"),
    ]
    canonical_query = "&".join(
        f"{k}={v}"
        for k, v in sorted((_v4_quote(k), _v4_quote(v)) for k, v in query)
    )
    canonical_request = "\n".join(
        (
            method.upper(),
            parts.path or "/",  # as-sent, single-encoded (see sign_v4)
            canonical_query,
            f"host:{parts.netloc}\n",
            "host",
            "UNSIGNED-PAYLOAD",
        )
    )
    string_to_sign = "\n".join(
        (
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        )
    )
    signature = hmac.new(
        _signing_key(secret_key, date, region, service),
        string_to_sign.encode(),
        hashlib.sha256,
    ).hexdigest()
    final_query = canonical_query + "&X-Amz-Signature=" + signature
    return urllib.parse.urlunsplit(
        (parts.scheme, parts.netloc, parts.path, final_query, "")
    )


# ------------------------------------------------------- OSS / OBS (v2ish)


def sign_headerstyle(
    method: str,
    bucket: str,
    key: str,
    headers: dict[str, str],
    access_key: str,
    secret_key: str,
    *,
    scheme: str = "OSS",
    query: str = "",
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """HMAC-SHA1 header signing shared by Aliyun OSS (`OSS ak:sig`,
    x-oss-*) and Huawei OBS (`OBS ak:sig`, x-obs-*)."""
    vendor_prefix = f"x-{scheme.lower()}-"
    out = dict(headers)
    out["Date"] = _utcnow(now).strftime("%a, %d %b %Y %H:%M:%S GMT")

    lowered = {k.lower(): v.strip() for k, v in out.items()}
    canon_vendor = "".join(
        f"{k}:{lowered[k]}\n" for k in sorted(lowered) if k.startswith(vendor_prefix)
    )
    resource = f"/{bucket}/{key}" if key else (f"/{bucket}/" if bucket else "/")
    signed_sub = sorted(
        (k, v)
        for k, v in urllib.parse.parse_qsl(query, keep_blank_values=True)
        if k in _SIGNED_SUBRESOURCES
    )
    if signed_sub:
        resource += "?" + "&".join(k if not v else f"{k}={v}" for k, v in signed_sub)
    string_to_sign = "\n".join(
        (
            method.upper(),
            lowered.get("content-md5", ""),
            lowered.get("content-type", ""),
            out["Date"],
            canon_vendor + resource,
        )
    )
    signature = hmac.new(
        secret_key.encode(), string_to_sign.encode(), hashlib.sha1
    ).digest()
    out["Authorization"] = f"{scheme} {access_key}:{base64.b64encode(signature).decode()}"
    return out
