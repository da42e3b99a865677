"""ID generation — parity with pkg/idgen (task/peer/host/model IDs).

Reference: pkg/idgen/{task_id.go,peer_id.go,host_id.go}.
Task IDs are sha256 over filtered-url + meta fields; host ID v2 is
sha256(ip, hostname); peer ID v2 is a UUID.
"""

from __future__ import annotations

import os
import uuid
from urllib.parse import parse_qsl, urlencode, urlsplit, urlunsplit

from dragonfly2_tpu_torch.utils.digest import sha256_from_strings

FILTERED_QUERY_PARAMS_SEPARATOR = "&"


def filter_query_params(url: str, filtered: list[str] | None) -> str:
    """Drop the named query params from the url (pkg/net/url semantics).

    Go's url.Values.Encode() emits keys in sorted order (values within a
    key keep insertion order), so the surviving params are sorted by key
    to keep task-id parity with the reference.
    """
    if not filtered:
        return url
    parts = urlsplit(url)
    kept = [(k, v) for k, v in parse_qsl(parts.query, keep_blank_values=True) if k not in set(filtered)]
    kept.sort(key=lambda kv: kv[0])
    return urlunsplit(parts._replace(query=urlencode(kept)))


def task_id_v1(
    url: str,
    digest: str = "",
    tag: str = "",
    application: str = "",
    byte_range: str = "",
    filtered_query_params: str = "",
    ignore_range: bool = False,
) -> str:
    """v1 task id (pkg/idgen/task_id.go:38-84): sha256 of the filtered url
    plus any non-empty meta fields, in digest/range/tag/application order."""
    filters = (
        filtered_query_params.split(FILTERED_QUERY_PARAMS_SEPARATOR)
        if filtered_query_params.strip()
        else None
    )
    try:
        u = filter_query_params(url, filters)
    except ValueError:
        u = ""
    data = [u]
    if digest:
        data.append(digest)
    if not ignore_range and byte_range:
        data.append(byte_range)
    if tag:
        data.append(tag)
    if application:
        data.append(application)
    return sha256_from_strings(*data)


def parent_task_id_v1(url: str, **kwargs) -> str:
    kwargs["ignore_range"] = True
    return task_id_v1(url, **kwargs)


def task_id_v2(
    url: str,
    digest: str = "",
    tag: str = "",
    application: str = "",
    piece_length: int = 0,
    filtered_query_params: list[str] | None = None,
) -> str:
    """v2 task id (task_id.go:96-104): sha256(url, digest, tag, application,
    str(piece_length)) — all fields always included."""
    try:
        u = filter_query_params(url, filtered_query_params)
    except ValueError:
        u = ""
    return sha256_from_strings(u, digest, tag, application, str(piece_length))


def peer_id_v1(ip: str) -> str:
    return f"{ip}-{os.getpid()}-{uuid.uuid4()}"


def seed_peer_id_v1(ip: str) -> str:
    return f"{peer_id_v1(ip)}_Seed"


def peer_id_v2() -> str:
    return str(uuid.uuid4())


def host_id_v1(hostname: str, port: int) -> str:
    return f"{hostname}-{port}"


def host_id_v2(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname)


def model_id(name: str, host_id: str) -> str:
    """Model id (pkg/idgen/model_id.go): sha256(host_id, name)."""
    return sha256_from_strings(host_id, name)
