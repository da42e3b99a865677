"""Digest helpers — parity with pkg/digest (sha256/md5 of strings, readers).

Reference: pkg/digest/digest.go. IDs across the system are
sha256 over ``:``-joined parts (digest.SHA256FromStrings).
"""

from __future__ import annotations

import hashlib
from typing import BinaryIO, Iterable

SEPARATOR = ":"


def sha256_from_strings(*parts: str) -> str:
    h = hashlib.sha256()
    h.update(SEPARATOR.join(parts).encode("utf-8"))
    return h.hexdigest()


def sha256_from_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def md5_from_bytes(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def sha256_from_reader(reader: BinaryIO, chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    while True:
        chunk = reader.read(chunk_size)
        if not chunk:
            break
        h.update(chunk)
    return h.hexdigest()


def sha256_from_chunks(chunks: Iterable[bytes]) -> str:
    h = hashlib.sha256()
    for chunk in chunks:
        h.update(chunk)
    return h.hexdigest()


def stable_hash64(s: str) -> int:
    """Stable 63-bit integer hash of a string (feature encoding for kernels).

    Used to turn categorical identity fields (IDC, location elements, host
    ids) into integer codes the batched evaluator can compare on device.
    Python's builtin hash() is salted per-process; this one is stable.
    """
    d = hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(d, "big") & 0x7FFF_FFFF_FFFF_FFFF
