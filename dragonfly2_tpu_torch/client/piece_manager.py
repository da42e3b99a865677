"""Piece acquisition: from a parent peer or back-to-source.

Port of dragonfly2_tpu/client/piece_manager.py, whole.

Capability parity with client/daemon/peer/piece_manager.go (DownloadPiece
:170 — HTTP GET from the parent's upload server with digest verification;
DownloadSource :303 + concurrent piece groups :793-921 — ranged source
reads split into pieces and written concurrently).
"""

from __future__ import annotations

import concurrent.futures
import time
import urllib.error
import urllib.request

from dragonfly2_tpu_torch.client import source as source_pkg
from dragonfly2_tpu_torch.client.storage import TaskStorage
from dragonfly2_tpu_torch.utils import dferrors
from dragonfly2_tpu_torch.utils.digest import md5_from_bytes


def piece_layout(content_length: int, piece_length: int) -> list[tuple[int, int, int]]:
    """[(number, offset, length)] covering content_length."""
    if content_length < 0:
        raise ValueError("content_length unknown")
    out = []
    n = 0
    off = 0
    while off < content_length:
        length = min(piece_length, content_length - off)
        out.append((n, off, length))
        n += 1
        off += length
    return out


class PieceManager:
    def __init__(self, timeout: float = 30.0, concurrency: int = 4):
        self.timeout = timeout
        self.concurrency = concurrency

    # ------------------------------------------------------------- parents

    def download_piece_from_parent(
        self, ts: TaskStorage, parent_ip: str, parent_port: int, number: int, offset: int,
        expected_digest: str = "",
    ) -> int:
        """Fetch one piece over the parent's upload server; returns bytes
        written. `expected_digest` is the scheduler-ATTESTED md5 for this
        piece (origin-reported, distributed in schedule responses); when
        present it is authoritative and the parent's header is advisory
        only — a parent serving corrupt bytes under a self-consistent
        header still fails here. Verification happens BEFORE commit, so
        corrupt bytes never reach disk; a mismatch raises the typed
        PieceCorrupted the conductor reports as reason="corruption"."""
        url = f"http://{parent_ip}:{parent_port}/download/{ts.meta.task_id}?piece={number}"
        t0 = time.perf_counter_ns()
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as resp:
                data = resp.read()
                header_digest = resp.headers.get("X-Dragonfly-Piece-Digest", "")
        except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
            raise dferrors.Unavailable(f"parent piece fetch {url}: {e}") from e
        cost = time.perf_counter_ns() - t0
        digest = expected_digest or header_digest
        if digest:
            actual = md5_from_bytes(data)
            if actual != digest:
                raise dferrors.PieceCorrupted(
                    f"piece {number} from {parent_ip}:{parent_port}: digest "
                    f"{actual} != {'attested' if expected_digest else 'header'} "
                    f"{digest}"
                )
        # verified=True: the check above already hashed this exact buffer
        ts.write_piece(number, offset, data, digest=digest, cost_ns=cost,
                       verified=bool(digest))
        return len(data)

    # -------------------------------------------------------------- source

    def download_source(
        self, ts: TaskStorage, url: str, headers: dict | None = None,
        on_piece=None,
    ) -> tuple[int, int]:
        """Back-to-source download of the whole task; returns
        (content_length, piece_count). Known-length sources fan out ranged
        piece-group fetches; unknown-length streams sequentially.
        `on_piece(number, length, cost_ns, digest)` fires per committed
        piece with the md5 this fetcher computed — the origin fetch is the
        digest chain's trust anchor, so the conductor reports these to the
        scheduler with each piece-finished message."""
        content_length = source_pkg.content_length(url, headers)
        piece_length = ts.meta.piece_length
        use_ranges = content_length >= 0
        if use_ranges:
            layout = piece_layout(content_length, piece_length)
            if len(layout) > 1 and not source_pkg.supports_range(url, headers):
                # Server ignores Range (python -m http.server, some CDNs):
                # concurrent ranged workers would each re-download and
                # discard the file head — O(N^2) transfer. Stream once.
                use_ranges = False
        if use_ranges:
            with concurrent.futures.ThreadPoolExecutor(self.concurrency) as pool:
                futures = {
                    pool.submit(self._fetch_range, url, headers, off, length): (n, off, length)
                    for n, off, length in layout
                }
                for future in concurrent.futures.as_completed(futures):
                    n, off, length = futures[future]
                    data, cost = future.result()
                    if len(data) != length:
                        raise dferrors.Unavailable(
                            f"source range {off}+{length} returned {len(data)} bytes"
                        )
                    digest = md5_from_bytes(data)
                    ts.write_piece(n, off, data, digest=digest, cost_ns=cost,
                                   verified=True)
                    if on_piece is not None:
                        on_piece(n, length, cost, digest)
            ts.mark_done(content_length, len(layout))
            return content_length, len(layout)
        # unknown length: sequential stream, cut into pieces as it arrives
        number, offset, buf = 0, 0, b""
        t0 = time.perf_counter_ns()
        for chunk in source_pkg.download(url, headers):
            buf += chunk
            while len(buf) >= piece_length:
                piece, buf = buf[:piece_length], buf[piece_length:]
                cost = time.perf_counter_ns() - t0
                digest = md5_from_bytes(piece)
                ts.write_piece(number, offset, piece, digest=digest, cost_ns=cost,
                               verified=True)
                if on_piece is not None:
                    on_piece(number, len(piece), cost, digest)
                number += 1
                offset += len(piece)
                t0 = time.perf_counter_ns()
        if buf:
            cost = time.perf_counter_ns() - t0
            digest = md5_from_bytes(buf)
            ts.write_piece(number, offset, buf, digest=digest, cost_ns=cost,
                           verified=True)
            if on_piece is not None:
                on_piece(number, len(buf), cost, digest)
            number += 1
            offset += len(buf)
        ts.mark_done(offset, number)
        return offset, number

    def _fetch_range(self, url: str, headers: dict | None, offset: int, length: int):
        t0 = time.perf_counter_ns()
        data = b"".join(source_pkg.download(url, headers, offset, length))
        return data, time.perf_counter_ns() - t0
