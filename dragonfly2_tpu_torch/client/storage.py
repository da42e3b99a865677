"""On-disk piece store for the daemon data plane.

Port of dragonfly2_tpu/client/storage.py, whole. The on-disk layout is
the reference's byte for byte (`<task_id>/data`, `metadata.json`,
`pieces.jsonl`), so either package reads a task the other stored.

Capability parity with client/daemon/storage (storage_manager.go:52-129
ifaces, local_storage.go): per-task data file + metadata sidecar, piece
writes at offsets with per-piece digests, FinishedPieces tracking,
reuse lookup by task id (RegisterTask dedup / FindCompletedTask),
partial-completion resume (FindPartialCompletedTask :545), TTL +
disk-usage GC, and persistent-task reload on restart (ReloadPersistentTask
:674). Single 'simple'-style strategy: one contiguous data file per task.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import threading
import time

from dragonfly2_tpu_torch.utils import dferrors
from dragonfly2_tpu_torch.utils.container import Bitset
from dragonfly2_tpu_torch.utils.digest import md5_from_bytes, sha256_from_reader


class _BoundedReader:
    """Read-at-most-N wrapper so the whole-task digest covers exactly
    content_length bytes even if the data file grew past it."""

    def __init__(self, f, limit: int):
        self._f = f
        self._left = limit

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        n = self._left if n < 0 else min(n, self._left)
        data = self._f.read(n)
        self._left -= len(data)
        return data


@dataclasses.dataclass
class PieceMetadata:
    number: int
    offset: int
    length: int
    digest: str = ""
    cost_ns: int = 0


@dataclasses.dataclass
class TaskMetadata:
    task_id: str
    peer_id: str
    url: str = ""
    content_length: int = -1
    piece_length: int = 4 << 20
    total_pieces: int = -1
    # whole-task sha256, computed at mark_done (the root of the digest
    # chain the scheduler distributes; "" until the task completes)
    digest: str = ""
    done: bool = False
    created_at: float = 0.0
    accessed_at: float = 0.0
    pieces: dict[int, PieceMetadata] = dataclasses.field(default_factory=dict)

    def finished_count(self) -> int:
        return len(self.pieces)


class TaskStorage:
    """One task's on-disk state: `<dir>/<task_id>/data` + `metadata.json`."""

    def __init__(self, base: pathlib.Path, meta: TaskMetadata):
        self.dir = base / meta.task_id
        self.dir.mkdir(parents=True, exist_ok=True)
        self.data_path = self.dir / "data"
        self.meta_path = self.dir / "metadata.json"
        self.pieces_path = self.dir / "pieces.jsonl"
        self.meta = meta
        self._lock = threading.RLock()
        # notified on every piece commit and on mark_done: the upload
        # server's long-poll piece listing (GET /pieces/<task>?wait_after=N)
        # blocks on it so children learn about new pieces push-style — the
        # role the reference's per-parent SyncPieceTasks stream plays
        # (client/daemon/peertask_piecetask_synchronizer.go)
        self.piece_cond = threading.Condition(self._lock)
        self._bitset = Bitset()
        for n in meta.pieces:
            self._bitset.set(n)
        if not self.data_path.exists():
            self.data_path.touch()
        if not self.meta_path.exists():
            self._flush_meta()

    # -------------------------------------------------------------- pieces

    def write_piece(
        self, number: int, offset: int, data: bytes, digest: str = "", cost_ns: int = 0,
        verified: bool = False,
    ) -> PieceMetadata:
        """Write piece bytes at their offset; validates the digest first
        (pieceManager digest check before commit). `verified=True` means
        the caller computed `digest` from THIS buffer moments ago
        (piece_manager's fetch paths) — skip re-hashing the same up-to-
        4 MiB buffer on the download hot path."""
        if digest and not verified:
            actual = md5_from_bytes(data)
            if actual != digest:
                raise dferrors.InvalidArgument(
                    f"piece {number} digest mismatch: got {actual} want {digest}"
                )
        with self._lock:
            with open(self.data_path, "r+b") as f:
                f.seek(offset)
                f.write(data)
            piece = PieceMetadata(
                number=number, offset=offset, length=len(data),
                digest=digest or md5_from_bytes(data), cost_ns=cost_ns,
            )
            self.meta.pieces[number] = piece
            self._bitset.set(number)
            self.meta.accessed_at = time.time()
            # O(1) durability per piece: append to the journal instead of
            # rewriting every accumulated entry (which is O(n^2) per task).
            with open(self.pieces_path, "a") as f:
                f.write(json.dumps(dataclasses.asdict(piece)) + "\n")
            self.piece_cond.notify_all()
            return piece

    def read_piece(self, number: int) -> bytes:
        with self._lock:
            piece = self.meta.pieces.get(number)
            if piece is None:
                raise dferrors.NotFound(f"piece {number} not stored")
            self.meta.accessed_at = time.time()
            with open(self.data_path, "rb") as f:
                f.seek(piece.offset)
                return f.read(piece.length)

    def read_range(self, offset: int, length: int) -> bytes:
        with self._lock:
            self.meta.accessed_at = time.time()
            with open(self.data_path, "rb") as f:
                f.seek(offset)
                return f.read(length)

    def has_piece(self, number: int) -> bool:
        return self._bitset.test(number)

    def finished_pieces(self) -> list[int]:
        with self._lock:
            return sorted(self.meta.pieces)

    def set_peer_id(self, peer_id: str) -> None:
        """The daemon re-registers a held task under a FRESH peer id on
        failover/restart re-announce; record it so later self-reports
        (verify-on-serve rot) name a peer the scheduler actually knows —
        a stale id would make quarantine silently no-op."""
        with self._lock:
            self.meta.peer_id = peer_id
            self._flush_meta()

    def evict_piece(self, number: int) -> bool:
        """Un-commit one piece (its bytes failed a LATER integrity check:
        verify-on-serve rot, or a whole-task digest mismatch attributed at
        mark_done). The piece leaves the finished set and the task drops
        out of `done`, so the conductor's resume/download path re-fetches
        it instead of serving or re-serving bad bytes forever. The bytes
        stay in the data file (harmless — unfinished ranges are never
        served) and the piece journal is rewritten without the entry.
        True iff THIS call removed the piece — concurrent detectors of the
        same rot use it to collapse to one self-report."""
        return bool(self.evict_pieces((number,)))

    def evict_pieces(self, numbers) -> list[int]:
        """Batch evict_piece: one journal rewrite + one metadata flush no
        matter how many pieces fall (mark_done recovery can evict
        thousands on a big task — per-piece rewrites would be O(n^2)
        journal bytes). Returns the numbers actually removed."""
        with self._lock:
            evicted = [n for n in numbers if self.meta.pieces.pop(n, None) is not None]
            if not evicted:
                return evicted
            for n in evicted:
                self._bitset.clear(n)
            self.meta.done = False
            self.meta.digest = ""
            with open(self.pieces_path, "w") as f:
                for piece in self.meta.pieces.values():
                    f.write(json.dumps(dataclasses.asdict(piece)) + "\n")
            self._flush_meta()
            return evicted

    def verify_piece(self, number: int) -> bool:
        """Re-hash a stored piece's bytes against its recorded digest
        (verify-on-serve / fsck). False = local disk rot or a torn write;
        the caller decides whether to 503, self-report, or just flag."""
        with self._lock:
            piece = self.meta.pieces.get(number)
            if piece is None:
                return False
            with open(self.data_path, "rb") as f:
                f.seek(piece.offset)
                data = f.read(piece.length)
        if len(data) != piece.length:
            return False
        return not piece.digest or md5_from_bytes(data) == piece.digest

    def compute_digest(self) -> str:
        """Whole-task sha256 over the first content_length bytes of the
        data file ("" when the length is unknown)."""
        with self._lock:
            length = self.meta.content_length
            if length < 0:
                return ""
            with open(self.data_path, "rb") as f:
                return sha256_from_reader(_BoundedReader(f, length))

    def mark_done(
        self,
        content_length: int | None = None,
        total_pieces: int | None = None,
        expected_digest: str | None = None,
    ) -> None:
        """Completion commit with integrity cross-checks. The caller's
        (content_length, total_pieces) claim is verified against the
        actual FinishedPieces state — a missed piece used to yield a
        silently short file — and the whole-task sha256 is computed and
        (when the scheduler attested one) verified before `done` flips.
        Raises TaskIntegrityError / PieceCorrupted; the task then stays
        resumable instead of serving a hole or corrupt bytes."""
        with self._lock:
            length = self.meta.content_length if content_length is None else content_length
            total = self.meta.total_pieces if total_pieces is None else total_pieces
            if total is not None and total > 0:
                missing = [n for n in range(total) if n not in self.meta.pieces]
                if missing:
                    raise dferrors.TaskIntegrityError(
                        f"task {self.meta.task_id}: {len(missing)} of {total} "
                        f"pieces missing at mark_done (first hole: piece "
                        f"{missing[0]})"
                    )
                if length is not None and length >= 0:
                    stored = sum(p.length for p in self.meta.pieces.values()
                                 if p.number < total)
                    if stored != length:
                        raise dferrors.TaskIntegrityError(
                            f"task {self.meta.task_id}: stored piece bytes "
                            f"{stored} != content_length {length}"
                        )
            if content_length is not None:
                self.meta.content_length = content_length
            if total_pieces is not None:
                self.meta.total_pieces = total_pieces
            digest = self.compute_digest()
            if expected_digest and digest and digest != expected_digest:
                raise dferrors.PieceCorrupted(
                    f"task {self.meta.task_id}: whole-task sha256 {digest} "
                    f"!= attested {expected_digest}"
                )
            self.meta.digest = digest
            self.meta.done = True
            self._flush_meta()
            self.piece_cond.notify_all()

    def wait_for_pieces(self, known_count: int, timeout: float) -> bool:
        """Block until this task holds MORE than `known_count` pieces or
        is done (True), or the timeout passes (False) — the long-poll
        primitive behind push-style piece announcements."""
        deadline = time.monotonic() + timeout
        with self.piece_cond:
            while (
                len(self.meta.pieces) <= known_count and not self.meta.done
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.piece_cond.wait(remaining)
            return True

    def size_on_disk(self) -> int:
        try:
            return self.data_path.stat().st_size
        except OSError:
            return 0

    # ---------------------------------------------------------- metadata io

    def _flush_meta(self) -> None:
        """Task-level fields only; piece entries live in the append-only
        journal (pieces.jsonl)."""
        d = dataclasses.asdict(self.meta)
        d.pop("pieces", None)
        tmp = self.meta_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(d))
        tmp.replace(self.meta_path)

    @staticmethod
    def load(base: pathlib.Path, task_dir: pathlib.Path) -> "TaskStorage | None":
        meta_path = task_dir / "metadata.json"
        try:
            d = json.loads(meta_path.read_text())
            pieces = {
                int(k): PieceMetadata(**v) for k, v in d.pop("pieces", {}).items()
            }
            meta = TaskMetadata(**{**d, "pieces": pieces})
        except (OSError, json.JSONDecodeError, TypeError, ValueError):
            return None
        # replay the append-only piece journal (a torn final line from a
        # crash mid-append is dropped)
        try:
            for line in (task_dir / "pieces.jsonl").read_text().splitlines():
                try:
                    piece = PieceMetadata(**json.loads(line))
                except (json.JSONDecodeError, TypeError):
                    continue
                meta.pieces[piece.number] = piece
        except OSError:
            pass
        return TaskStorage(base, meta)


class StorageManager:
    """All tasks on this daemon + GC policy.

    GC parity (local_storage + storage manager): TTL on last access, and
    a high/low-watermark disk-usage sweep evicting least-recently-used
    completed tasks first.
    """

    def __init__(
        self,
        data_dir: str | pathlib.Path,
        task_ttl: float = 24 * 3600.0,
        disk_gc_threshold_bytes: int = 0,  # 0 = unlimited
    ):
        self.base = pathlib.Path(data_dir)
        self.base.mkdir(parents=True, exist_ok=True)
        self.task_ttl = task_ttl
        self.disk_gc_threshold_bytes = disk_gc_threshold_bytes
        self._tasks: dict[str, TaskStorage] = {}
        self._lock = threading.RLock()
        self.reload()

    # ------------------------------------------------------------ lifecycle

    def register_task(self, meta: TaskMetadata) -> TaskStorage:
        with self._lock:
            ts = self._tasks.get(meta.task_id)
            if ts is None:
                meta.created_at = meta.created_at or time.time()
                meta.accessed_at = time.time()
                ts = TaskStorage(self.base, meta)
                self._tasks[meta.task_id] = ts
            return ts

    def get(self, task_id: str) -> TaskStorage | None:
        with self._lock:
            return self._tasks.get(task_id)

    def find_completed_task(self, task_id: str) -> TaskStorage | None:
        ts = self.get(task_id)
        return ts if ts is not None and ts.meta.done else None

    def find_partial_completed_task(self, task_id: str) -> TaskStorage | None:
        """Resume point: task exists with some pieces but not done
        (storage_manager.go:545)."""
        ts = self.get(task_id)
        if ts is not None and not ts.meta.done and ts.meta.finished_count() > 0:
            return ts
        return None

    def delete_task(self, task_id: str) -> bool:
        with self._lock:
            ts = self._tasks.pop(task_id, None)
        if ts is None:
            return False
        import shutil

        shutil.rmtree(ts.dir, ignore_errors=True)
        return True

    def tasks(self) -> list[TaskStorage]:
        with self._lock:
            return list(self._tasks.values())

    def reload(self) -> int:
        """Reload persisted tasks after restart (ReloadPersistentTask).

        The disk scan runs unlocked (it is slow and touches no shared
        state); each check-then-insert takes the task-table lock so a
        reload racing live registrations cannot clobber a TaskStorage a
        download is already writing through."""
        loaded = 0
        for task_dir in self.base.iterdir() if self.base.exists() else []:
            if not task_dir.is_dir():
                continue
            ts = TaskStorage.load(self.base, task_dir)
            if ts is None:
                continue
            with self._lock:
                if ts.meta.task_id not in self._tasks:
                    self._tasks[ts.meta.task_id] = ts
                    loaded += 1
        return loaded

    # ------------------------------------------------------------------ gc

    def run_gc(self) -> int:
        """TTL sweep + disk watermark sweep; returns tasks reclaimed."""
        now = time.time()
        reclaimed = 0
        for ts in self.tasks():
            if now - ts.meta.accessed_at > self.task_ttl:
                if self.delete_task(ts.meta.task_id):
                    reclaimed += 1
        if self.disk_gc_threshold_bytes > 0:
            usage = sum(ts.size_on_disk() for ts in self.tasks())
            if usage > self.disk_gc_threshold_bytes:
                # Evict least-recently-used completed tasks down to 80%.
                target = int(self.disk_gc_threshold_bytes * 0.8)
                for ts in sorted(self.tasks(), key=lambda t: t.meta.accessed_at):
                    if usage <= target:
                        break
                    if ts.meta.done:
                        usage -= ts.size_on_disk()
                        if self.delete_task(ts.meta.task_id):
                            reclaimed += 1
        return reclaimed
