"""Port of dragonfly2_tpu/records/storage.py, whole: ``TraceStorage``.

Buffered CSV trace storage with size-based rotation and max-backups.

Capability parity with /root/reference/scheduler/storage/storage.go:
``Create{Download,NetworkTopology}`` buffered appends, rotation at
``max_size/max_backups`` (:412-475), ``List``/``Open``/``Clear`` and the
count accessors, plus the trainer-side per-host variants
(/root/reference/trainer/storage/storage.go:44-148).

Difference from the upstream store: rows are written through the columnar ``flatten()``
layout (records/schema.py), so a file can be bulk-loaded straight into
numpy columns without per-row object decoding (records/features.py).
"""

from __future__ import annotations

import csv
import io
import pathlib
import threading
import time
from typing import Iterator, Type

from dragonfly2_tpu_torch.records import schema as _schema
from dragonfly2_tpu_torch.records.schema import DownloadRecord, NetworkTopologyRecord

DOWNLOAD_FILE_PREFIX = "download"
NETWORK_TOPOLOGY_FILE_PREFIX = "networktopology"
CSV_EXT = ".csv"


class _RotatingCSV:
    """One record type's rotating CSV set: <prefix>.csv + <prefix>-N.csv backups."""

    def __init__(self, base_dir: pathlib.Path, prefix: str, record_cls: type,
                 max_size_bytes: int, max_backups: int):
        self.base_dir = base_dir
        self.prefix = prefix
        self.record_cls = record_cls
        self.max_size_bytes = max_size_bytes
        self.max_backups = max_backups
        self.header = _schema.header(record_cls())
        self._lock = threading.Lock()
        self._count = 0
        self._fh = None  # persistent buffered append handle
        self._size = 0  # active-file size including unflushed bytes
        self._last_flush = 0.0
        self.base_dir.mkdir(parents=True, exist_ok=True)

    @property
    def active_path(self) -> pathlib.Path:
        return self.base_dir / f"{self.prefix}{CSV_EXT}"

    def backup_paths(self) -> list[pathlib.Path]:
        return sorted(
            self.base_dir.glob(f"{self.prefix}-*{CSV_EXT}"),
            key=lambda p: int(p.stem.rsplit("-", 1)[1]),
        )

    def all_paths(self) -> list[pathlib.Path]:
        paths = self.backup_paths()
        if self.active_path.exists():
            paths.append(self.active_path)
        return paths

    def create(self, record) -> None:
        """Buffered append (the reference's bufio writer, storage.go:
        Create*): the file handle persists across records — an open() +
        two stat() calls per row cost ~0.7 ms each and dominated trace
        recording at replay rates. Readers go through flush() first."""
        # compiled direct-to-text codec (schema.to_line): byte-identical
        # to _csv_values_line(to_row(record)) at ~10% of the cost — the
        # per-completion record write sat on the replay critical path
        line = _schema.to_line(record)
        # _size seeds from stat().st_size (bytes) and gates rotation
        # against max_size_bytes, so increments must be BYTE counts —
        # len(line) is characters and undercounts non-ASCII field values
        nbytes = len(line.encode("utf-8"))
        with self._lock:
            if self._fh is None:
                self._open_locked()
            if self._size and self._size + nbytes > self.max_size_bytes:
                self._rotate_locked()
            if self._size == 0:
                header = _csv_values_line(self.header)
                self._fh.write(header)
                self._size += len(header.encode("utf-8"))
            self._fh.write(line)
            self._size += nbytes
            self._count += 1
            # bound staleness for OTHER processes tailing the file (the
            # e2e harness, an operator's tail -f); in-process readers go
            # through flush() explicitly
            now = time.monotonic()
            if now - self._last_flush > 1.0:
                self._fh.flush()
                self._last_flush = now

    def flush(self) -> None:
        """Push buffered rows to disk so readers (iter_records,
        open_bytes, numeric_matrix — and other processes) see them."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _open_locked(self) -> None:
        path = self.active_path
        self._fh = path.open("a", newline="")
        self._size = path.stat().st_size

    def _close_locked(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    def _rotate_locked(self) -> None:
        self._close_locked()
        backups = self.backup_paths()
        next_idx = int(backups[-1].stem.rsplit("-", 1)[1]) + 1 if backups else 1
        self.active_path.rename(self.base_dir / f"{self.prefix}-{next_idx}{CSV_EXT}")
        backups = self.backup_paths()
        # max_backups counts the active file too, mirroring the reference.
        while len(backups) > self.max_backups - 1:
            backups.pop(0).unlink()
        self._open_locked()

    def iter_records(self) -> Iterator:
        # Positional fast path: rows are read as plain lists and decoded by
        # the compiled per-class codec (schema.from_row) — building a
        # 1,745-key dict per row (DictReader + unflatten) costs ~5 ms/row
        # and dominated trainer dataset loading at the 1M-piece scale.
        self.flush()
        n_cols = len(self.header)
        for path in self.all_paths():
            with path.open(newline="") as f:
                for row in csv.reader(f):
                    if len(row) != n_cols or row == self.header:
                        continue  # torn write, or a (possibly repeated —
                        # open_bytes() concatenates rotations) header row
                    try:
                        yield _schema.from_row(self.record_cls, row)
                    except ValueError:
                        continue  # foreign/renamed-schema row: skip, keep
                        # listing the healthy files (old DictReader behavior)

    def count(self) -> int:
        return self._count

    def numeric_matrix(self, columns: list[str] | None = None):
        """All rotations parsed into a float64 matrix (NaN where a field
        is non-numeric) — the trainer's columnar fast path over the
        100+-column schema. Parses in native code when dfnative is built;
        the csv-module fallback produces identical output."""
        import numpy as np

        from dragonfly2_tpu_torch import native

        self.flush()
        n_cols = len(self.header)
        col_idx = (
            np.arange(n_cols)
            if columns is None
            else np.asarray([self.header.index(c) for c in columns])
        )
        mats = []
        for path in self.all_paths():
            data = path.read_bytes()
            mat = native.csv_parse_numeric(data, n_cols, skip_header=True)
            if mat is None:  # pure-Python fallback
                rows = []
                with path.open(newline="") as f:
                    reader = csv.reader(f)
                    next(reader, None)
                    for row in reader:
                        if len(row) != n_cols:
                            continue
                        rows.append([_to_float(v) for v in row])
                mat = np.asarray(rows, np.float64).reshape(len(rows), n_cols)
            mats.append(mat[:, col_idx])
        if not mats:
            return np.zeros((0, len(col_idx)), np.float64)
        return np.concatenate(mats, axis=0)

    def open_bytes(self) -> bytes:
        """Concatenated raw bytes of all rotations (announcer upload path)."""
        self.flush()
        buf = io.BytesIO()
        for path in self.all_paths():
            buf.write(path.read_bytes())
        return buf.getvalue()

    def clear(self) -> None:
        with self._lock:
            self._close_locked()
            for path in self.all_paths():
                path.unlink(missing_ok=True)
            self._count = 0
            self._size = 0


def _to_float(value: str) -> float:
    try:
        return float(value)
    except ValueError:
        return float("nan")


def _csv_values_line(values: list) -> str:
    out = io.StringIO()
    csv.writer(out, lineterminator="\n").writerow(values)
    return out.getvalue()


class TraceStorage:
    """Scheduler-side trace recorder: download.csv + networktopology.csv."""

    def __init__(self, data_dir: str | pathlib.Path, max_size_mb: int = 100, max_backups: int = 10):
        base = pathlib.Path(data_dir)
        max_bytes = max_size_mb * (1 << 20)
        self.downloads = _RotatingCSV(base, DOWNLOAD_FILE_PREFIX, DownloadRecord, max_bytes, max_backups)
        self.topologies = _RotatingCSV(base, NETWORK_TOPOLOGY_FILE_PREFIX, NetworkTopologyRecord, max_bytes, max_backups)

    def create_download(self, record: DownloadRecord) -> None:
        self.downloads.create(record)

    def create_network_topology(self, record: NetworkTopologyRecord) -> None:
        self.topologies.create(record)

    def list_downloads(self) -> list[DownloadRecord]:
        return list(self.downloads.iter_records())

    def list_network_topologies(self) -> list[NetworkTopologyRecord]:
        return list(self.topologies.iter_records())

    def download_matrix(self, columns: list[str] | None = None):
        """Columnar numeric view of the download traces (native parse)."""
        return self.downloads.numeric_matrix(columns)

    def topology_matrix(self, columns: list[str] | None = None):
        return self.topologies.numeric_matrix(columns)

    def open_download(self) -> bytes:
        return self.downloads.open_bytes()

    def open_network_topology(self) -> bytes:
        return self.topologies.open_bytes()

    def flush(self) -> None:
        self.downloads.flush()
        self.topologies.flush()

    def close(self) -> None:
        """Flush + close the buffered writers — wire into service
        shutdown, or up to a second of rows dies with the process."""
        self.downloads.close()
        self.topologies.close()

    def clear(self) -> None:
        self.downloads.clear()
        self.topologies.clear()


class HostTraceStorage:
    """Trainer-side per-host dataset store (trainer/storage/storage.go).

    The trainer receives per-scheduler-host dataset streams; each host's
    rows land in ``download-<hostid>.csv`` / ``networktopology-<hostid>.csv``.
    """

    def __init__(self, data_dir: str | pathlib.Path):
        self.base = pathlib.Path(data_dir)
        self.base.mkdir(parents=True, exist_ok=True)

    def _path(self, prefix: str, host_id: str) -> pathlib.Path:
        return self.base / f"{prefix}-{host_id}{CSV_EXT}"

    def append_download_bytes(self, host_id: str, data: bytes) -> None:
        with self._path(DOWNLOAD_FILE_PREFIX, host_id).open("ab") as f:
            f.write(data)

    def append_network_topology_bytes(self, host_id: str, data: bytes) -> None:
        with self._path(NETWORK_TOPOLOGY_FILE_PREFIX, host_id).open("ab") as f:
            f.write(data)

    def _iter(self, prefix: str, cls: Type) -> Iterator:
        for path in sorted(self.base.glob(f"{prefix}-*{CSV_EXT}")):
            with path.open(newline="") as f:
                reader = csv.reader(f)
                header = None
                for values in reader:
                    # Concatenated uploads repeat the header mid-file.
                    if _looks_like_header(values):
                        header = values
                        continue
                    if header is None:
                        continue
                    yield _schema.unflatten(cls, dict(zip(header, values)))

    def list_downloads(self) -> list[DownloadRecord]:
        return list(self._iter(DOWNLOAD_FILE_PREFIX, DownloadRecord))

    def list_network_topologies(self) -> list[NetworkTopologyRecord]:
        return list(self._iter(NETWORK_TOPOLOGY_FILE_PREFIX, NetworkTopologyRecord))

    def clear_downloads(self) -> None:
        for path in self.base.glob(f"{DOWNLOAD_FILE_PREFIX}-*{CSV_EXT}"):
            path.unlink(missing_ok=True)

    def clear_network_topologies(self) -> None:
        for path in self.base.glob(f"{NETWORK_TOPOLOGY_FILE_PREFIX}-*{CSV_EXT}"):
            path.unlink(missing_ok=True)

    def clear_host(self, host_id: str) -> None:
        """Drop one host's partial datasets (trainer error path,
        service_v1.go:117-131 — scoped to the failing stream only)."""
        self._path(DOWNLOAD_FILE_PREFIX, host_id).unlink(missing_ok=True)
        self._path(NETWORK_TOPOLOGY_FILE_PREFIX, host_id).unlink(missing_ok=True)


def _looks_like_header(values: list[str]) -> bool:
    return bool(values) and values[0] in ("id",) and not values[0].isdigit()
