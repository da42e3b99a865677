"""Dynamic config: poll a source with an on-disk cache fallback.

Port of dragonfly2_tpu/utils/dynconfig.py, whole.

Capability parity with internal/dynconfig/dynconfig.go: a generic
poll-manager-with-cache engine — `get()` returns cached data within the
expiry window, refreshes from the client otherwise, and falls back to the
last persisted snapshot when the source is unreachable (how schedulers and
daemons survive a manager outage). Observers are notified on change
(scheduler/config/dynconfig.go Register/Notify semantics).
"""

from __future__ import annotations

import json
import pathlib
import threading
import time
from typing import Any, Callable

from dragonfly2_tpu_torch.utils import dferrors


class Dynconfig:
    def __init__(
        self,
        client: Callable[[], dict],
        cache_path: str | pathlib.Path,
        expire: float = 60.0,
    ):
        if expire <= 0:
            raise ValueError("expire must be positive")
        self._client = client
        self._cache_path = pathlib.Path(cache_path)
        self._expire = expire
        self._lock = threading.Lock()
        # Serializes whole refresh cycles (fetch + set + disk write) so a
        # stalled fetch can't clobber a newer snapshot behind it.
        self._refresh_lock = threading.Lock()
        self._data: dict | None = None
        self._fetched_at = 0.0
        self._observers: list[Callable[[dict], None]] = []

    def get(self) -> dict:
        with self._lock:
            if self._data is not None and time.monotonic() - self._fetched_at < self._expire:
                return self._data
        return self.refresh()

    def refresh(self) -> dict:
        """Fetch from the source; on failure serve the disk snapshot."""
        with self._refresh_lock:
            return self._refresh_locked()

    def _refresh_locked(self) -> dict:
        try:
            data = self._client()
        except Exception as e:  # noqa: BLE001 - any source failure falls back
            cached = self._load_disk()
            if cached is None:
                raise dferrors.Unavailable(f"dynconfig source failed and no cache: {e}")
            with self._lock:
                changed = cached != self._data
                self._data = cached
                self._fetched_at = time.monotonic()
            if changed:
                for fn in list(self._observers):
                    fn(cached)
            return cached
        changed = False
        with self._lock:
            changed = data != self._data
            self._data = data
            self._fetched_at = time.monotonic()
        self._store_disk(data)
        if changed:
            for fn in list(self._observers):
                fn(data)
        return data

    def register(self, observer: Callable[[dict], None]) -> None:
        self._observers.append(observer)

    # ------------------------------------------------------------ internal

    def _load_disk(self) -> dict | None:
        try:
            with open(self._cache_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _store_disk(self, data: dict) -> None:
        self._cache_path.parent.mkdir(parents=True, exist_ok=True)
        # UNIQUE temp per writer: two processes sharing one cache file
        # (same-cluster schedulers on one data_dir) must not interleave
        # writes into a common .tmp and rename a torn snapshot into place
        import os
        import tempfile

        fd, tmp = tempfile.mkstemp(
            prefix=self._cache_path.name + ".", suffix=".tmp",
            dir=self._cache_path.parent,
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self._cache_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
