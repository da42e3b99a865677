"""TTL in-memory cache with a janitor thread.

Capability parity with the reference's pkg/cache (pkg/cache/cache.go: Set
:114, Add :155, Get :169, GetWithExpiration :186, Scan :88, Delete :227,
DeleteExpired :253, Keys :273, OnEvicted :288, Save/Load :298-372, Flush
:403, janitor :414-437). Backs dynconfig's on-disk fallback and any
host-side lookup state; device-resident state lives in state/ and
cluster/probes.py instead.

Port of dragonfly2_tpu/utils/cache.py, whole; nothing here imports torch.
"""

from __future__ import annotations

import pickle
import threading
import time
import weakref
from typing import Any, Callable, Iterable

NO_EXPIRATION = 0.0


class CacheKeyExists(KeyError):
    pass


class Cache:
    """Thread-safe TTL cache. `default_expiration<=0` means never expire."""

    def __init__(self, default_expiration: float = NO_EXPIRATION, cleanup_interval: float = 0.0):
        self._default = default_expiration
        self._lock = threading.RLock()
        self._items: dict[str, tuple[Any, float]] = {}  # key -> (value, deadline or 0)
        self._on_evicted: Callable[[str, Any], None] | None = None
        self._janitor: threading.Thread | None = None
        self._stop = threading.Event()
        if cleanup_interval > 0:
            # Janitor holds only a weakref so an abandoned cache can be
            # collected (the reference uses runtime.SetFinalizer for the
            # same reason, pkg/cache/cache.go:451-467); the loop exits when
            # the cache dies or close() is called.
            self._janitor = threading.Thread(
                target=_janitor_loop,
                args=(weakref.ref(self), self._stop, cleanup_interval),
                daemon=True,
            )
            self._janitor.start()

    # ------------------------------------------------------------- writes

    def set(self, key: str, value: Any, ttl: float | None = None) -> None:
        deadline = self._deadline(ttl)
        with self._lock:
            self._items[key] = (value, deadline)

    def set_default(self, key: str, value: Any) -> None:
        self.set(key, value, None)

    def add(self, key: str, value: Any, ttl: float | None = None) -> None:
        """Set only if absent (or expired); raises CacheKeyExists otherwise."""
        with self._lock:
            if self._get_locked(key) is not None:
                raise CacheKeyExists(key)
            self._items[key] = (value, self._deadline(ttl))

    def delete(self, key: str) -> None:
        with self._lock:
            item = self._items.pop(key, None)
        if item is not None and self._on_evicted is not None:
            self._on_evicted(key, item[0])

    def flush(self) -> None:
        with self._lock:
            self._items.clear()

    # -------------------------------------------------------------- reads

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            item = self._get_locked(key)
        return default if item is None else item[0]

    def contains(self, key: str) -> bool:
        with self._lock:
            return self._get_locked(key) is not None

    def get_with_expiration(self, key: str) -> tuple[Any, float | None] | None:
        """Returns (value, deadline-or-None) for live keys, else None."""
        with self._lock:
            item = self._get_locked(key)
        if item is None:
            return None
        value, deadline = item
        return value, (deadline if deadline > 0 else None)

    def keys(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [k for k, (_, d) in self._items.items() if d <= 0 or d > now]

    def scan(self, prefix: str, limit: int = -1) -> list[str]:
        """Live keys with the given prefix (pkg/cache Scan — how the
        reference enumerates `networktopology:src:*` style keyspaces)."""
        out: list[str] = []
        for k in self.keys():
            if k.startswith(prefix):
                if 0 <= limit <= len(out):
                    break
                out.append(k)
        return out

    def item_count(self) -> int:
        with self._lock:
            return len(self._items)

    def items(self) -> dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            return {k: v for k, (v, d) in self._items.items() if d <= 0 or d > now}

    # --------------------------------------------------------- maintenance

    def on_evicted(self, fn: Callable[[str, Any], None] | None) -> None:
        self._on_evicted = fn

    def delete_expired(self) -> None:
        now = time.monotonic()
        evicted: list[tuple[str, Any]] = []
        with self._lock:
            for k in list(self._items):
                v, d = self._items[k]
                if 0 < d <= now:
                    del self._items[k]
                    evicted.append((k, v))
        if self._on_evicted is not None:
            for k, v in evicted:
                self._on_evicted(k, v)

    def close(self) -> None:
        self._stop.set()

    # --------------------------------------------------------- persistence

    def save_file(self, path: str) -> None:
        """Persist live items. Deadlines are converted to remaining TTL so a
        later load re-arms them against the new clock."""
        now = time.monotonic()
        with self._lock:
            dump = {
                k: (v, (d - now) if d > 0 else NO_EXPIRATION)
                for k, (v, d) in self._items.items()
                if d <= 0 or d > now
            }
        with open(path, "wb") as f:
            pickle.dump(dump, f)

    def load_file(self, path: str) -> None:
        with open(path, "rb") as f:
            dump = pickle.load(f)
        now = time.monotonic()
        with self._lock:
            for k, (v, ttl) in dump.items():
                if k not in self._items:
                    self._items[k] = (v, now + ttl if ttl > 0 else NO_EXPIRATION)

    # ------------------------------------------------------------ internal

    def _deadline(self, ttl: float | None) -> float:
        if ttl is None:
            ttl = self._default
        return time.monotonic() + ttl if ttl > 0 else NO_EXPIRATION

    def _get_locked(self, key: str):
        item = self._items.get(key)
        if item is None:
            return None
        _, deadline = item
        if 0 < deadline <= time.monotonic():
            return None
        return item

def _janitor_loop(cache_ref, stop: threading.Event, interval: float) -> None:
    while not stop.wait(interval):
        cache = cache_ref()
        if cache is None:
            return
        cache.delete_expired()
        del cache


def new_cache(default_expiration: float = NO_EXPIRATION, cleanup_interval: float = 0.0) -> Cache:
    return Cache(default_expiration, cleanup_interval)
