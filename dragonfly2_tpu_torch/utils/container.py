"""Concurrency-safe containers.

Port of dragonfly2_tpu/utils/container.py, whole (host code).

Capability parity with pkg/container: `set.SafeSet` (blocklists, schedule
bookkeeping), the `FinishedPieces` bitset (resource/peer.go uses
bits-and-blooms/bitset), and a bounded ring buffer (probe queues). The
bitset is numpy-backed so it can be lifted straight into device arrays —
the scheduler's SoA state (state/cluster.py) keeps the same layout.
"""

from __future__ import annotations

import collections
import threading
from typing import Generic, Iterable, Iterator, TypeVar

import numpy as np

T = TypeVar("T")


class SafeSet(Generic[T]):
    def __init__(self, items: Iterable[T] = ()):  # noqa: B008
        self._lock = threading.RLock()
        self._set: set[T] = set(items)

    def add(self, item: T) -> bool:
        with self._lock:
            if item in self._set:
                return False
            self._set.add(item)
            return True

    def delete(self, item: T) -> None:
        with self._lock:
            self._set.discard(item)

    def contains(self, *items: T) -> bool:
        with self._lock:
            return all(i in self._set for i in items)

    def values(self) -> list[T]:
        with self._lock:
            return list(self._set)

    def clear(self) -> None:
        with self._lock:
            self._set.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._set)

    def __iter__(self) -> Iterator[T]:
        return iter(self.values())


class Bitset:
    """Fixed-capacity bitset over a uint64 word array (grows on demand)."""

    WORD = 64

    def __init__(self, nbits: int = 0):
        self._words = np.zeros(max(1, -(-nbits // self.WORD)), np.uint64)
        self._lock = threading.Lock()

    def _ensure(self, bit: int) -> None:
        need = bit // self.WORD + 1
        if need > self._words.shape[0]:
            grown = np.zeros(max(need, 2 * self._words.shape[0]), np.uint64)
            grown[: self._words.shape[0]] = self._words
            self._words = grown

    def set(self, bit: int) -> None:
        with self._lock:
            self._ensure(bit)
            self._words[bit // self.WORD] |= np.uint64(1) << np.uint64(bit % self.WORD)

    def clear(self, bit: int) -> None:
        with self._lock:
            if bit // self.WORD < self._words.shape[0]:
                self._words[bit // self.WORD] &= ~(np.uint64(1) << np.uint64(bit % self.WORD))

    def test(self, bit: int) -> bool:
        with self._lock:
            if bit // self.WORD >= self._words.shape[0]:
                return False
            return bool(self._words[bit // self.WORD] >> np.uint64(bit % self.WORD) & np.uint64(1))

    def count(self) -> int:
        with self._lock:
            return int(np.unpackbits(self._words.view(np.uint8)).sum())

    def words(self) -> np.ndarray:
        """Copy of the raw words — the device-array lift point."""
        with self._lock:
            return self._words.copy()

    def set_words(self, words: np.ndarray) -> None:
        with self._lock:
            self._words = np.asarray(words, np.uint64).copy()


class RingBuffer(Generic[T]):
    """Bounded FIFO that drops the oldest on overflow (probe queue
    semantics: networktopology/probes.go keeps the newest `queue_length`)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._items: collections.deque[T] = collections.deque()

    def push(self, item: T) -> T | None:
        """Append; returns the evicted oldest item if the buffer was full."""
        with self._lock:
            evicted = None
            if len(self._items) >= self.capacity:
                evicted = self._items.popleft()
            self._items.append(item)
            return evicted

    def items(self) -> list[T]:
        with self._lock:
            return list(self._items)

    def peek_oldest(self) -> T | None:
        with self._lock:
            return self._items[0] if self._items else None

    def peek_newest(self) -> T | None:
        with self._lock:
            return self._items[-1] if self._items else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
