"""Piece dispatcher + traffic shaper.

Port of dragonfly2_tpu/client/dispatcher.py, whole: one seed gives the
reference's picks (the same random.Random draws).

Capability parity with client/daemon/peer/piece_dispatcher.go:34-168 (a
scored piece-request queue: parents that served fast recently are
preferred, with randomization so load spreads) and traffic_shaper.go:36-104
(`plain`/`sampling` bandwidth shaping across concurrent tasks via a token
bucket).
"""

from __future__ import annotations

import heapq
import random
import threading
import time


class PieceDispatcher:
    """Priority queue of (piece, parent) jobs. Score = parent's EWMA piece
    cost x U(0.5, 1.5) jitter — cheapest-expected-cost first with enough
    randomness to avoid thundering herds (piece_dispatcher.go score+rand)."""

    def __init__(self, seed: int | None = None):
        self._heap: list[tuple[float, int, int, str]] = []
        self._cost_ewma: dict[str, float] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._rng = random.Random(seed)

    def report_cost(self, parent_peer_id: str, cost_ns: float) -> None:
        with self._lock:
            prev = self._cost_ewma.get(parent_peer_id)
            # EWMA fold matching the probe store (0.1*old + 0.9*new,
            # probes.go:39 semantics).
            self._cost_ewma[parent_peer_id] = (
                cost_ns if prev is None else 0.1 * prev + 0.9 * cost_ns
            )

    def put(self, piece_number: int, parent_peer_id: str) -> None:
        with self._lock:
            base = self._cost_ewma.get(parent_peer_id, 1.0)
            score = base * self._rng.uniform(0.5, 1.5)
            heapq.heappush(self._heap, (score, self._seq, piece_number, parent_peer_id))
            self._seq += 1

    def get(self) -> tuple[int, str] | None:
        with self._lock:
            if not self._heap:
                return None
            _, _, piece, parent = heapq.heappop(self._heap)
            return piece, parent

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


class TrafficShaper:
    """Token-bucket bandwidth limiter shared by all tasks on a daemon.

    `plain` mode: fixed per-task share. `sampling` mode: per-task need is
    re-sampled from recent usage and the total bandwidth divided
    proportionally (traffic_shaper.go samplingTrafficShaper).
    """

    def __init__(self, total_rate_bps: float = 0.0, mode: str = "plain"):
        if mode not in ("plain", "sampling"):
            raise ValueError(f"unknown traffic shaper mode {mode}")
        self.total_rate = total_rate_bps  # 0 = unlimited
        self.mode = mode
        self._lock = threading.Lock()
        self._tokens = 0.0
        self._last = time.monotonic()
        self._task_usage: dict[str, float] = {}

    def register_task(self, task_id: str) -> None:
        with self._lock:
            self._task_usage.setdefault(task_id, 0.0)

    def unregister_task(self, task_id: str) -> None:
        with self._lock:
            self._task_usage.pop(task_id, None)

    def record(self, task_id: str, nbytes: int) -> None:
        with self._lock:
            if task_id in self._task_usage:
                # sampled recent usage decays so idle tasks release share
                self._task_usage[task_id] = 0.5 * self._task_usage[task_id] + 0.5 * nbytes

    def acquire(self, task_id: str, nbytes: int, timeout: float = 30.0) -> bool:
        """Block until `nbytes` of budget is available (True), or timeout
        (False). Unlimited shapers return immediately."""
        if self.total_rate <= 0:
            return True
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self._tokens + (now - self._last) * self._rate_for(task_id),
                    self._rate_for(task_id),  # burst cap = 1s of budget
                )
                self._last = now
                if self._tokens >= nbytes:
                    self._tokens -= nbytes
                    return True
                missing = nbytes - self._tokens
                rate = self._rate_for(task_id)
            wait = missing / rate if rate > 0 else timeout
            if time.monotonic() + wait > deadline:
                return False
            time.sleep(min(wait, 0.05))

    def _rate_for(self, task_id: str) -> float:
        n = max(len(self._task_usage), 1)
        if self.mode == "plain" or not self._task_usage:
            return self.total_rate / n
        total_usage = sum(self._task_usage.values())
        if total_usage <= 0:
            return self.total_rate / n
        share = self._task_usage.get(task_id, 0.0) / total_usage
        # floor share so a new task is never starved
        return self.total_rate * max(share, 0.1 / n)
