"""Port of dragonfly2_tpu/cluster/quarantine.py, whole.

Corrupt-parent quarantine: per-host penalty scores with time-decay.

The reference blocklists a failed parent per-CHILD (scheduling.go's
piece-failure -> blocklist path, mirrored in cluster/scheduler.py
reschedule); that protects the one child that observed the failure but
keeps advertising the parent to everyone else. Corruption is different
from a flaky transport: a host serving bytes that fail their
scheduler-attested digests is either rotting or lying, and every child
it serves pays a wasted transfer plus a re-fetch. The QuarantineBoard is
the cluster-wide response: corruption reports accumulate into a per-host
score that decays exponentially; at the threshold the host is quarantined
— the tick's candidate fill skips it entirely — until the score decays
back under the release fraction, so a host that stops corrupting becomes
schedulable again without an operator in the loop.

Scores use an explicit half-life (exponential decay) rather than a fixed
penalty window: a repeat offender re-quarantined while still warm stays
out longer, a one-off decays away on schedule. The clock is injectable so
tests pin the decay deterministically.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

# One corruption report reaches the threshold by default: a host observed
# serving corrupt bytes should stop being advertised IMMEDIATELY — the
# acceptance bar is quarantine within <=3 piece failures, and a child
# blocklists the parent after its first failure, so waiting for multiple
# independent reports could leave the parent advertised indefinitely.
DEFAULT_THRESHOLD = 1.0
DEFAULT_CORRUPTION_WEIGHT = 1.0
DEFAULT_HALF_LIFE_S = 120.0
# released once the decayed score falls under threshold * this fraction
DEFAULT_RELEASE_FRACTION = 0.5


class QuarantineBoard:
    """Thread-safe per-host quarantine scores (callers may hold the
    scheduler's service lock; the board has its own small lock so reads
    from metrics/debug surfaces never need the big one)."""

    def __init__(
        self,
        threshold: float = DEFAULT_THRESHOLD,
        half_life_s: float = DEFAULT_HALF_LIFE_S,
        release_fraction: float = DEFAULT_RELEASE_FRACTION,
        clock: Callable[[], float] = time.monotonic,
        metrics: Any | None = None,
    ) -> None:
        self.threshold = threshold
        self.half_life_s = half_life_s
        self.release_fraction = release_fraction
        self.clock = clock
        self.metrics = metrics  # scheduler_series namespace (or None)
        self._mu = threading.Lock()
        self._score: dict[str, float] = {}
        self._at: dict[str, float] = {}
        self._quarantined: set[str] = set()

    # ------------------------------------------------------------ internal

    def _decayed(self, host_id: str, now: float) -> float:
        score = self._score.get(host_id, 0.0)
        if score <= 0.0:
            return 0.0
        dt = max(now - self._at.get(host_id, now), 0.0)
        return score * (0.5 ** (dt / self.half_life_s))

    def _set_active_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.quarantine_active.labels().set(len(self._quarantined))

    # ------------------------------------------------------------- surface

    def report(self, host_id: str, weight: float = DEFAULT_CORRUPTION_WEIGHT,
               reason: str = "corruption") -> bool:
        """Record one integrity failure against `host_id`; returns True if
        the host is (now) quarantined."""
        if not host_id:
            return False
        now = self.clock()
        with self._mu:
            score = self._decayed(host_id, now) + weight
            self._score[host_id] = score
            self._at[host_id] = now
            if score >= self.threshold and host_id not in self._quarantined:
                self._quarantined.add(host_id)
                if self.metrics is not None:
                    self.metrics.quarantine_total.labels(reason).inc()
                self._set_active_gauge()
            return host_id in self._quarantined

    def is_quarantined(self, host_id: str) -> bool:
        """Decay-aware check; releases the host (and updates the gauge)
        once its score has cooled below the release fraction."""
        with self._mu:
            if host_id not in self._quarantined:
                return False
            now = self.clock()
            if self._decayed(host_id, now) < self.threshold * self.release_fraction:
                self._quarantined.discard(host_id)
                self._score.pop(host_id, None)
                self._at.pop(host_id, None)
                if self.metrics is not None:
                    self.metrics.quarantine_released.labels().inc()
                self._set_active_gauge()
                return False
            return True

    def penalty(self, host_id: str) -> float:
        """Current decayed score — the residual scoring penalty a host
        carries after (or before) quarantine."""
        with self._mu:
            return self._decayed(host_id, self.clock())

    def active_count(self) -> int:
        """Cheap gate for the tick's candidate fill: 0 means no candidate
        lookup needs a quarantine check at all (the common case)."""
        with self._mu:
            return len(self._quarantined)

    def active(self) -> set[str]:
        with self._mu:
            return set(self._quarantined)

    def drop(self, host_id: str) -> None:
        """Forget a host (it left the cluster)."""
        with self._mu:
            self._score.pop(host_id, None)
            self._at.pop(host_id, None)
            if host_id in self._quarantined:
                self._quarantined.discard(host_id)
                self._set_active_gauge()
