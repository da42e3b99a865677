"""Streaming quantiles for the tail plane.

Port of dragonfly2_tpu/telemetry/timeline.py in part: only
:class:`QuantileSketch`, which telemetry/tailtrace.py keeps per region
and phase. The soak timelines (``TimelineRecorder``, ``recovery_time``)
come with the megascale lab (ROADMAP A10).

:class:`QuantileSketch` is a DDSketch-style log-bucketed streaming
quantile sketch with a provable relative-error bound (the answer x̂ for
quantile q satisfies ``|x̂ - x_q| <= alpha * x_q`` against the exact
quantile value x_q of the inserts). Deterministic: same inserts → same
buckets → same answers.
"""

from __future__ import annotations

import math
from typing import Iterable

# ------------------------------------------------------- quantile sketch


class QuantileSketch:
    """Log-bucketed streaming quantile sketch (the DDSketch construction).

    Values land in bucket ``ceil(log_gamma(x))`` with
    ``gamma = (1 + alpha) / (1 - alpha)``; reporting the geometric
    midpoint of a bucket guarantees relative error <= ``alpha`` for
    every quantile of the positive inserts. Sub-``min_value`` and
    non-positive values collapse into a zero bucket (reported as 0.0 —
    exact for the simulated "instant completion" case). Memory is
    bounded by ``max_buckets``: when exceeded, the LOWEST buckets
    collapse into the zero bucket, so the tail quantiles the soak cares
    about (p50/p90/p99) keep their bound while tiny outliers lose
    resolution first.
    """

    __slots__ = ("alpha", "_gamma", "_log_gamma", "min_value",
                 "max_buckets", "_buckets", "_zero", "count")

    def __init__(self, relative_accuracy: float = 0.01,
                 min_value: float = 1e-6, max_buckets: int = 2048):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError("relative_accuracy must be in (0, 1)")
        self.alpha = relative_accuracy
        self._gamma = (1.0 + relative_accuracy) / (1.0 - relative_accuracy)
        self._log_gamma = math.log(self._gamma)
        self.min_value = min_value
        self.max_buckets = max_buckets
        self._buckets: dict[int, int] = {}
        self._zero = 0
        self.count = 0

    def add(self, value: float, n: int = 1) -> None:
        self.count += n
        if value <= self.min_value:
            self._zero += n
            return
        idx = math.ceil(math.log(value) / self._log_gamma)
        self._buckets[idx] = self._buckets.get(idx, 0) + n
        if len(self._buckets) > self.max_buckets:
            self._collapse()

    def _collapse(self) -> None:
        for idx in sorted(self._buckets)[: len(self._buckets) - self.max_buckets]:
            self._zero += self._buckets.pop(idx)

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(float(v))

    def quantile(self, q: float) -> float | None:
        """Value at quantile ``q`` in [0, 1], or None when empty."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        rank = q * (self.count - 1)
        seen = self._zero
        if rank < seen or not self._buckets:
            return 0.0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if rank < seen:
                # geometric bucket midpoint: 2*g^i/(g+1) — the point whose
                # worst-case relative distance to any bucket member is alpha
                return 2.0 * self._gamma ** idx / (self._gamma + 1.0)
        idx = max(self._buckets)
        return 2.0 * self._gamma ** idx / (self._gamma + 1.0)

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "p50": _round_opt(self.quantile(0.50)),
            "p90": _round_opt(self.quantile(0.90)),
            "p99": _round_opt(self.quantile(0.99)),
        }


def _round_opt(v: float | None, nd: int = 2) -> float | None:
    return None if v is None else round(v, nd)
