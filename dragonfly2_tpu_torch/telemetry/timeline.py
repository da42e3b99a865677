"""Soak timelines: behavior over simulated time, not end-of-run aggregates.

The megascale lab's reports answered "did the soak survive?" with final
counters — "pieces/s recovers after a scheduler kill" was asserted,
never measured. This module gives replay domains a deterministic
per-interval sampled gauge ring:

- :class:`TimelineRecorder` — one sample per simulated interval (the
  event clock, NOT wall time): pieces per interval, origin fraction,
  quarantine population, breaker-open count, re-announce backlog,
  per-region time-to-complete quantiles. The ring is plain data, rides
  the ``timeline`` array in BENCH_mega artifacts and the
  ``/debug/flight`` dump, and mirrors its latest sample into
  ``dragonfly_timeline_*`` Prometheus gauges for live scrapes.
- :class:`QuantileSketch` — a DDSketch-style log-bucketed streaming
  quantile sketch with a PROVABLE relative-error bound (the answer x̂
  for quantile q satisfies ``|x̂ - x_q| <= alpha * x_q`` against the
  exact quantile value x_q of the inserts), so per-region TTC
  percentiles can ride every sample without retaining per-download
  arrays. Deterministic: same inserts → same buckets → same answers.
- :func:`recovery_time` — the measurement the soak test asserts on:
  given a timeline, a fault round and a metric, how many simulated
  intervals until the metric recovers to ``threshold`` × its pre-fault
  baseline (and how deep the dip was).

Everything recorded here must be a pure function of the replay's event
clock and counters — two runs with the same (spec, seed) produce
IDENTICAL timeline arrays (pinned by tests/test_timeline.py and the
megascale determinism test).

Port of dragonfly2_tpu/telemetry/timeline.py, whole; host code, no torch.
"""

from __future__ import annotations

import math
import threading
import weakref
from collections import deque
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


# ---------------------------------------------------------- the recorder


_TIMELINES: dict[str, "weakref.ref[TimelineRecorder]"] = {}
_timelines_mu = threading.Lock()


def register_timeline(name: str, recorder: "TimelineRecorder") -> None:
    """Weak named registry (mirrors flight.register_recorder) so the
    process-wide /debug/flight dump can find live timelines without a
    handle on the engine that owns them. Last registration wins."""
    with _timelines_mu:
        _TIMELINES[name] = weakref.ref(recorder)


def live_timelines() -> dict[str, "TimelineRecorder"]:
    out = {}
    with _timelines_mu:
        for name, ref in list(_TIMELINES.items()):
            rec = ref()
            if rec is None:
                del _TIMELINES[name]
            else:
                out[name] = rec
    return out


class TimelineRecorder:
    """Bounded ring of per-interval samples keyed by the EVENT clock.

    ``sample(t, values)`` appends one plain dict (``{"t": t, **values}``)
    and mirrors every scalar into the ``dragonfly_timeline_value`` gauge
    (labels: source, metric) for live scrapes; nested dicts (per-region
    sub-objects) ride the ring only. Samples must be derived from the
    replay's counters — never from wall clock — so paired-seed runs
    produce identical arrays.
    """

    __slots__ = ("name", "ring", "events", "_gauge", "_samples",
                 "_children", "__weakref__")

    def __init__(self, name: str, maxlen: int = 4096, registry=None):
        self.name = name
        self.ring: deque = deque(maxlen=maxlen)
        # annotated event marks: [{"t": ..., "event": ...}] — the fault
        # rounds recovery measurements anchor on
        self.events: list[dict] = []
        from dragonfly2_tpu_torch.telemetry import metrics as _metrics
        from dragonfly2_tpu_torch.telemetry.series import timeline_series

        reg = registry if registry is not None else _metrics.default_registry()
        s = timeline_series(reg)
        self._gauge = s.value
        self._samples = s.samples.labels(name)
        self._children: dict[str, object] = {}
        register_timeline(name, self)

    def sample(self, t: float, values: dict) -> None:
        entry = {"t": t}
        entry.update(values)
        self.ring.append(entry)
        self._samples.inc()
        for key, v in values.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = self._gauge.labels(
                        self.name, key
                    )
                child.set(float(v))

    def mark_event(self, t: float, event: str) -> None:
        self.events.append({"t": t, "event": event})

    def timeline(self) -> list[dict]:
        return list(self.ring)

    def dump(self) -> dict:
        return {"name": self.name, "events": list(self.events),
                "samples": self.timeline()}


# ------------------------------------------------------ recovery measure


def recovery_time(
    timeline: list[dict],
    metric: str,
    event_t: float,
    baseline_window: int = 8,
    threshold: float = 0.9,
    horizon: int | None = None,
) -> dict:
    """Measure a fault's dip + recovery on one timeline metric.

    baseline = mean of the last ``baseline_window`` samples strictly
    before ``event_t``; the dip is the minimum over [event_t, recovery);
    recovery is the first sample at/after ``event_t`` whose value climbs
    back to ``threshold * baseline``. Returns plain data::

        {"baseline": float, "dip": float, "dip_ratio": float,
         "recovered": bool, "recovery_t": float | None,
         "recovery_intervals": float | None}

    ``recovery_intervals`` is in event-clock units (simulated intervals),
    so "recovers within N simulated minutes" is
    ``recovery_intervals * minutes_per_interval <= N``.
    """
    before = [s[metric] for s in timeline
              if s.get("t", 0) < event_t and metric in s]
    after = [(s["t"], s[metric]) for s in timeline
             if s.get("t", 0) >= event_t and metric in s]
    if horizon is not None:
        after = after[:horizon]
    base_vals = before[-baseline_window:]
    if not base_vals or not after:
        return {"baseline": None, "dip": None, "dip_ratio": None,
                "recovered": False, "recovery_t": None,
                "recovery_intervals": None}
    baseline = sum(base_vals) / len(base_vals)
    target = threshold * baseline
    dip = min(v for _, v in after)
    recovery_t = None
    for t, v in after:
        if v >= target:
            recovery_t = t
            break
        # the dip only counts until recovery; later troughs (the next
        # fault, the diurnal trough) are not THIS event's dip
    if recovery_t is not None:
        dip = min([v for t, v in after if t <= recovery_t] or [dip])
    return {
        "baseline": round(baseline, 3),
        "dip": round(dip, 3),
        "dip_ratio": round(dip / baseline, 4) if baseline else None,
        "recovered": recovery_t is not None,
        "recovery_t": recovery_t,
        "recovery_intervals": (
            round(recovery_t - event_t, 3) if recovery_t is not None else None
        ),
    }
