"""Port of dragonfly2_tpu/telemetry/metrics.py: the collectors,
``Registry`` and ``default_registry``. The reference's ``/metrics`` and
debug HTTP server (``serve_metrics``) comes with the service processes
(ROADMAP A9).

Prometheus-compatible metrics: counters, gauges, histograms, with the
label sets of the reference's per-service metrics packages
(scheduler/metrics/metrics.go:44-454 — ~40 collectors under
`dragonfly_scheduler_*`). Text exposition format v0.0.4 so a real
Prometheus can scrape it; no external client library.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{n}="{_escape(v)}"' for n, v in zip(names, values))
    return "{" + pairs + "}"


class _Metric:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._lock = threading.Lock()

    def labels(self, *values: str):
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: got {len(values)} label values, want {len(self.label_names)}"
            )
        return self._child(tuple(str(v) for v in values))

    def _help_lines(self) -> Iterable[str]:
        help_text = self.help.replace("\\", "\\\\").replace("\n", "\\n")
        yield f"# HELP {self.name} {help_text}"
        yield f"# TYPE {self.name} {self.TYPE}"


class _ScalarMetric(_Metric):
    """Shared storage + exposition for single-value-per-labelset metrics."""

    def __init__(self, name: str, help_: str = "", label_names: tuple[str, ...] = ()):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple[str, ...], float] = {}

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(tuple(map(str, label_values)), 0.0)

    def expose(self) -> Iterable[str]:
        yield from self._help_lines()
        with self._lock:
            items = list(self._values.items())
        for key, v in items:
            yield f"{self.name}{_fmt_labels(self.label_names, key)} {v}"


class Counter(_ScalarMetric):
    TYPE = "counter"

    def _child(self, key: tuple[str, ...]) -> "_CounterChild":
        return _CounterChild(self, key)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)


class _CounterChild:
    def __init__(self, parent: Counter, key: tuple[str, ...]):
        self._parent = parent
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._parent._lock:
            self._parent._values[self._key] = self._parent._values.get(self._key, 0.0) + amount


class Gauge(_ScalarMetric):
    TYPE = "gauge"

    def _child(self, key: tuple[str, ...]) -> "_GaugeChild":
        return _GaugeChild(self, key)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().inc(-amount)


class _GaugeChild:
    def __init__(self, parent: Gauge, key: tuple[str, ...]):
        self._parent = parent
        self._key = key

    def set(self, value: float) -> None:
        with self._parent._lock:
            self._parent._values[self._key] = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._parent._lock:
            self._parent._values[self._key] = self._parent._values.get(self._key, 0.0) + amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(
        self,
        name: str,
        help_: str = "",
        label_names: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}

    def _child(self, key: tuple[str, ...]) -> "_HistogramChild":
        return _HistogramChild(self, key)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def expose(self) -> Iterable[str]:
        yield from self._help_lines()
        with self._lock:
            keys = list(self._counts)
            counts = {k: list(v) for k, v in self._counts.items()}
            sums = dict(self._sums)
            totals = dict(self._totals)
        for key in keys:
            cumulative = 0
            for bound, c in zip(self.buckets, counts[key]):
                cumulative += c
                labels = _fmt_labels(self.label_names + ("le",), key + (repr(bound),))
                yield f"{self.name}_bucket{labels} {cumulative}"
            labels = _fmt_labels(self.label_names + ("le",), key + ("+Inf",))
            yield f"{self.name}_bucket{labels} {totals[key]}"
            yield f"{self.name}_sum{_fmt_labels(self.label_names, key)} {sums[key]}"
            yield f"{self.name}_count{_fmt_labels(self.label_names, key)} {totals[key]}"


class _HistogramChild:
    def __init__(self, parent: Histogram, key: tuple[str, ...]):
        self._parent = parent
        self._key = key

    def observe(self, value: float) -> None:
        p = self._parent
        with p._lock:
            counts = p._counts.setdefault(self._key, [0] * len(p.buckets))
            for i, bound in enumerate(p.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            p._sums[self._key] = p._sums.get(self._key, 0.0) + value
            p._totals[self._key] = p._totals.get(self._key, 0) + 1


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric) or existing.label_names != metric.label_names:
                    raise ValueError(
                        f"metric {metric.name} already registered as "
                        f"{type(existing).__name__}{existing.label_names}"
                    )
                if (
                    isinstance(existing, Histogram)
                    and isinstance(metric, Histogram)
                    and existing.buckets != metric.buckets
                ):
                    raise ValueError(
                        f"metric {metric.name} already registered with buckets "
                        f"{existing.buckets}"
                    )
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Counter:
        return self.register(Counter(name, help_, labels))  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Gauge:
        return self.register(Gauge(name, help_, labels))  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help_: str = "",
        labels: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self.register(Histogram(name, help_, labels, buckets))  # type: ignore[return-value]

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT


class Timer:
    """Context manager observing elapsed seconds into a histogram child."""

    def __init__(self, histogram_child):
        self._h = histogram_child

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._h.observe(time.perf_counter() - self._t0)
        return False
