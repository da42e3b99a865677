"""Port of dragonfly2_tpu/telemetry/metrics.py: the collectors,
``Registry``, ``default_registry`` and the per-service observability HTTP
server (``serve_metrics``: ``/metrics``, ``/debug/stacks``,
``/debug/profile``, ``/debug/health``, ``/debug/flight``), whole.

Prometheus-compatible metrics: counters, gauges, histograms, with the
label sets of the reference's per-service metrics packages
(scheduler/metrics/metrics.go:44-454 — ~40 collectors under
`dragonfly_scheduler_*`). Text exposition format v0.0.4 so a real
Prometheus can scrape it; no external client library.
"""

from __future__ import annotations

import http.server
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


def _sample_stacks(seconds: float, interval_s: float = 0.01) -> str:
    """Poor-man's py-spy: aggregate `sys._current_frames()` samples into
    per-frame inclusive counts across all threads."""
    import collections
    import sys
    import time as _time

    counts: collections.Counter[str] = collections.Counter()
    me = threading.get_ident()
    samples = 0
    deadline = _time.monotonic() + seconds
    while _time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            while frame is not None:
                code = frame.f_code
                # co_qualname needs 3.11; fall back to the bare name so
                # the endpoint answers instead of killing the handler
                # thread mid-response on 3.10
                qualname = getattr(code, "co_qualname", code.co_name)
                counts[f"{code.co_filename}:{frame.f_lineno} {qualname}"] += 1
                frame = frame.f_back
        samples += 1
        _time.sleep(interval_s)
    lines = [f"# {samples} samples over {seconds:.1f}s (10ms interval), inclusive counts"]
    for frame_id, n in counts.most_common(80):
        lines.append(f"{n:8d} {frame_id}")
    return "\n".join(lines) + "\n"


class MonitorServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer whose shutdown() is GRACEFUL: stop
    serve_forever, join the serving thread, close the listening socket.
    The base class leaves the acceptor thread and the bound socket behind
    — every test/daemon that starts a monitor leaked a listener until the
    process died."""

    _serve_thread: threading.Thread | None = None

    def shutdown(self) -> None:  # noqa: A003 - stdlib API name
        super().shutdown()
        thread = self._serve_thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5)
        self._serve_thread = None
        self.server_close()


def serve_metrics(registry: Registry | None = None, port: int = 0) -> MonitorServer:
    """Serve the per-service observability HTTP endpoint on a background
    thread (the reference starts a Prometheus `/metrics` server per
    service plus pprof/statsview via InitMonitor,
    cmd/dependency/dependency.go:95-138):

    - `/metrics` — Prometheus text exposition
    - `/debug/stacks` — current stack of every thread (pprof goroutine
      profile equivalent; faulthandler)
    - `/debug/profile?seconds=N` — sampling profiler: sample every
      thread's stack every 10 ms for N seconds (default 2, max 30) and
      return frames ranked by inclusive sample count (cProfile only sees
      the calling thread; sampling `sys._current_frames()` sees the whole
      process, like the pprof CPU profile does)
    - `/debug/flight` — flight-recorder dump (telemetry/flight.py: last-N
      tick phase breakdowns, entry call counters, open spans, cost cards)
      as JSON
    - `/debug/health` — the SLO health verdict plane (telemetry/slo.py:
      ok/degraded/critical with firing-alert causes; 503 on critical)

    Returns the server (.server_address for the bound port, .shutdown()
    to stop — graceful: joins the serving thread and closes the socket)."""
    reg = registry or _DEFAULT

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib API
            path, _, query = self.path.partition("?")
            path = path.rstrip("/")
            if path in ("", "/metrics"):
                return self._send(reg.expose().encode(), "text/plain; version=0.0.4")
            if path == "/debug/stacks":
                import sys
                import traceback

                names = {t.ident: t.name for t in threading.enumerate()}
                parts = []
                for tid, frame in sys._current_frames().items():
                    parts.append(f"Thread {names.get(tid, '?')} (id {tid}):")
                    parts.append("".join(traceback.format_stack(frame)))
                return self._send("\n".join(parts).encode())
            if path == "/debug/profile":
                import urllib.parse as _up

                params = dict(_up.parse_qsl(query))
                try:
                    seconds = float(params.get("seconds", 2) or 2)
                except ValueError:
                    self.send_error(400, "seconds must be a number")
                    return
                seconds = min(max(seconds, 0.1), 30.0)
                return self._send(_sample_stacks(seconds).encode())
            if path == "/debug/flight":
                import json

                from dragonfly2_tpu_torch.telemetry import flight

                try:
                    kwargs = flight.parse_flight_query(query)
                except ValueError as e:
                    self.send_error(400, str(e))
                    return
                # compact separators: the dump's max_bytes cap is
                # measured against compact JSON
                body = json.dumps(
                    flight.dump(**kwargs), separators=(",", ":"), default=str
                ).encode()
                return self._send(body, "application/json")
            if path == "/debug/health":
                import json

                from dragonfly2_tpu_torch.telemetry import slo as _slo

                try:
                    kwargs = _slo.parse_health_query(query)
                except ValueError as e:
                    self.send_error(400, str(e))
                    return
                # the machine-readable verdict plane (same body as the
                # mux route — telemetry/slo.health_verdict): 503 on
                # `critical` for probes, compact JSON so the max_bytes
                # cap is the bytes actually shipped
                doc = _slo.health_verdict(**kwargs)
                body = json.dumps(
                    doc, separators=(",", ":"), default=str
                ).encode()
                return self._send(
                    body, "application/json",
                    status=503 if doc["state"] == _slo.VERDICT_CRITICAL
                    else 200,
                )
            self.send_error(404)

        def _send(self, body: bytes, ctype: str = "text/plain",
                  status: int = 200):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr noise
            pass

    server = MonitorServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(
        target=server.serve_forever, name="metrics-http", daemon=True
    )
    server._serve_thread = thread
    thread.start()
    return server


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
