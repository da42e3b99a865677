"""Span tracing at service boundaries.

Capability parity with the reference's OpenTelemetry usage: every binary
initializes a tracer with an exporter (cmd/dependency/dependency.go:263-280
jaeger flag) and services create spans at boundaries (scheduler service,
client conductor/piece_downloader, manager jobs). This implementation is
OTel-shaped (trace_id/span_id/parent, attributes, events, status) with
pluggable exporters: in-memory (tests), JSONL file, or a user callable —
zero required external infrastructure.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import pathlib
import secrets
import threading
import time
from typing import Any, Callable

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "dragonfly2_tpu_torch_span", default=None
)


@dataclasses.dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start_ns: int
    end_ns: int | None = None
    attributes: dict[str, Any] = dataclasses.field(default_factory=dict)
    events: list[dict] = dataclasses.field(default_factory=list)
    status: str = "OK"

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attrs) -> None:
        self.events.append({"name": name, "ts_ns": time.time_ns(), **attrs})

    def record_exception(self, exc: BaseException) -> None:
        self.status = "ERROR"
        self.add_event("exception", type=type(exc).__name__, message=str(exc))

    def duration_ms(self) -> float | None:
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Tracer:
    def __init__(self, service: str = "dragonfly2-tpu"):
        self.service = service
        self._exporters: list[Callable[[Span], None]] = []
        self._lock = threading.Lock()
        # Spans started but not yet ended, keyed by span_id — the flight
        # recorder dumps these so an operator can see what a slow tick is
        # CURRENTLY inside of, not only what already finished.
        self._active: dict[str, Span] = {}

    def add_exporter(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            self._exporters.append(fn)

    def remove_exporter(self, fn: Callable[[Span], None]) -> None:
        """Detach by identity; the process-global tracer outlives tests
        and short-lived consumers, which must not leak exporters into it."""
        with self._lock:
            self._exporters = [f for f in self._exporters if f is not fn]

    def export_to_memory(self) -> list[Span]:
        """Attach an in-memory exporter; returns the live list of spans."""
        spans: list[Span] = []
        self.add_exporter(spans.append)
        return spans

    def export_to_file(self, path: str | pathlib.Path) -> "FileSpanExporter":
        """Attach a JSONL file exporter holding ONE open handle with
        locked writes (the old closure reopened the file once per span —
        measurable fd churn on a busy tracer). Returns the exporter so
        the caller can ``close()`` it (and ``remove_exporter`` it) when
        done; the JSONL format is byte-identical to the per-span-open
        implementation."""
        exporter = FileSpanExporter(path)
        self.add_exporter(exporter)
        return exporter

    @contextlib.contextmanager
    def span(self, name: str, remote_parent: dict | None = None, **attributes):
        """Open a span under the ambient parent, or — when `remote_parent`
        is a wire-propagated context ({"trace_id", "span_id"}, rpc/wire.py
        frame envelope) — continue the REMOTE trace: the explicit context
        wins over the contextvar so a server-side handler parents on the
        caller's span, not on whatever local span happens to be open."""
        parent = _current_span.get()
        if remote_parent and remote_parent.get("trace_id"):
            trace_id = str(remote_parent["trace_id"])
            parent_id = str(remote_parent.get("span_id") or "") or None
        else:
            trace_id = parent.trace_id if parent else secrets.token_hex(16)
            parent_id = parent.span_id if parent else None
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=secrets.token_hex(8),
            parent_id=parent_id,
            start_ns=time.time_ns(),
            attributes={"service": self.service, **attributes},
        )
        token = _current_span.set(span)
        with self._lock:
            self._active[span.span_id] = span
        try:
            yield span
        except BaseException as e:
            span.record_exception(e)
            raise
        finally:
            span.end_ns = time.time_ns()
            _current_span.reset(token)
            with self._lock:
                self._active.pop(span.span_id, None)
                exporters = list(self._exporters)
            for fn in exporters:
                try:
                    fn(span)
                except Exception:  # noqa: BLE001 - exporters must not break the traced path
                    pass

    def active_spans(self) -> list[Span]:
        """Snapshot of spans currently open (started, not ended)."""
        with self._lock:
            return list(self._active.values())


class FileSpanExporter:
    """JSONL span sink over one held file handle.

    Writes are serialized by a lock and flushed per span (the per-span
    reopen it replaces flushed implicitly on close, and external readers
    tail the file). After ``close()`` further spans are dropped silently
    — an exporter must never break the traced path."""

    def __init__(self, path: str | pathlib.Path):
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def __call__(self, span: Span) -> None:
        line = json.dumps(span.to_dict()) + "\n"
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def current_span() -> Span | None:
    return _current_span.get()


def current_context() -> dict | None:
    """Wire-propagatable context of the ambient span (None outside any
    span). rpc/wire.encode stamps this into the frame envelope so a trace
    started on one side of an RPC continues on the other."""
    span = _current_span.get()
    if span is None:
        return None
    return {"trace_id": span.trace_id, "span_id": span.span_id}


# ------------------------------------------------------------------ OTLP


def _otlp_value(value: Any) -> dict:
    """Python scalar -> OTLP/JSON AnyValue (int64 rides as a string per
    the protobuf JSON mapping)."""
    if isinstance(value, bool):
        return {"boolValue": value}
    if isinstance(value, int):
        return {"intValue": str(value)}
    if isinstance(value, float):
        return {"doubleValue": value}
    return {"stringValue": str(value)}


def _otlp_attributes(attrs: dict) -> list[dict]:
    return [{"key": k, "value": _otlp_value(v)} for k, v in attrs.items()]


def span_to_otlp(span: Span) -> dict:
    """One Span -> an OTLP/JSON span object (opentelemetry-proto
    trace/v1, the wire shape `POST /v1/traces` collectors ingest)."""
    out = {
        "traceId": span.trace_id,
        "spanId": span.span_id,
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(span.start_ns),
        "endTimeUnixNano": str(span.end_ns or span.start_ns),
        "attributes": _otlp_attributes(span.attributes),
        "events": [
            {
                "timeUnixNano": str(e.get("ts_ns", span.start_ns)),
                "name": e.get("name", ""),
                "attributes": _otlp_attributes(
                    {k: v for k, v in e.items() if k not in ("name", "ts_ns")}
                ),
            }
            for e in span.events
        ],
        "status": {"code": 2 if span.status == "ERROR" else 1},
    }
    if span.parent_id:
        out["parentSpanId"] = span.parent_id
    return out


def spans_to_otlp_request(spans: list[Span], service: str) -> dict:
    """ExportTraceServiceRequest JSON body for a span batch."""
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": _otlp_attributes({"service.name": service})
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "dragonfly2-tpu"},
                        "spans": [span_to_otlp(s) for s in spans],
                    }
                ],
            }
        ]
    }


class OTLPExporter:
    """Batching OTLP/HTTP-JSON trace exporter (the reference initializes a
    Jaeger exporter per binary, cmd/dependency/dependency.go:263-280; OTLP
    is what that stack speaks today — any collector/Jaeger >=1.35 ingests
    `POST <endpoint>/v1/traces`). Buffers spans; full batches are handed to
    a daemon worker thread so span-end NEVER blocks the caller (the tracer
    runs inside asyncio handlers — a slow collector must not stall the
    event loop, the reference's BatchSpanProcessor makes the same call).
    `flush()` posts the partial buffer AND drains batches already queued
    to the worker (shutdown/tests — a queued-but-unposted batch must not
    be lost just because the daemon worker hadn't gotten to it);
    `close()` flushes, then stops the worker via a sentinel with a
    bounded join. Network failures drop the batch with a log line, never
    break the traced path."""

    def __init__(self, endpoint: str, service: str = "dragonfly2-tpu",
                 batch_size: int = 64, timeout: float = 10.0):
        import queue

        self.endpoint = endpoint.rstrip("/")
        self.service = service
        self.batch_size = batch_size
        self.timeout = timeout
        self._buf: list[Span] = []
        self._lock = threading.Lock()
        self._queue: "queue.Queue[list[Span] | None]" = queue.Queue(maxsize=16)
        self._worker: threading.Thread | None = None
        self._closed = False

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._drain, name="otlp-exporter", daemon=True
            )
            self._worker.start()

    def _drain(self) -> None:
        while True:
            batch = self._queue.get()
            if batch is None:  # close() sentinel
                return
            self._post(batch)

    def export(self, span: Span) -> None:
        with self._lock:
            if self._closed:
                return  # spans after close drop silently, like a full queue
            self._buf.append(span)
            if len(self._buf) < self.batch_size:
                return
            batch, self._buf = self._buf, []
        self._ensure_worker()
        try:
            self._queue.put_nowait(batch)
        except Exception:  # noqa: BLE001 - full queue: drop, never block
            import logging

            logging.getLogger(__name__).warning(
                "OTLP export queue full; dropping a %d-span batch", len(batch)
            )

    def flush(self) -> None:
        """Synchronously post everything buffered ANYWHERE in the
        exporter: batches already handed to the daemon worker's queue
        (drained here, not abandoned to a thread that may never run
        again) and then the partial in-progress buffer."""
        import queue

        while True:
            try:
                batch = self._queue.get_nowait()
            except queue.Empty:
                break
            if batch is None:
                # close()'s shutdown sentinel: hand it back to the worker
                # and stop — swallowing it here would leave the worker
                # blocked in get() forever (and close() burning its full
                # join timeout). Nothing can be queued behind it: close()
                # enqueues it only after _closed blocks further exports.
                try:
                    self._queue.put_nowait(None)
                except Exception:  # noqa: BLE001 - full queue: worker will still see EOF via close()'s retry
                    pass
                break
            self._post(batch)
        with self._lock:
            batch, self._buf = self._buf, []
        if batch:
            self._post(batch)

    def close(self, timeout: float = 5.0) -> None:
        """Bounded shutdown: flush every queued/partial span, then stop
        the worker via sentinel and join it for at most ``timeout``
        seconds. Idempotent; later export() calls drop silently."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.flush()
        worker = self._worker
        if worker is not None and worker.is_alive():
            try:
                self._queue.put_nowait(None)
            except Exception:  # noqa: BLE001 - full queue: join is still bounded
                pass
            worker.join(timeout)
        self._worker = None

    def _post(self, batch: list[Span]) -> None:
        import logging
        import urllib.error
        import urllib.request

        body = json.dumps(spans_to_otlp_request(batch, self.service)).encode()
        req = urllib.request.Request(
            f"{self.endpoint}/v1/traces",
            data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
        except urllib.error.URLError as e:
            logging.getLogger(__name__).warning(
                "OTLP export of %d spans to %s failed: %s",
                len(batch), self.endpoint, e,
            )


_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    return _DEFAULT
