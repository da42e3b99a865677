"""The wire side of dragonfly2_tpu/rpc/mux.py that the inference server
uses: the health-check messages, the shared health answer and the
envelope-anchored dispatch. The single-port HTTP/wire multiplexer
(``MuxServer``) is not ported yet."""

from __future__ import annotations

import contextlib
import dataclasses

from dragonfly2_tpu_torch.rpc import resilience, wire
from dragonfly2_tpu_torch.telemetry.tracing import default_tracer

SERVING = "SERVING"
NOT_SERVING = "NOT_SERVING"


@dataclasses.dataclass
class HealthCheckRequest:
    """pkg/rpc/health: the standard health v1 Check, per-service."""

    service: str = ""


@dataclasses.dataclass
class HealthCheckResponse:
    status: str = SERVING


wire.register_messages(HealthCheckRequest, HealthCheckResponse)


def dispatch_anchored(dispatch, request, span_prefix: str):
    """Run one decoded frame through ``dispatch`` with the wire envelope
    re-anchored: the frame's remaining deadline budget restarts on this
    host's clock so onward frames carry what is left, and the caller's
    trace context continues through a ``{span_prefix}.<Type>`` span."""
    budget = getattr(request, "deadline_s", None)
    remote_ctx = getattr(request, "trace_context", None)
    with contextlib.ExitStack() as stack:
        if remote_ctx is not None:
            stack.enter_context(default_tracer().span(
                f"{span_prefix}.{type(request).__name__}",
                remote_parent=remote_ctx,
            ))
        if budget is not None:
            stack.enter_context(resilience.deadline(budget))
        return dispatch(request)


def handle_health_request(request, health_check=None):
    """Shared wire-side health answer — servers call this first in their
    dispatch: returns a response for HealthCheckRequest, else None. The
    optional `health_check` callable decides SERVING/NOT_SERVING."""
    if isinstance(request, HealthCheckRequest):
        healthy = True if health_check is None else bool(health_check())
        return HealthCheckResponse(status=SERVING if healthy else NOT_SERVING)
    return None
