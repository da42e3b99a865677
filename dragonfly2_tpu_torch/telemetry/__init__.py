"""Tracing only. Unlike dragonfly2_tpu/telemetry/__init__.py, this package
pulls in nothing else: the reference's metrics, flight and cost-card
modules are not ported yet."""

from dragonfly2_tpu_torch.telemetry.tracing import (  # noqa: F401
    Span,
    Tracer,
    current_context,
    default_tracer,
)
