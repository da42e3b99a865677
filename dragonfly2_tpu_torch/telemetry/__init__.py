"""Telemetry: metrics and their HTTP server, tracing, the flight recorder
with its cost cards and soak timelines, and the SLO engine with its health
verdict.

As dragonfly2_tpu/telemetry/__init__.py; nothing here pulls in a device
library (telemetry/costcard.py imports torch only inside a capture).
"""

from dragonfly2_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MonitorServer,
    Registry,
    default_registry,
    serve_metrics,
)
from dragonfly2_tpu_torch.telemetry.tracing import (  # noqa: F401
    Span,
    Tracer,
    current_context,
    default_tracer,
)
from dragonfly2_tpu_torch.telemetry.flight import (  # noqa: F401
    PhaseRecorder,
    instrument_entry,
)
from dragonfly2_tpu_torch.telemetry.costcard import (  # noqa: F401
    CostCard,
    CostCardLedger,
)
from dragonfly2_tpu_torch.telemetry.timeline import (  # noqa: F401
    QuantileSketch,
    TimelineRecorder,
    recovery_time,
)
from dragonfly2_tpu_torch.telemetry.slo import (  # noqa: F401
    BurnRateRule,
    SLOEngine,
    SLOSpec,
    health_verdict,
)
