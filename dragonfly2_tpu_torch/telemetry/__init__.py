"""Telemetry: metrics, tracing, the flight recorder and the SLO engine.

As dragonfly2_tpu/telemetry/__init__.py, less what is not ported yet (the
exposition server, the cost cards, the soak timelines and the health
verdict plane); nothing here pulls in a device library.
"""

from dragonfly2_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
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
from dragonfly2_tpu_torch.telemetry.slo import (  # noqa: F401
    BurnRateRule,
    SLOEngine,
    SLOSpec,
)
