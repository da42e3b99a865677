"""Static configuration: workload constants and the typed config dataclasses."""
