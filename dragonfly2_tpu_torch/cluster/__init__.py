"""The scheduler service (module helpers so far)."""
