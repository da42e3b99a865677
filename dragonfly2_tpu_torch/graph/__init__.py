"""Per-task peer DAGs."""
