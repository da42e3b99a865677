"""Leveled, rotating, per-concern loggers.

Port of dragonfly2_tpu/utils/dflog.py, whole; the loggers hang under `dragonfly2_tpu_torch`.

Capability parity with internal/dflog: one named logger per concern (core,
gc, grpc, job, storage...), size-based rotation with backups, and a
peer/task-scoped adapter mirroring the reference's `With(...)` sugar
loggers. Built on stdlib logging so every module's `logging.getLogger`
output is captured too.
"""

from __future__ import annotations

import logging
import logging.handlers
import pathlib
import sys

_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"
_CONFIGURED: set[str] = set()


def init_logging(
    log_dir: str | pathlib.Path | None = None,
    level: int = logging.INFO,
    max_bytes: int = 100 * 1024 * 1024,
    backups: int = 10,
    console: bool = True,
    concerns: tuple[str, ...] = ("core", "gc", "grpc", "job", "storage"),
) -> None:
    """Configure root + per-concern rotating files (100 MiB x 10 backups —
    the same bounds the reference applies to its logs and traces,
    scheduler/config/constants.go:183-190)."""
    root = logging.getLogger("dragonfly2_tpu_torch")
    root.setLevel(level)
    if console and "console" not in _CONFIGURED:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(h)
        _CONFIGURED.add("console")
    if log_dir is None:
        return
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    for concern in concerns:
        # Keyed by (concern, dir) so a second service in the same process
        # (mini-cluster harness) gets its own files instead of a silent no-op.
        key = f"{concern}@{log_dir}"
        if key in _CONFIGURED:
            continue
        handler = logging.handlers.RotatingFileHandler(
            log_dir / f"{concern}.log", maxBytes=max_bytes, backupCount=backups
        )
        handler.setFormatter(logging.Formatter(_FORMAT))
        logging.getLogger(f"dragonfly2_tpu_torch.{concern}").addHandler(handler)
        _CONFIGURED.add(key)


def get(concern: str = "core") -> logging.Logger:
    return logging.getLogger(f"dragonfly2_tpu_torch.{concern}")


class ScopedLogger(logging.LoggerAdapter):
    """`WithTaskAndPeerID`-style contextual logger."""

    def process(self, msg, kwargs):
        ctx = " ".join(f"{k}={v}" for k, v in self.extra.items())
        return f"[{ctx}] {msg}", kwargs


def with_scope(logger: logging.Logger | None = None, **scope) -> ScopedLogger:
    return ScopedLogger(logger or get(), scope)
