"""Announcer: streams the scheduler's trace datasets to the trainer.

Port of dragonfly2_tpu/cluster/announcer.py (the reference's
scheduler/announcer: every ``Trainer.Interval``, 7 days by default, both
CSV datasets are streamed in 128 MiB chunks) to any ``TrainerSink``: the
in-proc TrainerService (cluster/trainer_service.py) or a transport's
client edge, keyed by this scheduler's host id.
"""

from __future__ import annotations

import time
from typing import Iterator, Protocol

from dragonfly2_tpu_torch.config.constants import CONSTANTS
from dragonfly2_tpu_torch.records.storage import TraceStorage
from dragonfly2_tpu_torch.telemetry.tracing import default_tracer


class TrainerSink(Protocol):
    def train_mlp_chunk(self, host_id: str, data: bytes) -> None: ...
    def train_gnn_chunk(self, host_id: str, data: bytes) -> None: ...
    def train_finish(self, host_id: str) -> None: ...
    def train_abort(self, host_id: str) -> None: ...


def _chunks(blob: bytes, chunk_size: int) -> Iterator[bytes]:
    for off in range(0, len(blob), chunk_size):
        yield blob[off : off + chunk_size]


class Announcer:
    def __init__(
        self,
        host_id: str,
        storage: TraceStorage,
        trainer: TrainerSink,
        interval_seconds: float = CONSTANTS.TRAIN_INTERVAL_SECONDS,
        chunk_bytes: int = CONSTANTS.TRAIN_UPLOAD_CHUNK_BYTES,
        keepalive=None,
    ):
        self.host_id = host_id
        self.storage = storage
        self.trainer = trainer
        self.interval_seconds = interval_seconds
        self.chunk_bytes = chunk_bytes
        self.keepalive = keepalive
        self._last_upload = 0.0
        self.uploads = 0

    def maybe_announce(self, now: float | None = None) -> bool:
        """Upload both datasets if the interval has elapsed."""
        now = time.monotonic() if now is None else now
        if now - self._last_upload < self.interval_seconds:
            return False
        self._last_upload = now
        self.announce_to_trainer()
        return True

    def announce_to_trainer(self) -> None:
        """Stream download.csv (the mlp stream) and networktopology.csv (the
        gnn stream) in chunks, then finish; on any error abort, which clears
        the trainer's partial files for this host, and re-raise. Runs under
        the ``scheduler.announce_to_trainer`` span."""
        with default_tracer().span("scheduler.announce_to_trainer", host_id=self.host_id):
            try:
                for chunk in _chunks(self.storage.open_download(), self.chunk_bytes):
                    self.trainer.train_mlp_chunk(self.host_id, chunk)
                for chunk in _chunks(self.storage.open_network_topology(), self.chunk_bytes):
                    self.trainer.train_gnn_chunk(self.host_id, chunk)
                self.trainer.train_finish(self.host_id)
                self.uploads += 1
            except Exception:
                self.trainer.train_abort(self.host_id)
                raise

    def keepalive_once(self) -> None:
        if self.keepalive is not None:
            self.keepalive(self.host_id)
