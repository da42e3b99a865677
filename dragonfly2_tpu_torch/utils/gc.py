"""Interval-driven GC task runner.

Port of dragonfly2_tpu/utils/gc.py, whole (host code).

Capability parity with pkg/gc/gc.go:28-63: named tasks with an interval,
timeout, and runner; Add/Run/RunAll/Start/Stop. Used by cluster state TTL
reclamation and the client piece store, the same seams the reference wires
it into (scheduler resource managers, client storage).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, Protocol

logger = logging.getLogger(__name__)


class Runner(Protocol):
    def run_gc(self) -> None: ...


@dataclasses.dataclass
class Task:
    id: str
    interval: float  # seconds
    timeout: float
    runner: Callable[[], None]

    def validate(self) -> None:
        if not self.id:
            raise ValueError("gc task requires an id")
        if self.interval <= 0:
            raise ValueError(f"gc task {self.id}: interval must be positive")
        if self.timeout <= 0 or self.timeout > self.interval:
            raise ValueError(f"gc task {self.id}: need 0 < timeout <= interval")


class GC:
    def __init__(self):
        self._tasks: dict[str, Task] = {}
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False

    def add(self, task: Task) -> None:
        task.validate()
        with self._lock:
            if task.id in self._tasks:
                raise ValueError(f"gc task {task.id} already registered")
            self._tasks[task.id] = task
        if self._started:
            self._spawn(task)

    def run(self, task_id: str) -> None:
        with self._lock:
            task = self._tasks.get(task_id)
        if task is None:
            raise KeyError(f"gc task {task_id} not found")
        self._run_one(task)

    def run_all(self) -> None:
        with self._lock:
            tasks = list(self._tasks.values())
        for task in tasks:
            self._run_one(task)

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            tasks = list(self._tasks.values())
        for task in tasks:
            self._spawn(task)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        self._threads.clear()
        # Reset so the runner can be started again (tasks stay registered).
        self._stop = threading.Event()
        with self._lock:
            self._started = False

    # ------------------------------------------------------------ internal

    def _spawn(self, task: Task) -> None:
        t = threading.Thread(
            target=self._loop, args=(task, self._stop), daemon=True, name=f"gc-{task.id}"
        )
        t.start()
        self._threads.append(t)

    def _loop(self, task: Task, stop: threading.Event) -> None:
        while not stop.wait(task.interval):
            self._run_one(task)

    def _run_one(self, task: Task) -> None:
        # The runner gets a watchdog thread instead of the reference's
        # context deadline; an overrun is logged, not killed (no safe way to
        # kill a Python thread), which matches -what- the timeout is for:
        # flagging stuck GC, not resource enforcement.
        done = threading.Event()

        def run():
            try:
                task.runner()
            except Exception:  # noqa: BLE001 - GC must never take down the host loop
                logger.exception("gc task %s failed", task.id)
            finally:
                done.set()

        worker = threading.Thread(target=run, daemon=True, name=f"gc-run-{task.id}")
        worker.start()
        if not done.wait(task.timeout):
            logger.warning("gc task %s exceeded timeout %.1fs", task.id, task.timeout)
