"""Standard directory layout per service.

Capability parity with pkg/dfpath (workHome, cacheDir, dataDir, pluginDir,
logDir, lock files), rooted at an overridable base so tests and the
mini-cluster harness can isolate per-process state.

Port of dragonfly2_tpu/utils/dfpath.py, whole.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib


@dataclasses.dataclass(frozen=True)
class Paths:
    work_home: pathlib.Path
    cache_dir: pathlib.Path
    config_dir: pathlib.Path
    log_dir: pathlib.Path
    data_dir: pathlib.Path
    plugin_dir: pathlib.Path

    def ensure(self) -> "Paths":
        for p in (
            self.work_home,
            self.cache_dir,
            self.config_dir,
            self.log_dir,
            self.data_dir,
            self.plugin_dir,
        ):
            p.mkdir(parents=True, exist_ok=True)
        return self

    def lock_file(self, name: str) -> pathlib.Path:
        return self.work_home / f"{name}.lock"


def new_paths(
    name: str,
    work_home: str | os.PathLike | None = None,
    cache_dir: str | os.PathLike | None = None,
    log_dir: str | os.PathLike | None = None,
    data_dir: str | os.PathLike | None = None,
    plugin_dir: str | os.PathLike | None = None,
) -> Paths:
    """Layout for service `name` (manager/scheduler/trainer/daemon).
    Default base is $DRAGONFLY_TPU_HOME or ~/.dragonfly2-tpu/<name>."""
    base = pathlib.Path(
        os.environ.get("DRAGONFLY_TPU_HOME", pathlib.Path.home() / ".dragonfly2-tpu")
    )
    home = pathlib.Path(work_home) if work_home else base / name
    return Paths(
        work_home=home,
        cache_dir=pathlib.Path(cache_dir) if cache_dir else home / "cache",
        config_dir=home / "config",
        log_dir=pathlib.Path(log_dir) if log_dir else home / "logs",
        data_dir=pathlib.Path(data_dir) if data_dir else home / "data",
        plugin_dir=pathlib.Path(plugin_dir) if plugin_dir else home / "plugins",
    ).ensure()
