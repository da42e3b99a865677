"""Build metadata — capability parity with version/version.go (Major/
Minor/GitVersion/GitCommit/Platform + the per-service `version` metric
gauge every reference service exports, e.g. scheduler/metrics/
metrics.go:273-280).

Port of dragonfly2_tpu/version.py. Where the reference's build reports
its device library, this one reports PyTorch's version and the CUDA
version PyTorch was built with (``"none"`` for a CPU-only build), both in
``version_info()`` and as labels of the version gauge.
"""

from __future__ import annotations

import platform as _platform

MAJOR = "2"
MINOR = "2"
GIT_VERSION = "v2.2.0-torch"
GIT_COMMIT = "unknown"
BUILD_PLATFORM = f"{_platform.system().lower()}/{_platform.machine()}"


def _torch_versions() -> tuple[str, str]:
    import torch

    return str(torch.__version__), str(torch.version.cuda or "none")


def version() -> str:
    return GIT_VERSION


def version_info() -> dict:
    torch_version, cuda_version = _torch_versions()
    return {
        "major": MAJOR,
        "minor": MINOR,
        "git_version": GIT_VERSION,
        "git_commit": GIT_COMMIT,
        "platform": BUILD_PLATFORM,
        "torch_version": torch_version,
        "cuda_version": cuda_version,
    }


def register_version_gauge(registry, service: str) -> None:
    """dragonfly_<service>_version{major,minor,git_version,git_commit,
    platform,torch_version,cuda_version} = 1 — the reference's BuildInfo
    gauge."""
    torch_version, cuda_version = _torch_versions()
    gauge = registry.gauge(
        f"dragonfly_{service}_version",
        "build metadata",
        ("major", "minor", "git_version", "git_commit", "platform",
         "torch_version", "cuda_version"),
    )
    gauge.labels(MAJOR, MINOR, GIT_VERSION, GIT_COMMIT, BUILD_PLATFORM,
                 torch_version, cuda_version).set(1)
