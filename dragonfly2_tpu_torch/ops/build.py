"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``, where
the hash covers the source, every header it includes from ``csrc/`` (the
``#include "..."`` lines, followed through the headers), the flags and the
compiler path, so an edited source or header builds anew and an unchanged
one is reused. The build happens at
first use, on the machine with the card; nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def nvcc_path() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels build on the GPU machine")


def _source_files(name: str) -> list[pathlib.Path]:
    """``csrc/<name>.cu`` and the csrc files it includes with quotes,
    directly or through another such header, each once, in the order
    first met."""
    files, pending = [], [CSRC_DIR / f"{name}.cu"]
    while pending:
        path = pending.pop(0)
        if path in files:
            continue
        files.append(path)
        for include in _LOCAL_INCLUDE.findall(path.read_bytes()):
            header = path.parent / include.decode()
            if header.is_file():
                pending.append(header)
    return files


def _library_path(name: str, nvcc: str) -> pathlib.Path:
    digest = hashlib.sha256()
    for path in _source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(repr((NVCC_FLAGS, nvcc)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: list[str]) -> dict[str, str]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together; raises if any compile fails. Returns
    each source's compiler report (ptxas registers, shared memory and
    spills), empty for a source that was already built."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name, nvcc) for name in names}
    procs, logs = {}, {name: "" for name in names}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = _loaded[name] = ctypes.CDLL(str(_library_path(name, nvcc_path())))
        return lib
