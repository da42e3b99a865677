"""Build the port's CUDA sources and their host launcher, and load the launcher.

Each ``csrc/<name>.cu`` exposes a plain C interface (declared in
``csrc/flash_entries.h``) and is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``_build/lib<name>-<hash>.so``. A source whose entries
sit under ``DFLY_IN_PART(i)`` compiles in parts, one ``nvcc -c`` a part
with ``-DDFLY_PART=i``, all started with the other sources, and its parts'
objects link into its one library: the build's wall is its slowest
compile, so a source of many kernels is split. The hash covers
the source, every header it includes from ``csrc/`` (the ``#include "..."``
lines, followed through the headers), the flags and the compiler path, so
an edited source or header builds anew and an unchanged one is reused.

``csrc/flash_launch.cpp`` is the host launcher through which ops/flash.py
makes every launch: a CPython extension module compiled by ``g++``
against PyTorch's per-operator headers (never ``torch/extension.h``) and
Python's, and linked to the kernel libraries (found beside it through an
rpath of ``$ORIGIN``) and to PyTorch's, into
``_build/libflash_launch-<hash>.so``. Its hash also covers the PyTorch
version, the C++ ABI flag and the kernel libraries' names, which hold their
own hashes. Its object compiles together with the kernel sources; the link
follows them.

The build happens at first use, on the machine with the card, and a failed
one raises; nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import pathlib
import re
import shutil
import subprocess
import sysconfig
import threading
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LAUNCHER = "flash_launch"  # csrc/flash_launch.cpp
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-w")
# PyTorch's and the CUDA runtime's libraries the launcher calls into
LAUNCHER_LIBS = ("-lc10", "-lc10_cuda", "-ltorch_cpu", "-ltorch_python", "-lcudart")

_lock = threading.Lock()
_launcher = None
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_PART = re.compile(rb"DFLY_IN_PART\((\d+)\)")


def nvcc_path() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels build on the GPU machine")


def cxx_path() -> str:
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: it builds the kernels' host launcher")
    return compiler


def kernel_sources() -> list[str]:
    """The kernel sources, ``csrc/<name>.cu``, by name."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def source_parts(name: str) -> int:
    """The parts ``csrc/<name>.cu`` compiles in: one more than the highest
    ``DFLY_IN_PART`` index it names, 1 where it names none."""
    found = _PART.findall((CSRC_DIR / f"{name}.cu").read_bytes())
    return max((int(i) for i in found), default=0) + 1


def _source_files(name: str) -> list[pathlib.Path]:
    """``csrc/<name>.cu`` (``.cpp`` for the launcher) and the csrc files it
    includes with quotes, directly or through another such header, each
    once, in the order first met."""
    files, pending = [], [CSRC_DIR / (f"{name}.cpp" if name == LAUNCHER else f"{name}.cu")]
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


def _hashed_path(name: str, *settings) -> pathlib.Path:
    """``_build/lib<name>-<hash>.so``, the hash over the source, the csrc
    headers it includes and ``settings``."""
    digest = hashlib.sha256()
    for path in _source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(repr(settings).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _library_path(name: str, nvcc: str) -> pathlib.Path:
    return _hashed_path(name, NVCC_FLAGS, nvcc)


def launcher_flags(kernel_libraries: list[pathlib.Path]) -> tuple[list[str], list[str]]:
    """(compile flags, link flags) of the launcher: PyTorch's include dirs
    with the CUDA runtime's and Python's, PyTorch's C++ ABI, and a link to
    the kernel libraries by name with an rpath of ``$ORIGIN`` (they sit
    beside it) and to PyTorch's and the CUDA runtime's libraries."""
    import torch
    from torch.utils import cpp_extension

    python_include = sysconfig.get_paths()["include"]
    if not os.path.isfile(os.path.join(python_include, "Python.h")):
        raise RuntimeError(f"Python.h not found in {python_include}: the launcher is a CPython "
                           "extension module and needs Python's headers")
    includes = [*cpp_extension.include_paths(device_type="cuda"), python_include]
    compile_flags = [*CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
                     *(f"-I{d}" for d in includes)]
    link_flags = ["-shared", f"-L{BUILD_DIR}", *(f"-l:{p.name}" for p in kernel_libraries),
                  "-Wl,-rpath,$ORIGIN",
                  *(f"-L{d}" for d in cpp_extension.library_paths(device_type="cuda")),
                  *LAUNCHER_LIBS]
    return compile_flags, link_flags


def _launcher_path(cxx: str, flags: tuple[list[str], list[str]]) -> pathlib.Path:
    import torch

    return _hashed_path(LAUNCHER, flags, cxx, torch.__version__,
                        bool(torch._C._GLIBCXX_USE_CXX11_ABI))


def _launcher_build():
    """(path, compile command, link command) of the launcher; the compile
    writes an object file beside the path, the link a temporary file."""
    cxx, nvcc = cxx_path(), nvcc_path()
    flags = launcher_flags([_library_path(name, nvcc) for name in kernel_sources()])
    path = _launcher_path(cxx, flags)
    obj = path.with_name(f"{path.name}.{os.getpid()}.o")
    compile_cmd = [cxx, *flags[0], "-c", str(CSRC_DIR / f"{LAUNCHER}.cpp"), "-o", str(obj)]
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    link_cmd = [cxx, str(obj), *flags[1], "-o", str(tmp)]
    return path, compile_cmd, link_cmd


def _run_together(commands: dict[str, list[str]], reports: dict) -> dict[str, int]:
    """Start every command at once and wait for all; each one's output and
    seconds go to ``reports``. Returns each one's exit code."""
    start, procs, codes = time.perf_counter(), {}, {}
    for name, cmd in commands.items():
        log = pathlib.Path(f"{_output(cmd)}.log")  # beside what the command writes
        with open(log, "w") as sink:
            procs[name] = (subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT), log)
    while procs:
        for name, (proc, log) in list(procs.items()):
            if proc.poll() is not None:
                codes[name] = proc.returncode
                reports[name] = (log.read_text(), time.perf_counter() - start)
                log.unlink()
                del procs[name]
        time.sleep(0.02)
    return codes


def _output(cmd: list[str]) -> pathlib.Path:
    """The file a compile or link command writes (its "-o")."""
    return pathlib.Path(cmd[cmd.index("-o") + 1])


def part_name(name: str, part: int) -> str:
    """The report key of part ``part`` of a source compiled in parts."""
    return f"{name}#{part}"


def build_all(names: list[str]) -> dict[str, tuple[str, float]]:
    """Build every named source that is not built yet (the kernel sources
    by name, the launcher as LAUNCHER; naming the launcher builds every
    kernel source too): one nvcc process per kernel source, or per part of
    one compiled in parts, and g++ for the launcher's object, all started
    together; then the parts' links, then the launcher's. Raises if any
    step fails. Returns each one's compiler report (ptxas registers, shared
    memory and spills for a kernel source, its parts' reports in turn) and
    seconds (a source in parts: its slowest part's and its link's; the
    launcher's: its compile's and its link's), ("", 0.0) for one already
    built; and, under ``part_name(name, i)``, each part's own."""
    nvcc = nvcc_path()
    if LAUNCHER in names:
        names = sorted(set(names) | set(kernel_sources()))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiles = {}  # step -> command; its output is the file after "-o"
    links = {}  # name -> (the steps it links, link command, the built file)
    for name in names:
        if name == LAUNCHER:
            path, cmd, link_cmd = _launcher_build()
            if not path.exists():
                compiles[name] = cmd
                links[name] = ([name], link_cmd, path)
            continue
        path = _library_path(name, nvcc)
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        source = str(CSRC_DIR / f"{name}.cu")
        parts = source_parts(name)
        if parts == 1:
            compiles[name] = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), source]
            links[name] = ([], None, path)
            continue
        steps = [part_name(name, i) for i in range(parts)]
        for i, step in enumerate(steps):
            obj = path.with_name(f"{path.name}.{os.getpid()}.{i}.o")
            compiles[step] = [nvcc, *NVCC_FLAGS, f"-DDFLY_PART={i}", "-c", "-o", str(obj), source]
        objs = [str(_output(compiles[step])) for step in steps]
        links[name] = (steps, [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs], path)
    reports = {name: ("", 0.0) for name in names}
    codes = _run_together(compiles, reports)
    failed = [f"{step}: {cmd[0]} exited {codes[step]}\n{reports[step][0]}"
              for step, cmd in compiles.items() if codes[step] != 0]
    # the parted sources' links together, then the launcher's, which needs
    # every library
    for batch in ([n for n in links if n != LAUNCHER], [n for n in links if n == LAUNCHER]):
        ready = {n: links[n][1] for n in batch if links[n][1] is not None
                 and all(codes[step] == 0 for step in links[n][0])}
        if LAUNCHER in batch and failed:
            ready = {}
        link_reports: dict = {}
        link_codes = _run_together(ready, link_reports)
        for n in batch:
            steps, cmd, path = links[n]
            if cmd is None:  # compiled and linked in one step
                out, ok = _output(compiles[n]), codes[n] == 0
            else:
                out, ok = _output(cmd), link_codes.get(n) == 0
                if n in ready:
                    log = "".join(reports[step][0] for step in steps) + link_reports[n][0]
                    reports[n] = (log, max(reports[step][1] for step in steps)
                                  + link_reports[n][1])
                    if not ok:
                        failed.append(f"{n}: link exited {link_codes[n]}\n{link_reports[n][0]}")
            for step in steps:  # the objects the link read
                _output(compiles[step]).unlink(missing_ok=True)
            if ok:
                os.replace(out, path)
            else:
                out.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def launcher():
    """The launcher module, building it and the kernel libraries it links
    at first use."""
    global _launcher
    if _launcher is None:
        with _lock:
            if _launcher is None:
                build_all([LAUNCHER])
                path = _launcher_build()[0]
                loader = importlib.machinery.ExtensionFileLoader(LAUNCHER, str(path))
                spec = importlib.util.spec_from_file_location(LAUNCHER, path, loader=loader)
                module = importlib.util.module_from_spec(spec)
                loader.exec_module(module)
                _launcher = module
    return _launcher
