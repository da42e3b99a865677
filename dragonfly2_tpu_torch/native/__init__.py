"""Native host kernels through ctypes: the DAG reachability queries, the
trace store's numeric CSV parse and the hash ring's FNV-1a 64 hashes and
ring picks.

The port's own loader for the repository's ``native/dfnative.cpp`` (used
as it is, read-only), after dragonfly2_tpu/native/__init__.py. The source
is compiled once with g++ into ``dragonfly2_tpu_torch/_build/``, under a
name that carries a hash of the source and the flags, and loaded with
ctypes, on the first call that needs it (a blocking build). These are
host-side C++ functions of the DAG's mutation path and of records/storage.py's ``numeric_matrix``, not
device kernels: where the library cannot be built or loaded, graph/dag.py
keeps its own numpy BFS, storage.py its csv-module parse and
utils/hashring.py the pure-Python FNV-1a 64 and numpy bisect below, which
are the same host semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "dfnative.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_MASK64 = 0xFFFFFFFFFFFFFFFF

_lock = threading.Lock()  # serializes the build and the load
_lib: ctypes.CDLL | None = None
_tried = False


def _lib_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libdfnative-{digest}.so"


def _build(path: pathlib.Path) -> bool:
    """g++ the source into path (via a temporary file and an atomic
    rename, so processes building at once race harmlessly)."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("dfnative build failed to run: %s", e)
        return False
    if proc.returncode != 0:
        logger.warning("dfnative build failed:\n%s", proc.stderr)
        return False
    os.replace(tmp, path)
    return True


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.df_fnv1a64.argtypes = [u8p, ctypes.c_int64]
    lib.df_fnv1a64.restype = ctypes.c_uint64
    lib.df_fnv1a64_batch.argtypes = [u8p, i64p, ctypes.c_int64, u64p]
    lib.df_fnv1a64_batch.restype = None
    lib.df_ring_pick_batch.argtypes = [u64p, ctypes.c_int64, u64p, ctypes.c_int64, i64p]
    lib.df_ring_pick_batch.restype = None
    lib.df_dag_reachable.argtypes = [u64p] + [ctypes.c_int64] * 4
    lib.df_dag_reachable.restype = ctypes.c_int32
    lib.df_dag_reachable_batch.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_int64, i32p,
    ]
    lib.df_dag_reachable_batch.restype = None
    lib.df_csv_parse_numeric.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ]
    lib.df_csv_parse_numeric.restype = ctypes.c_int64
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built now if needed (blocking, once), or None
    when it cannot be built or loaded (callers take the numpy path)."""
    ensure_built()
    return _lib


def ensure_built() -> bool:
    """Build and load the library if that has not been tried yet; True
    when it is loaded. A failed build or load is not retried."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib is not None
        _tried = True
        try:
            path = _lib_path()
            if not path.exists() and not _build(path):
                return False
            _lib = _declare(ctypes.CDLL(str(path)))
            return True
        except OSError as e:
            logger.warning("dfnative unavailable: %s", e)
            return False


def available() -> bool:
    return ensure_built()


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64 of `data` — native when available, else pure Python.
    Both paths are the exact same function, so ring placements agree
    across mixed fleets."""
    lib = get_lib()
    if lib is not None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else (ctypes.c_uint8 * 1)()
        return int(lib.df_fnv1a64(buf, len(data)))
    h = 0xCBF29CE484222325
    for byte in data:
        h ^= byte
        h = (h * 0x100000001B3) & _MASK64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK64
    h ^= h >> 33
    return h


def fnv1a64_batch(keys: list[bytes]) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return np.asarray([fnv1a64(k) for k in keys], np.uint64)
    buf = b"".join(keys)
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    out = np.zeros(len(keys), np.uint64)
    cbuf = (ctypes.c_uint8 * max(len(buf), 1)).from_buffer_copy(buf or b"\0")
    lib.df_fnv1a64_batch(cbuf, _as_ptr(offsets, ctypes.c_int64), len(keys), _as_ptr(out, ctypes.c_uint64))
    return out


def ring_pick_batch(ring_hashes: np.ndarray, key_hashes: np.ndarray) -> np.ndarray:
    """For each key hash, index into the sorted ring (bisect semantics)."""
    ring_hashes = np.ascontiguousarray(ring_hashes, np.uint64)
    key_hashes = np.ascontiguousarray(key_hashes, np.uint64)
    out = np.zeros(key_hashes.shape[0], np.int64)
    lib = get_lib()
    if lib is None:
        idx = np.searchsorted(ring_hashes, key_hashes, side="right")
        return idx % len(ring_hashes)
    lib.df_ring_pick_batch(
        _as_ptr(ring_hashes, ctypes.c_uint64), len(ring_hashes),
        _as_ptr(key_hashes, ctypes.c_uint64), len(key_hashes),
        _as_ptr(out, ctypes.c_int64),
    )
    return out


def dag_reachable(adj: np.ndarray, src: int, dst: int) -> bool | None:
    """Native BFS over the TaskDAG bit matrix; None when unavailable.

    Vertex ids are bounds-checked HERE: the C++ function indexes the bit
    matrix unchecked, so an out-of-range id would be a heap write."""
    lib = get_lib()
    if lib is None:
        return None
    adj = np.ascontiguousarray(adj, np.uint64)
    capacity, words = adj.shape
    if not (0 <= src < capacity and 0 <= dst < capacity):
        raise ValueError(f"vertex out of range [0, {capacity}): src={src} dst={dst}")
    result = lib.df_dag_reachable(_as_ptr(adj, ctypes.c_uint64), capacity, words, src, dst)
    if result < 0:
        return None  # native-side allocation failure
    return bool(result)


def dag_reachable_batch(adj: np.ndarray, srcs: np.ndarray, dsts: np.ndarray
                        ) -> np.ndarray | None:
    """N reachability queries in ONE native call; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    adj = np.ascontiguousarray(adj, np.uint64)
    srcs = np.ascontiguousarray(srcs, np.int64)
    dsts = np.ascontiguousarray(dsts, np.int64)
    if srcs.shape != dsts.shape or srcs.ndim != 1:
        raise ValueError("srcs/dsts must be equal-length 1-D arrays")
    capacity, words = adj.shape
    # bounds-check BEFORE the native call (unchecked indexing there)
    if srcs.shape[0] and not (
        (srcs >= 0).all() and (srcs < capacity).all()
        and (dsts >= 0).all() and (dsts < capacity).all()
    ):
        raise ValueError(f"vertex out of range [0, {capacity}) in batch query")
    out = np.empty(srcs.shape[0], np.int32)
    lib.df_dag_reachable_batch(
        _as_ptr(adj, ctypes.c_uint64), capacity, words,
        _as_ptr(srcs, ctypes.c_int64), _as_ptr(dsts, ctypes.c_int64),
        srcs.shape[0], _as_ptr(out, ctypes.c_int32),
    )
    if (out < 0).any():
        return None  # native-side allocation failure
    return out.astype(bool)


def csv_parse_numeric(data: bytes, n_cols: int, skip_header: bool = True,
                      max_rows: int | None = None) -> np.ndarray | None:
    """Parse CSV bytes into an (rows, n_cols) float64 matrix; non-numeric
    fields become NaN. None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if max_rows is None:
        max_rows = data.count(b"\n") + 1
    out = np.empty((max(max_rows, 1), n_cols), np.float64)
    rows = lib.df_csv_parse_numeric(
        data, len(data), n_cols, 1 if skip_header else 0,
        _as_ptr(out, ctypes.c_double), max_rows,
    )
    if rows < 0:
        return None
    return out[:rows]
