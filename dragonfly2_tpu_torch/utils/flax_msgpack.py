"""The flax msgpack params layout, written and read without flax.

dragonfly2_tpu publishes params as ``flax.serialization.msgpack_serialize``
of a dict tree of numpy leaves (registry/bucket.py). This module encodes
and decodes that exact byte layout so the two packages share one model
registry:

- dict keys are strings, sorted at every level, and numpy scalars are 0-d
  arrays (the reference passes its tree through ``jax.device_get``, whose
  tree_map rebuilds dicts in sorted key order and turns scalars into
  arrays);
- an ndarray leaf is msgpack ext type 1 whose payload is
  ``packb((shape, dtype.name, raw C-order bytes), use_bin_type=True)``.

Arrays above flax's 2**30-byte chunking threshold are refused, as are
bfloat16 leaves (numpy has no bfloat16 without ml_dtypes).
"""

from __future__ import annotations

from typing import Any

import msgpack
import numpy as np
import torch

_EXT_NDARRAY = 1
MAX_LEAF_BYTES = 2**30


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"array leaf of {arr.nbytes} bytes needs flax chunking")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 params leaves are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_pack(x: Any) -> Any:
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _ext_unpack(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    raise ValueError(f"unsupported msgpack ext type {code} in a params blob")


def _canonical(tree: Any) -> Any:
    """What ``jax.device_get`` hands flax: sorted-key dicts, numpy scalars
    as 0-d arrays; torch tensors are copied to host numpy."""
    if isinstance(tree, dict):
        return {str(k): _canonical(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.generic):
        return np.asarray(tree)
    return tree


def serialize(tree: Any) -> bytes:
    """Byte-identical to ``flax.serialization.msgpack_serialize(jax.device_get(tree))``
    for a dict tree of array leaves."""
    return msgpack.packb(_canonical(tree), default=_ext_pack, strict_types=True)


def restore(blob: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: a dict tree of numpy leaves."""
    tree = msgpack.unpackb(blob, ext_hook=_ext_unpack, raw=False)
    if _is_chunked(tree):
        raise ValueError("chunked array leaves (flax arrays over 2**30 bytes) are not supported")
    return tree


def _is_chunked(tree: Any) -> bool:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            return True
        return any(_is_chunked(v) for v in tree.values())
    return False
