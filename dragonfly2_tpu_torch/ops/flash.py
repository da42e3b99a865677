"""Flash attention forward: the wrapper of the Hopper kernel and its plain twin.

Port of dragonfly2_tpu/ops/flash.py's ``flash_attention`` in the mode the
attention ranker serves with: the finished output of the forward kernel
``_flash_kernel`` (flash.py:71, launched at flash.py:340). The kernel is
written by hand in CUDA C++ for sm_90a (csrc/flash_fwd.cu, whose header
gives its design and its bound on an H100) and is built with nvcc at first
use (ops/build.py).

- A CUDA tensor goes to the kernel, or the wrapper raises.
- A CPU tensor goes to ``flash_attention_plain``, which is
  parallel/ring.py's ``dense_attention``: the same function with the same
  masking contract, and the kernel's oracle on the card.

The save_lse and partial modes, the backward kernels and the autograd
function are not ported yet.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from dragonfly2_tpu_torch.ops import build
from dragonfly2_tpu_torch.parallel.ring import dense_attention

KERNEL = "flash_fwd"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

# kernel launches made by flash_attention in this process; only the line
# that launches adds to it (under a lock: the inference server launches
# from worker threads)
LAUNCHES = 0
_launches_lock = threading.Lock()

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load(KERNEL)
        lib.dfly_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.dfly_flash_fwd.restype = ctypes.c_int
        lib.dfly_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dfly_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def warps_for(length: int) -> int:
    """Query warps per block (16 rows each): no idle warps on short sets."""
    return 1 if length <= 16 else (2 if length <= 32 else 4)


def _check(q, k, v, kv_mask) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash attention takes equal [B, H, L, D] q/k/v, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention takes bf16 or float32 q/k/v of one dtype, got "
            f"{q.dtype} {k.dtype} {v.dtype}"
        )
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    tensors = [q, k, v]
    if kv_mask is not None:
        b, _, l, _ = q.shape
        if kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (b, l):
            raise ValueError(
                f"kv_mask must be bool [{b}, {l}], got {kv_mask.dtype} {tuple(kv_mask.shape)}"
            )
        tensors.append(kv_mask)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention operands must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention operands must be contiguous")


def flash_attention_plain(q, k, v, kv_mask=None, causal: bool = False) -> torch.Tensor:
    """The kernel's plain version: dense attention, kv_mask=None meaning
    every key is valid."""
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[0], q.shape[2], dtype=torch.bool, device=q.device)
    return dense_attention(q, k, v, kv_mask, causal)


def flash_attention(q, k, v, kv_mask=None, causal: bool = False) -> torch.Tensor:
    """Attention over [B, H, L, D] with an optional [B, L] bool key mask.

    Drop-in for dense_attention and for models/attention.py's injectable
    attention_fn: invalid keys contribute nothing and fully masked rows
    return 0. Output has q's dtype."""
    _check(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    b, h, l, d = q.shape
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    if any(t.data_ptr() % 16 for t in (q, k, v, o)):
        raise ValueError("flash attention operands must be 16-byte aligned")
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dfly_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), o.data_ptr(),
            b, h, l, d, int(causal), _DTYPE_CODES[q.dtype], warps_for(l), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: {lib.dfly_cuda_error_string(err).decode()} ({err})"
        )
    global LAUNCHES
    with _launches_lock:
        LAUNCHES += 1
    return o
