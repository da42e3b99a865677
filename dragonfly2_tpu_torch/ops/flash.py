"""Flash attention: the wrappers of the Hopper kernels and their plain twins.

Port of dragonfly2_tpu/ops/flash.py's ``flash_attention`` and its
``custom_vjp`` (flash.py:681-697), and of ``flash_attention_partials``
(flash.py:711). Every TPU kernel of that file is ported, each written by
hand in CUDA C++ for sm_90a and built with nvcc at first use
(ops/build.py); each source's header gives its design and its bound on an
H100:

- ``_flash_kernel`` (flash.py:71) in its finished-output mode ->
  csrc/flash_fwd.cu ``dfly_flash_fwd`` (serving, eval);
- the same kernel in its ``save_lse`` mode (flash.py:186-197) ->
  csrc/flash_fwd.cu ``dfly_flash_fwd_lse`` (training forward);
- the same kernel in its ``partial`` mode (flash.py:93-94,177-184) ->
  csrc/flash_fwd.cu ``dfly_flash_fwd_partial`` (ring attention's blocks);
- ``_flash_bwd_dkv_kernel`` (flash.py:418) and ``_flash_bwd_dq_kernel``
  (flash.py:474) -> csrc/flash_bwd.cu ``dfly_flash_bwd_dkv`` and
  ``dfly_flash_bwd_dq`` (training backward).

Every one of them has these instances: the mma.sync ones above at the head
dims of ``HEAD_DIMS``; the wide mma.sync ones for any head dim above 128 in
the same two sources (``*_wide``); Hopper redesigns with TMA, wgmma and a
ring of dynamic shared memory for long sequences at ``HEAD_DIMS``,
csrc/flash_fwd_sm90.cu (``dfly_flash_fwd_sm90``,
``dfly_flash_fwd_lse_sm90``, ``dfly_flash_fwd_partial_sm90``),
csrc/flash_bwd_dkv_sm90.cu (``dfly_flash_bwd_dkv_sm90``) and
csrc/flash_bwd_dq_sm90.cu (``dfly_flash_bwd_dq_sm90``); and wide Hopper
ones of the forward (three modes), of dK/dV and of dQ for head dims in
(128, 256], ``*_wide_sm90`` in the same sources. The wide mma.sync forward
packs short sets into its blocks for head dims up to 256 at L up to 32,
scores each key tile once for head dims in (256, 512] and splits D into
256-column chunks only above; the wide mma.sync dK/dV and dQ compute every
column of their rows in one pass for head dims in (128, 512] and split D
into chunks only above (the C sides pick those kernels from L and D). The
head dim and ``_sm90_path`` pick one from the shape and dtype alone; a
refused launch raises, it never falls back to another.

Every launch goes through one compiled host launcher,
csrc/flash_launch.cpp (built with the kernels by ops/build.py), called at
one site, ``_launch``: Python routes the call to an instance and the
launcher checks the operands, allocates the outputs, enters the device and
launches on its current stream, in C++: at the ranker's short sets these
steps, not the kernels, set a call's time (PERF.md).

Every wrapper launches its kernel on a CUDA tensor, or raises; on a CPU
tensor it takes the kernel's plain version, and only then. Each function
has a launch counter (``LAUNCHES``, ``LSE_LAUNCHES``, ``PARTIAL_LAUNCHES``,
``DKV_LAUNCHES``, ``DQ_LAUNCHES``) that counts its launches of any
instance, and each Hopper and wide instance one more (``FWD_SM90_LAUNCHES``,
``LSE_SM90_LAUNCHES``, ``PARTIAL_SM90_LAUNCHES``, ``DKV_SM90_LAUNCHES``,
``DQ_SM90_LAUNCHES``; ``FWD_WIDE_LAUNCHES`` .. ``DQ_WIDE_LAUNCHES``;
``FWD_WIDE_SM90_LAUNCHES``, ``LSE_WIDE_SM90_LAUNCHES``,
``PARTIAL_WIDE_SM90_LAUNCHES``, ``DKV_WIDE_SM90_LAUNCHES``,
``DQ_WIDE_SM90_LAUNCHES``); only the lines launching add to them.

``flash_attention`` is the public entry. With autograd recording and an
input that requires grad it runs ``FlashAttention`` (forward with lse,
backward through the two backward kernels); otherwise, as under
``torch.inference_mode()`` on the serving path, one finished-output
forward. ``flash_attention_partials`` is forward-only, as in the
reference: under autograd it raises.

Head dims: the reference takes any D, and so does the port. On the CPU the
plain versions take any D. On CUDA the shape alone decides, before any
launch (``_kernel_dim``): a D in ``HEAD_DIMS`` (16, 32, 64, 128) goes to
its instances; a D above 128 with D % 8 == 0 goes to the wide instances as
it is, which read the head dim at run time (16-byte row vectors, columns
past D zeroed in shared memory, stores stopping at D; above 256 dQ
splits D into 256-column chunks, the forward and dK/dV only above 512);
any other D is zero-padded, below 128 to the next of
``HEAD_DIMS``, above it to the next multiple of 8. A padded call
gives the kernels the softmax scale of the unpadded D (every C entry takes
it) and slices the outputs and gradients back to D. Zero columns add
nothing to q k^T, dO v^T or rowsum(dO o), so the padded call computes the
unpadded function, and nothing is rounded on the way. No D is refused, and
a CUDA tensor never runs a plain version; a refused launch raises.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.ops import build
from dragonfly2_tpu_torch.parallel.ring import dense_attention
from dragonfly2_tpu_torch.telemetry import costcard as _costcard

HEAD_DIMS = (16, 32, 64, 128)  # the mma.sync and Hopper instances
# the wide instances take any D above HEAD_DIMS[-1] with D % 8 == 0; their
# Hopper ones, of the forward, dK/dV and dQ, D up to WIDE_SM90_MAX_DIM
WIDE_SM90_MAX_DIM = 256
_DTYPES = (torch.bfloat16, torch.float32)
_NEG = -1e30
_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)

# kernel launches made in this process, one counter per kernel; only the
# line that launches adds to it (under a lock: the inference server
# launches from worker threads)
LAUNCHES = 0  # finished-output forward
LSE_LAUNCHES = 0  # forward with lse
PARTIAL_LAUNCHES = 0  # forward, partial mode
DKV_LAUNCHES = 0  # backward, dK/dV
DQ_LAUNCHES = 0  # backward, dQ
# of those, the launches of the Hopper (TMA + wgmma) instances
FWD_SM90_LAUNCHES = 0
LSE_SM90_LAUNCHES = 0
PARTIAL_SM90_LAUNCHES = 0
DKV_SM90_LAUNCHES = 0
DQ_SM90_LAUNCHES = 0
# and those of the wide mma.sync instances (head dims above 128)
FWD_WIDE_LAUNCHES = 0
LSE_WIDE_LAUNCHES = 0
PARTIAL_WIDE_LAUNCHES = 0
DKV_WIDE_LAUNCHES = 0
DQ_WIDE_LAUNCHES = 0
# and those of the wide Hopper (TMA + wgmma) instances
FWD_WIDE_SM90_LAUNCHES = 0
LSE_WIDE_SM90_LAUNCHES = 0
PARTIAL_WIDE_SM90_LAUNCHES = 0
DKV_WIDE_SM90_LAUNCHES = 0
DQ_WIDE_SM90_LAUNCHES = 0
_launches_lock = threading.Lock()

# The Hopper instances take bf16 at L above this. Shorter sets (the
# ranker's 10-20 candidates) and float32 (which TMA cannot round to bf16 on
# the way in) keep the mma.sync instances. Set from both instances' device
# times of the forward, dK/dV and dQ on an H100 (python3 chip_smoke.py
# --threshold, PERF.md): at the trained batch [256, 4, L, 32] the mma.sync
# ones win up to L = 64 (one 128-row Hopper block is mostly padding there)
# and lose from L = 96.
SM90_MIN_L = 64
# At L up to this the mma.sync forward (three modes), dK/dV and dQ C sides
# launch their packed-sets kernels, whose blocks take whole consecutive
# sets of the flattened [B H L, D] rows (flash_fwd_sets_kernel,
# flash_bwd_dkv_sets_kernel and flash_bwd_dq_sets_kernel, csrc/flash_fwd.cu
# and csrc/flash_bwd.cu, where SETS_MAX_L decides); the mirror names them
# for the profiler.
SETS_MAX_L = 32
# The wide Hopper instances take bf16 at a wide head dim up to 256: the
# forward (all three modes) at L above WIDE_SM90_MIN_L, dK/dV at L above
# WIDE_DKV_SM90_MIN_L, dQ at L above WIDE_DQ_SM90_MIN_L. Set from both wide
# instances' device times at D = 192 and 256 (python3 chip_smoke.py
# --threshold, PERF.md): the mma.sync forward wins at L = 16-32 (a 64-row
# Hopper block holds one set of L rows) and loses from L = 64; the one-pass
# mma.sync dK/dV wins at L = 16-32 and the Hopper one leads from L = 48
# (at both D; the two trade places at 64-96, Hopper leads again from 128);
# the one-pass dQ wins up to 32. The ranker's sets (L = 20) keep the three
# mma.sync ones.
WIDE_SM90_MIN_L = 32
WIDE_DKV_SM90_MIN_L = 32
WIDE_DQ_SM90_MIN_L = 32

# The instances, as the launcher (csrc/flash_launch.cpp) numbers them; the
# mma.sync one also takes its warps (``warps_for``).
MMA_SYNC, WIDE, SM90, WIDE_SM90 = 0, 1, 2, 3
# each kind of launch (a function of the launcher): its mma.sync C entry,
# its counter and the prefix of its other instances' counters
_KINDS = {
    "fwd": ("dfly_flash_fwd", "LAUNCHES", "FWD"),
    "lse": ("dfly_flash_fwd_lse", "LSE_LAUNCHES", "LSE"),
    "partial": ("dfly_flash_fwd_partial", "PARTIAL_LAUNCHES", "PARTIAL"),
    "dkv": ("dfly_flash_bwd_dkv", "DKV_LAUNCHES", "DKV"),
    "dq": ("dfly_flash_bwd_dq", "DQ_LAUNCHES", "DQ"),
}
_SUFFIXES = {MMA_SYNC: "", WIDE: "_wide", SM90: "_sm90", WIDE_SM90: "_wide_sm90"}
# (kind, instance) -> (C entry, the counters its launch adds to)
_ROUTES = {
    (kind, instance): (base + suffix,
                       (total,) if instance == MMA_SYNC
                       else (total, f"{part}{suffix.upper()}_LAUNCHES"))
    for kind, (base, total, part) in _KINDS.items() for instance, suffix in _SUFFIXES.items()
}
# C entry -> (kind, instance): the 20 entries the launcher calls
ENTRIES = {name: route for route, (name, _) in _ROUTES.items()}


def _launch(name: str, q, *args):
    """Launch C entry ``name`` through the compiled launcher (built by
    ops/build.py at first use): it checks q and the other operands, raises
    ValueError or TypeError for what the kernels do not take, allocates the
    outputs on q's device, launches on that device's current stream and
    raises RuntimeError if the launch is refused. Returns the outputs. The
    one call site of every launch."""
    kind, instance = ENTRIES[name]
    return getattr(build.launcher(), kind)(instance, q, *args)


def _kernel(kind: str, q, *args):
    """The launch of ``kind`` ("fwd", "lse", "partial", "dkv", "dq") at the
    instance q's shape and dtype select, with the kind's other operands,
    and its counters; returns the outputs. An empty q launches nothing."""
    _, _, l, d = q.shape
    instance = WIDE if _is_wide(d) else MMA_SYNC
    if _sm90_path(l, d, q.dtype, kind):
        instance += SM90
    name, counters = _ROUTES[kind, instance]
    outputs = _launch(name, q, *args, warps_for(l))
    if q.numel():
        _count(*counters)
        if _costcard.COUNTING:
            _count_cost(kind, name, q, args, outputs)
    return outputs


def _count_cost(kind: str, name: str, q, args, outputs) -> None:
    """A launch inside a cost-card count (telemetry/costcard.py) adds its
    PERF.md §6 bound: ``KERNEL_OPS_PER_PAIR[kind]`` · D operations a
    (query, key) pair this call's mask and causality leave valid, and its
    inputs read and outputs written once. The count is worked out outside
    the counting mode."""
    count = _costcard.active_count()
    if count is None:
        return
    with _costcard.uncounted():
        b, h, l, d = q.shape
        if kind in ("dkv", "dq"):  # (k, v, do, lse, delta, kv_mask, causal, scale)
            kv_mask, causal = args[5], args[6]
        else:  # (k, v, kv_mask, causal, scale), partial without causal
            kv_mask, causal = args[2], kind != "partial" and args[3]
        pairs = h * int(_valid_pairs(kv_mask, causal, b, l, q.device).sum())
        outs = outputs if isinstance(outputs, (tuple, list)) else (outputs,)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (q, *args, *outs) if isinstance(t, torch.Tensor))
    count.kernel(name, _costcard.KERNEL_OPS_PER_PAIR[kind] * d * pairs, nbytes)


def _count(*counters: str) -> None:
    with _launches_lock:
        for counter in counters:
            globals()[counter] += 1


def warps_for(length: int) -> int:
    """Warps per block (16 rows each) of the mma.sync instances: no idle
    warps on short sets."""
    return 1 if length <= 16 else (2 if length <= 32 else 4)


def _sm90_path(length: int, head_dim: int, dtype: torch.dtype, kernel: str = "fwd") -> bool:
    """Whether ``kernel`` ("fwd", "lse" or "partial" for the forward's
    three modes, "dkv", "dq") takes its Hopper instance: bf16 at L above
    SM90_MIN_L at the head dims of HEAD_DIMS, and at a wide head dim up to
    WIDE_SM90_MAX_DIM above WIDE_SM90_MIN_L (the forward),
    WIDE_DKV_SM90_MIN_L (dK/dV) or WIDE_DQ_SM90_MIN_L (dQ). Shape and dtype
    alone decide."""
    if dtype != torch.bfloat16:
        return False
    if head_dim in HEAD_DIMS:
        return length > SM90_MIN_L
    min_l = (WIDE_DKV_SM90_MIN_L if kernel == "dkv"
             else WIDE_DQ_SM90_MIN_L if kernel == "dq" else WIDE_SM90_MIN_L)
    return (_is_wide(head_dim) and head_dim <= WIDE_SM90_MAX_DIM and head_dim % 8 == 0
            and length > min_l)


def _check(q, k, v, kv_mask) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash attention takes equal [B, H, L, D] q/k/v, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention takes bf16 or float32 q/k/v of one dtype, got "
            f"{q.dtype} {k.dtype} {v.dtype}"
        )
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
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def _kernel_dim(d: int) -> int:
    """The head dim the kernels take for a call at D, from D alone: D itself
    where an instance takes it (HEAD_DIMS, or above 128 a multiple of 8, as
    the wide instances read rows in 16-byte vectors), else the next such
    D, to which the call is zero-padded."""
    if d in HEAD_DIMS or (_is_wide(d) and d % 8 == 0):
        return d
    if d < HEAD_DIMS[-1]:
        return next(x for x in HEAD_DIMS if x >= d)
    return d + (-d) % 8


def _is_wide(d: int) -> bool:
    """Whether head dim D takes the wide instances."""
    return d > HEAD_DIMS[-1]


def _padded_route(q) -> bool:
    """Whether a call at q's head dim takes the padded route, from the
    shape alone: a tensor off the CPU (the kernels' route) whose D is not a
    kernel's (``_kernel_dim``)."""
    d = q.shape[-1]
    return not q.is_cpu and _kernel_dim(d) != d


def _padded(*tensors):
    """The [B, H, L, D] tensors zero-padded from D to ``_kernel_dim(D)``.
    With the softmax scale of D (``_scale``) a kernel computes the unpadded
    function on them."""
    d = tensors[0].shape[-1]
    pad = (0, _kernel_dim(d) - d)
    return [F.pad(t, pad) for t in tensors]


def _scale(q) -> float:
    """The softmax scale of a call at q's head dim, 1/sqrt(D): what the
    kernels get, at the padded head dim too."""
    return 1.0 / math.sqrt(q.shape[-1])


def _need_cuda(q) -> None:
    """The kernels' route takes CUDA tensors; the launcher checks the rest."""
    if not q.is_cuda:
        raise ValueError(
            f"the flash kernels take CUDA tensors, not {q.device}: flash attention runs on cuda "
            "or cpu, and on the CPU the wrappers take the plain versions"
        )


def _valid_pairs(kv_mask, causal: bool, b: int, l: int, device) -> torch.Tensor:
    """[B, 1, L, L] bool: which (query, key) pairs attend."""
    valid = torch.ones(b, 1, 1, l, dtype=torch.bool, device=device)
    if kv_mask is not None:
        valid = kv_mask[:, None, None, :]
    if causal:
        pos = torch.arange(l, device=device)
        valid = valid & (pos[None, :] <= pos[:, None])[None, None]
    return valid.expand(b, 1, l, l)


# --------------------------------------------------------------- forward


def flash_attention_plain(q, k, v, kv_mask=None, causal: bool = False) -> torch.Tensor:
    """The finished-output kernel's plain version: dense attention,
    kv_mask=None meaning every key is valid."""
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[0], q.shape[2], dtype=torch.bool, device=q.device)
    return dense_attention(q, k, v, kv_mask, causal)


def _flash_forward(q, k, v, kv_mask, causal: bool) -> torch.Tensor:
    """Finished output, no autograd: the kernel on CUDA, the plain version
    on the CPU."""
    if q.is_cpu:
        _check(q, k, v, kv_mask)
        return flash_attention_plain(q, k, v, kv_mask, causal)
    if _padded_route(q):
        _check(q, k, v, kv_mask)
        o = _kernel("fwd", *_padded(q, k, v), kv_mask, causal, _scale(q))
        return o[..., : q.shape[-1]].contiguous()
    _need_cuda(q)
    return _kernel("fwd", q, k, v, kv_mask, causal, _scale(q))


def flash_attention_lse_plain(q, k, v, kv_mask=None, causal: bool = False, scale=None):
    """The lse kernel's plain version: (o in q's dtype, lse [B, H, L] f32),
    scoring with ``scale`` (1/sqrt(D) when None), as the kernels take it.

    lse is the per-row logsumexp of the scaled scores in natural units,
    reached as the reference kernel reaches it (flash.py:194-197): row max
    m in the base-2 domain, l = sum exp2(s - m), lse = m ln2 + log(max(l,
    1e-30)). A row with no valid key keeps m = -1e30 and l = 0, so it gets
    the same finite filler, and its output is 0."""
    b, h, l, d = q.shape
    scale = _scale(q) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (_LOG2E * scale)
    valid = _valid_pairs(kv_mask, causal, b, l, q.device)
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp2(s - m), torch.zeros_like(s))
    row_sum = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / row_sum.clamp_min(1e-9)
    lse = (m * _LN2 + torch.log(row_sum.clamp_min(1e-30)))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_lse(q, k, v, kv_mask=None, causal: bool = False):
    """(o, lse) of the forward in its save_lse mode: the kernel on CUDA,
    the plain version on the CPU. No autograd of its own."""
    if q.is_cpu:
        _check(q, k, v, kv_mask)
        return flash_attention_lse_plain(q, k, v, kv_mask, causal)
    if _padded_route(q):
        _check(q, k, v, kv_mask)
        o, lse = _kernel("lse", *_padded(q, k, v), kv_mask, causal, _scale(q))
        return o[..., : q.shape[-1]].contiguous(), lse
    _need_cuda(q)
    return _kernel("lse", q, k, v, kv_mask, causal, _scale(q))


def flash_attention_partials_plain(q, k, v, kv_mask=None, scale=None):
    """The partial kernel's plain version: (acc [B, H, L, D] f32, row_max
    [B, H, L] f32, row_sum [B, H, L] f32), scoring with ``scale``
    (1/sqrt(D) when None), reached as the reference kernel
    reaches them (flash.py:143-165,177-184): base-2 scores, the masked row
    max m, p = exp2(s - m) on valid keys, row_sum = sum p, acc = P V with p
    rounded to the input dtype first (``probs.astype(vb.dtype)``), and
    row_max = m ln2 in natural units. A row with no valid key keeps m =
    -1e30, so row_max = -1e30 ln2, row_sum = 0 and acc = 0."""
    b, h, l, d = q.shape
    scale = _scale(q) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (_LOG2E * scale)
    valid = _valid_pairs(kv_mask, False, b, l, q.device)
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp2(s - m), torch.zeros_like(s))
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return acc, m[..., 0] * _LN2, p.sum(-1)


def flash_attention_partials(q, k, v, kv_mask=None):
    """Unnormalised flash partials of one KV block, for ring attention's
    merges: (acc, row_max, row_sum), all float32, with ``acc / max(row_sum,
    eps)`` the attention output over exactly this block. The kernel on
    CUDA, the plain version on the CPU. Equal q/kv lengths, no causal mode.

    Forward-only, as in the reference (the kernel has no gradient): with
    autograd recording and an input that requires grad it raises rather
    than return tensors cut off from the graph."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention_partials has no gradient: differentiate ring attention "
            "through its einsum path (use_flash=False)"
        )
    if q.is_cpu:
        _check(q, k, v, kv_mask)
        return flash_attention_partials_plain(q, k, v, kv_mask)
    if _padded_route(q):
        _check(q, k, v, kv_mask)
        acc, row_max, row_sum = _kernel("partial", *_padded(q, k, v), kv_mask, _scale(q))
        return acc[..., : q.shape[-1]].contiguous(), row_max, row_sum
    _need_cuda(q)
    return _kernel("partial", q, k, v, kv_mask, _scale(q))


# -------------------------------------------------------------- backward


def flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal: bool = False, scale=None):
    """The backward kernels' plain version: (dq, dk, dv) in q's, k's and
    v's dtypes, step for step as the reference's _bwd_tile and its two
    kernels (flash.py:383-415,451-458,505-508), over the whole [L, L] tile:

        s = q k^T * log2(e)/sqrt(D);  p = exp2(s - lse*log2(e)) on valid pairs, 0 elsewhere
        dp = dO v^T;  delta = rowsum(dO * o);  ds = p * (dp - delta)
        dv = p^T dO;  dk = ds^T q / sqrt(D);  dq = ds k / sqrt(D)

    with ``scale`` in place of 1/sqrt(D) when given, as the kernels take
    it, and p and ds rounded to the input dtype before their products, as the
    reference casts them. Invalid pairs are zeroed explicitly: a fully
    masked row carries a filler lse."""
    b, h, l, d = q.shape
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    scale = _scale(q) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (_LOG2E * scale)
    valid = _valid_pairs(kv_mask, causal, b, l, q.device)
    p = torch.where(valid, torch.exp2(s - lse[..., None] * _LOG2E), torch.zeros_like(s))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    p_c, ds_c = p.to(do.dtype).float(), ds.to(q.dtype).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p_c, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_c, qf) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_c, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_check(q, o, lse, do) -> None:
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("o and dO must match q's shape and dtype")
    if lse.dtype != torch.float32 or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}")
    if any(t.device != q.device or not t.is_contiguous() for t in (o, lse, do)):
        raise ValueError("o, lse and dO must be contiguous on q's device")


def flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do, causal: bool = False,
                            scale=None):
    """(dk, dv) from the dK/dV kernel; CUDA tensors only. ``delta`` is
    rowsum(dO * o) in float32 [B, H, L]; ``scale`` the softmax scale,
    1/sqrt(D) when None (the padded route passes the unpadded D's). A D no
    kernel takes is zero-padded here and the gradients sliced back."""
    _need_cuda(q)
    scale = _scale(q) if scale is None else scale
    if _padded_route(q):
        _check(q, k, v, kv_mask)
        d = q.shape[-1]
        qp, kp, vp, dop = _padded(q, k, v, do)
        dk, dv = flash_attention_bwd_dkv(qp, kp, vp, kv_mask, lse, delta, dop, causal, scale)
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return _kernel("dkv", q, k, v, do, lse, delta, kv_mask, causal, scale)


def flash_attention_bwd_dq(q, k, v, kv_mask, lse, delta, do, causal: bool = False,
                           scale=None):
    """dq from the dQ kernel; CUDA tensors only; ``scale`` and a D no
    kernel takes as for dK/dV."""
    _need_cuda(q)
    scale = _scale(q) if scale is None else scale
    if _padded_route(q):
        _check(q, k, v, kv_mask)
        d = q.shape[-1]
        qp, kp, vp, dop = _padded(q, k, v, do)
        return flash_attention_bwd_dq(qp, kp, vp, kv_mask, lse, delta, dop, causal,
                                      scale)[..., :d].contiguous()
    return _kernel("dq", q, k, v, do, lse, delta, kv_mask, causal, scale)


def flash_attention_bwd(q, k, v, kv_mask, o, lse, do, causal: bool = False):
    """(dq, dk, dv): the two backward kernels on CUDA, the plain version on
    the CPU. delta = rowsum(dO * o) is one plain reduction before the
    kernels, as the reference computes it outside its kernels
    (flash.py:562); o, lse and dO are checked before it, q, k, v and the
    mask by the launcher on CUDA."""
    _bwd_check(q, o, lse, do)
    if q.is_cpu:
        _check(q, k, v, kv_mask)
        return flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal)
    scale, d = _scale(q), q.shape[-1]
    padded = _padded_route(q)
    if padded:  # o and dO pad with zeros too: delta = rowsum(dO * o) is unchanged
        _check(q, k, v, kv_mask)
        q, k, v, o, do = _padded(q, k, v, o, do)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do, causal, scale)
    dq = flash_attention_bwd_dq(q, k, v, kv_mask, lse, delta, do, causal, scale)
    if padded:
        return dq[..., :d].contiguous(), dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """flash_attention with its gradient: the forward saves (q, k, v,
    kv_mask, o, lse) and the backward runs the dK/dV and dQ kernels, the
    counterpart of the reference's _flash / _flash_fwd / _flash_bwd."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        o, lse = flash_attention_lse(q, k, v, kv_mask, causal)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, o, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, kv_mask=None, causal: bool = False) -> torch.Tensor:
    """Attention over [B, H, L, D] with an optional [B, L] bool key mask.

    Drop-in for dense_attention and for models/attention.py's injectable
    attention_fn: invalid keys contribute nothing and fully masked rows
    return 0. Output has q's dtype. Differentiable in q, k and v. The
    operands are checked once, on the route taken: by the plain version's
    wrapper on the CPU, by the launcher on CUDA."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, kv_mask, causal)
    return _flash_forward(q, k, v, kv_mask, causal)
