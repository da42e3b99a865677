"""Cost-card ledger: counted flops and bytes of every instrumented device
program, per (entry, signature).

Port of dragonfly2_tpu/telemetry/costcard.py. The reference reads each
compiled program's ``cost_analysis()`` from XLA; PyTorch runs eagerly and
has no such analysis, so a card here is COUNTED by this module, op by op,
while the entry runs under a counting dispatch mode. The rules, one for
every card:

- **Flops.** A matrix product counts what ``torch.utils.flop_counter``'s
  formula gives (2·M·N·K for ``mm``; ``bmm``, convolutions and SDPA
  likewise), plus one per output element for the bias add that
  ``addmm``/``baddbmm`` fuse. An elementwise op (ATen's ``pointwise``
  tag) counts one per output element, a copy (``clone``) none; a
  ``_foreach_`` op one per element of its first list. Softmax and
  log-softmax count five per element (max, subtract, exp, sum, divide).
  A reduction (ATen's ``reduction`` tag; ``cumsum``; the scatter and
  index adds and ``index_put`` with accumulate) counts one per element it
  folds. A hand kernel (ops/flash.py) counts the operations of its
  ``PERF.md`` §6 bound: 4·D a valid (query, key) pair for the forward,
  8·D for dK/dV, 6·D for dQ, over the pairs this call's mask leaves
  valid. Every other op (gathers, sorts, casts, fills, copies) counts
  none.
- **Bytes.** Every op reads each tensor argument once and writes each
  tensor it returns once; views and allocations move none. A hand
  kernel reads its inputs once and writes its outputs once.
- **Transcendentals.** One per output element of exp, log, tanh,
  sigmoid, erf, sqrt, rsqrt, pow, sin and cos, and of softmax.
- ``argument_bytes``/``output_bytes`` are the entry's tensors in and out;
  ``temp_bytes`` the bytes of every other tensor an op of the entry
  returns (a sum over ops, not a peak: the allocator reuses blocks);
  ``generated_code_bytes`` is 0 (nothing is compiled).
- **Data-dependent ops** (``nonzero``, ``masked_select``, a boolean
  index, ``.item()``; ATen's ``dynamic_output_shape`` and
  ``data_dependent_output`` tags) are named on the card under
  ``data_dependent``: a capture replays the entry on zeros, so whatever
  such an op returned is the zero input's, not the live data's.

The peaks are one NVIDIA H100 SXM's published dense rates at 700 W
(``H100_PEAK_FLOPS_BF16``, ``H100_HBM_BYTES_PER_S``); training/train.py
reads them from here.

Capture discipline — off the hot path:

- The flight-recorder ``EntryWrapper`` (telemetry/flight.py) only NOTES
  a pending capture when it routes a NEW signature; the note keeps each
  tensor's and array's shape, dtype and device and a weak reference to a
  module argument, never a live tensor, so it cannot pin a mirror column
  or an embedding table; a note whose module was collected is dropped at
  the drain (the program it describes can no longer run).
- The replay of a noted entry on fresh zero tensors of the noted shapes
  runs only at ``SchedulerService.warmup()``, at ``flight.dump()`` and at
  the trainer's one-shot registration (training/train.py counts the first
  step of its first block as it runs, so it launches nothing extra). A
  tick never captures.
- The replay calls the entry's unwrapped function, so it adds no call and
  no signature to the wrapper's counters.

Importing this module imports no torch: torch loads inside a capture.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import weakref
from typing import Any, Callable

# NVIDIA H100 80GB HBM3 (SXM, 700 W): dense bf16 tensor-core peak and HBM3
# bandwidth from NVIDIA's data sheet — the roofline platform of every card
# (and of training/train.gnn_roofline_bound); the reference's are a TPU
# v5e's
H100_PEAK_FLOPS_BF16 = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

# the operations of a hand kernel's PERF.md §6 bound, per valid (query,
# key) pair and head-dim column, by the kind of launch (ops/flash.py)
KERNEL_OPS_PER_PAIR = {"fwd": 4, "lse": 4, "partial": 4, "dkv": 8, "dq": 6}

# counting sessions open in this process: a hand kernel's wrapper reads
# this one global before it looks for its thread's session
COUNTING = 0
_counting_mu = threading.Lock()


@dataclasses.dataclass(frozen=True)
class CostCard:
    """One device program's counted cost profile."""

    entry: str            # flight-recorder name, e.g. "scheduler.tick.fused_tick_chunk"
    signature: str        # stable short digest of the call signature
    signature_repr: str   # human-readable (shapes/dtypes/devices/statics) form
    flops: float          # counted flops (module rules)
    bytes_accessed: float  # counted bytes read and written
    transcendentals: float
    argument_bytes: int   # the entry's tensor arguments
    output_bytes: int     # the entry's returned tensors
    temp_bytes: int       # every other tensor its ops return, summed
    generated_code_bytes: int
    kernels: tuple = ()   # (name, launches) of the hand kernels counted
    data_dependent: tuple = ()  # ops whose result followed the zero replay

    def arithmetic_intensity(self) -> float:
        """FLOPs per byte of counted memory traffic."""
        return self.flops / max(self.bytes_accessed, 1.0)

    def bound(self, peak_flops: float = H100_PEAK_FLOPS_BF16,
              hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S) -> str:
        """"compute" | "memory": which side of the roofline ridge this
        program's arithmetic intensity falls on."""
        ridge = peak_flops / hbm_bytes_per_s
        return "compute" if self.arithmetic_intensity() >= ridge else "memory"

    def mfu_pct(self, device_seconds: float,
                peak_flops: float = H100_PEAK_FLOPS_BF16) -> float:
        """The card's flops over what the card could have done in the
        measured device time."""
        if device_seconds <= 0:
            return 0.0
        return 100.0 * self.flops / (peak_flops * device_seconds)

    def time_lower_bound_s(self, peak_flops: float = H100_PEAK_FLOPS_BF16,
                           hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S) -> float:
        """Roofline time floor: max(compute time, memory time)."""
        return max(self.flops / peak_flops,
                   self.bytes_accessed / max(hbm_bytes_per_s, 1.0))

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kernels"] = [list(k) for k in self.kernels]
        d["data_dependent"] = list(self.data_dependent)
        d["arithmetic_intensity"] = round(self.arithmetic_intensity(), 3)
        d["bound"] = self.bound()
        return d


# ------------------------------------------------------------ signatures


def _is_module(value: Any) -> bool:
    return callable(getattr(value, "named_parameters", None))


def _sig_repr(value: Any) -> str:
    """Compact human-readable signature component."""
    if _is_module(value):
        n = sum(p.numel() for p in value.parameters())
        return f"{type(value).__name__}(params={n})"
    if isinstance(value, _Spec):
        return value.repr()
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        return _Spec.of(value).repr()
    if isinstance(value, dict):
        return "{" + ",".join(
            f"{k}:{_sig_repr(v)}" for k, v in sorted(value.items())
        ) + "}"
    if isinstance(value, (list, tuple)):
        return "(" + ",".join(_sig_repr(v) for v in value) + ")"
    return repr(value)


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What a pending note keeps of a tensor or array: shape, dtype and
    device (``None`` for a numpy array), never the data."""

    shape: tuple
    dtype: Any
    device: Any

    @staticmethod
    def of(value) -> "_Spec":
        device = getattr(value, "device", None)
        is_torch = type(value).__module__.startswith("torch")
        return _Spec(tuple(value.shape), value.dtype, device if is_torch else None)

    def repr(self) -> str:
        dims = ",".join(map(str, self.shape))
        where = "" if self.device is None or str(self.device) == "cpu" else f"@{self.device}"
        return f"{self.dtype}[{dims}]{where}"

    def fresh(self):
        if self.device is None:
            import numpy as np

            return np.zeros(self.shape, self.dtype)
        import torch

        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


class _Gone(Exception):
    """A module argument of a pending note was collected before its capture."""


def _specs(value: Any):
    """Replace tensor and array leaves with _Specs and modules with weak
    references, so a pending note keeps SHAPES, never data."""
    if _is_module(value):
        return weakref.ref(value)
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        return _Spec.of(value)
    if isinstance(value, dict):
        return {k: _specs(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_specs(v) for v in value)
    return value


def _materialise(value: Any):
    """The replay's arguments: fresh zeros for each _Spec, the live module
    behind each weak reference."""
    if isinstance(value, _Spec):
        return value.fresh()
    if isinstance(value, weakref.ref):
        obj = value()
        if obj is None:
            raise _Gone("a module argument was collected before the capture")
        return obj
    if isinstance(value, dict):
        return {k: _materialise(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_materialise(v) for v in value)
    return value


def _tensor_bytes(value: Any) -> int:
    """Bytes of every tensor and array leaf of ``value``."""
    if isinstance(value, dict):
        return sum(_tensor_bytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_tensor_bytes(v) for v in value)
    if isinstance(value, _Spec):
        import numpy as np

        n = 1
        for dim in value.shape:
            n *= int(dim)
        if value.device is None:
            return n * np.dtype(value.dtype).itemsize
        return n * value.dtype.itemsize
    if type(value).__module__.startswith("torch") and hasattr(value, "element_size"):
        return int(value.numel()) * int(value.element_size())
    nbytes = getattr(value, "nbytes", None)
    return int(nbytes) if isinstance(nbytes, int) else 0


# -------------------------------------------------------------- counting


@dataclasses.dataclass
class Count:
    """What one counting session saw."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    temp_bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    data_dependent: set = dataclasses.field(default_factory=set)

    def kernel(self, name: str, flops: float, nbytes: int) -> None:
        """Add one hand-kernel launch at its bound's operations and bytes."""
        self.flops += float(flops)
        self.bytes_accessed += float(nbytes)
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def scaled(self, times: int) -> "Count":
        return Count(
            self.flops * times, self.bytes_accessed * times, self.transcendentals * times,
            self.temp_bytes * times, {k: v * times for k, v in self.kernels.items()},
            set(self.data_dependent),
        )


_MODE_CLS = None


def _mode_cls():
    """The counting dispatch mode's class, built at the first capture (the
    one place this module imports torch)."""
    global _MODE_CLS
    if _MODE_CLS is not None:
        return _MODE_CLS
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    aten = torch.ops.aten
    fused_bias = {aten.addmm, aten.baddbmm}
    copies = {aten.clone, aten.copy, aten.copy_, aten._to_copy, aten.fill, aten.fill_,
              aten.zero_, aten.lift_fresh_copy}
    allocations = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
                   aten.new_empty_strided}
    scans = (aten.cumsum, aten.cumprod)
    folds = {aten.cumsum, aten.cumprod, aten.scatter_add, aten.scatter_add_,
             aten.scatter_reduce, aten.scatter_reduce_, aten.index_add, aten.index_add_,
             aten.index_reduce, aten.index_reduce_}
    softmaxes = {aten._softmax, aten._log_softmax}
    transcendental = {aten.exp, aten.exp_, aten.exp2, aten.exp2_, aten.expm1, aten.log,
                      aten.log_, aten.log1p, aten.log2, aten.log10, aten.tanh, aten.tanh_,
                      aten.sigmoid, aten.sigmoid_, aten.erf, aten.erf_, aten.sqrt, aten.sqrt_,
                      aten.rsqrt, aten.rsqrt_, aten.pow, aten.pow_, aten.sin, aten.cos}
    pointwise, reduction = torch.Tag.pointwise, torch.Tag.reduction
    dynamic = (torch.Tag.dynamic_output_shape, torch.Tag.data_dependent_output)

    def tensors(tree) -> list:
        return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]

    def nbytes(t) -> int:
        return t.numel() * t.element_size()

    class _CountMode(TorchDispatchMode):
        """Counts every ATen op the entry runs on this thread (and on the
        autograd threads its backward runs on) by the module's rules."""

        def __init__(self):
            super().__init__()
            self.count = Count()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self._add(func, args, kwargs, out)
            return out

        def _add(self, func, args, kwargs, out) -> None:
            c = self.count
            packet = func._overloadpacket
            if any(tag in func.tags for tag in dynamic) and not (
                packet is aten.index and not any(
                    t.dtype in (torch.bool, torch.uint8) for t in tensors(args[1:]))
            ):
                c.data_dependent.add(str(packet))
            if func.is_view or packet in allocations:
                return
            ins, outs = tensors((args, kwargs)), tensors(out)
            out_bytes = sum(nbytes(t) for t in outs)
            c.bytes_accessed += sum(nbytes(t) for t in ins) + out_bytes
            c.temp_bytes += out_bytes
            out_numel = outs[0].numel() if outs else 0
            if packet in flop_registry:
                c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
                if packet in fused_bias:
                    c.flops += out_numel
            elif packet in softmaxes:
                c.flops += 5 * out_numel
                c.transcendentals += out_numel
            elif packet in folds:  # a scan folds its input, a scatter its source
                c.flops += (ins[0] if packet in scans else ins[-1]).numel()
            elif packet in (aten.index_put, aten.index_put_, aten._index_put_impl_):
                if kwargs.get("accumulate", len(args) > 3 and bool(args[3])):
                    c.flops += ins[-1].numel()
            elif reduction in func.tags:
                c.flops += ins[0].numel() if ins else 0
            elif str(packet).startswith("aten._foreach_"):
                first = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
                c.flops += sum(t.numel() for t in first if isinstance(t, torch.Tensor))
            elif pointwise in func.tags and packet not in copies:
                c.flops += out_numel
            if packet in transcendental:
                c.transcendentals += out_numel

    _CountMode._dragonfly_count = True
    _MODE_CLS = _CountMode
    return _MODE_CLS


class counting:
    """``with counting() as count:`` counts every op the block runs on this
    thread (and in the autograd backward it starts) into ``count``."""

    def __enter__(self) -> Count:
        global COUNTING
        self._mode = _mode_cls()()
        with _counting_mu:
            COUNTING += 1
        self._mode.__enter__()
        return self._mode.count

    def __exit__(self, *exc) -> None:
        global COUNTING
        try:
            self._mode.__exit__(*exc)
        finally:
            with _counting_mu:
                COUNTING -= 1


def active_count() -> Count | None:
    """This thread's open counting session, or None (a hand kernel's
    wrapper adds its launch here; call only when COUNTING is set)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "_dragonfly_count", False):
            return mode.count
    return None


def uncounted():
    """A context in which this thread's counting mode sees nothing (a hand
    kernel's wrapper computes its bound inside one)."""
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


# ---------------------------------------------------------------- ledger


@dataclasses.dataclass
class _Pending:
    entry: str
    signature: str
    signature_repr: str
    fn: Callable             # the entry's unwrapped function (never the wrapper)
    args: tuple              # _Specs, weak module references and statics
    kwargs: dict


def _signature(rep: str) -> str:
    return hashlib.blake2b(rep.encode(), digest_size=6).hexdigest()


class CostCardLedger:
    """Process-wide per-(entry, signature) card store + capture queue."""

    def __init__(self, registry=None):
        self._mu = threading.Lock()
        self._cards: dict[tuple[str, str], CostCard] = {}
        self._pending: dict[tuple[str, str], _Pending] = {}
        self._capture_errors: dict[tuple[str, str], str] = {}
        self._registry = registry

    # -------------------------------------------------------- producers

    def note_pending(self, entry: str, fn: Callable, args: tuple,
                     kwargs: dict, signature_repr: str | None = None) -> None:
        """Queue a capture for a new signature (called by the flight
        recorder's wrapper). Cheap: the arguments' specs and a dict
        insert; the replay waits for :meth:`capture_pending`."""
        try:
            rep = signature_repr or _sig_repr((args, dict(kwargs)))
            spec_args, spec_kwargs = _specs(tuple(args)), _specs(dict(kwargs))
        except Exception:  # noqa: BLE001 - telemetry must not break calls
            return
        key = (entry, _signature(rep))
        with self._mu:
            if key in self._cards:
                return
            self._pending[key] = _Pending(entry, key[1], rep, fn, spec_args, spec_kwargs)

    def capture_pending(self) -> list[CostCard]:
        """Drain the queue: replay each pending entry on fresh zero tensors
        of its noted shapes under the counting mode and register the card.
        The one place the ledger runs device work — callers are warmup,
        dump and the trainer's registration, never a tick."""
        with self._mu:
            todo = list(self._pending.values())
            self._pending.clear()
        out = []
        for p in todo:
            try:
                args, kwargs = _materialise(p.args), _materialise(p.kwargs)
            except _Gone:
                continue  # the model it ran is gone: that program can no longer run
            try:
                with counting() as count:
                    result = p.fn(*args, **kwargs)
                out.append(self.register_count(
                    p.entry, count, signature_repr=p.signature_repr,
                    argument_bytes=_tensor_bytes((p.args, p.kwargs)),
                    output_bytes=_tensor_bytes(result),
                ))
            except Exception as e:  # noqa: BLE001 - a replay that fails must
                # not fail warmup or a dump; the miss is recorded so dumps
                # show why a card is absent
                with self._mu:
                    self._capture_errors[(p.entry, p.signature)] = f"{type(e).__name__}: {e}"
        return out

    def register_count(self, entry: str, count: Count, signature_repr: str = "",
                       argument_bytes: int = 0, output_bytes: int = 0) -> CostCard:
        """Build + register a card from a finished counting session (the
        trainer path: training/train.py counts its first step as it runs
        and hands the count here, so the card costs no replay)."""
        card = CostCard(
            entry=entry,
            signature=_signature(signature_repr),
            signature_repr=signature_repr,
            flops=float(count.flops),
            bytes_accessed=float(count.bytes_accessed),
            transcendentals=float(count.transcendentals),
            argument_bytes=int(argument_bytes),
            output_bytes=int(output_bytes),
            temp_bytes=max(int(count.temp_bytes) - int(output_bytes), 0),
            generated_code_bytes=0,
            kernels=tuple(sorted(count.kernels.items())),
            data_dependent=tuple(sorted(count.data_dependent)),
        )
        with self._mu:
            self._cards[(entry, card.signature)] = card
            self._capture_errors.pop((entry, card.signature), None)
        self._export(card)
        return card

    def _export(self, card: CostCard) -> None:
        from dragonfly2_tpu_torch.telemetry import metrics as _metrics
        from dragonfly2_tpu_torch.telemetry.series import costcard_series

        reg = self._registry or _metrics.default_registry()
        s = costcard_series(reg)
        labels = (card.entry, card.signature)
        s.flops.labels(*labels).set(card.flops)
        s.bytes_accessed.labels(*labels).set(card.bytes_accessed)
        s.output_bytes.labels(*labels).set(card.output_bytes)
        s.temp_bytes.labels(*labels).set(card.temp_bytes)
        s.captures.labels().inc()

    # --------------------------------------------------------- consumers

    def cards(self, entry: str | None = None) -> list[CostCard]:
        with self._mu:
            return [
                c for (e, _), c in sorted(self._cards.items())
                if entry is None or e == entry
            ]

    def card(self, entry: str, signature: str) -> CostCard | None:
        with self._mu:
            return self._cards.get((entry, signature))

    def pending_count(self) -> int:
        with self._mu:
            return len(self._pending)

    def dump(self) -> dict:
        """Plain-data snapshot for /debug/flight."""
        with self._mu:
            cards = sorted(self._cards.values(), key=lambda c: (c.entry, c.signature))
            errors = dict(self._capture_errors)
            pending = len(self._pending)
        return {
            "cards": [c.as_dict() for c in cards],
            "pending": pending,
            "capture_errors": {
                f"{e}@{s}": msg for (e, s), msg in sorted(errors.items())
            },
        }

    def reset(self) -> None:
        """Test hook: forget every card and pending note."""
        with self._mu:
            self._cards.clear()
            self._pending.clear()
            self._capture_errors.clear()


_LEDGER = CostCardLedger()


def ledger() -> CostCardLedger:
    return _LEDGER


def capture_pending() -> list[CostCard]:
    """Module-level drain: warmup, dump and the trainer call this; a tick
    never does."""
    return _LEDGER.capture_pending()
