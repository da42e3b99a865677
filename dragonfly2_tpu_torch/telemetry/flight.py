"""Hot-loop flight recorder: in-product phase timing and device-entry
call accounting.

Port of dragonfly2_tpu/telemetry/flight.py. ``PhaseRecorder`` lives
inside the scheduler's tick (cluster/scheduler.py), keeping a ring of the
last-N per-phase wall-time breakdowns and feeding the Prometheus phase
histogram, so bench numbers and production metrics read one source.
``instrument_entry`` wraps the port's device entry points
(ops/evaluator.py ``schedule_from_packed``, ops/tick.py
``fused_tick_chunk`` and the mirror scatter) to count calls, and
distinct call signatures when ``TRACK_SIGNATURES`` is on; it stands in
for the reference's ``instrument_jit``. PyTorch runs eagerly, so a new
signature is no compile here: it only says which bucket shapes the
service reached. The wrapper never synchronises with the device (the
tick's dispatch must not). The reference's ``dump`` (with its cost
cards, timelines and tail tracers) is not ported yet.
"""

from __future__ import annotations

import statistics
import threading
import time
import weakref
from collections import deque

from dragonfly2_tpu_torch.telemetry import metrics as _metrics
from dragonfly2_tpu_torch.telemetry import series as _series

# module-level binding: mark() runs up to 7x per tick in the scheduler's
# hot loop; the attribute chain lookup is measurable at that cadence
_perf = time.perf_counter

# ------------------------------------------------------------ phase timing


class PhaseRecorder:
    """Low-overhead per-tick phase recorder.

    One `begin()` per tick, `mark(name)` after each phase (marks
    accumulate, so a phase touched once per chunk sums across chunks),
    one `commit()` when the tick did real work. Commit appends the
    {phase: ms} dict to a bounded ring and observes the (label-cached)
    histogram children. A disabled recorder no-ops every call — the
    overhead budget is <=1% of tick p50, asserted by the tier-1
    micro-check (tests/test_flight_recorder.py)."""

    __slots__ = ("ring", "ticks", "enabled", "_histogram", "_children",
                 "_phases", "_t0", "_open", "__weakref__")

    def __init__(self, histogram=None, maxlen: int = 4096,
                 enabled: bool = True, name: str | None = None):
        self.ring: deque = deque(maxlen=maxlen)
        self.ticks = 0  # total commits, beyond what the ring retains
        self.enabled = enabled
        self._histogram = histogram
        self._children: dict = {}
        self._phases: dict[str, float] = {}
        self._t0 = 0.0
        self._open = False
        if name is not None:
            register_recorder(name, self)

    def begin(self) -> None:
        if not self.enabled:
            return
        self._phases = {}
        self._t0 = _perf()
        self._open = True

    def mark(self, name: str) -> None:
        if not self._open:
            return
        now = _perf()
        phases = self._phases
        phases[name] = phases.get(name, 0.0) + (now - self._t0) * 1e3
        self._t0 = now

    def add(self, name: str, ms: float) -> None:
        """Accumulate an externally timed duration into the open tick
        WITHOUT moving the phase cursor — for quantities that overlap
        other phases and therefore must not be derived from the cursor
        (the pipelined tick's `overlap` phase: host work done while a
        device call is in flight, which wall-clock-coexists with the
        `pack`/`apply_selection` marks that already cover it)."""
        if not self._open:
            return
        phases = self._phases
        phases[name] = phases.get(name, 0.0) + ms

    def sync(self) -> None:
        """Move the phase cursor to now WITHOUT recording anything —
        callers that time a section explicitly (via add) use this so the
        NEXT mark() does not inherit that section's wall time."""
        if self._open:
            self._t0 = _perf()

    def value(self, name: str) -> float:
        """Accumulated ms of `name` in the currently-OPEN tick (0.0 when
        unmarked or no tick is open) — lets the tick compute aggregate
        phases (control_dispatch = sum of the control-plane phases,
        device_call = dispatch + d2h_wait) from its own marks before
        commit."""
        return self._phases.get(name, 0.0) if self._open else 0.0

    def commit(self) -> None:
        if not self._open:
            return
        self._open = False
        self._commit_dict(self._phases)

    def commit_phases(self, phases: dict[str, float]) -> None:
        """Append one externally-measured {phase: ms} entry atomically —
        for concurrent producers (e.g. several downloads recovering from
        one scheduler crash at once, client/daemon.py failover) that
        cannot share the single begin/mark/commit cursor without
        clobbering each other's in-progress entry."""
        if not self.enabled:
            return
        self._commit_dict(dict(phases))

    def _commit_dict(self, phases: dict[str, float]) -> None:
        self.ring.append(phases)
        self.ticks += 1
        h = self._histogram
        if h is not None:
            children = self._children
            for phase, ms in phases.items():
                child = children.get(phase)
                if child is None:
                    child = children[phase] = h.labels(phase)
                child.observe(ms / 1e3)

    # ------------------------------------------------------------- reading

    def snapshot(self, last_n: int | None = None) -> list[dict]:
        # dump readers (manager REST / wire RPC threads) race the tick
        # thread's append; deque iteration then raises RuntimeError —
        # retry instead of locking the hot path
        ticks: list[dict] = []
        for _ in range(4):
            try:
                ticks = list(self.ring)
                break
            except RuntimeError:
                continue
        if last_n is None:
            return ticks
        # last_n=0 must mean "no entries": [-0:] would return them all,
        # and 0 is reachable from the /debug/flight query surface
        return ticks[-last_n:] if last_n > 0 else []

    def phase_p50s(self, last_n: int | None = None) -> dict[str, float]:
        """Per-phase p50 ms over the retained ticks — the exact numbers
        the loop bench publishes (bench_loop.py), now computed from the
        recorder so bench and production metrics cannot diverge."""
        ticks = self.snapshot(last_n)
        if not ticks:
            return {}
        keys = set().union(*ticks)
        return {
            k: round(statistics.median([p.get(k, 0.0) for p in ticks]), 3)
            for k in sorted(keys)
        }

    def dump(self, last_n: int = 64) -> dict:
        # p50 over the SAME window as "last": an operator asking for the
        # last 8 ticks is diagnosing now — a median over 4096 mostly-
        # healthy historical ticks would mask the very regression the
        # endpoint exists to surface
        return {
            "ticks_total": self.ticks,
            "p50_ms": self.phase_p50s(last_n),
            "last": self.snapshot(last_n),
        }


# Named recorders for the process-wide dump (the monitor HTTP endpoint has
# no handle on the scheduler object). Weak refs: test suites and bench A/B
# arms create many short-lived services; registration must not keep their
# 4096-tick rings alive. Last registration wins per name — a live process
# runs one scheduler.
_RECORDERS: dict[str, "weakref.ref[PhaseRecorder]"] = {}
_recorders_mu = threading.Lock()


def register_recorder(name: str, recorder: PhaseRecorder) -> None:
    with _recorders_mu:
        _RECORDERS[name] = weakref.ref(recorder)


def _live_recorders() -> dict[str, PhaseRecorder]:
    out = {}
    with _recorders_mu:
        for name, ref in list(_RECORDERS.items()):
            rec = ref()
            if rec is None:
                del _RECORDERS[name]
            else:
                out[name] = rec
    return out


# ------------------------------------------------------ device entry points


# Weak refs, like _RECORDERS: module-level wrappers stay alive through
# their module globals regardless.
_WRAPPERS: dict[str, "weakref.ref[EntryWrapper]"] = {}
_wrappers_mu = threading.Lock()

# Whether the entry wrappers also count distinct call signatures. Off by
# default: hashing every argument's shape, dtype and device costs each
# call host time, and an eager PyTorch call compiles nothing per
# signature, so only a caller that asks for the count pays for it.
TRACK_SIGNATURES = False


def _sig_of(v) -> object:
    """Hashable call-signature component: tensors and arrays collapse to
    (shape, dtype, device), containers recurse, hashable statics ride as
    themselves, everything else degrades to its type."""
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(shape), str(dtype), str(getattr(v, "device", "cpu")))
    if isinstance(v, dict):
        return ("dict", tuple((k, _sig_of(x)) for k, x in sorted(v.items())))
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(_sig_of(x) for x in v))
    try:
        hash(v)
    except TypeError:
        return ("type", type(v).__name__)
    return v


class EntryWrapper:
    """Callable wrapper around one device entry point: counts its calls,
    and with TRACK_SIGNATURES on its distinct call signatures (``_seen``;
    a new signature counts in the ``retraces`` family the reference's jit
    wrapper feeds). Unknown attributes forward to the wrapped function."""

    def __init__(self, fn, name: str, service: str = "scheduler", registry=None):
        self.__wrapped__ = fn
        self.name = name
        self.service = service
        self._seen: set = set()
        self._mu = threading.Lock()
        reg = registry if registry is not None else _metrics.default_registry()
        s = _series.jit_series(reg, service)
        self._series = s
        self._calls = s.calls.labels(name)
        self._retraces = s.retraces.labels(name)
        self._cache = s.cache_entries.labels(name)
        with _wrappers_mu:
            _WRAPPERS[f"{service}.{name}"] = weakref.ref(self)

    def __call__(self, *args, **kwargs):
        self._calls.inc()
        if TRACK_SIGNATURES:
            sig = (_sig_of(args), _sig_of(tuple(sorted(kwargs.items(), key=lambda kv: kv[0]))))
            with self._mu:
                new = sig not in self._seen
                if new:
                    self._seen.add(sig)
                    self._retraces.inc()
                    self._cache.set(len(self._seen))
        return self.__wrapped__(*args, **kwargs)

    def __getattr__(self, item: str):
        return getattr(self.__wrapped__, item)

    def stats(self) -> dict:
        return {
            "calls": self._series.calls.value(self.name),
            "signatures": len(self._seen),
        }


def instrument_entry(fn, name: str, service: str = "scheduler",
                     registry=None) -> EntryWrapper:
    """Wrap a device entry point with its call counter (and signature
    counter, under TRACK_SIGNATURES); the
    families land in `registry` (default: the process default registry)
    under dragonfly_<service>_jit_*, the reference's names."""
    return EntryWrapper(fn, name, service=service, registry=registry)


def entry_wrappers() -> dict[str, EntryWrapper]:
    out = {}
    with _wrappers_mu:
        for name, ref in list(_WRAPPERS.items()):
            wrapper = ref()
            if wrapper is None:
                del _WRAPPERS[name]
            else:
                out[name] = wrapper
    return out
