"""Hot-loop flight recorder: in-product phase timing, device-entry call
accounting and the operator-facing dump.

Port of dragonfly2_tpu/telemetry/flight.py. ``PhaseRecorder`` lives
inside the scheduler's tick (cluster/scheduler.py), keeping a ring of the
last-N per-phase wall-time breakdowns and feeding the Prometheus phase
histogram, so bench numbers and production metrics read one source.
``instrument_entry`` wraps the port's device entry points
(ops/evaluator.py ``schedule_from_packed``, ops/tick.py
``fused_tick_chunk`` and the mirror scatter, the ml arm's entries in
registry/serving.py, the trainer's epochs) to count calls, and distinct
call signatures when ``TRACK_SIGNATURES`` is on or the wrapper keeps cost
cards; it stands in for the reference's ``instrument_jit``. PyTorch runs
eagerly, so a new signature is no compile here: it says which bucket
shapes the service reached, and with ``costcards=True`` it queues the
signature's cost card (telemetry/costcard.py). The wrapper never
synchronises with the device (the tick's dispatch must not). ``dump()``
assembles the snapshot (last-N ticks, entry counters, open spans, cost
cards, timelines, decision ledgers, SLO engines, tail tracers) served
over the scheduler wire RPC (FlightRecorderRequest), the manager REST
surface (GET /api/v1/flight-recorder) and the mux/monitor HTTP debug
routes (``/debug/flight``).
"""

from __future__ import annotations

import statistics
import threading
import time
import weakref
from collections import deque

from dragonfly2_tpu_torch.telemetry import metrics as _metrics
from dragonfly2_tpu_torch.telemetry import series as _series
from dragonfly2_tpu_torch.telemetry.tracing import default_tracer

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


_STATICS = (type(None), bool, int, float, str, bytes)
# a module argument's signature (its class and parameter shapes), cached
# weakly: a signature must never keep a model version alive
_MODULE_SIGS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _sig_of(v) -> object:
    """Hashable call-signature component: tensors and arrays collapse to
    (shape, dtype, device), a module to its class and parameter shapes,
    containers recurse, plain statics (and torch's dtypes and devices)
    ride as themselves, everything else degrades to its type — never the
    object itself, which the signature set would keep alive."""
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(shape), dtype, getattr(v, "device", None))
    if isinstance(v, dict):
        return ("dict", tuple((k, _sig_of(x)) for k, x in sorted(v.items())))
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(_sig_of(x) for x in v))
    if isinstance(v, _STATICS) or type(v).__module__ == "torch":
        return v
    if callable(getattr(v, "named_parameters", None)):
        sig = _MODULE_SIGS.get(v)
        if sig is None:
            sig = _MODULE_SIGS[v] = ("module", type(v).__name__, tuple(
                (name, tuple(p.shape), p.dtype) for name, p in v.named_parameters()))
        return sig
    return ("type", type(v).__name__)


class EntryWrapper:
    """Callable wrapper around one device entry point: counts its calls,
    and with TRACK_SIGNATURES on or ``costcards`` its distinct call
    signatures (``_seen``; a new signature counts in the ``retraces``
    family the reference's jit wrapper feeds). Unknown attributes forward
    to the wrapped function."""

    def __init__(self, fn, name: str, service: str = "scheduler", registry=None,
                 costcards: bool = False, key=None):
        self.__wrapped__ = fn
        self.name = name
        self.service = service
        # ``key(*args, **kwargs)``: a cheap hashable stand-in for the call
        # signature, for an entry on the tick whose arguments are too many
        # to hash whole every call; it must change wherever the signature
        # does. A key already in ``_keyed`` skips the hashing; a new one
        # hashes the call once into ``_seen``. None hashes every call.
        self._key = key
        self._keyed: set = set()
        # cost-card capture (telemetry/costcard.py): a NEW signature queues
        # a pending note (shapes, dtypes, devices; no live tensor); the
        # replay that counts it runs at the next off-hot-path drain
        # (warmup / flight dump). Opt-in per wrapper: the serving entries.
        self._costcards = costcards
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
        new = False
        if TRACK_SIGNATURES or self._costcards:
            key = None if self._key is None else self._key(*args, **kwargs)
            if key is None or key not in self._keyed:
                sig = (_sig_of(args),
                       _sig_of(tuple(sorted(kwargs.items(), key=lambda kv: kv[0]))))
                with self._mu:
                    if key is not None:
                        self._keyed.add(key)
                    new = sig not in self._seen
                    if new:
                        self._seen.add(sig)
                        self._retraces.inc()
                        self._cache.set(len(self._seen))
        out = self.__wrapped__(*args, **kwargs)
        if new and self._costcards:
            self._note_costcard(args, kwargs)
        return out

    def _note_costcard(self, args, kwargs) -> None:
        """Queue a cost-card capture for this new signature: the note
        keeps the arguments' shapes, dtypes and devices and the UNWRAPPED
        function, so the eventual replay routes no call or signature
        through this wrapper."""
        try:
            from dragonfly2_tpu_torch.telemetry import costcard

            costcard.ledger().note_pending(
                f"{self.service}.{self.name}", self.__wrapped__, args, kwargs
            )
        except Exception:  # noqa: BLE001 - telemetry must not break calls
            pass

    def __getattr__(self, item: str):
        return getattr(self.__wrapped__, item)

    def stats(self) -> dict:
        return {
            "calls": self._series.calls.value(self.name),
            "signatures": len(self._seen),
        }


def instrument_entry(fn, name: str, service: str = "scheduler",
                     registry=None, costcards: bool = False, key=None) -> EntryWrapper:
    """Wrap a device entry point with its call counter (and signature
    counter, under TRACK_SIGNATURES or with ``costcards``; ``key`` as in
    EntryWrapper); the families land in `registry` (default: the process
    default registry) under dragonfly_<service>_jit_*, the reference's
    names. ``costcards=True`` also queues a cost-card capture per new
    signature (telemetry/costcard.py)."""
    return EntryWrapper(fn, name, service=service, registry=registry,
                        costcards=costcards, key=key)


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


# ------------------------------------------------------------------- dump


def _plain(value) -> "bool | int | float | str | None":
    """msgpack/json-safe scalar: pass primitives, stringify the rest."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return str(value)


def _span_summary(span) -> dict:
    return {
        "name": span.name,
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "parent_id": span.parent_id,
        "start_ns": span.start_ns,
        "age_ms": round((time.time_ns() - span.start_ns) / 1e6, 3),
        "attributes": {k: _plain(v) for k, v in span.attributes.items()},
    }


# Every section a dump can carry; `section=` query params and the
# `sections` kwarg select a subset (ticks/jit/active_spans stay the
# backward-compatible core — older consumers index them directly).
DUMP_SECTIONS = (
    "ticks", "jit", "active_spans", "costcards", "timelines", "decisions",
    "slo", "tail",
)
# Hard payload bound for the HTTP debug surfaces: flight.dump has grown
# costcards + timelines + decisions on top of the tick ring, and an
# unbounded /debug/flight pull against a long soak could ship tens of MB
# through a debug socket. Over the cap, the variable-length rings shed
# oldest-first and the body carries a `truncated` marker.
DUMP_MAX_BYTES = 2 << 20


def _dump_nbytes(body: dict) -> int:
    import json

    return len(json.dumps(body, separators=(",", ":"), default=str))


def _truncate_dump(body: dict, max_bytes: int) -> dict:
    """Shrink the dump's ring-backed lists (oldest entries first) until
    the JSON body fits ``max_bytes``; record what was dropped under the
    ``truncated`` marker. The scalar sections (jit stats, counters) are
    bounded by construction and never shed."""
    dropped: dict[str, int] = {}

    def _lists(b: dict):
        out = []
        ticks = b.get("ticks")
        if isinstance(ticks, dict) and isinstance(ticks.get("last"), list):
            out.append(("ticks.last", ticks, "last"))
        for name, tl in (b.get("timelines") or {}).items():
            if isinstance(tl, dict) and isinstance(tl.get("samples"), list):
                out.append((f"timelines.{name}.samples", tl, "samples"))
        for name, led in (b.get("decisions") or {}).items():
            if isinstance(led, dict) and isinstance(led.get("rows"), list):
                out.append((f"decisions.{name}.rows", led, "rows"))
        for name, eng in (b.get("slo") or {}).items():
            if isinstance(eng, dict) and isinstance(eng.get("alert_log"), list):
                out.append((f"slo.{name}.alert_log", eng, "alert_log"))
        for name, tr in (b.get("tail") or {}).items():
            if isinstance(tr, dict) and isinstance(tr.get("exemplars"), list):
                out.append((f"tail.{name}.exemplars", tr, "exemplars"))
        spans = b.get("active_spans")
        if isinstance(spans, list) and spans:
            out.append(("active_spans", b, "active_spans"))
        cards = b.get("costcards")
        if isinstance(cards, dict) and isinstance(cards.get("cards"), list):
            out.append(("costcards.cards", cards, "cards"))
        return out

    while _dump_nbytes(body) > max_bytes:
        candidates = [
            (key, holder, field) for key, holder, field in _lists(body)
            if holder[field]
        ]
        if candidates:
            # shed from the largest list first, oldest half at a time
            key, holder, field = max(
                candidates, key=lambda c: len(c[1][c[2]])
            )
            lst = holder[field]
            keep = len(lst) // 2
            dropped[key] = dropped.get(key, 0) + (len(lst) - keep)
            holder[field] = lst[-keep:] if keep else []
            body["truncated"] = {
                "max_bytes": max_bytes, "dropped": dict(dropped)
            }
            continue
        tails = body.get("tail")
        if isinstance(tails, dict) and tails:
            # every ring-backed list is already empty, yet the body still
            # exceeds the cap: shed whole tail ledgers, largest first.
            # Unlike every other section, the tail section's scalar floor
            # grows with the number of LIVE tracers (the daemon singleton
            # plus one per engine), and the byte cap is a hard promise.
            name = max(tails, key=lambda n: _dump_nbytes(tails[n]))
            del tails[name]
            dropped[f"tail.{name}"] = 1
            body["truncated"] = {
                "max_bytes": max_bytes, "dropped": dict(dropped)
            }
            continue
        break  # nothing left to shed; scalar floor
    return body


def parse_flight_query(query: str) -> dict:
    """``?last_n=&section=&max_bytes=`` → :func:`dump` kwargs — shared
    by the mux and monitor ``/debug/flight`` routes so the two debug
    surfaces cannot drift. Raises ValueError with a client-facing
    message on bad input (the routes answer 400)."""
    import urllib.parse as _up

    kwargs: dict = {}
    sections: list[str] = []
    for key, value in _up.parse_qsl(query or ""):
        if key == "last_n":
            try:
                kwargs["last_n"] = max(int(value), 0)
            except ValueError:
                raise ValueError("last_n must be an integer") from None
        elif key == "section":
            for name in value.split(","):
                name = name.strip()
                if not name:
                    continue
                if name not in DUMP_SECTIONS:
                    raise ValueError(
                        f"unknown section {name!r}; valid: "
                        f"{', '.join(DUMP_SECTIONS)}"
                    )
                sections.append(name)
        elif key == "max_bytes":
            try:
                # floor keeps the truncation loop meaningful: below ~1k
                # even the scalar skeleton cannot fit
                kwargs["max_bytes"] = max(int(value), 1024)
            except ValueError:
                raise ValueError("max_bytes must be an integer") from None
    if sections:
        kwargs["sections"] = tuple(sections)
    return kwargs


def dump(last_n: int = 64, recorder: PhaseRecorder | None = None,
         registry_fallback: bool = True,
         sections: "tuple[str, ...] | list[str] | None" = None,
         max_bytes: int | None = DUMP_MAX_BYTES) -> dict:
    """The flight-recorder snapshot: last-N tick phase breakdowns, the
    device entries' call counters, spans currently open, cost cards, soak
    timelines, the decision ledger, the SLO engines, and the tail
    tracers. Pure plain data (dicts/lists/
    scalars) so it rides the wire codec and JSON as-is.
    `registry_fallback=False` skips the process-global recorder lookup —
    a service reporting about ITSELF (the manager's own section) must not
    claim a co-located scheduler's tick ring as its own.
    `sections` selects a subset of :data:`DUMP_SECTIONS`; `max_bytes`
    (None = unbounded) is a hard JSON-size cap enforced by shedding the
    ring-backed lists oldest-first with a ``truncated`` marker."""
    want = set(DUMP_SECTIONS if sections is None else sections)
    body: dict = {"generated_at_ns": time.time_ns()}
    if "ticks" in want:
        if recorder is None and registry_fallback:
            # the scheduler registers under this name; last registration
            # wins, so a process-wide dump reads the live service's recorder
            recorder = _live_recorders().get("scheduler.tick")
        # shape-stable when no recorder exists: consumers index ["last"] /
        # ["p50_ms"] without guarding a sometimes-empty dict
        body["ticks"] = (
            recorder.dump(last_n) if recorder is not None
            else {"ticks_total": 0, "p50_ms": {}, "last": []}
        )
    if "jit" in want:
        body["jit"] = {
            name: w.stats() for name, w in sorted(entry_wrappers().items())
        }
    if "active_spans" in want:
        spans = []
        for span in default_tracer().active_spans():
            try:
                spans.append(_span_summary(span))
            except RuntimeError:
                continue  # owner thread mutated attributes mid-copy; skip
        body["active_spans"] = spans
    # Perf-observatory surfaces (additive keys — older consumers index
    # only ticks/jit/active_spans): the cost-card ledger, any live soak
    # timelines, and the decision provenance ledger. A dump is an
    # operator pulling /debug/flight — an explicitly off-hot-path
    # moment, so it doubles as a cost-card capture drain (a new
    # signature queued the note; the replay that counts it lands here or
    # in warmup).
    if "costcards" in want:
        from dragonfly2_tpu_torch.telemetry import costcard as _costcard

        _costcard.ledger().capture_pending()
        body["costcards"] = _costcard.ledger().dump()
    if "timelines" in want:
        from dragonfly2_tpu_torch.telemetry import timeline as _timeline

        body["timelines"] = {
            name: rec.dump()
            for name, rec in sorted(_timeline.live_timelines().items())
        }
    if "decisions" in want:
        from dragonfly2_tpu_torch.telemetry import decisions as _decisions

        body["decisions"] = {
            name: led.dump(last_n=last_n)
            for name, led in sorted(_decisions.live_ledgers().items())
        }
    if "slo" in want:
        from dragonfly2_tpu_torch.telemetry import slo as _slo

        body["slo"] = {
            name: eng.dump(last_n=last_n)
            for name, eng in sorted(_slo.live_engines().items())
        }
    if "tail" in want:
        from dragonfly2_tpu_torch.telemetry import tailtrace as _tailtrace

        body["tail"] = {
            name: tr.dump(last_n=last_n)
            for name, tr in sorted(_tailtrace.live_tracers().items())
        }
    if max_bytes is not None and _dump_nbytes(body) > max_bytes:
        body = _truncate_dump(body, max_bytes)
    return body
