"""dftail: per-download lifecycle ledger and critical-path TTC
decomposition.

Port of dragonfly2_tpu/telemetry/tailtrace.py, whole: the same phases,
the same splitmix64 sampling bit for bit, the same reports and digest.
The dfdaemon feeds it over real transfers and the megascale engine
(megascale/engine.py) over modeled ones, on the event clock.

The observability planes before this one can say WHICH parent was chosen
(telemetry/decisions.py), WHETHER the planet is healthy (telemetry/slo.py)
and WHAT the device pays (telemetry/costcard.py); none of them can answer
"why was download X slow". :class:`TailTrace` closes that gap: a bounded
columnar (SoA — numpy columns, no per-download Python dicts on any hot
path) ledger that attributes every completed download's time-to-complete
to the lifecycle phases it traversed —

    register -> schedule-wait -> parent fetch -> piece retries ->
    failover/re-announce -> back-to-source -> digest verify -> complete

— such that the attributed phases sum to the measured TTC exactly (the
caller constructs the phase vector from disjoint components; the
``decomp_ratio`` cell in every report is the audit of that invariant).

Two planes feed it:

- the megascale ``EventBatchEngine`` on the EVENT clock (one ``observe``
  per completion, phases in virtual ns) — everything recorded there is a
  pure function of (spec, seed), so paired-seed runs produce
  bit-identical ``deterministic_digest()`` values;
- the real client path (client/daemon.py + client/conductor.py), where
  phase durations are measured by the CALLERS with ``perf_counter_ns``
  and handed in — this module itself never reads a clock.

Bounded memory at planet scale: aggregates are per-(region, phase)
sketches/sums (independent of host count) and exemplar retention is
deterministic sampling — always-keep slowest-K per region plus a
counter-hashed uniform sample (the splitmix64 ``hash_u01`` construction,
never process-global rng) into a fixed-capacity ring, so a 1M-host day
keeps the same footprint as a 10k-host smoke.

Surfaces: the ``tail`` block in ``run_megascale`` reports /
``BENCH_mega.json`` (:meth:`TailTrace.report`), the ``tail`` section of
``flight.dump()`` / ``/debug/flight`` (:meth:`TailTrace.dump` via the
weak registry), the ``dragonfly_tail_*`` metric families
(telemetry/series.tail_series), dfslo cause enrichment (the per-sample
dominant phase rides the timeline), and ``tools/dftail.py`` offline.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from typing import Any, Iterable, Sequence

import numpy as np

from dragonfly2_tpu_torch.telemetry.timeline import QuantileSketch

# Lifecycle phases, in causal order. Index constants are the hot-path
# contract: callers accumulate into a float vector by index and hand the
# vector to observe() — never a dict per download.
PHASES: tuple[str, ...] = (
    "register",
    "schedule_wait",
    "parent_fetch",
    "retry",
    "failover",
    "back_to_source",
    "verify",
)
N_PHASES = len(PHASES)
(
    PH_REGISTER,
    PH_SCHEDULE_WAIT,
    PH_PARENT_FETCH,
    PH_RETRY,
    PH_FAILOVER,
    PH_BACK_TO_SOURCE,
    PH_VERIFY,
) = range(N_PHASES)

# attributed-sums-to-measured audit bound, shared with tools/dftail.py:
# phase vectors are built from disjoint components so the event plane
# sums exactly; the client plane books unmeasured glue as schedule wait
# and must still land within this
DEFAULT_TOLERANCE = 0.05


# --------------------------------------------------- deterministic sampling

_MASK64 = (1 << 64) - 1
_GOLD = 0x9E3779B97F4A7C15
_SM_A = 0xBF58476D1CE4E5B9
_SM_B = 0x94D049BB133111EB
_KIND_CODES: dict[str, int] = {}


def _kind_code(kind: str) -> int:
    """Stable 64-bit code for a sampling kind — blake2b of the name, so
    codes never depend on interpreter hash randomization (the same
    construction as megascale/topology._kind_code)."""
    code = _KIND_CODES.get(kind)
    if code is None:
        code = int.from_bytes(
            hashlib.blake2b(kind.encode(), digest_size=8).digest(), "big"
        )
        _KIND_CODES[kind] = code
    return code


def _mix64(h: int) -> int:
    h &= _MASK64
    h = ((h ^ (h >> 30)) * _SM_A) & _MASK64
    h = ((h ^ (h >> 27)) * _SM_B) & _MASK64
    return h ^ (h >> 31)


def hash_u01_scalar(seed: int, kind: str, *keys: int) -> float:
    """Scalar twin of ``megascale.topology.hash_u01`` (bit-identical for
    the same inputs): deterministic uniform in [0, 1) as a pure function
    of (seed, kind, keys). The hot path samples one download at a time,
    and a per-call numpy round-trip would cost more than the mix."""
    h = _mix64((seed & _MASK64) ^ _kind_code(kind))
    for k in keys:
        h = _mix64(((h ^ (int(k) & _MASK64)) * _GOLD) & _MASK64)
    return (h >> 11) * 2.0 ** -53


# --------------------------------------------------- process-wide registry

_TRACERS: dict[str, "weakref.ref[TailTrace]"] = {}
_tracers_mu = threading.Lock()


def register_tracer(name: str, tracer: "TailTrace") -> None:
    """Weak named registry (mirrors timeline.register_timeline /
    decisions.register_ledger) so the process-wide ``/debug/flight``
    dump finds live tracers without a handle on the engine or daemon
    that owns them. Last registration wins."""
    with _tracers_mu:
        _TRACERS[name] = weakref.ref(tracer)


def live_tracers() -> dict[str, "TailTrace"]:
    out: dict[str, "TailTrace"] = {}
    with _tracers_mu:
        for name, ref in list(_TRACERS.items()):
            tracer = ref()
            if tracer is None:
                del _TRACERS[name]
            else:
                out[name] = tracer
    return out


# ----------------------------------------------------------------- tracer


class TailTrace:
    """Bounded columnar tail-attribution ledger.

    ``observe(region, seq, ttc_ns, phase_ns, round_idx)`` records one
    completed download: its measured TTC and the per-phase attribution
    vector (both in ns — virtual ns on the event clock, wall ns on the
    client plane). Aggregates are SoA numpy arrays sized by
    (regions x phases) plus one growable (rounds x phases) matrix —
    never by download count — and exemplar retention is deterministic:
    the slowest ``slowest_k`` downloads per region always stay, plus a
    ``hash_u01``-sampled uniform slice into a fixed ring.
    """

    def __init__(
        self,
        regions: Sequence[str] = ("region-0",),
        *,
        seed: int = 0,
        name: str | None = None,
        slowest_k: int = 8,
        sample_rate: float = 1.0 / 64.0,
        exemplar_capacity: int = 256,
        registry: Any = None,
    ) -> None:
        self.regions = tuple(str(r) for r in regions) or ("region-0",)
        n = len(self.regions)
        self.seed = int(seed)
        self.name = name
        self.slowest_k = max(int(slowest_k), 1)
        self.sample_rate = float(sample_rate)
        self.exemplar_capacity = max(int(exemplar_capacity), 1)
        self._mu = threading.Lock()
        self._seq = 0
        # --- aggregates: (regions,) / (regions, phases), host-count-free
        self._completions = np.zeros(n, np.int64)
        self._ttc_sum_ns = np.zeros(n, np.float64)
        self._phase_sum_ns = np.zeros((n, N_PHASES), np.float64)
        self._dominant = np.zeros((n, N_PHASES), np.int64)
        self._ttc_sketch = [
            QuantileSketch(relative_accuracy=0.01) for _ in range(n)
        ]
        self._phase_sketch = [
            [QuantileSketch(relative_accuracy=0.01) for _ in range(N_PHASES)]
            for _ in range(n)
        ]
        # --- per-round phase attribution matrix: grows with ROUNDS (one
        # compressed day is ~10^2 rows), never with hosts — the basis of
        # the kill-window dominant-phase report
        self._round_phase_ns = np.zeros((128, N_PHASES), np.float64)
        # the single slowest completion per round (TTC + its phase
        # vector): the per-window TAIL view. The mass matrix above can
        # bury a scheduler kill under hundreds of healthy completions;
        # the worst download in the window cannot be buried.
        self._round_slow_ttc = np.full(128, -1.0, np.float64)
        self._round_slow_phase = np.zeros((128, N_PHASES), np.float64)
        self._max_round = -1
        # --- slowest-K exemplars per region (always kept)
        k = self.slowest_k
        self._slow_ttc = np.full((n, k), -1.0, np.float64)
        self._slow_seq = np.full((n, k), -1, np.int64)
        self._slow_round = np.full((n, k), -1, np.int64)
        self._slow_phase = np.zeros((n, k, N_PHASES), np.float64)
        # --- counter-hashed uniform exemplar ring (fixed capacity)
        cap = self.exemplar_capacity
        self._ring_seq = np.full(cap, -1, np.int64)
        self._ring_region = np.full(cap, -1, np.int32)
        self._ring_round = np.full(cap, -1, np.int64)
        self._ring_ttc = np.zeros(cap, np.float64)
        self._ring_phase = np.zeros((cap, N_PHASES), np.float64)
        self._ring_count = 0
        from dragonfly2_tpu_torch.telemetry import metrics as _metrics
        from dragonfly2_tpu_torch.telemetry.series import tail_series

        reg = registry if registry is not None else _metrics.default_registry()
        self._series = tail_series(reg)
        self._children: dict[tuple, Any] = {}
        if name is not None:
            register_tracer(name, self)

    # ------------------------------------------------------------- feeding

    def next_seq(self) -> int:
        """Monotone download sequence for callers without a natural one
        (the client plane; the megascale plane uses its registration
        counter)."""
        with self._mu:
            seq = self._seq
            self._seq += 1
            return seq

    def observe(
        self,
        region: int,
        seq: int,
        ttc_ns: float,
        phase_ns: "np.ndarray | Sequence[float]",
        round_idx: int = 0,
    ) -> None:
        """Record one completed download. ``phase_ns`` is the length-
        ``N_PHASES`` attribution vector (indices ``PH_*``); callers build
        it from disjoint components so it sums to ``ttc_ns``."""
        vec = np.asarray(phase_ns, np.float64)
        r = int(region)
        name = self.regions[r] if 0 <= r < len(self.regions) else str(r)
        with self._mu:
            if not 0 <= r < len(self.regions):
                return
            if seq >= self._seq:
                self._seq = int(seq) + 1
            self._completions[r] += 1
            self._ttc_sum_ns[r] += float(ttc_ns)
            self._phase_sum_ns[r] += vec
            dom = int(np.argmax(vec))
            self._dominant[r, dom] += 1
            self._ttc_sketch[r].add(float(ttc_ns) / 1e6)
            sketches = self._phase_sketch[r]
            for p in range(N_PHASES):
                sketches[p].add(float(vec[p]) / 1e6)
            # per-round matrix row (kill-window attribution basis)
            ri = max(int(round_idx), 0)
            if ri >= self._round_phase_ns.shape[0]:
                rows = max(self._round_phase_ns.shape[0] * 2, ri + 1)
                grown = np.zeros((rows, N_PHASES), np.float64)
                grown[: self._round_phase_ns.shape[0]] = self._round_phase_ns
                self._round_phase_ns = grown
                grown_ttc = np.full(rows, -1.0, np.float64)
                grown_ttc[: self._round_slow_ttc.shape[0]] = self._round_slow_ttc
                self._round_slow_ttc = grown_ttc
                grown_ph = np.zeros((rows, N_PHASES), np.float64)
                grown_ph[: self._round_slow_phase.shape[0]] = self._round_slow_phase
                self._round_slow_phase = grown_ph
            self._round_phase_ns[ri] += vec
            if float(ttc_ns) > self._round_slow_ttc[ri]:
                self._round_slow_ttc[ri] = float(ttc_ns)
                self._round_slow_phase[ri] = vec
            if ri > self._max_round:
                self._max_round = ri
            # slowest-K: replace the region's current minimum when slower
            # (strict >, so observation order breaks ties deterministically)
            slot = int(np.argmin(self._slow_ttc[r]))
            if float(ttc_ns) > self._slow_ttc[r, slot]:
                self._slow_ttc[r, slot] = float(ttc_ns)
                self._slow_seq[r, slot] = int(seq)
                self._slow_round[r, slot] = ri
                self._slow_phase[r, slot] = vec
            # counter-hashed uniform sample into the fixed ring
            if hash_u01_scalar(self.seed, "tail_exemplar", seq) < self.sample_rate:
                pos = self._ring_count % self.exemplar_capacity
                self._ring_seq[pos] = int(seq)
                self._ring_region[pos] = r
                self._ring_round[pos] = ri
                self._ring_ttc[pos] = float(ttc_ns)
                self._ring_phase[pos] = vec
                self._ring_count += 1
        source = self.name or "tail"
        self._child(self._series.completions, source, name).inc()
        self._child(self._series.dominant, source, name, PHASES[dom]).inc()

    # ------------------------------------------------------------ queries

    def round_dominant(self, round_idx: int) -> str | None:
        """Dominant phase among the attributed time of downloads that
        COMPLETED in ``round_idx`` (None when that round completed
        nothing) — the per-sample cause hint the SLO plane rides."""
        with self._mu:
            ri = int(round_idx)
            if not 0 <= ri <= self._max_round:
                return None
            row = self._round_phase_ns[ri]
            if float(row.sum()) <= 0.0:
                return None
            return PHASES[int(np.argmax(row))]

    def round_phase_matrix_ms(self) -> list[list[float]]:
        """The per-round phase-attribution matrix (rounds x phases, ms)
        — the complete offline basis for window/dominant recomputation:
        ``tools/dftail.py`` re-derives the report's window attribution
        from this alone and drift-checks it against the recorded one."""
        with self._mu:
            matrix = self._round_phase_ns[: self._max_round + 1] / 1e6
            return [[round(float(v), 3) for v in row] for row in matrix]

    def round_slow_matrix_ms(self) -> list[list[float]]:
        """Per-round slowest-completion rows (``[ttc_ms, *phase_ms]``;
        ttc -1 when the round completed nothing) — the offline basis
        for the windows' tail view, same contract as
        :meth:`round_phase_matrix_ms`."""
        with self._mu:
            n = self._max_round + 1
            ttc = self._round_slow_ttc[:n]
            phase = self._round_slow_phase[:n]
            return [
                [round(float(ttc[i]) / 1e6, 3) if ttc[i] > 0.0 else -1.0]
                + [round(float(v) / 1e6, 3) for v in phase[i]]
                for i in range(n)
            ]

    def exemplar_rows(self) -> list[dict]:
        """Kept exemplars as plain rows, shed-friendly order: the uniform
        ring first (oldest retained first), then the slowest-K blocks
        ascending by TTC — so a byte-capped dump drops uniform samples
        before it drops the slowest downloads on the planet."""
        with self._mu:
            rows: list[dict] = []
            kept = min(self._ring_count, self.exemplar_capacity)
            start = self._ring_count - kept
            for i in range(start, self._ring_count):
                pos = i % self.exemplar_capacity
                rows.append(self._exemplar_row(
                    "uniform", int(self._ring_seq[pos]),
                    int(self._ring_region[pos]), int(self._ring_round[pos]),
                    float(self._ring_ttc[pos]), self._ring_phase[pos],
                ))
            slow: list[dict] = []
            for r in range(len(self.regions)):
                for slot in range(self.slowest_k):
                    if self._slow_seq[r, slot] < 0:
                        continue
                    slow.append(self._exemplar_row(
                        "slowest", int(self._slow_seq[r, slot]), r,
                        int(self._slow_round[r, slot]),
                        float(self._slow_ttc[r, slot]),
                        self._slow_phase[r, slot],
                    ))
            slow.sort(key=lambda e: (e["ttc_ms"], e["seq"]))
            rows.extend(slow)
            return rows

    def _exemplar_row(
        self, kind: str, seq: int, region: int, round_idx: int,
        ttc_ns: float, vec: np.ndarray,
    ) -> dict:
        name = (
            self.regions[region] if 0 <= region < len(self.regions)
            else str(region)
        )
        return {
            "kind": kind,
            "seq": seq,
            "region": name,
            "round": round_idx,
            "ttc_ms": round(ttc_ns / 1e6, 3),
            "phases_ms": {
                PHASES[p]: round(float(vec[p]) / 1e6, 3)
                for p in range(N_PHASES)
                if float(vec[p]) > 0.0
            },
        }

    # ---------------------------------------------------------- reporting

    # a kill's victims drain over the re-announce/retire cycle, not the
    # crash round alone — the soak's recovery completions land ~8 rounds
    # after the kill, so the window must reach past them (kills are 16
    # rounds apart; 12 keeps windows disjoint)
    DEFAULT_WINDOW_ROUNDS = 12

    def report(
        self,
        crash_rounds: Iterable[int] = (),
        window_rounds: int = DEFAULT_WINDOW_ROUNDS,
    ) -> dict:
        """The deterministic tail block for ``run_megascale`` reports and
        BENCH_mega artifacts: per-region TTC quantiles with their
        per-phase decomposition, phase shares, dominant-phase histogram,
        kill-window attribution over ``crash_rounds``, kept exemplars,
        and the paired-seed digest."""
        with self._mu:
            regions: dict[str, dict] = {}
            for r, name in enumerate(self.regions):
                regions[name] = self._region_block_locked(r)
            dominant_hist = {
                PHASES[p]: int(self._dominant[:, p].sum())
                for p in range(N_PHASES)
                if int(self._dominant[:, p].sum())
            }
            windows, baseline = self._windows_locked(
                sorted(int(k) for k in crash_rounds), max(int(window_rounds), 1)
            )
            digest = self._digest_locked()
            completions = int(self._completions.sum())
            sampling = {
                "slowest_k": self.slowest_k,
                "uniform_rate": self.sample_rate,
                "ring_capacity": self.exemplar_capacity,
                "uniform_kept": min(self._ring_count, self.exemplar_capacity),
                "uniform_sampled": self._ring_count,
            }
        self.mirror_metrics()
        return {
            "phases": list(PHASES),
            "completions": completions,
            "regions": regions,
            "dominant_hist": dominant_hist,
            "windows": windows,
            "baseline_dominant_phase": baseline,
            "sampling": sampling,
            "exemplars": self.exemplar_rows(),
            "digest": digest,
        }

    def _region_block_locked(self, r: int) -> dict:
        completed = int(self._completions[r])
        ttc_sk = self._ttc_sketch[r]
        ttc_ms = {
            "p50": _round_opt(ttc_sk.quantile(0.50)),
            "p95": _round_opt(ttc_sk.quantile(0.95)),
            "p99": _round_opt(ttc_sk.quantile(0.99)),
        }
        decomposition: dict[str, dict] = {}
        for p in range(N_PHASES):
            sk = self._phase_sketch[r][p]
            decomposition[PHASES[p]] = {
                "p50": _round_opt(sk.quantile(0.50)),
                "p95": _round_opt(sk.quantile(0.95)),
                "p99": _round_opt(sk.quantile(0.99)),
            }
        total = float(self._phase_sum_ns[r].sum())
        share = {
            PHASES[p]: round(float(self._phase_sum_ns[r, p]) / total, 6)
            for p in range(N_PHASES)
            if total > 0.0 and float(self._phase_sum_ns[r, p]) > 0.0
        }
        # the attribution audit: attributed phase time over measured TTC
        # — 1.0 by construction, drifts only if a caller's vector stops
        # summing to its measured total
        ttc_total = float(self._ttc_sum_ns[r])
        ratio = round(total / ttc_total, 6) if ttc_total > 0.0 else None
        dominant = (
            PHASES[int(np.argmax(self._dominant[r]))] if completed else None
        )
        tail_block = self._tail_block_locked(r, ttc_ms["p99"])
        return {
            "completed": completed,
            "ttc_ms": ttc_ms,
            "decomposition_ms": decomposition,
            "phase_share": share,
            "decomp_ratio": ratio,
            "dominant_phase": dominant,
            "tail": tail_block,
        }

    def _tail_block_locked(self, r: int, p99_ms: float | None) -> dict:
        """The slowest-K view of one region: which phase dominates the
        kept tail, and the exemplar nearest the p99 as a concrete
        end-to-end decomposition that sums to ITS measured TTC."""
        kept = self._slow_seq[r] >= 0
        if not bool(kept.any()):
            return {"kept": 0, "dominant_phase": None, "p99_exemplar": None}
        phases = self._slow_phase[r][kept]
        dominant = PHASES[int(np.argmax(phases.sum(axis=0)))]
        exemplar = None
        if p99_ms is not None:
            ttc = self._slow_ttc[r][kept]
            order = np.argsort(np.abs(ttc / 1e6 - p99_ms), kind="stable")
            pick = int(order[0])
            exemplar = {
                "seq": int(self._slow_seq[r][kept][pick]),
                "ttc_ms": round(float(ttc[pick]) / 1e6, 3),
                "phases_ms": {
                    PHASES[p]: round(float(phases[pick, p]) / 1e6, 3)
                    for p in range(N_PHASES)
                    if float(phases[pick, p]) > 0.0
                },
                "sum_ms": round(float(phases[pick].sum()) / 1e6, 3),
            }
        return {
            "kept": int(kept.sum()),
            "dominant_phase": dominant,
            "p99_exemplar": exemplar,
        }

    def _windows_locked(
        self, crash_rounds: list[int], window_rounds: int
    ) -> tuple[list[dict], str | None]:
        """Per-kill-window dominant phases from the round matrix, plus
        the baseline dominant phase over every round outside a window."""
        last = self._max_round
        in_window = np.zeros(max(last + 1, 1), bool)
        windows: list[dict] = []
        for k in crash_rounds:
            lo = max(int(k), 0)
            hi = min(lo + window_rounds - 1, last)
            if hi < lo:
                windows.append({
                    "round": int(k), "until": int(k),
                    "dominant_phase": None, "phase_ms": {},
                    "tail_dominant_phase": None, "slowest_ttc_ms": None,
                })
                continue
            in_window[lo:hi + 1] = True
            row = self._round_phase_ns[lo:hi + 1].sum(axis=0)
            # tail view: the window's single slowest completion. Mass
            # argmax can bury a kill under healthy traffic (a trough
            # kill hurts few downloads); the worst download cannot hide.
            slow = self._round_slow_ttc[lo:hi + 1]
            s = int(np.argmax(slow))
            tail_dom = None
            slowest_ms = None
            if float(slow[s]) > 0.0:
                tail_dom = PHASES[int(np.argmax(self._round_slow_phase[lo + s]))]
                slowest_ms = round(float(slow[s]) / 1e6, 2)
            windows.append({
                "round": int(k),
                "until": hi,
                "dominant_phase": (
                    PHASES[int(np.argmax(row))] if float(row.sum()) > 0.0
                    else None
                ),
                "phase_ms": {
                    PHASES[p]: round(float(row[p]) / 1e6, 2)
                    for p in range(N_PHASES)
                    if float(row[p]) > 0.0
                },
                "tail_dominant_phase": tail_dom,
                "slowest_ttc_ms": slowest_ms,
            })
        baseline = None
        if last >= 0:
            base = self._round_phase_ns[: last + 1][~in_window[: last + 1]]
            if base.size:
                row = base.sum(axis=0)
                if float(row.sum()) > 0.0:
                    baseline = PHASES[int(np.argmax(row))]
        return windows, baseline

    def dump(self, last_n: int = 64) -> dict:
        """Plain-data snapshot for ``flight.dump()`` / ``/debug/flight``:
        the per-region summary plus the newest ``last_n`` exemplars (the
        byte-cap truncation loop sheds the ``exemplars`` list)."""
        with self._mu:
            regions = {
                name: self._region_block_locked(r)
                for r, name in enumerate(self.regions)
            }
            completions = int(self._completions.sum())
            digest = self._digest_locked()
        exemplars = self.exemplar_rows()
        exemplars = exemplars[-last_n:] if last_n > 0 else []
        self.mirror_metrics()
        return {
            "name": self.name or "tail",
            "phases": list(PHASES),
            "completions": completions,
            "regions": regions,
            "exemplars": exemplars,
            "digest": digest,
        }

    # ------------------------------------------------------------- digest

    def _digest_locked(self) -> str:
        """blake2b over every deterministic column and aggregate. All
        recorded values derive from the caller's clock (virtual ns on
        the event plane), so paired-seed megascale runs must match bit
        for bit — the tail twin of DecisionLedger.deterministic_digest."""
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64(self._completions.sum()).tobytes())
        h.update(np.int64(self._ring_count).tobytes())
        for arr in (
            self._completions, self._ttc_sum_ns, self._phase_sum_ns,
            self._dominant, self._round_phase_ns[: self._max_round + 1],
            self._round_slow_ttc[: self._max_round + 1],
            self._round_slow_phase[: self._max_round + 1],
            self._slow_ttc, self._slow_seq, self._slow_round,
            self._slow_phase, self._ring_seq, self._ring_region,
            self._ring_round, self._ring_ttc, self._ring_phase,
        ):
            h.update(np.ascontiguousarray(arr).tobytes())
        for sk in self._ttc_sketch:
            self._digest_sketch(h, sk)
        for row in self._phase_sketch:
            for sk in row:
                self._digest_sketch(h, sk)
        return h.hexdigest()

    @staticmethod
    def _digest_sketch(h: "hashlib._Hash", sk: QuantileSketch) -> None:
        h.update(np.int64(sk.count).tobytes())
        h.update(np.int64(sk._zero).tobytes())
        for idx in sorted(sk._buckets):
            h.update(np.int64(idx).tobytes())
            h.update(np.int64(sk._buckets[idx]).tobytes())

    def deterministic_digest(self) -> str:
        with self._mu:
            return self._digest_locked()

    # ------------------------------------------------------------ metrics

    def _child(self, family: Any, *labels: str) -> Any:
        key = (id(family),) + labels
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = family.labels(*labels)
        return child

    def mirror_metrics(self) -> None:
        """Refresh the gauge families from the aggregates (quantiles and
        shares move on every observe; exporting them lazily at dump/
        report time keeps the hot path to two counter bumps)."""
        source = self.name or "tail"
        with self._mu:
            per_region = [
                (name, self._ttc_sketch[r], self._phase_sum_ns[r].copy())
                for r, name in enumerate(self.regions)
            ]
            kept_uniform = min(self._ring_count, self.exemplar_capacity)
            kept_slow = int((self._slow_seq >= 0).sum())
        for name, sketch, sums in per_region:
            for q in (0.50, 0.95, 0.99):
                v = sketch.quantile(q)
                if v is not None:
                    self._child(
                        self._series.ttc_ms, source, name, f"p{int(q * 100)}"
                    ).set(v)
            total = float(sums.sum())
            if total > 0.0:
                for p in range(N_PHASES):
                    self._child(
                        self._series.phase_share, source, name, PHASES[p]
                    ).set(float(sums[p]) / total)
        self._child(self._series.exemplars_kept, source, "uniform").set(
            float(kept_uniform)
        )
        self._child(self._series.exemplars_kept, source, "slowest").set(
            float(kept_slow)
        )


def _round_opt(v: float | None, nd: int = 2) -> float | None:
    return None if v is None else round(v, nd)


# ----------------------------------------------------------- client plane

_default_mu = threading.Lock()
_DEFAULT: TailTrace | None = None


def default_tailtrace() -> TailTrace:
    """The daemon-side tracer (real client plane, wall-ns phases measured
    by client/daemon.py + client/conductor.py with ``perf_counter_ns``).
    Lazy so importing this module never allocates columns."""
    global _DEFAULT
    with _default_mu:
        if _DEFAULT is None:
            _DEFAULT = TailTrace(regions=("local",), name="dfdaemon.tail")
        return _DEFAULT
