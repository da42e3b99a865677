"""Port of dragonfly2_tpu/telemetry/slo.py: ``SLOEngine``,
``scheduler_slo_specs`` and the process verdict plane
(``health_verdict`` and its ``/debug/health`` query,
``parse_health_query``), what the scheduler service and its HTTP routes
run. The megascale SLI derivation and the artifact report come with the
modules that write them (ROADMAP A11).

Streaming SLO engine: declarative objectives over sliding good/bad
counters and multi-window multi-burn-rate alerting, after the Google SRE
workbook construction the reference operates under its Prometheus
alerting rules in ``deploy/``:

- :class:`SLOSpec` — one declarative objective: which SLI stream feeds
  it, the target good-event fraction, the error-budget accounting
  window, and its burn-rate alert rules (default: the fast-page 5m/1h
  pair at 14.4x budget burn and the slow-ticket 30m/6h pair at 6x).
- :class:`SLOEngine` — sliding good/bad event counters per SLO over a
  caller-supplied clock (the wall clock, ``perf_counter`` minutes, in
  the live service). A burn-rate alert fires only while BOTH its windows
  burn above the rule factor, so it pages fast on a real spike and
  clears as soon as the short window drains. Every engine folds its
  firing alerts into a three-state verdict (``ok`` / ``degraded`` /
  ``critical``) with the firing alerts as machine-readable causes, and
  exports the ``dragonfly_slo_*`` metric families.

Determinism contract (dflint DET domain): no wall-clock reads anywhere
in this module — callers stamp time. ``perf_counter`` is the one exempt
clock (live engines use it for window arithmetic, never for deciding
replay outcomes).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import weakref
from collections import deque
from typing import Any, Iterable, Mapping

SEVERITY_PAGE = "page"
SEVERITY_TICKET = "ticket"

VERDICT_OK = "ok"
VERDICT_DEGRADED = "degraded"
VERDICT_CRITICAL = "critical"
VERDICT_CODES = {VERDICT_OK: 0, VERDICT_DEGRADED: 1, VERDICT_CRITICAL: 2}
VERDICT_NAMES = {code: name for name, code in VERDICT_CODES.items()}


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """One multi-window burn-rate alert rule.

    Fires while the error-budget burn rate over BOTH windows is at or
    above ``factor`` (burn rate 1.0 = consuming exactly the budget).
    The long window gives detection confidence, the short window makes
    the alert clear quickly once the spike passes — reset time is
    bounded by ``short_minutes``, not ``long_minutes``."""

    name: str
    severity: str  # SEVERITY_PAGE | SEVERITY_TICKET
    long_minutes: float
    short_minutes: float
    factor: float


# The SRE-workbook standard pairs: page on a fast burn (14.4x budget
# over 1h+5m — a day's budget in 100 minutes), ticket on a slow burn
# (6x over 6h+30m).
DEFAULT_BURN_RULES: tuple[BurnRateRule, ...] = (
    BurnRateRule("fast_burn", SEVERITY_PAGE, 60.0, 5.0, 14.4),
    BurnRateRule("slow_burn", SEVERITY_TICKET, 360.0, 30.0, 6.0),
)

# Rules for LENIENT objectives (budget near 0.5, e.g. "no open breakers
# most of the time"): burn rate is bounded by 1/budget, so the standard
# 14.4x/6x factors are unreachable there — these fire on SUSTAINED
# near-total badness instead (error ~90% of intervals pages, ~60%
# tickets), same window pairs.
SUSTAINED_BURN_RULES: tuple[BurnRateRule, ...] = (
    BurnRateRule("sustained_page", SEVERITY_PAGE, 60.0, 5.0, 1.8),
    BurnRateRule("sustained_ticket", SEVERITY_TICKET, 360.0, 30.0, 1.2),
)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over a good/bad SLI event stream."""

    name: str
    sli: str
    objective: float  # target good fraction in (0, 1)
    description: str = ""
    window_minutes: float = 24.0 * 60.0  # error-budget accounting window
    burn_rules: tuple[BurnRateRule, ...] = DEFAULT_BURN_RULES
    # abstain below this many events in a rule's long window: one bad
    # event in an otherwise-empty window is noise, not a page
    min_events: int = 8

    def __post_init__(self) -> None:
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), "
                f"got {self.objective}"
            )
        if self.window_minutes <= 0:
            raise ValueError(f"SLO {self.name!r}: window_minutes must be > 0")

    @property
    def budget(self) -> float:
        """Allowed bad-event fraction (1 - objective)."""
        return 1.0 - self.objective

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "sli": self.sli,
            "objective": self.objective,
            "description": self.description,
            "window_minutes": self.window_minutes,
            "min_events": self.min_events,
            "burn_rules": [dataclasses.asdict(r) for r in self.burn_rules],
        }


class _SlidingCounter:
    """Bucketed good/bad counts over a monotone clock in minutes.

    ``observe`` accumulates into the bucket holding ``t``; buckets older
    than ``max_minutes`` prune on append, so memory is bounded by
    ``max_minutes / bucket_minutes``. ``totals(window, now)`` sums the
    buckets younger than the window (clamped to at least one bucket, so
    a 5-minute alert window still reads the current 15-minute megascale
    round instead of nothing). Deterministic: pure arithmetic over the
    caller's clock."""

    __slots__ = ("bucket_minutes", "max_minutes", "_buckets")

    def __init__(self, bucket_minutes: float, max_minutes: float) -> None:
        self.bucket_minutes = max(bucket_minutes, 1e-6)
        self.max_minutes = max_minutes
        # each entry: [bucket_start_minute, good, bad]
        self._buckets: deque[list[float]] = deque()

    def observe(self, t_minutes: float, good: float, bad: float) -> None:
        start = (t_minutes // self.bucket_minutes) * self.bucket_minutes
        buckets = self._buckets
        if buckets and buckets[-1][0] == start:
            buckets[-1][1] += good
            buckets[-1][2] += bad
        else:
            buckets.append([start, good, bad])
        horizon = t_minutes - self.max_minutes
        while buckets and buckets[0][0] < horizon:
            buckets.popleft()

    def totals(self, window_minutes: float, now_minutes: float) -> tuple[float, float]:
        window = max(window_minutes, self.bucket_minutes)
        cutoff = now_minutes - window
        good = bad = 0.0
        for start, g, b in reversed(self._buckets):
            if start <= cutoff:
                break
            good += g
            bad += b
        return good, bad


@dataclasses.dataclass
class _AlertState:
    firing: bool = False
    fired_t: float | None = None
    fired_count: int = 0


class SLOEngine:
    """Streaming evaluator for a set of :class:`SLOSpec`.

    Usage: ``observe(sli, good=, bad=)`` any number of times per
    interval, then ``step(t)`` once to close the interval at clock
    ``t`` (in caller units; ``minutes_per_unit`` converts — rounds on
    the megascale event clock, minutes on the wall clock). ``step``
    evaluates every objective, runs the burn-rate alert state machines,
    mirrors the results into the ``dragonfly_slo_*`` families, and
    returns the verdict columns for the caller's timeline sample."""

    def __init__(
        self,
        specs: Iterable[SLOSpec],
        name: str | None = None,
        minutes_per_unit: float = 1.0,
        bucket_minutes: float | None = None,
        registry: Any = None,
        alert_log_limit: int = 1024,
    ) -> None:
        specs = tuple(specs)
        seen: dict[str, SLOSpec] = {}
        for spec in specs:
            if spec.name in seen:
                raise ValueError(f"duplicate SLO name {spec.name!r}")
            seen[spec.name] = spec
        self.specs: dict[str, SLOSpec] = seen
        self.name = name or "slo"
        self.minutes_per_unit = minutes_per_unit
        bucket = bucket_minutes if bucket_minutes is not None else minutes_per_unit
        self._mu = threading.Lock()
        self._counters: dict[str, _SlidingCounter] = {}
        self._specs_by_sli: dict[str, list[SLOSpec]] = {}
        for spec in specs:
            longest = max(
                [spec.window_minutes]
                + [r.long_minutes for r in spec.burn_rules]
            )
            self._counters[spec.name] = _SlidingCounter(bucket, longest)
            self._specs_by_sli.setdefault(spec.sli, []).append(spec)
        self._pending: dict[str, list[float]] = {}
        self._alerts: dict[tuple[str, str], _AlertState] = {
            (spec.name, rule.name): _AlertState()
            for spec in specs
            for rule in spec.burn_rules
        }
        self.alert_log: deque[dict] = deque(maxlen=alert_log_limit)
        self.pages_fired = 0
        self.tickets_fired = 0
        self._last_eval: dict[str, dict] = {}
        self._last_t: float | None = None
        # cause enrichment from the tail plane (telemetry/tailtrace.py):
        # the lifecycle phase dominating the interval's completions —
        # set per-sample so a firing TTC page can NAME what it burns on
        self._tail_hint: str | None = None
        from dragonfly2_tpu_torch.telemetry import metrics as _metrics
        from dragonfly2_tpu_torch.telemetry.series import slo_series

        reg = registry if registry is not None else _metrics.default_registry()
        self._series = slo_series(reg)
        self._children: dict[tuple, Any] = {}
        if name is not None:
            register_engine(name, self)

    # ------------------------------------------------------------- feeding

    def set_tail_hint(self, phase: "str | None") -> None:
        """Record the lifecycle phase dominating the current interval's
        completions (tailtrace.round_dominant). TTC-objective causes in
        the next verdict carry it as ``dominant_phase`` — a firing TTC
        page then names WHERE the burn lives. Fed from the timeline
        sample (a pure function of it), so offline replays reproduce the
        identical enriched causes."""
        with self._mu:
            self._tail_hint = phase or None

    def observe(self, sli: str, good: float = 0.0, bad: float = 0.0) -> None:
        """Accumulate good/bad events for ``sli`` into the open interval
        (closed by the next :meth:`step`)."""
        if good == 0.0 and bad == 0.0:
            return
        with self._mu:
            acc = self._pending.setdefault(sli, [0.0, 0.0])
            acc[0] += good
            acc[1] += bad

    def step(self, t: float) -> dict:
        """Close the interval at clock ``t``: stamp pending events,
        evaluate every SLO, run the alert state machines, export
        metrics. Returns the verdict columns (plain scalars plus the
        interval's alert ``transitions``)."""
        now_min = t * self.minutes_per_unit
        with self._mu:
            pending, self._pending = self._pending, {}
            for sli, (good, bad) in pending.items():
                for spec in self._specs_by_sli.get(sli, []):
                    self._counters[spec.name].observe(now_min, good, bad)
                self._export_events(sli, good, bad)
            transitions: list[dict] = []
            evals: dict[str, dict] = {}
            for spec in self.specs.values():
                evals[spec.name] = self._evaluate_locked(
                    spec, now_min, t, transitions
                )
            self._last_eval = evals
            self._last_t = t
            verdict = self._verdict_locked()
            pages, tickets = self.pages_fired, self.tickets_fired
        self._export_verdict(verdict)
        return {
            "verdict": verdict["state"],
            "verdict_code": verdict["state_code"],
            "alerts_firing": len(verdict["causes"]),
            "pages_fired": pages,
            "tickets_fired": tickets,
            "transitions": transitions,
        }

    def _evaluate_locked(
        self, spec: SLOSpec, now_min: float, t: float,
        transitions: list[dict],
    ) -> dict:
        counter = self._counters[spec.name]
        good_w, bad_w = counter.totals(spec.window_minutes, now_min)
        total_w = good_w + bad_w
        error_rate = bad_w / total_w if total_w else 0.0
        allowed = spec.budget * total_w
        budget_remaining = 1.0 - (bad_w / allowed) if allowed > 0 else 1.0
        burns: dict[str, dict] = {}
        for rule in spec.burn_rules:
            g_l, b_l = counter.totals(rule.long_minutes, now_min)
            g_s, b_s = counter.totals(rule.short_minutes, now_min)
            n_l, n_s = g_l + b_l, g_s + b_s
            burn_long = (b_l / n_l) / spec.budget if n_l else 0.0
            burn_short = (b_s / n_s) / spec.budget if n_s else 0.0
            firing = (
                n_l >= spec.min_events
                and burn_long >= rule.factor
                and burn_short >= rule.factor
            )
            state = self._alerts[(spec.name, rule.name)]
            if firing and not state.firing:
                state.firing = True
                state.fired_t = t
                state.fired_count += 1
                if rule.severity == SEVERITY_PAGE:
                    self.pages_fired += 1
                else:
                    self.tickets_fired += 1
                self._child(
                    self._series.alerts_fired, self.name, spec.name,
                    rule.name, rule.severity,
                ).inc()
                event = self._log_transition(
                    t, spec, rule, "fired", burn_long, burn_short
                )
                transitions.append(event)
            elif not firing and state.firing:
                state.firing = False
                event = self._log_transition(
                    t, spec, rule, "cleared", burn_long, burn_short
                )
                transitions.append(event)
            burns[rule.name] = {
                "severity": rule.severity,
                "factor": rule.factor,
                "burn_long": round(burn_long, 4),
                "burn_short": round(burn_short, 4),
                "firing": state.firing,
            }
            self._export_rule(spec, rule, burn_long, burn_short, state.firing)
        self._export_budget(spec, budget_remaining)
        return {
            "sli": spec.sli,
            "objective": spec.objective,
            "events": round(total_w, 3),
            "bad_events": round(bad_w, 3),
            "error_rate": round(error_rate, 6),
            "budget_remaining": round(budget_remaining, 4),
            "burn": burns,
        }

    def _log_transition(
        self, t: float, spec: SLOSpec, rule: BurnRateRule, event: str,
        burn_long: float, burn_short: float,
    ) -> dict:
        entry = {
            "t": t,
            "slo": spec.name,
            "rule": rule.name,
            "severity": rule.severity,
            "event": event,
            "burn_long": round(burn_long, 4),
            "burn_short": round(burn_short, 4),
        }
        self.alert_log.append(entry)
        return entry

    # ------------------------------------------------------------ verdicts

    def _verdict_locked(self) -> dict:
        causes: list[dict] = []
        for (slo_name, rule_name), state in self._alerts.items():
            if not state.firing:
                continue
            spec = self.specs[slo_name]
            rule = next(r for r in spec.burn_rules if r.name == rule_name)
            burn = (self._last_eval.get(slo_name) or {}).get("burn", {})
            cause = {
                "slo": slo_name,
                "rule": rule_name,
                "severity": rule.severity,
                "since_t": state.fired_t,
                **{
                    k: (burn.get(rule_name) or {}).get(k)
                    for k in ("burn_long", "burn_short")
                },
            }
            if slo_name.startswith("ttc") and self._tail_hint:
                # the tail plane's per-interval attribution: the phase a
                # firing TTC objective is actually burning on
                cause["dominant_phase"] = self._tail_hint
            causes.append(cause)
        if any(c["severity"] == SEVERITY_PAGE for c in causes):
            state_name = VERDICT_CRITICAL
        elif causes:
            state_name = VERDICT_DEGRADED
        else:
            state_name = VERDICT_OK
        return {
            "state": state_name,
            "state_code": VERDICT_CODES[state_name],
            "causes": causes,
            "t": self._last_t,
        }

    def verdict(self) -> dict:
        """The engine's current three-state health verdict with its
        firing-alert causes (machine-readable plain data)."""
        with self._mu:
            return self._verdict_locked()

    def dump(self, last_n: int = 128) -> dict:
        """Plain-data snapshot for ``flight.dump()`` / ``/debug/health``
        / bench artifacts: specs, the latest per-SLO evaluation, the
        verdict, counters, and the newest ``last_n`` alert transitions."""
        with self._mu:
            verdict = self._verdict_locked()
            evals = dict(self._last_eval)
            log = list(self.alert_log)
        log = log[-last_n:] if last_n > 0 else []
        return {
            "name": self.name,
            "verdict": verdict,
            "specs": [s.to_dict() for s in self.specs.values()],
            "evaluations": evals,
            "pages_fired": self.pages_fired,
            "tickets_fired": self.tickets_fired,
            "alert_log": log,
        }

    # ------------------------------------------------------------- metrics

    def _child(self, family: Any, *labels: str) -> Any:
        key = (id(family),) + labels
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = family.labels(*labels)
        return child

    def _export_events(self, sli: str, good: float, bad: float) -> None:
        if good:
            self._child(self._series.sli_events, self.name, sli, "good").inc(good)
        if bad:
            self._child(self._series.sli_events, self.name, sli, "bad").inc(bad)

    def _export_rule(
        self, spec: SLOSpec, rule: BurnRateRule,
        burn_long: float, burn_short: float, firing: bool,
    ) -> None:
        s = self._series
        self._child(s.burn_rate, self.name, spec.name, rule.name, "long").set(burn_long)
        self._child(s.burn_rate, self.name, spec.name, rule.name, "short").set(burn_short)
        self._child(
            s.alert_state, self.name, spec.name, rule.name, rule.severity
        ).set(1.0 if firing else 0.0)

    def _export_budget(self, spec: SLOSpec, budget_remaining: float) -> None:
        self._child(
            self._series.budget_remaining, self.name, spec.name
        ).set(budget_remaining)

    def _export_verdict(self, verdict: dict) -> None:
        self._child(self._series.verdict_state, self.name).set(
            float(verdict["state_code"])
        )


# --------------------------------------------------- process-wide registry


_ENGINES: dict[str, "weakref.ref[SLOEngine]"] = {}
_engines_mu = threading.Lock()


def register_engine(name: str, engine: SLOEngine) -> None:
    """Weak named registry (mirrors flight.register_recorder) so the
    process-wide /debug/health and flight.dump surfaces find live SLO
    engines without a handle on their owners. Last registration wins."""
    with _engines_mu:
        _ENGINES[name] = weakref.ref(engine)


def live_engines() -> dict[str, SLOEngine]:
    out: dict[str, SLOEngine] = {}
    with _engines_mu:
        for name, ref in list(_ENGINES.items()):
            eng = ref()
            if eng is None:
                del _ENGINES[name]
            else:
                out[name] = eng
    return out


# ------------------------------------------------------ the verdict plane


# Hard payload bound for the /debug/health routes: the verdict is meant
# for probes and dashboards, not bulk export — far smaller than the
# flight dump's 2 MiB.
HEALTH_MAX_BYTES = 256 << 10


def parse_health_query(query: str) -> dict:
    """``?last_n=&max_bytes=`` → :func:`health_verdict` kwargs — shared
    by the mux and monitor ``/debug/health`` routes (the same contract
    as flight.parse_flight_query). Raises ValueError with a
    client-facing message on bad input (the routes answer 400)."""
    import urllib.parse as _up

    kwargs: dict = {}
    for key, value in _up.parse_qsl(query or ""):
        if key == "last_n":
            try:
                kwargs["last_n"] = max(int(value), 0)
            except ValueError:
                raise ValueError("last_n must be an integer") from None
        elif key == "max_bytes":
            try:
                kwargs["max_bytes"] = max(int(value), 1024)
            except ValueError:
                raise ValueError("max_bytes must be an integer") from None
    return kwargs


def _health_nbytes(body: Mapping[str, Any]) -> int:
    return len(json.dumps(body, separators=(",", ":"), default=str))


def health_verdict(last_n: int = 32,
                   max_bytes: int | None = HEALTH_MAX_BYTES) -> dict:
    """The process health verdict: every live SLO engine's verdict
    merged worst-wins, with firing alerts as causes and the newest
    alert transitions. Plain data; ``max_bytes`` is a hard compact-JSON
    cap enforced by shedding alert-log entries oldest-first (then the
    per-SLO evaluation detail) with a ``truncated`` marker."""
    engines = live_engines()
    worst = VERDICT_OK
    causes: list[dict] = []
    slos: dict[str, dict] = {}
    log: list[dict] = []
    for name in sorted(engines):
        eng = engines[name]
        d = eng.dump(last_n=last_n)
        v = d["verdict"]
        if VERDICT_CODES[v["state"]] > VERDICT_CODES[worst]:
            worst = v["state"]
        for cause in v["causes"]:
            causes.append({"source": name, **cause})
        slos[name] = {
            "state": v["state"],
            "pages_fired": d["pages_fired"],
            "tickets_fired": d["tickets_fired"],
            "evaluations": d["evaluations"],
        }
        # per-source tails, NOT one merged tail-slice: engines run on
        # different clocks (event rounds vs wall minutes), so a global
        # sort or slice would let one engine's backlog displace another
        # engine's newer — possibly currently-firing — transitions.
        # Each engine's dump already bounds its own log to last_n
        # (newest-last); byte growth is bounded by the max_bytes shed.
        for entry in d["alert_log"]:
            log.append({"source": name, **entry})
    body: dict = {
        "state": worst,
        "state_code": VERDICT_CODES[worst],
        "causes": causes,
        "slos": slos,
        "alert_log": log,
        "sources": sorted(engines),
    }
    if max_bytes is not None and _health_nbytes(body) > max_bytes:
        dropped = 0
        while body["alert_log"] and _health_nbytes(body) > max_bytes:
            shed = max(len(body["alert_log"]) // 2, 1)
            dropped += shed
            body["alert_log"] = body["alert_log"][shed:]
            body["truncated"] = {
                "max_bytes": max_bytes, "dropped_alert_log": dropped,
            }
        if _health_nbytes(body) > max_bytes:
            # evaluation detail is the next-largest variable block; the
            # scalar skeleton (state/causes/sources) is the floor
            for entry in body["slos"].values():
                entry.pop("evaluations", None)
            body["truncated"] = {
                "max_bytes": max_bytes, "dropped_alert_log": dropped,
                "dropped_evaluations": True,
            }
    return body


# ------------------------------------------------- scheduler (wall clock)


def scheduler_slo_specs(tick_budget_ms: float) -> tuple[SLOSpec, ...]:
    """The live scheduler's SLO set: tick latency against its budget
    (PhaseRecorder is the timing source of record; the SLI counts whole
    ticks over/under budget), shadow regret from the decision ledger
    (disagreement decisions count against the budget only while the
    measured fail-rate regret says the active arm is losing), and the
    process breaker census."""
    return (
        SLOSpec(
            "tick_latency", sli="tick_latency", objective=0.99,
            description=f"scheduler ticks completing within "
                        f"{tick_budget_ms:.0f} ms",
        ),
        SLOSpec(
            "shadow_regret", sli="shadow_regret", objective=0.5,
            burn_rules=SUSTAINED_BURN_RULES,
            description="shadow-scored decisions where the active arm "
                        "is not measurably losing to the inactive arm",
        ),
        SLOSpec(
            "breaker_health", sli="breakers", objective=0.5,
            burn_rules=SUSTAINED_BURN_RULES,
            description="evaluation intervals without open circuit "
                        "breakers anywhere in the process",
        ),
    )
