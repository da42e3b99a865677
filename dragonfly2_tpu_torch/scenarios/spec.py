"""Port of dragonfly2_tpu/scenarios/spec.py, whole.

Declarative scenario specs.

A scenario is a plain dataclass tree — serializable, diffable, loadable
from TOML or JSON — that fully determines (together with an integer seed)
the heterogeneity and faults injected into a run. The spec carries NO
randomness itself; all sampling lives in ``engine.ScenarioEngine`` so the
same spec document can drive the pure simulator, the A/B harness, and the
multiprocess e2e loop identically.

Knob ↔ reference semantics (see PARITY.md "Scenario lab"):

- ``LinkSpec`` RTT tiers mirror the networktopology probe structure the
  reference snapshots (same-IDC / same-region / cross-region RTT bands,
  scheduler/networktopology) — the scenario's link model is what the
  probe loop *measures*;
- ``FlakySpec`` models parents whose piece serving errors or stalls —
  exercised through the child's real retry path
  (DownloadPieceFailedRequest → reschedule → blocklist), not simulated
  around it;
- ``ChurnSpec`` models peers leaving/crashing mid-download and hosts
  dropping off the announce plane (LeaveHost) and returning;
- ``SkewSpec`` models hotspot task popularity (Zipf), the regime where a
  few blobs are downloaded cluster-wide and swarms get deep.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any


@dataclasses.dataclass
class LinkSpec:
    """Per-link RTT/bandwidth model.

    RTT tiers (ms) follow the synthetic IDC structure records/synth.py
    plants; bandwidth is per-HOST NIC capacity (bytes/s) with a bimodal
    fast/slow split, an optional oversubscribed spine penalty applied to
    cross-rack transfers, and an optional handful of pathologically slow
    NICs (the tail the rule blend cannot see until piece costs pile up).
    """

    same_rack_rtt_ms: float = 0.2
    same_idc_rtt_ms: float = 0.5
    same_region_rtt_ms: float = 5.0
    cross_region_rtt_ms: float = 60.0
    rtt_jitter_sigma: float = 0.3

    base_bandwidth_bps: float = 100e6  # bytes/s of a healthy NIC
    bandwidth_jitter_sigma: float = 0.25
    slow_fraction: float = 0.0         # fraction of hosts in the slow mode
    slow_multiplier: float = 1.0       # slow-mode bandwidth = base * this
    spine_oversubscription: float = 1.0  # cross-rack bandwidth divisor
    slow_nic_count: int = 0            # hosts with a pathological NIC
    slow_nic_multiplier: float = 0.05


@dataclasses.dataclass
class ChurnSpec:
    peer_crash_rate: float = 0.0   # P(a child crashes mid-download)
    crash_progress: float = 0.5    # crash lands after this piece fraction
    host_leave_rate: float = 0.0   # P(host offline in a given epoch)
    leave_epoch_rounds: int = 20   # offline membership re-rolls every N rounds


@dataclasses.dataclass
class FlakySpec:
    parent_fraction: float = 0.0   # fraction of hosts that serve flakily
    piece_error_rate: float = 0.0  # P(piece from a flaky parent errors)
    piece_stall_rate: float = 0.0  # P(piece from a flaky parent stalls)
    stall_seconds: float = 1.0     # injected stall duration
    # Deterministic CONTENT corruption (the trust-boundary adversary): a
    # corrupting parent serves bytes that differ from the origin's, with
    # its advisory digest header rewritten to match — only verification
    # against the scheduler-attested chain catches it. Modes: "bitflip"
    # (one deterministic bit flipped) or "truncate" (deterministic tail
    # dropped).
    piece_corrupt_rate: float = 0.0  # P(piece from a flaky parent corrupts)
    corrupt_mode: str = "bitflip"    # bitflip | truncate


@dataclasses.dataclass
class SkewSpec:
    zipf_alpha: float = 0.0        # 0 = uniform task popularity


@dataclasses.dataclass
class ControlPlaneSpec:
    """Control-plane fault events (the failure-domain resilience layer's
    adversary): scheduler crashes that sever every announce stream at
    once, and host↔scheduler partitions that silently blackhole the
    announce plane (no FIN — requests vanish). Like every other spec
    knob, the EVENTS are sampled deterministically by the engine from
    (spec, seed, event identity); these fields only set the rates."""

    scheduler_crash_rate: float = 0.0   # P(the scheduler crashes in an epoch)
    crash_epoch_rounds: int = 25        # crash opportunity every N rounds
    crash_progress: float = 0.5         # e2e: kill after this piece fraction
    partition_rate: float = 0.0         # P(a host is partitioned in an epoch)
    partition_epoch_rounds: int = 20    # partition membership re-rolls every N


@dataclasses.dataclass
class WanSpec:
    """Multi-region WAN hierarchy (megascale scenario lab). `regions=0`
    disables the hierarchy — the base single-region link model applies.
    With regions, hosts partition into contiguous region blocks, each
    region gets its own seed peers, intra-region paths keep the
    ``LinkSpec`` RTT tiers, and CROSS-region paths pay the WAN tier:
    `wan_rtt_ms` latency and a bandwidth cap of `wan_bandwidth_bps`
    (modeling the analytic link-tier characterization of arXiv
    2103.10515 — parameterized tiers, not packet simulation). A
    back-to-source escalation outside `origin_region` pays
    `back_to_source_penalty_ms` on top of the origin transfer."""

    regions: int = 0
    seeds_per_region: int = 2
    zones_per_region: int = 4
    racks_per_zone: int = 16
    wan_rtt_ms: float = 80.0
    wan_jitter_sigma: float = 0.3
    wan_bandwidth_bps: float = 25e6
    origin_region: int = 0
    back_to_source_penalty_ms: float = 250.0


@dataclasses.dataclass
class TrafficSpec:
    """Diurnal Zipf traffic arrival (time-varying task popularity).
    `day_rounds=0` disables — arrivals stay flat. Otherwise the per-round
    arrival count scales sinusoidally between `trough_multiplier` and
    `peak_multiplier` over a `day_rounds`-round compressed day, task
    popularity is Zipf(`zipf_alpha`) over rotated ranks, and the hot
    ranks rotate `rotate_hot_tasks` times per day (the "what is popular
    changes through the day" regime a static Zipf cannot express)."""

    day_rounds: int = 0
    peak_multiplier: float = 3.0
    trough_multiplier: float = 0.3
    zipf_alpha: float = 1.1
    rotate_hot_tasks: int = 0


@dataclasses.dataclass
class FlashCrowdSpec:
    """Flash-crowd preheat storms: `events_per_day` bursts at
    deterministic (seed, day, event) start rounds; during a burst,
    `arrival_multiplier` x the base arrival rate slams onto `hot_tasks`
    deterministically chosen task ranks for `duration_rounds` rounds —
    the release-day preheat stampede."""

    events_per_day: int = 0
    arrival_multiplier: float = 8.0
    duration_rounds: int = 6
    hot_tasks: int = 1


@dataclasses.dataclass
class UpgradeSpec:
    """Rolling-upgrade churn waves: `waves_per_day` sweeps per compressed
    day; each sweep moves a restart window of `cohort_fraction` of the
    fleet across the host order (region blocks first — the region-by-
    region rollout shape) over `wave_rounds` rounds. Hosts in the window
    are off the announce plane (LeaveHost) and re-announce when the
    window passes them."""

    waves_per_day: int = 0
    wave_rounds: int = 30
    cohort_fraction: float = 0.05


@dataclasses.dataclass
class ScenarioSpec:
    name: str = "homogeneous"
    description: str = ""
    link: LinkSpec = dataclasses.field(default_factory=LinkSpec)
    churn: ChurnSpec = dataclasses.field(default_factory=ChurnSpec)
    flaky: FlakySpec = dataclasses.field(default_factory=FlakySpec)
    skew: SkewSpec = dataclasses.field(default_factory=SkewSpec)
    control: ControlPlaneSpec = dataclasses.field(default_factory=ControlPlaneSpec)
    # megascale scenario lab (the reference's megascale/, ROADMAP A11): multi-region WAN
    # topology, diurnal arrival, flash crowds, rolling upgrades — all
    # default-disabled so every pre-existing builtin is bit-unchanged
    wan: WanSpec = dataclasses.field(default_factory=WanSpec)
    traffic: TrafficSpec = dataclasses.field(default_factory=TrafficSpec)
    flash: FlashCrowdSpec = dataclasses.field(default_factory=FlashCrowdSpec)
    upgrade: UpgradeSpec = dataclasses.field(default_factory=UpgradeSpec)

    # ------------------------------------------------------------- codecs

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "ScenarioSpec":
        spec = cls()
        for key, value in (data or {}).items():
            if not hasattr(spec, key):
                raise ValueError(f"unknown scenario field {key!r}")
            current = getattr(spec, key)
            if dataclasses.is_dataclass(current) and isinstance(value, dict):
                for k, v in value.items():
                    if not hasattr(current, k):
                        raise ValueError(f"unknown scenario field {key}.{k}")
                    setattr(current, k, type(getattr(current, k))(v))
            else:
                setattr(spec, key, value)
        return spec

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def to_toml(self) -> str:
        """Serialize to the flat ``[section] key = value`` TOML subset
        both parsers (stdlib ``tomllib`` and the <3.11 fallback) accept —
        the round-trip the parser-agreement test pins."""
        # top-level scalars first (TOML: root keys precede any [section]),
        # then one flat section per nested spec dataclass
        scalars: list[str] = []
        sections: list[str] = []
        for field in dataclasses.fields(self):
            value = getattr(self, field.name)
            if dataclasses.is_dataclass(value):
                sections.append(f"[{field.name}]")
                for sub in dataclasses.fields(value):
                    sections.append(
                        f"{sub.name} = {_toml_value(getattr(value, sub.name))}"
                    )
                sections.append("")
            else:
                scalars.append(f"{field.name} = {_toml_value(value)}")
        return "\n".join(scalars + [""] + sections)


def _toml_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, str):
        return json.dumps(value)  # TOML basic strings == JSON strings here
    if isinstance(value, float) and value == int(value) and abs(value) < 1e15:
        # tomllib keeps 1.0 a float; emit a form both parsers read as float
        return f"{value:.1f}"
    return repr(value)


def load_scenario(path: str | pathlib.Path) -> ScenarioSpec:
    """Load a spec from a ``.toml`` or ``.json`` file. TOML parsing uses
    stdlib ``tomllib`` (py3.11+) directly; on older interpreters the
    hand-rolled flat-section fallback below covers the spec grammar (the
    parser-agreement test pins that both read every builtin scenario
    identically)."""
    path = pathlib.Path(path)
    text = path.read_text()
    if path.suffix == ".toml":
        return ScenarioSpec.from_dict(_parse_toml(text))
    return ScenarioSpec.from_dict(json.loads(text))


def _parse_toml(text: str) -> dict[str, Any]:
    try:
        import tomllib  # py311+: the real parser
    except ImportError:
        return _parse_toml_fallback(text)
    return tomllib.loads(text)


def _parse_toml_fallback(text: str) -> dict[str, Any]:
    """Minimal ``[section] key = value`` parser for interpreters without
    ``tomllib`` (<3.11) — only the flat spec grammar, not general TOML."""
    root: dict[str, Any] = {}
    section = root
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            section = root.setdefault(line[1:-1].strip(), {})
            continue
        key, _, value = line.partition("=")
        section[key.strip()] = _coerce(value.strip())
    return root


def _coerce(value: str) -> Any:
    if value.startswith('"') and value.endswith('"'):
        try:
            # TOML basic strings share JSON's escape grammar — decoding
            # through json keeps the fallback byte-identical to tomllib
            # on escaped/non-ASCII content
            return json.loads(value)
        except json.JSONDecodeError:
            return value[1:-1]
    if value.startswith("'") and value.endswith("'"):
        return value[1:-1]  # TOML literal string: no escapes
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    return value


# --------------------------------------------------------------- builtins


def builtin_scenarios() -> dict[str, ScenarioSpec]:
    """The scenario grid BENCH_scenarios.json covers: a homogeneous
    control plus the structured adversarial conditions the learned
    evaluator exists for. Severity is deliberately strong — the point is
    exploitable structure, not realism tuning."""
    return {
        "homogeneous": ScenarioSpec(
            name="homogeneous",
            description="control: uniform NICs, no faults, uniform popularity",
        ),
        "bandwidth_skew": ScenarioSpec(
            name="bandwidth_skew",
            description=(
                "bimodal rack NICs (40% at 15% speed), 4x oversubscribed "
                "spine on cross-rack paths, plus 2 pathological slow NICs"
            ),
            link=LinkSpec(
                slow_fraction=0.4,
                slow_multiplier=0.15,
                spine_oversubscription=4.0,
                slow_nic_count=2,
                slow_nic_multiplier=0.02,
            ),
        ),
        "churn": ScenarioSpec(
            name="churn",
            description=(
                "15% of children crash mid-download; 10% of hosts flap "
                "off the announce plane each epoch"
            ),
            churn=ChurnSpec(
                peer_crash_rate=0.15,
                crash_progress=0.5,
                host_leave_rate=0.10,
                leave_epoch_rounds=15,
            ),
        ),
        "flaky_parent": ScenarioSpec(
            name="flaky_parent",
            description=(
                "30% of hosts serve flakily: 25% piece error rate, 10% "
                "stall rate — exercised through the real retry path"
            ),
            flaky=FlakySpec(
                parent_fraction=0.30,
                piece_error_rate=0.25,
                piece_stall_rate=0.10,
                stall_seconds=0.5,
            ),
        ),
        "corruption": ScenarioSpec(
            name="corruption",
            description=(
                "20% of hosts serve CORRUPT bytes on 30% of pieces "
                "(deterministic bit flips under a self-consistent digest "
                "header) plus a little plain flakiness — children verify "
                "against scheduler-attested digests, report "
                "reason=corruption, and the scheduler quarantines the "
                "corrupting parents (time-decayed release)"
            ),
            flaky=FlakySpec(
                parent_fraction=0.20,
                piece_error_rate=0.05,
                piece_corrupt_rate=0.30,
                corrupt_mode="bitflip",
            ),
        ),
        "hotspot": ScenarioSpec(
            name="hotspot",
            description="Zipf(1.2) task popularity: a few blobs go cluster-wide",
            skew=SkewSpec(zipf_alpha=1.2),
        ),
        "chaos": ScenarioSpec(
            name="chaos",
            description=(
                "control-plane chaos: scheduler crashes sever every "
                "announce stream (in-flight peers re-announce their kept "
                "pieces and the scheduler adopts them), 10% of hosts "
                "silently partitioned per epoch, plus peer churn and "
                "enough flaky serving that downloads span rounds — the "
                "failure-domain resilience gauntlet"
            ),
            churn=ChurnSpec(peer_crash_rate=0.05, crash_progress=0.5),
            # flaky parents keep downloads in flight across rounds, so
            # crashes and partitions catch real partial progress instead
            # of an empty pending queue
            flaky=FlakySpec(
                parent_fraction=0.25, piece_error_rate=0.15,
                piece_stall_rate=0.05, stall_seconds=0.2,
            ),
            control=ControlPlaneSpec(
                scheduler_crash_rate=0.6,
                crash_epoch_rounds=20,
                partition_rate=0.10,
                partition_epoch_rounds=15,
            ),
        ),
    }
