"""Port of dragonfly2_tpu/scenarios/engine.py, whole: ``ScenarioEngine``
and ``FaultInjector``.

Deterministic scenario engine: (spec, seed) → heterogeneity + faults.

Every stochastic decision is COUNTER-BASED, not stream-based: a decision
is ``u = blake2b(seed, kind, *key) / 2^64`` over a semantic key (host
ids, task index, piece number, attempt number) rather than a draw from a
shared RNG stream. That makes the injected fault schedule a pure function
of (spec, seed, event identity): two runs of the same replay produce the
same schedule even though the surrounding code allocates uuids, runs GC
off wall clocks, or interleaves differently — the determinism contract
the scenario A/B test pins (no ``Date.now``-style nondeterminism can leak
in, because no decision reads a clock or an ordered stream).

The engine serves three consumers:

- ``cluster/simulator.py``: piece costs from the link model, churn and
  flaky-parent events, Zipf task popularity, probe RTTs;
- ``client/upload.py`` via ``FaultInjector``: piece-serving errors and
  stalls injected at a REAL parent daemon, so a child's conductor
  exercises its genuine retry path (DownloadPieceFailedRequest →
  reschedule → blocklist → back-to-source). Verdicts are per-attempt
  deterministic; bit-exact schedule replay additionally needs a
  deterministic serve order (see FaultInjector's docstring);
- ``scenarios/ab.py``: schedule digests for the determinism check.
"""

from __future__ import annotations

import hashlib
import math
import statistics
import threading

from dragonfly2_tpu_torch.scenarios.spec import ScenarioSpec

_U64 = float(1 << 64)
_NORM = statistics.NormalDist()


def _u(seed: int, kind: str, *key) -> float:
    """Deterministic uniform in [0, 1) from (seed, kind, key...)."""
    h = hashlib.blake2b(digest_size=8)
    h.update((f"{seed}:{kind}:" + ":".join(str(k) for k in key)).encode())
    return int.from_bytes(h.digest(), "big") / _U64


def _lognorm(u: float, sigma: float) -> float:
    """Deterministic lognormal(0, sigma) sample from one uniform via the
    inverse-CDF transform (stdlib NormalDist probit)."""
    u = min(max(u, 1e-12), 1.0 - 1e-12)
    return math.exp(sigma * _NORM.inv_cdf(u))


NS_PER_MS = 1_000_000


class ScenarioEngine:
    """Deterministic sampler for one (spec, seed, host population)."""

    def __init__(self, spec: ScenarioSpec, hosts, seed: int = 0):
        """`hosts` is any sequence of objects with ``.id``, ``.idc``,
        ``.location`` (records/synth.SynthHost or equivalents)."""
        self.spec = spec
        self.seed = seed
        self.hosts = list(hosts)
        self._schedule = hashlib.blake2b(digest_size=16)
        self._schedule_events = 0
        link = spec.link

        # ---- per-host assignments: deterministic in host ID, not order
        self.bandwidth: dict[str, float] = {}
        self.flaky_hosts: set[str] = set()
        self._rack: dict[str, str] = {}
        self._region: dict[str, str] = {}
        self._idc: dict[str, str] = {}
        for h in self.hosts:
            bw = link.base_bandwidth_bps
            if link.slow_fraction > 0 and _u(seed, "slow_mode", h.id) < link.slow_fraction:
                bw *= link.slow_multiplier
            self.bandwidth[h.id] = bw
            if (
                spec.flaky.parent_fraction > 0
                and _u(seed, "flaky_host", h.id) < spec.flaky.parent_fraction
            ):
                self.flaky_hosts.add(h.id)
            loc = h.location.split("|")
            self._region[h.id] = loc[0] if loc else ""
            self._rack[h.id] = h.location  # full zone|rack path = the rack key
            self._idc[h.id] = h.idc
        # "one slow NIC": the k hosts with the smallest assignment hash —
        # a deterministic choice independent of host-list order
        if link.slow_nic_count > 0 and self.hosts:
            ranked = sorted(self.hosts, key=lambda h: _u(seed, "slow_nic", h.id))
            for h in ranked[: link.slow_nic_count]:
                self.bandwidth[h.id] = (
                    link.base_bandwidth_bps * link.slow_nic_multiplier
                )
        # per-epoch membership caches (offline/partitioned are pure
        # functions of (spec, seed, epoch) — recomputing them every round
        # is O(hosts) of blake2b at megascale)
        self._offline_cache: tuple[int, set[str]] | None = None
        self._partition_cache: tuple[int, set[str]] | None = None

    # -------------------------------------------------------- link model

    def rtt_ns(self, src, dst, key=()) -> int:
        """IDC/rack-structured RTT with deterministic jitter. `key`
        disambiguates repeated samples of the same pair (probe sequence
        numbers, piece attempts)."""
        link = self.spec.link
        if self._rack.get(src.id) == self._rack.get(dst.id) and src.id != dst.id:
            base = link.same_rack_rtt_ms
        elif self._idc.get(src.id) == self._idc.get(dst.id):
            base = link.same_idc_rtt_ms
        elif self._region.get(src.id) == self._region.get(dst.id):
            base = link.same_region_rtt_ms
        else:
            base = link.cross_region_rtt_ms
        jitter = _lognorm(
            _u(self.seed, "rtt", src.id, dst.id, *key), link.rtt_jitter_sigma
        )
        return max(1, int(base * jitter * NS_PER_MS))

    def pair_bandwidth(self, child, parent) -> float:
        """Effective parent→child bandwidth: the parent NIC's capacity,
        divided by the spine oversubscription when the path crosses
        racks."""
        link = self.spec.link
        bw = self.bandwidth.get(parent.id, link.base_bandwidth_bps)
        if (
            link.spine_oversubscription > 1.0
            and self._rack.get(child.id) != self._rack.get(parent.id)
        ):
            bw /= link.spine_oversubscription
        return max(bw, 1.0)

    def piece_cost_ns(
        self, child, parent, piece_length: int, task_idx: int,
        piece: int, attempt: int,
    ) -> tuple[int, str | None]:
        """(cost_ns, fault) for one piece transfer. fault ∈ {None,
        "error", "stall", "corrupt"}: an error aborts the transfer through
        the retry path; a stall completes but carries the stall in its
        cost; a corrupt transfer completes with WRONG bytes — the child's
        digest verification refuses them and reports reason="corruption"
        (the quarantine path)."""
        key = (task_idx, piece, attempt)
        rtt = self.rtt_ns(child, parent, key=key)
        bw = self.pair_bandwidth(child, parent)
        service_s = piece_length / bw
        jitter = _lognorm(
            _u(self.seed, "svc", child.id, parent.id, *key),
            self.spec.link.bandwidth_jitter_sigma,
        )
        cost = rtt + int(service_s * jitter * 1e9)
        fault = None
        flaky = self.spec.flaky
        if parent.id in self.flaky_hosts:
            roll = _u(self.seed, "flake", child.id, parent.id, *key)
            if roll < flaky.piece_error_rate:
                fault = "error"
            elif roll < flaky.piece_error_rate + flaky.piece_stall_rate:
                fault = "stall"
                cost += int(flaky.stall_seconds * 1e9)
            elif roll < (flaky.piece_error_rate + flaky.piece_stall_rate
                         + flaky.piece_corrupt_rate):
                fault = "corrupt"
            if fault is not None:
                self._record(fault, parent.id, *key)
        return cost, fault

    # ------------------------------------------------------------- churn

    def crash_point(self, registration_index: int, n_pieces: int) -> int | None:
        """Piece count after which this download crashes, or None. Keyed
        on the simulator's deterministic registration counter (peer uuids
        are process-random and MUST NOT key schedule decisions)."""
        churn = self.spec.churn
        if churn.peer_crash_rate <= 0:
            return None
        if _u(self.seed, "crash", registration_index) >= churn.peer_crash_rate:
            return None
        self._record("crash", registration_index)
        return max(1, int(n_pieces * churn.crash_progress))

    def offline_hosts(self, round_idx: int) -> set[str]:
        """Host ids off the announce plane during this round's epoch.
        Membership re-rolls per epoch so hosts flap rather than die.
        Cached per epoch — the membership is a pure function of (spec,
        seed, epoch), and re-hashing every host every round was O(hosts)
        per round at megascale (0.5 s/round at 10^5 hosts). Callers must
        not mutate the returned set."""
        churn = self.spec.churn
        if churn.host_leave_rate <= 0:
            return set()
        epoch = round_idx // max(churn.leave_epoch_rounds, 1)
        if self._offline_cache is not None and self._offline_cache[0] == epoch:
            return self._offline_cache[1]
        out = {
            h.id
            for h in self.hosts
            if _u(self.seed, "leave", epoch, h.id) < churn.host_leave_rate
        }
        self._offline_cache = (epoch, out)
        return out

    # ----------------------------------------------------- control plane

    def scheduler_crashed(self, round_idx: int) -> bool:
        """True exactly on the FIRST round of an epoch whose crash roll
        hit: the scheduler loses its in-memory state and every announce
        stream at once. Deterministic in (spec, seed, epoch) — replays
        crash at identical rounds."""
        control = self.spec.control
        if control.scheduler_crash_rate <= 0:
            return False
        epoch_len = max(control.crash_epoch_rounds, 1)
        if round_idx % epoch_len != 0 or round_idx == 0:
            return False
        epoch = round_idx // epoch_len
        if _u(self.seed, "sched_crash", epoch) >= control.scheduler_crash_rate:
            return False
        self._record("sched_crash", epoch)
        return True

    def crash_rounds(self, rounds: int) -> list[int]:
        """Pure PREVIEW of every round ``scheduler_crashed`` will fire on
        in ``[1, rounds]`` — same (spec, seed, epoch) arithmetic, but
        WITHOUT recording into the schedule digest, so reports and tests
        can annotate a soak timeline's kill schedule up front (the
        megascale engine marks the live events as they land; this is the
        expected-schedule cross-check)."""
        control = self.spec.control
        if control.scheduler_crash_rate <= 0:
            return []
        epoch_len = max(control.crash_epoch_rounds, 1)
        return [
            r for r in range(epoch_len, rounds + 1, epoch_len)
            if _u(self.seed, "sched_crash", r // epoch_len)
            < control.scheduler_crash_rate
        ]

    def scheduler_crash_point(self, task_idx: int, n_pieces: int) -> int | None:
        """Real-socket chaos e2e: the piece count after which the task's
        hashring-primary scheduler is killed, or None when this task's
        crash roll missed. Keyed on the task index so the same (spec,
        seed, task) always kills at the same progress point."""
        control = self.spec.control
        if control.scheduler_crash_rate <= 0:
            return None
        if _u(self.seed, "sched_crash_task", task_idx) >= control.scheduler_crash_rate:
            return None
        self._record("sched_crash_task", task_idx)
        return max(1, min(n_pieces - 1, int(n_pieces * control.crash_progress)))

    def partitioned_hosts(self, round_idx: int) -> set[str]:
        """Hosts whose announce-plane link is silently blackholed this
        epoch: unlike churn's leave/rejoin, the scheduler receives no
        LeaveHost — their requests and its responses just vanish, the
        shape a stateful-firewall drop or asymmetric route takes."""
        control = self.spec.control
        if control.partition_rate <= 0:
            return set()
        epoch = round_idx // max(control.partition_epoch_rounds, 1)
        if self._partition_cache is not None and self._partition_cache[0] == epoch:
            return self._partition_cache[1]
        out = {
            h.id
            for h in self.hosts
            if _u(self.seed, "partition", epoch, h.id) < control.partition_rate
        }
        self._partition_cache = (epoch, out)
        return out

    # ----------------------------------------------- megascale traffic

    def diurnal_multiplier(self, round_idx: int) -> float:
        """Arrival-rate multiplier for this round of the compressed day:
        a raised cosine between trough and peak (trough at round 0, peak
        mid-day). Pure function of (spec, round) — no sampling."""
        traffic = self.spec.traffic
        if traffic.day_rounds <= 0:
            return 1.0
        phase = (round_idx % traffic.day_rounds) / traffic.day_rounds
        lo, hi = traffic.trough_multiplier, traffic.peak_multiplier
        return lo + (hi - lo) * 0.5 * (1.0 - math.cos(2.0 * math.pi * phase))

    def flash_crowds(self, round_idx: int, n_tasks: int) -> list[int]:
        """Hot task ranks under an active flash-crowd storm this round
        (empty = no storm). Each of the day's `events_per_day` storms
        starts at a deterministic (seed, day, event) round and pins
        `hot_tasks` deterministic task ranks for `duration_rounds`."""
        flash = self.spec.flash
        day = self.spec.traffic.day_rounds or max(flash.duration_rounds * 8, 1)
        if flash.events_per_day <= 0 or n_tasks <= 0:
            return []
        d, r = divmod(round_idx, day)
        hot: list[int] = []
        span = max(day - flash.duration_rounds, 1)
        for e in range(flash.events_per_day):
            start = int(_u(self.seed, "flash_start", d, e) * span)
            if start <= r < start + flash.duration_rounds:
                if r == start:
                    self._record("flash", d, e)
                for t in range(flash.hot_tasks):
                    hot.append(int(_u(self.seed, "flash_task", d, e, t) * n_tasks))
        return hot

    def upgrade_window(self, round_idx: int) -> tuple[float, float] | None:
        """Host-order fraction window [lo, hi) currently restarting under
        a rolling-upgrade wave, or None. The window (width =
        `cohort_fraction`) sweeps 0 → 1 across the host order over
        `wave_rounds`; with hosts laid out in contiguous region blocks
        (megascale topology) that is a region-by-region rollout. Wave
        start rounds are deterministic in (seed, day, wave)."""
        upgrade = self.spec.upgrade
        day = self.spec.traffic.day_rounds or max(upgrade.wave_rounds * 2, 1)
        if upgrade.waves_per_day <= 0:
            return None
        d, r = divmod(round_idx, day)
        span = max(day - upgrade.wave_rounds, 1)
        for w in range(upgrade.waves_per_day):
            start = int(_u(self.seed, "upgrade_start", d, w) * span)
            if start <= r < start + upgrade.wave_rounds:
                progress = (r - start) / max(upgrade.wave_rounds, 1)
                lo = progress * (1.0 - upgrade.cohort_fraction)
                return (lo, lo + upgrade.cohort_fraction)
        return None

    def rotated_task_weights(self, n_tasks: int, round_idx: int) -> list[float] | None:
        """Time-varying Zipf popularity for the diurnal traffic model:
        the rank → task assignment rotates `rotate_hot_tasks` times per
        day by a deterministic (seed, rotation-epoch) offset, so WHICH
        content is hot changes through the day while the popularity
        SHAPE stays Zipf(traffic.zipf_alpha). Falls back to the static
        skew weights when the traffic model is off."""
        traffic = self.spec.traffic
        if traffic.day_rounds <= 0 or traffic.zipf_alpha <= 0:
            return self.task_weights(n_tasks)
        base = [
            1.0 / (rank + 1) ** traffic.zipf_alpha for rank in range(n_tasks)
        ]
        if traffic.rotate_hot_tasks > 0:
            phase_len = max(traffic.day_rounds // traffic.rotate_hot_tasks, 1)
            epoch = round_idx // phase_len
            offset = int(_u(self.seed, "task_rotation", epoch) * n_tasks)
            base = [base[(rank + offset) % n_tasks] for rank in range(n_tasks)]
        total = sum(base)
        return [x / total for x in base]

    # ------------------------------------------------------------- skew

    def task_weights(self, n_tasks: int) -> list[float] | None:
        """Zipf popularity weights over task indices (None = uniform)."""
        alpha = self.spec.skew.zipf_alpha
        if alpha <= 0:
            return None
        w = [1.0 / (rank + 1) ** alpha for rank in range(n_tasks)]
        total = sum(w)
        return [x / total for x in w]

    # --------------------------------------------------------- schedule

    def _record(self, kind: str, *key) -> None:
        self._schedule.update(f"{kind}:{':'.join(str(k) for k in key)};".encode())
        self._schedule_events += 1

    def schedule_digest(self) -> str:
        """Hash over every fault/churn event decided so far — two runs of
        the same (spec, seed, replay) must produce identical digests."""
        return f"{self._schedule_events}:{self._schedule.copy().hexdigest()}"

    def fault_injector(self) -> "FaultInjector":
        return FaultInjector(self.spec, seed=self.seed)


class FaultInjector:
    """Piece-serving fault decisions for a REAL parent daemon's upload
    server (client/upload.py): the verdict is a pure function of (task,
    piece, serve-attempt NUMBER), so the first fetch of a piece may error
    while the retry succeeds — and the retry path actually recovers.

    Determinism scope: the bit-exact same-schedule guarantee holds when
    the serve ORDER is itself deterministic (one child per task, or the
    in-proc simulator/matrix path, whose events are counter-hashed).
    With multiple children racing fetches of the same piece over real
    sockets, which request lands attempt 0 vs 1 follows socket timing —
    per-attempt verdicts stay reproducible, attempt attribution does
    not. Attach to a daemon to make it the flaky parent (the engine's
    per-host flaky split does not apply here: the injector IS the flaky
    parent)."""

    def __init__(self, spec: ScenarioSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self.stall_seconds = spec.flaky.stall_seconds
        self._mu = threading.Lock()
        self._attempts: dict[tuple[str, int], int] = {}
        self.injected: dict[str, int] = {"error": 0, "stall": 0, "corrupt": 0}

    def piece_fault(self, task_id: str, piece: int) -> str | None:
        with self._mu:
            attempt = self._attempts.get((task_id, piece), 0)
            self._attempts[(task_id, piece)] = attempt + 1
        flaky = self.spec.flaky
        roll = _u(self.seed, "inj", task_id, piece, attempt)
        if roll < flaky.piece_error_rate:
            verdict = "error"
        elif roll < flaky.piece_error_rate + flaky.piece_stall_rate:
            verdict = "stall"
        elif roll < (flaky.piece_error_rate + flaky.piece_stall_rate
                     + flaky.piece_corrupt_rate):
            verdict = "corrupt"
        else:
            return None
        with self._mu:
            self.injected[verdict] += 1
        return verdict

    def corrupt_bytes(self, task_id: str, piece: int, data: bytes) -> bytes:
        """Deterministically corrupt one piece's bytes (the trust-boundary
        adversary): the SAME (task, piece) always corrupts the same way,
        so replays and the chaos e2e's byte-level assertions are stable.
        "bitflip" flips one deterministic bit; "truncate" drops a
        deterministic 1..64-byte tail. The serving side rewrites its
        advisory digest header to match (a consistent liar) — only the
        scheduler-attested chain catches the result."""
        if not data:
            return data
        mode = self.spec.flaky.corrupt_mode
        u = _u(self.seed, "corrupt_at", task_id, piece)
        if mode == "truncate":
            drop = 1 + int(u * min(len(data) - 1, 63)) if len(data) > 1 else 0
            return data[: len(data) - drop] if drop else b""
        # bitflip (default)
        bit = int(u * len(data) * 8)
        byte_i, bit_i = divmod(bit, 8)
        out = bytearray(data)
        out[byte_i] ^= 1 << bit_i
        return bytes(out)
