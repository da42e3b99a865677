"""Port of dragonfly2_tpu/megascale/engine.py, whole: the event pricing
stays numpy on the host, as in the reference; the device work is the
port's ``SchedulerService`` (its fused tick, evaluator and top-k), which
``megascale_service`` builds on the card unless asked for the CPU.

Event-batch simulation engine — the megascale scenario lab's core.

``ClusterSimulator`` (the per-peer oracle) drives the scheduler one
response at a time and one PIECE at a time: a Python loop per wave draws
each piece's cost/fault and reports it. That tops out around 10^4 hosts.
``EventBatchEngine`` subclasses it and keeps every protocol interaction
(arrival draws, registration, seed triggers, churn/crash/partition
handling) bit-identical — that is what makes the small-scale paired-seed
equivalence test possible — while replacing the per-piece wave loop with
ONE vectorized event batch per round over columnar peer state:

- per-download columns (task, host, region, have-bitset, wave, virtual
  transfer time) indexed by the deterministic registration counter, so a
  response's peer id decodes to its row with integer math, no dicts;
- a round's NormalTaskResponses expand into a flat (event,) table —
  (child, parent, task, piece, wave) — missing pieces enumerated from
  the have-bitsets in one pass;
- costs and faults price per BATCH: the WAN topologies use the
  vectorized counter-hash model (megascale/topology.WanCostModel), plain
  scenario specs fall back to the oracle's per-event blake2b draws so
  paired runs match draw for draw;
- wave semantics (first error/corrupt aborts the wave, a churn crash
  lands after a piece-count threshold, stalls complete with their cost)
  reduce to per-row cutoffs computed with `np.minimum.at`;
- reports feed the scheduler's bulk APIs: one
  ``pieces_finished_batch`` per completed wave slice,
  ``register_peers_batch`` for arrival waves, ``leave_hosts_batch`` for
  churn/upgrade cohorts.

On top of the engine ride the traffic models only the megascale lab can
express: diurnal Zipf arrivals, flash-crowd preheat storms, and
rolling-upgrade churn waves (scenarios/spec Wan/Traffic/FlashCrowd/
UpgradeSpec, sampled by the same deterministic ScenarioEngine).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib

import numpy as np

from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
from dragonfly2_tpu_torch.megascale.topology import (
    FAULT_CORRUPT,
    FAULT_ERROR,
    FAULT_STALL,
    WanCostModel,
    _FAULT_CODE,
    make_region_cluster,
)

# one uint64 have-bitset word per download: megascale tasks are capped at
# 64 pieces (the simulator draws 2..32); the oracle's generic path keeps
# the full 4096-piece bitset in scheduler state
MEGA_MAX_PIECES = 64

_BIG = np.int64(1 << 40)


@dataclasses.dataclass
class MegaStats:
    """Megascale-only counters beyond the oracle-shared SimStats (those
    stay in `stats` so the equivalence test compares them field for
    field)."""

    piece_events: int = 0          # events priced by the batch engine
    flash_arrivals: int = 0        # arrivals injected by flash-crowd storms
    upgrade_host_restarts: int = 0  # hosts cycled by rolling-upgrade waves
    origin_bytes: int = 0          # back-to-source + seed-trigger bytes
    p2p_bytes: int = 0             # bytes served peer-to-peer
    cross_region_b2s: int = 0      # b2s escalations outside the origin region
    # registrations the scheduler refused (hot task's peer DAG full under
    # a flash crowd) — the modeled daemon falls back to a direct origin
    # fetch, dfget's schedule-failure path, so these complete as origin
    # traffic instead of silently vanishing (the oracle ignores register
    # responses; at its scale the DAG never fills)
    refused_registrations: int = 0


class EventBatchEngine(ClusterSimulator):
    def __init__(
        self,
        scheduler,
        num_hosts: int = 1024,
        num_tasks: int = 64,
        seed: int = 0,
        piece_length: int = 4 << 20,
        scenario=None,
        retire_after_rounds: int | None = None,
        tail_capture: bool = True,
        tail_failover_horizon: int = 8,
    ):
        wan_active = scenario is not None and scenario.wan.regions > 0
        cluster = (
            make_region_cluster(num_hosts, scenario, seed=seed)
            if wan_active else None
        )
        super().__init__(
            scheduler, num_hosts=num_hosts, num_tasks=num_tasks, seed=seed,
            piece_length=piece_length, scenario=scenario,
            # registration-counter peer ids are the engine's row index —
            # a response decodes to its columns with integer math
            deterministic_peer_ids=True,
            cluster=cluster,
        )
        if any(t["pieces"] >= MEGA_MAX_PIECES for t in self._tasks):
            raise ValueError(f"megascale tasks cap at {MEGA_MAX_PIECES - 1} pieces")
        self.mega = MegaStats()
        hosts = self.cluster.hosts
        self._host_pos = {h.id: i for i, h in enumerate(hosts)}
        self._region_of = np.zeros(len(hosts), np.int32)
        if wan_active:
            for i, h in enumerate(hosts):
                region = h.location.split("|", 1)[0]
                self._region_of[i] = int(region.rsplit("-", 1)[1])
        self._wan = (
            WanCostModel.from_engine(scenario, hosts, self.engine, seed)
            if wan_active else None
        )
        self._task_pieces = np.asarray([t["pieces"] for t in self._tasks], np.int64)
        self._task_content = np.asarray(
            [t["content_length"] for t in self._tasks], np.int64
        )
        # --- columnar per-download state, indexed by registration counter
        cap = 1024
        self._col_task = np.full(cap, -1, np.int32)
        self._col_host = np.full(cap, -1, np.int32)
        self._col_have = np.zeros(cap, np.uint64)
        self._col_wave = np.zeros(cap, np.int32)
        self._col_cost_ns = np.zeros(cap, np.float64)
        self._col_done_round = np.full(cap, -1, np.int32)
        # --- tail-attribution columns (telemetry/tailtrace.py): the
        # registration round, rounds actually served a parent wave, and
        # the disjoint retry/back-to-source slices of _col_cost_ns —
        # everything _observe_tail needs to decompose a TTC, still SoA
        self._col_reg_round = np.full(cap, -1, np.int32)
        self._col_served = np.zeros(cap, np.int32)
        self._col_retry_ns = np.zeros(cap, np.float64)
        self._col_b2s_ns = np.zeros(cap, np.float64)
        # crash victimhood: the latest scheduler crash this row was alive
        # through (-1 = none) and the cost already accumulated at that
        # moment — everything after the mark is failover-phase time
        self._col_crash_round = np.full(cap, -1, np.int32)
        self._col_crash_cost_ns = np.zeros(cap, np.float64)
        # completed/failed downloads pending retirement, in completion
        # order (round-based, so retirement is deterministic — the
        # megascale stand-in for the wall-clock TTL GC the oracle never
        # drives); None disables
        self.retire_after_rounds = retire_after_rounds
        self._retire_queue: list[tuple[int, str]] = []
        self._retire_head = 0
        # run-to-run fault-schedule digest for the vectorized (WAN) path;
        # compat-mode draws land in engine.schedule_digest() as usual
        self._fault_digest = hashlib.blake2b(digest_size=16)
        self._fault_events = 0
        from dragonfly2_tpu_torch.telemetry import default_registry
        from dragonfly2_tpu_torch.telemetry.flight import PhaseRecorder
        from dragonfly2_tpu_torch.telemetry.series import megascale_series
        from dragonfly2_tpu_torch.telemetry.timeline import (
            QuantileSketch,
            TimelineRecorder,
        )

        series = megascale_series(default_registry())
        self._piece_event_counter = series.piece_events.labels()
        self.recorder = PhaseRecorder(
            histogram=series.step_phase, maxlen=4096, name="megascale.step"
        )
        # --- soak timeline (telemetry/timeline.py): one sample per round
        # off the EVENT clock. Every sampled value is a pure function of
        # the replay's counters, so paired-seed runs produce identical
        # timeline arrays (pinned by the megascale determinism test).
        day = (
            scenario.traffic.day_rounds
            if scenario is not None and scenario.traffic.day_rounds > 0
            else 96
        )
        self.minutes_per_round = 24.0 * 60.0 / day
        self.timeline = TimelineRecorder("megascale.timeline")
        n_regions = int(self._region_of.max()) + 1 if self._region_of.size else 1
        # per-region time-to-complete quantile sketches: bounded-error
        # streaming percentiles ride every sample without retaining
        # per-download arrays (1% relative accuracy)
        self._ttc_sketch = [
            QuantileSketch(relative_accuracy=0.01) for _ in range(n_regions)
        ]
        self._tl_prev: dict[str, float] = {}
        self._crash_rounds: list[int] = []
        # --- streaming SLO engine (telemetry/slo.py) on the EVENT clock:
        # fed one timeline sample per round (a PURE function of the
        # sample, so tools/dfslo.py replays the identical alert timeline
        # offline from the recorded samples), stepping burn-rate alert
        # state machines whose transitions annotate the timeline and
        # whose verdict columns ride every sample.
        from dragonfly2_tpu_torch.telemetry.slo import SLOEngine, megascale_slo_specs

        self.slo = SLOEngine(
            megascale_slo_specs([f"region-{r}" for r in range(n_regions)]),
            name="megascale.slo",
            minutes_per_unit=self.minutes_per_round,
        )
        # --- tail-attribution plane (telemetry/tailtrace.py) on the
        # EVENT clock: every completion's virtual TTC decomposed into
        # lifecycle phases (waits priced at the round width, transfer
        # phases from the disjoint cost columns). Pure function of
        # (spec, seed) — the tail digest is paired-seed-pinned.
        from dragonfly2_tpu_torch.telemetry import tailtrace as _tailtrace

        self.tail_capture = bool(tail_capture)
        self.tail_failover_horizon = int(tail_failover_horizon)
        self._round_ns = self.minutes_per_round * 60.0 * 1e9
        self._tail_vec = np.zeros(_tailtrace.N_PHASES, np.float64)
        self.tail = _tailtrace.TailTrace(
            [f"region-{r}" for r in range(n_regions)],
            seed=seed,
            name="megascale.tail",
        )

    # ------------------------------------------------------------ columns

    def _ensure_cols(self, n: int) -> None:
        cap = self._col_task.shape[0]
        if n <= cap:
            return
        new = max(cap * 2, n)
        for name in ("_col_task", "_col_host", "_col_have", "_col_wave",
                     "_col_cost_ns", "_col_done_round", "_col_reg_round",
                     "_col_served", "_col_retry_ns", "_col_b2s_ns",
                     "_col_crash_round", "_col_crash_cost_ns"):
            old = getattr(self, name)
            grown = np.zeros(new, old.dtype)
            if name in ("_col_task", "_col_host", "_col_done_round",
                        "_col_reg_round", "_col_crash_round"):
                grown[:] = -1
            grown[:cap] = old
            setattr(self, name, grown)

    @staticmethod
    def _reg_of(peer_id: str) -> int:
        return int(peer_id.rsplit("-", 1)[1])

    def _new_download_request(self, host=None, task=None):
        reg = self._reg_index
        req = super()._new_download_request(host, task)
        self._ensure_cols(self._reg_index)
        t = self._task_of[req.peer_id]
        hidx = self._host_pos[self._peer_host[req.peer_id]]
        self._col_task[reg] = t["index"]
        self._col_host[reg] = hidx
        self._col_have[reg] = 0
        self._col_wave[reg] = 0
        self._col_cost_ns[reg] = 0.0
        self._col_done_round[reg] = -1
        self._col_reg_round[reg] = self._round
        self._col_served[reg] = 0
        self._col_retry_ns[reg] = 0.0
        self._col_b2s_ns[reg] = 0.0
        self._col_crash_round[reg] = -1
        self._col_crash_cost_ns[reg] = 0.0
        return req

    def _finished_pieces(self, peer_id: str) -> list[int]:
        """Columnar override of the oracle's per-peer `have` sets: decode
        the uint64 bitset (ascending, like sorted(have))."""
        if not peer_id.startswith("peer-"):
            return []
        reg = self._reg_of(peer_id)
        if reg >= self._col_have.shape[0]:
            return []
        bits = int(self._col_have[reg])
        return [p for p in range(MEGA_MAX_PIECES) if bits >> p & 1]

    # ---------------------------------------------------------- traffic

    def _apply_scheduler_crash(self) -> None:
        """Columnar victim marking on top of the oracle's crash replay:
        every download alive when the scheduler dies gets stamped with
        the crash round and its cost-so-far, so the tail plane can
        attribute everything AFTER the re-announce — remaining waits and
        re-fetched waves alike — to the failover phase."""
        n = self._reg_index
        alive = (self._col_task[:n] >= 0) & (self._col_done_round[:n] < 0)
        self._col_crash_round[:n][alive] = self._round
        self._col_crash_cost_ns[:n][alive] = self._col_cost_ns[:n][alive]
        super()._apply_scheduler_crash()

    def _extra_offline(self, round_idx: int) -> set[str]:
        """Rolling-upgrade cohort: the host-order restart window the
        engine samples deterministically (region blocks are contiguous in
        host order, so the sweep is a region-by-region rollout)."""
        if self.engine is None:
            return set()
        window = self.engine.upgrade_window(round_idx)
        if window is None:
            return set()
        n = len(self.cluster.hosts)
        lo, hi = int(window[0] * n), max(int(window[1] * n), int(window[0] * n) + 1)
        cohort = {h.id for h in self.cluster.hosts[lo:hi]}
        self.mega.upgrade_host_restarts += len(cohort - self._offline)
        return cohort

    def _arrival_plan(self, base: int) -> tuple[int, list[int]]:
        """(diurnal-scaled arrival count, flash-crowd hot task ranks for
        extra arrivals this round)."""
        if self.engine is None:
            return base, []
        n = max(0, int(round(base * self.engine.diurnal_multiplier(self._round))))
        hot = self.engine.flash_crowds(self._round, len(self._tasks))
        if self.engine.spec.traffic.day_rounds > 0:
            # time-varying popularity: WHICH tasks are hot rotates through
            # the compressed day (the oracle's static Zipf can't express it)
            self._task_weights = self.engine.rotated_task_weights(
                len(self._tasks), self._round
            )
        return n, hot

    # ------------------------------------------------------------- round

    def run_round(self, new_downloads: int = 8) -> list:
        """One engine step: fault application, one arrival wave (diurnal
        x flash scaled) registered through the bulk API, one scheduler
        tick, then ALL normal responses advanced as one event batch."""
        recorder = self.recorder
        recorder.begin()
        self._round += 1
        crashed = False
        if self.engine is not None:
            self._apply_host_churn()
            if self.engine.scheduler_crashed(self._round):
                crashed = True
                self._crash_rounds.append(self._round)
                self.timeline.mark_event(self._round, "scheduler_crash")
                self._apply_scheduler_crash()
            self._apply_partitions()
        recorder.mark("faults")
        base_n, hot_ranks = self._arrival_plan(new_downloads)
        reqs = [self._new_download_request() for _ in range(base_n)]
        if hot_ranks:
            per_task = max(
                1,
                int(new_downloads * self.engine.spec.flash.arrival_multiplier)
                // len(hot_ranks),
            )
            for rank in hot_ranks:
                task = self._tasks[rank % len(self._tasks)]
                for _ in range(per_task):
                    reqs.append(self._new_download_request(task=task))
                    self.mega.flash_arrivals += 1
        if reqs:
            for req, resp in zip(reqs, self.scheduler.register_peers_batch(reqs)):
                if isinstance(resp, msg.ScheduleFailure):
                    self._register_refused(req)
        self.consume_seed_triggers()
        recorder.mark("arrivals")
        responses = self.scheduler.tick()
        recorder.mark("tick")
        # Acting non-normal responses inline and batching the normals
        # preserves the oracle's processing order: tick() emits every
        # pre-schedule decision (back-to-source, failures) BEFORE the
        # first NormalTaskResponse, so "non-normals in encounter order,
        # then all normals in list order" IS list order.
        normal: list = []
        for resp in responses:
            peer_id = getattr(resp, "peer_id", "")
            if self._peer_host.get(peer_id) in self._partitioned:
                # silent partition: the response never reaches the daemon
                # (same semantics as the oracle's run_round)
                self.stats.injected_partition_drops += 1
                self._partition_stalled.add(peer_id)
                continue
            if isinstance(resp, msg.NormalTaskResponse):
                normal.append(resp)
            else:
                self._act(resp)
        if normal:
            self._process_normal_batch(normal)
        recorder.mark("event_batch")
        self._retire_downloads()
        recorder.mark("retire")
        self._timeline_sample(crashed)
        recorder.mark("timeline")
        recorder.commit()
        return responses

    def _timeline_sample(self, crashed: bool) -> None:
        """One per-round timeline sample off the event clock: interval
        deltas of the replay counters (pieces, completions, origin/p2p
        bytes, re-announces, refused registrations), the quarantine
        population, the process breaker census, and per-region TTC
        percentiles from the streaming sketches. Deterministic in
        (spec, seed, replay) — no wall-clock reads."""
        from dragonfly2_tpu_torch.rpc.resilience import open_breaker_census

        st, mega = self.stats, self.mega
        led = getattr(self.scheduler, "decisions", None)
        led_counters = led.counters() if led is not None else {}
        cur = {
            "pieces": float(st.pieces),
            "completed": float(st.completed),
            "origin_bytes": float(mega.origin_bytes),
            "p2p_bytes": float(mega.p2p_bytes),
            "reannounced": float(st.crash_reannounced_peers),
            "refused": float(mega.refused_registrations),
            "corruptions": float(st.injected_corruptions),
            # decision-ledger cumulative counters (wall-free by
            # construction — telemetry/decisions.counters), so the
            # divergence columns below stay paired-seed deterministic
            "decisions": float(led_counters.get("decisions", 0)),
            "shadow_compared": float(led_counters.get("shadow_compared", 0)),
            "shadow_disagree": float(
                led_counters.get("shadow_top1_disagree", 0)
            ),
        }
        prev = self._tl_prev
        delta = {k: v - prev.get(k, 0.0) for k, v in cur.items()}
        self._tl_prev = cur
        bytes_total = delta["origin_bytes"] + delta["p2p_bytes"]
        sample = {
            "sim_minutes": round(self._round * self.minutes_per_round, 2),
            "pieces": int(delta["pieces"]),
            "completed": int(delta["completed"]),
            "origin_fraction": (
                round(delta["origin_bytes"] / bytes_total, 6)
                if bytes_total > 0 else 0.0
            ),
            "quarantine_active": self.scheduler.quarantine.active_count(),
            "breaker_open": open_breaker_census(),
            "reannounce_backlog": int(delta["reannounced"]),
            "refused_registrations": int(delta["refused"]),
            "corruptions": int(delta["corruptions"]),
            "scheduler_crash": 1 if crashed else 0,
            # decision provenance columns: per-interval applied
            # selections and, when a shadow arm ran, its top-1
            # disagreement rate plus the deterministic failure-rate
            # regret basis (the TTC-ms basis is wall-derived and
            # deliberately excluded from the deterministic timeline)
            "decisions": int(delta["decisions"]),
            "shadow_divergence": (
                round(delta["shadow_disagree"] / delta["shadow_compared"], 4)
                if delta["shadow_compared"] > 0 else None
            ),
            "decision_regret_fail": self._regret_fail_sample(led),
            "ttc_ms_p50": {
                f"region-{r}": (
                    None if (q := sk.quantile(0.5)) is None else round(q, 2)
                )
                for r, sk in enumerate(self._ttc_sketch)
            },
            "ttc_ms_p95": {
                f"region-{r}": (
                    None if (q := sk.quantile(0.95)) is None else round(q, 2)
                )
                for r, sk in enumerate(self._ttc_sketch)
            },
            # which lifecycle phase dominated the attributed time of THIS
            # round's completions (telemetry/tailtrace.round_dominant) —
            # the cause hint a firing TTC page names, recorded in the
            # sample so dfslo's offline replay reproduces it exactly
            "tail_dominant_phase": (
                self.tail.round_dominant(self._round)
                if self.tail_capture else None
            ),
        }
        # SLO evaluation: derive every SLI from THIS sample and step the
        # engine at the event clock. The returned verdict columns ride
        # the sample (deterministic — pinned by the paired-seed test);
        # alert fire/clear transitions annotate the timeline next to the
        # scheduler_crash marks they judge.
        from dragonfly2_tpu_torch.telemetry.slo import feed_megascale_sample

        step = feed_megascale_sample(
            self.slo, {**sample, "t": float(self._round)}
        )
        sample["slo_verdict"] = step["verdict_code"]
        sample["slo_alerts_firing"] = step["alerts_firing"]
        sample["slo_pages_fired"] = step["pages_fired"]
        sample["slo_tickets_fired"] = step["tickets_fired"]
        for tr in step["transitions"]:
            self.timeline.mark_event(
                self._round,
                f"slo_{tr['event']}:{tr['severity']}:{tr['slo']}:{tr['rule']}",
            )
        self.timeline.sample(self._round, sample)

    @staticmethod
    def _regret_fail_sample(led) -> float | None:
        """Deterministic per-sample regret: the active arm's mean
        failure-rate delta against the shadow pick on disagreement
        decisions (the ledger report's fail_rate basis — counts only,
        no wall reads). None until a disagreement has joined outcomes
        on both hosts."""
        return None if led is None else led.report()["regret_fail_rate"]

    def _record_ttc(self, reg: int) -> None:
        """Feed the completing download's virtual time-to-complete into
        its region's streaming quantile sketch."""
        host = int(self._col_host[reg])
        if host < 0:
            return
        region = int(self._region_of[host])
        if region < len(self._ttc_sketch):
            self._ttc_sketch[region].add(float(self._col_cost_ns[reg]) / 1e6)

    def _observe_tail(self, reg: int) -> None:
        """Decompose the completing download's virtual TTC into lifecycle
        phases and feed the tail plane. TTC here includes wait time —
        rounds alive but not served a parent wave, priced at the round
        width — on top of the transfer-cost column the region percentiles
        report; the phase vector is built from disjoint components
        (waits + retry/b2s/fetch slices of the cost), so it sums to the
        recorded TTC exactly. Failover absorbs everything a scheduler
        death cost the download: for crash victims (alive at the kill,
        per the crash-mark columns) ALL accrued wait is failover —
        the re-announce reset their queue position, so pre-crash queue
        time bought nothing and counting it as schedule_wait would hide
        the kill — plus every wave re-fetched after the re-announce.
        Downloads that registered into a still-recovering scheduler
        (within ``tail_failover_horizon`` rounds of a crash) also stall
        on the rebuild, not on steady-state backlog, so their waits are
        failover too; all other waits are schedule_wait."""
        if not self.tail_capture:
            return
        host = int(self._col_host[reg])
        if host < 0:
            return
        from dragonfly2_tpu_torch.telemetry import tailtrace as tt

        cost_ns = float(self._col_cost_ns[reg])
        reg_round = int(self._col_reg_round[reg])
        done_round = int(self._col_done_round[reg])
        served = int(self._col_served[reg])
        wait_rounds = max(done_round - reg_round + 1 - max(served, 1), 0)
        crash_round = int(self._col_crash_round[reg])
        fail_cost = 0.0
        fail_wait = 0
        if crash_round >= 0:
            # lived through a crash: split the cost at the mark — the
            # pre-crash slice keeps its retry/b2s decomposition, the
            # post-re-announce slice is failover re-work — and charge
            # ALL wait to failover (wasted-wait attribution: the
            # re-announce threw away the queue position)
            pre = min(float(self._col_crash_cost_ns[reg]), cost_ns)
            fail_cost = cost_ns - pre
            fail_wait = wait_rounds
            cost_ns = pre
        elif wait_rounds and self._crash_rounds:
            # registered into a recovering scheduler: its waits are the
            # crash's queue backlog, not steady-state schedule wait
            k = bisect.bisect_right(self._crash_rounds, reg_round) - 1
            if k >= 0 and reg_round - self._crash_rounds[k] \
                    <= self.tail_failover_horizon:
                fail_wait = wait_rounds
        b2s = min(float(self._col_b2s_ns[reg]), cost_ns)
        retry = min(float(self._col_retry_ns[reg]), max(cost_ns - b2s, 0.0))
        fetch = max(cost_ns - b2s - retry, 0.0)
        rns = self._round_ns
        vec = self._tail_vec
        vec[:] = 0.0
        vec[tt.PH_SCHEDULE_WAIT] = (wait_rounds - fail_wait) * rns
        vec[tt.PH_FAILOVER] = fail_wait * rns + fail_cost
        vec[tt.PH_PARENT_FETCH] = fetch
        vec[tt.PH_RETRY] = retry
        vec[tt.PH_BACK_TO_SOURCE] = b2s
        self.tail.observe(
            int(self._region_of[host]), reg,
            cost_ns + fail_cost + wait_rounds * rns, vec,
            round_idx=done_round,
        )

    # -------------------------------------------------------- event batch

    def _process_normal_batch(self, responses: list) -> None:
        """Advance every in-flight download that received parents this
        tick by one wave, as one vectorized event batch. Scheduler calls
        are then issued per RESPONSE in response order — the exact call
        sequence the oracle produces, with the per-piece Python loop
        replaced by array math."""
        if self.engine is None:
            # scenario-less legacy replay: the oracle's wave path is
            # already vectorized per response and draws from a sequential
            # np rng — reuse it verbatim so paired runs stay bit-equal
            for resp in responses:
                self._download_from_parents(resp)
            return
        stats = self.stats
        m = len(responses)
        regs = np.empty(m, np.int64)
        n_par = np.empty(m, np.int64)
        crash_cut = np.full(m, _BIG)
        waves = np.empty(m, np.int64)
        max_par = max(len(r.candidate_parents) for r in responses)
        pmat = np.zeros((m, max_par), np.int64)
        parent_ids: list[list[str]] = []
        hosts_by_id = self._hosts_by_id
        for i, resp in enumerate(responses):
            reg = self._reg_of(resp.peer_id)
            regs[i] = reg
            wave = int(self._col_wave[reg]) + 1
            self._col_wave[reg] = wave
            waves[i] = wave
            if wave > 1:
                stats.retry_waves += 1
            parents = resp.candidate_parents
            n_par[i] = len(parents)
            ids = []
            for j, p in enumerate(parents):
                pmat[i, j] = self._host_pos[
                    self._peer_host.get(p.peer_id, p.host_id)
                ]
                ids.append(p.peer_id)
            parent_ids.append(ids)
            ca = self.engine.crash_point(
                self._peer_reg.get(resp.peer_id, 0),
                int(self._task_pieces[self._col_task[reg]]),
            )
            if ca is not None:
                prior = int(self._col_have[reg]).bit_count()
                crash_cut[i] = max(1, ca - prior)
        # one response per in-flight download per tick, so `regs` has no
        # duplicates: rounds NOT counted here are rounds the download sat
        # waiting for the scheduler (the tail plane's wait basis)
        self._col_served[regs] += 1

        total = self._task_pieces[self._col_task[regs]]
        have = self._col_have[regs]
        missing = ~have & ((np.uint64(1) << total.astype(np.uint64)) - np.uint64(1))
        bits = (
            (missing[:, None] >> np.arange(MEGA_MAX_PIECES, dtype=np.uint64)[None, :])
            & np.uint64(1)
        ).astype(bool)
        # row-major nonzero: events grouped per response, ascending piece
        ev_row, ev_piece = np.nonzero(bits)
        n_ev = bits.sum(axis=1).astype(np.int64)
        e = ev_row.shape[0]
        starts = np.zeros(m, np.int64)
        np.cumsum(n_ev[:-1], out=starts[1:])
        ev_rank = np.arange(e) - np.repeat(starts, n_ev)
        ev_sel = ev_piece % n_par[ev_row]
        ev_parent = pmat[ev_row, ev_sel]
        ev_child = self._col_host[regs[ev_row]].astype(np.int64)
        ev_task = self._col_task[regs[ev_row]].astype(np.int64)
        ev_wave = waves[ev_row]
        self.mega.piece_events += int(e)
        self._piece_event_counter.inc(int(e))

        if self._wan is not None:
            cost, fault = self._wan.piece_costs(
                ev_child, ev_parent, self.piece_length,
                ev_task, ev_piece.astype(np.int64), ev_wave,
            )
        else:
            # oracle-compat: the engine's per-event counter-hashed draws.
            # Order-independent by construction (semantic keys, no
            # stream), so pricing them here — instead of inside the
            # per-piece wave loop — cannot change any value the oracle
            # would have drawn; the batch just also prices events past an
            # abort, whose results are masked out below.
            hosts = self.cluster.hosts
            piece_cost_ns = self.engine.piece_cost_ns
            plen = self.piece_length
            cost = np.empty(e, np.int64)
            fault = np.zeros(e, np.int8)
            for k in range(e):
                c, f = piece_cost_ns(
                    hosts[ev_child[k]], hosts[ev_parent[k]], plen,
                    int(ev_task[k]), int(ev_piece[k]), int(ev_wave[k]),
                )
                cost[k] = c
                fault[k] = _FAULT_CODE[f]

        # --- wave cutoffs: first error/corrupt aborts; a crash lands
        # after `crash_cut` completed pieces; the earlier one wins
        abort_rank = np.full(m, _BIG)
        aborting = np.flatnonzero(fault >= FAULT_ERROR)
        if aborting.size:
            np.minimum.at(abort_rank, ev_row[aborting], ev_rank[aborting])
        cut = np.minimum(abort_rank, crash_cut)
        done = ev_rank < cut[ev_row]
        aborted = abort_rank < crash_cut            # a real event rank
        crashed = ~aborted & (crash_cut <= n_ev)
        abort_event = np.full(m, -1, np.int64)
        if aborting.size:
            hit = aborting[ev_rank[aborting] == abort_rank[ev_row[aborting]]]
            abort_event[ev_row[hit]] = hit

        # --- stats + columns, one pass each
        done_rows = ev_row[done]
        n_done = int(done.sum())
        stats.pieces += n_done
        stats.piece_cost_ns_total += int(cost[done].sum())
        stats.injected_stalls += int((fault[done] == FAULT_STALL).sum())
        abort_faults = fault[abort_event[aborted]]
        stats.injected_piece_failures += int((abort_faults == FAULT_ERROR).sum())
        stats.injected_corruptions += int((abort_faults == FAULT_CORRUPT).sum())
        stats.injected_crashes += int(crashed.sum())
        self.mega.p2p_bytes += n_done * self.piece_length
        if n_done:
            add_bits = np.zeros(m, np.uint64)
            np.bitwise_or.at(
                add_bits, done_rows,
                np.uint64(1) << ev_piece[done].astype(np.uint64),
            )
            self._col_have[regs] |= add_bits
            sums = np.zeros(m)
            np.add.at(sums, done_rows, cost[done].astype(np.float64))
            self._col_cost_ns[regs] += sums
            # waves past the first are the retry slice of the cost —
            # disjoint from the back-to-source slice by construction, so
            # the tail decomposition sums exactly
            retry_rows = waves > 1
            if retry_rows.any():
                self._col_retry_ns[regs[retry_rows]] += sums[retry_rows]
        faulted = np.flatnonzero(fault != 0)
        if faulted.size:
            self._fault_events += int(faulted.size)
            self._fault_digest.update(np.int64(self._round).tobytes())
            for col in (ev_task, ev_piece, ev_wave, fault):
                self._fault_digest.update(
                    np.ascontiguousarray(col[faulted]).tobytes()
                )

        # --- scheduler calls, per response in response order (the same
        # call sequence the oracle's per-response loop produces: the
        # completed slice reports first, then the wave's outcome)
        plen = self.piece_length
        finished_total = self._task_content
        for i, resp in enumerate(responses):
            peer_id = resp.peer_id
            s = int(starts[i])
            c = int(min(cut[i], n_ev[i]))
            if c:
                sl = slice(s, s + c)
                self.scheduler.pieces_finished_batch(
                    peer_id,
                    ev_piece[sl].tolist(),
                    [plen] * c,
                    cost[sl].tolist(),
                    parent_ids=parent_ids[i],
                    parent_sel=ev_sel[sl].tolist(),
                )
            if aborted[i]:
                kind = int(fault[abort_event[i]])
                self.scheduler.piece_failed(msg.DownloadPieceFailedRequest(
                    peer_id=peer_id,
                    parent_peer_id=parent_ids[i][int(ev_sel[abort_event[i]])],
                    reason="corruption" if kind == FAULT_CORRUPT else "",
                ))
            elif crashed[i]:
                self.scheduler.peer_failed(msg.DownloadPeerFailedRequest(
                    peer_id=peer_id, description="scenario churn: crashed"
                ))
                # dead row, but NOT a completion: no done_round, so the
                # region time-to-complete percentiles exclude it
                self._retire_later(peer_id)
            else:
                task_idx = int(self._col_task[regs[i]])
                self.scheduler.peer_finished(msg.DownloadPeerFinishedRequest(
                    peer_id=peer_id,
                    content_length=int(finished_total[task_idx]),
                    piece_count=int(self._task_pieces[task_idx]),
                ))
                stats.completed += 1
                self._complete(peer_id, int(regs[i]))

    def _charge_origin_fetch(self, reg: int, content: int) -> None:
        """Account one whole-task origin transfer against download row
        `reg`: origin bytes, the modeled transfer time at the base NIC
        tier, and — on the WAN topology — the cross-region back-to-source
        penalty when the downloader's region is not the origin's. Shared
        by the protocol back-to-source path and the refused-registration
        fallback so the origin-traffic split cannot drift between them."""
        self.mega.origin_bytes += content
        link = self.engine.spec.link if self.engine is not None else None
        base_bw = link.base_bandwidth_bps if link is not None else 100e6
        origin_ns = content / max(base_bw, 1.0) * 1e9
        if self._wan is not None:
            wan = self.engine.spec.wan
            if int(self._region_of[self._col_host[reg]]) != wan.origin_region:
                origin_ns += wan.back_to_source_penalty_ms * 1e6
                self.mega.cross_region_b2s += 1
        self._col_cost_ns[reg] += origin_ns
        self._col_b2s_ns[reg] += origin_ns

    def _register_refused(self, req) -> None:
        """Scheduler refused the registration (hot-task DAG full under a
        flash crowd, or peer table full): the modeled daemon downloads
        straight from origin — dfget's ScheduleFailure fallback — so the
        download completes as origin traffic with the WAN penalty when
        its region is not the origin's."""
        peer_id = req.peer_id
        reg = self._reg_of(peer_id)
        self.stats.schedule_failures += 1
        self.mega.refused_registrations += 1
        self._charge_origin_fetch(reg, int(req.content_length))
        self._col_done_round[reg] = self._round
        self._record_ttc(reg)
        self._observe_tail(reg)
        self.stats.completed += 1
        # never registered with the scheduler: nothing to retire, just
        # drop the sim-side identity maps
        self._task_of.pop(peer_id, None)
        self._peer_host.pop(peer_id, None)
        self._peer_reg.pop(peer_id, None)

    def _retire_later(self, peer_id: str) -> None:
        if self.retire_after_rounds is not None:
            self._retire_queue.append((self._round, peer_id))

    def _complete(self, peer_id: str, reg: int) -> None:
        self._col_done_round[reg] = self._round
        self._record_ttc(reg)
        self._observe_tail(reg)
        self._retire_later(peer_id)

    def _back_to_source(self, peer_id: str) -> None:
        super()._back_to_source(peer_id)
        reg = self._reg_of(peer_id)
        self._charge_origin_fetch(
            reg, int(self._task_content[self._col_task[reg]])
        )
        self._complete(peer_id, reg)

    def consume_seed_triggers(self) -> int:
        # snapshot the queued triggers' tasks before the superclass
        # drains them — seed downloads are origin traffic by design
        with self.scheduler.mu:
            pending = [t.task_id for t in self.scheduler.seed_triggers]
        n = super().consume_seed_triggers()
        if pending:
            by_task = {t["task_id"]: t for t in self._tasks}
            self.mega.origin_bytes += sum(
                by_task[tid]["content_length"] for tid in pending if tid in by_task
            )
        return n

    # -------------------------------------------------------- retirement

    def _retire_downloads(self) -> None:
        """Deterministic round-based retirement of long-completed
        downloads (LeavePeer): bounds live scheduler rows and per-task
        DAG slots over a compressed day the way the reference's peer-TTL
        GC does over wall time — without coupling the replay to the
        clock."""
        if self.retire_after_rounds is None:
            return
        horizon = self._round - self.retire_after_rounds
        q = self._retire_queue
        head = self._retire_head
        while head < len(q) and q[head][0] <= horizon:
            _, peer_id = q[head]
            head += 1
            self.scheduler.leave_peer(peer_id)
            self._task_of.pop(peer_id, None)
            self._peer_host.pop(peer_id, None)
            self._peer_reg.pop(peer_id, None)
            self._peer_waves.pop(peer_id, None)
            self._partition_stalled.discard(peer_id)
        if head > 4096 and head * 2 > len(q):
            del q[:head]
            head = 0
        self._retire_head = head

    # ---------------------------------------------------------- reporting

    def fault_schedule_digest(self) -> str:
        """Digest over every vectorized-path fault event plus the
        engine's own counter-hashed schedule — two runs of the same
        (spec, seed, replay) must match exactly (the megascale
        determinism contract)."""
        vec = f"{self._fault_events}:{self._fault_digest.copy().hexdigest()}"
        eng = self.engine.schedule_digest() if self.engine is not None else ""
        return f"{vec}|{eng}"

    def region_report(self) -> dict:
        """Per-region completion aggregates for the soak report:
        completed downloads, virtual time-to-complete percentiles (ms),
        and the origin-traffic split."""
        n = self._reg_index
        done = self._col_done_round[:n] >= 0
        region = self._region_of[self._col_host[:n]]
        ttc_ms = self._col_cost_ns[:n] / 1e6
        regions = {}
        n_regions = int(self._region_of.max()) + 1 if self._region_of.size else 1
        for r in range(n_regions):
            mask = done & (region == r) & (self._col_host[:n] >= 0)
            vals = np.sort(ttc_ms[mask])
            regions[f"region-{r}"] = {
                "completed": int(mask.sum()),
                "ttc_ms_p50": round(float(np.percentile(vals, 50)), 2) if vals.size else None,
                "ttc_ms_p90": round(float(np.percentile(vals, 90)), 2) if vals.size else None,
                "ttc_ms_p99": round(float(np.percentile(vals, 99)), 2) if vals.size else None,
            }
        total_bytes = self.mega.origin_bytes + self.mega.p2p_bytes
        return {
            "regions": regions,
            "origin_bytes": self.mega.origin_bytes,
            "p2p_bytes": self.mega.p2p_bytes,
            "origin_traffic_fraction": round(
                self.mega.origin_bytes / total_bytes, 6
            ) if total_bytes else None,
            "cross_region_back_to_source": self.mega.cross_region_b2s,
        }


def megascale_service(
    num_hosts: int,
    num_tasks: int = 64,
    max_live_peers: int | None = None,
    algorithm: str = "default",
    seed: int = 0,
    max_peers_per_task: int = 2048,
    device=None,
):
    """SchedulerService sized for a megascale run: host/task tables fit
    the population, the peer table is sized to the LIVE download bound
    (arrival rate x retirement window — not total registrations; retired
    rows recycle through the free list), and the finished-piece bitset
    shrinks to one word (64-piece task cap). Returns the service, on the
    card unless ``device`` names another (``device.resolve_device``:
    None is CUDA, and raises where there is none)."""
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.config.config import Config

    config = Config()
    config.evaluator.algorithm = algorithm
    sched = config.scheduler
    sched.max_hosts = num_hosts + 64
    sched.max_tasks = max(256, 2 * num_tasks)
    sched.max_peers = max_live_peers or max(4 * num_hosts, 4096)
    sched.max_peers_per_task = max_peers_per_task
    sched.piece_bitset_words = 1
    sched.region_aware_seeds = True
    return SchedulerService(config=config, seed=seed, device=device)
