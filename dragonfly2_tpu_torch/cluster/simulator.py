"""Port of dragonfly2_tpu/cluster/simulator.py: the same ``random.Random``
stream (``self.rng = self.cluster.rng``) and the same numpy draws, so a
seed drives the port's service through the same requests as the
reference's, probe rounds included (the probe key is utils/prng's, drawn
from the same ``randint``).

Mini-cluster simulator — the e2e harness standing in for the reference's
kind-cluster tests (SURVEY.md §4 tier 2: "multi-process mini-cluster ...
spawn scheduler + N fake peers").

Fake peer daemons drive a real SchedulerService through the full message
protocol: register -> receive parents -> "download" pieces with latencies
drawn from the synthetic latent model (records/synth.py: host quality +
IDC-structured RTT) -> report piece/peer results -> probe RTTs. Produces
real Download/NetworkTopology traces via the service's storage, so the
whole loop (schedule -> trace -> train -> serve) runs in-process.
"""

from __future__ import annotations

import dataclasses
import uuid

import numpy as np

from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.records import synth
from dragonfly2_tpu_torch.utils import idgen, prng


@dataclasses.dataclass
class SimStats:
    registered: int = 0
    completed: int = 0
    back_to_source: int = 0
    failed: int = 0
    pieces: int = 0
    schedule_failures: int = 0
    # scenario-injected events (scenarios/engine.py): piece errors that
    # aborted a wave through the reschedule path, stalls folded into
    # piece cost, children crashed mid-download, hosts dropped off the
    # announce plane, and waves beyond a peer's first (its retries)
    injected_piece_failures: int = 0
    injected_stalls: int = 0
    # corruption verdicts from the scenario engine: the child's digest
    # verification caught the piece, reported reason="corruption", and
    # the scheduler quarantined the parent host (trust-boundary PR)
    injected_corruptions: int = 0
    injected_crashes: int = 0
    injected_host_leaves: int = 0
    # control-plane chaos (scenarios/spec ControlPlaneSpec): scheduler
    # crashes that wiped state and forced every in-flight peer through the
    # re-announce/adoption path, peers recovered that way, and scheduling
    # responses lost to a silent host<->scheduler partition
    injected_scheduler_crashes: int = 0
    crash_reannounced_peers: int = 0
    injected_partition_drops: int = 0
    retry_waves: int = 0
    # seed daemons fetching origin on a TriggerSeedRequest (ObtainSeeds) —
    # origin traffic by design, not a P2P miss
    seed_downloads: int = 0
    # back-to-source cause split (VERDICT r3 weak #6): starved = the task
    # had no live finished peer to serve from when the child escalated;
    # with_parents = candidates existed but every schedule attempt was
    # filtered/rejected for retry_back_to_source_limit straight ticks
    back_to_source_starved: int = 0
    back_to_source_with_parents: int = 0
    # Sum of simulated piece-download costs (rtt + parent-quality service
    # time, the synth latent model). The replay clock does not advance on
    # piece cost, so this is a PURE selection-quality signal: a scheduler
    # that picks closer/faster parents accumulates less cost for the same
    # pieces — the measurable payoff an evaluator is supposed to buy
    # (the VERDICT r4 missing-#2 A/B compares it across algorithms).
    piece_cost_ns_total: int = 0


class ClusterSimulator:
    def __init__(
        self,
        scheduler: SchedulerService,
        num_hosts: int = 64,
        num_tasks: int = 16,
        seed: int = 0,
        piece_length: int = 4 << 20,
        scenario=None,
        deterministic_peer_ids: bool = False,
        cluster=None,
    ):
        self.scheduler = scheduler
        # `cluster` lets a subclass (megascale EventBatchEngine) supply a
        # pre-built host population (region/WAN topology) while keeping
        # every protocol interaction here; default stays the latent
        # synth model, bit-for-bit.
        self.cluster = (
            cluster if cluster is not None
            else synth.make_cluster(num_hosts, seed=seed)
        )
        self.rng = self.cluster.rng
        # Vectorised draws for the legacy (scenario-less) piece-cost
        # model: same distributions as the old per-piece
        # rtt_ns/lognormvariate calls, one numpy draw per wave. Seeded
        # from the sim seed so paired A/B arms stay paired.
        self._nprng = np.random.default_rng(seed + 0x5EED)
        # deterministic peer ids ("peer-<reg index>") let two sims with
        # the same seed be compared response-for-response (the
        # vectorized-vs-loop control-plane equivalence test); default
        # keeps uuid4 so concurrent sims can share a scheduler.
        self._det_ids = deterministic_peer_ids
        self.piece_length = piece_length
        self.stats = SimStats()
        # Scenario lab (scenarios/): a ScenarioSpec turns on the
        # deterministic heterogeneity/fault engine — piece costs from the
        # scenario link model, churn, flaky parents, Zipf popularity.
        # None keeps the legacy homogeneous replay bit-for-bit.
        self.engine = None
        self._task_weights = None
        if scenario is not None:
            from dragonfly2_tpu_torch.scenarios.engine import ScenarioEngine

            self.engine = ScenarioEngine(scenario, self.cluster.hosts, seed=seed)
            self._task_weights = self.engine.task_weights(num_tasks)
        self._round = 0
        self._probe_seq = 0
        self._reg_index = 0
        self._offline: set[str] = set()
        self._partitioned: set[str] = set()
        # Arrival host pool with some hosts unavailable, cached between
        # membership changes: offline/partitioned sets only change at
        # round boundaries (churn/partition epoch application), while a
        # round draws many arrivals — rebuilding the O(hosts) online
        # list per ARRIVAL was the dominant soak cost at megascale
        # (100k hosts x 1.5k arrivals/round). Content and order are
        # identical to an inline rebuild, so rng draws are unchanged.
        self._online_cache: list | None = None
        # peers whose scheduling response was lost to a partition: they
        # re-announce (register is load-not-create) once their host heals
        self._partition_stalled: set[str] = set()
        self._peer_reg: dict[str, int] = {}
        self._peer_have: dict[str, set[int]] = {}
        self._peer_waves: dict[str, int] = {}
        self._host_info: dict[str, msg.HostInfo] = {}
        self._tasks = []
        for t in range(num_tasks):
            url = f"https://origin.example.com/blob-{t}.bin"
            pieces = self.rng.randint(2, 32)
            self._tasks.append(
                {
                    "url": url,
                    "task_id": idgen.task_id_v2(url, tag="sim", piece_length=piece_length),
                    "pieces": pieces,
                    "content_length": pieces * piece_length,
                    "index": t,
                }
            )
        for h in self.cluster.hosts:
            info = msg.HostInfo(
                host_id=h.id,
                hostname=h.hostname,
                ip=h.ip,
                host_type="super" if h.is_seed else "normal",
                idc=h.idc,
                location=h.location,
                concurrent_upload_limit=h.concurrent_upload_limit,
                upload_count=h.upload_count,
                upload_failed_count=h.upload_failed_count,
            )
            self._host_info[h.id] = info
            self.scheduler.announce_host(info)
        self._hosts_by_id = {h.id: h for h in self.cluster.hosts}
        self._peer_host: dict[str, str] = {}
        self._task_of: dict[str, dict] = {}

    # ------------------------------------------------------------- driving

    def _new_download_request(self, host=None, task=None) -> msg.RegisterPeerRequest:
        """Draw (host, task), allocate the peer identity and sim-side
        bookkeeping, and build the register request WITHOUT sending it —
        split from `start_download` so the event-batch engine can build a
        whole arrival wave and register it through the scheduler's
        `register_peers_batch` bulk API with identical draws."""
        if host is None:
            if self._offline or self._partitioned:
                online = self._online_cache
                if online is None:
                    unavailable = self._offline | self._partitioned
                    online = self._online_cache = [
                        h for h in self.cluster.hosts if h.id not in unavailable
                    ]
                host = self.rng.choice(online or self.cluster.hosts)
            else:
                host = self.rng.choice(self.cluster.hosts)
        if task is None:
            if self._task_weights is not None:
                # hotspot skew: Zipf draw over task ranks (scenarios/spec
                # SkewSpec) — a few blobs get downloaded cluster-wide
                task = self.rng.choices(self._tasks, weights=self._task_weights)[0]
            else:
                task = self.rng.choice(self._tasks)
        peer_id = (
            f"peer-{self._reg_index}" if self._det_ids else str(uuid.uuid4())
        )
        self._peer_reg[peer_id] = self._reg_index
        self._reg_index += 1
        self._peer_host[peer_id] = host.id
        self.stats.registered += 1
        self._task_of[peer_id] = task
        return msg.RegisterPeerRequest(
            peer_id=peer_id,
            task_id=task["task_id"],
            host=self._host_info[host.id],
            url=task["url"],
            content_length=task["content_length"],
            piece_length=self.piece_length,
            total_piece_count=task["pieces"],
            tag="sim",
            application="simulator",
        )

    def start_download(self, host=None, task=None) -> str:
        req = self._new_download_request(host, task)
        self.scheduler.register_peer(req)
        return req.peer_id

    def run_round(self, new_downloads: int = 8) -> list:
        """One simulation round: start downloads, tick the scheduler, act on
        every response like a dfdaemon would."""
        self._round += 1
        if self.engine is not None:
            self._apply_host_churn()
            if self.engine.scheduler_crashed(self._round):
                self._apply_scheduler_crash()
            self._apply_partitions()
        for _ in range(new_downloads):
            self.start_download()
        self.consume_seed_triggers()
        responses = self.scheduler.tick()
        for resp in responses:
            peer_id = getattr(resp, "peer_id", "")
            if self._peer_host.get(peer_id) in self._partitioned:
                # silent partition: the response never reaches the daemon —
                # the peer stalls until the partition heals and it
                # re-announces (no LeaveHost, no error, just loss)
                self.stats.injected_partition_drops += 1
                self._partition_stalled.add(peer_id)
                continue
            self._act(resp)
        return responses

    def _apply_scheduler_crash(self) -> None:
        """Scheduler crash: in-memory scheduler state is wiped and every
        announce stream dies at once. Every incomplete peer then does what
        a real daemon does after failover/restart — re-announces with the
        pieces it kept, and the scheduler ADOPTS the partial download
        (register_peer finished_pieces) instead of starting it over."""
        self.stats.injected_scheduler_crashes += 1
        svc = self.scheduler
        # Every in-flight peer loses its scheduler state: the pending
        # queue AND peers whose response was lost to a partition (their
        # registration is wiped too — they re-register with kept pieces
        # when their partition heals, via the same adoption path).
        victims = [
            pid for pid in list(svc._pending)
            if pid in self._task_of
        ]
        # sorted: _partition_stalled is a set of peer-id strings, and set
        # iteration order follows the per-process string-hash salt — the
        # leave order must not (it drives free-list and pending order)
        for pid in sorted(self._partition_stalled):
            if pid in self._task_of and pid not in svc._pending:
                svc.leave_peer(pid)
        for pid in victims:
            svc.leave_peer(pid)
        for pid in victims:
            task = self._task_of[pid]
            host_id = self._peer_host.get(pid)
            info = self._host_info.get(host_id)
            if info is None:
                continue
            svc.register_peer(msg.RegisterPeerRequest(
                peer_id=pid,
                task_id=task["task_id"],
                host=info,
                url=task["url"],
                content_length=task["content_length"],
                piece_length=self.piece_length,
                total_piece_count=task["pieces"],
                tag="sim",
                application="simulator",
                finished_pieces=self._finished_pieces(pid) or None,
            ))
            self.stats.crash_reannounced_peers += 1

    def _finished_pieces(self, peer_id: str) -> list[int]:
        """Pieces this peer holds, ascending — what a daemon re-announces
        after a scheduler crash or healed partition. Overridable: the
        event-batch engine decodes its columnar have-bitsets here instead
        of keeping per-peer sets."""
        return sorted(self._peer_have.get(peer_id, ()))

    def _apply_partitions(self) -> None:
        """Epoch re-roll of silently partitioned hosts; healed peers whose
        scheduling response was lost re-announce and re-enter the queue."""
        partitioned_now = self.engine.partitioned_hosts(self._round)
        healed = self._partitioned - partitioned_now
        if partitioned_now != self._partitioned:
            self._online_cache = None
        self._partitioned = partitioned_now
        if not healed:
            return
        # sorted, not set order: healed peers re-enter the scheduler's
        # pending queue right here, and the queue order maps candidate
        # sample rows to children in the next tick — iterating the set
        # raw would make parent selection follow the per-process string-
        # hash salt (identical aggregates, different replicas)
        for pid in sorted(self._partition_stalled):
            host_id = self._peer_host.get(pid)
            if host_id not in healed:
                continue
            self._partition_stalled.discard(pid)
            task = self._task_of.get(pid)
            info = self._host_info.get(host_id)
            if task is None or info is None:
                continue
            self.scheduler.register_peer(msg.RegisterPeerRequest(
                peer_id=pid,
                task_id=task["task_id"],
                host=info,
                url=task["url"],
                content_length=task["content_length"],
                piece_length=self.piece_length,
                total_piece_count=task["pieces"],
                tag="sim",
                application="simulator",
                finished_pieces=self._finished_pieces(pid) or None,
            ))

    def consume_seed_triggers(self) -> int:
        """Act as the seed daemons: drain the TriggerSeedRequests the
        service enqueues for cold tasks (register_peer -> seed_triggers;
        the ObtainSeeds edge, scheduler/job.go:152 — in production the RPC
        server pushes these to seed daemons, which back-source and then
        serve). Without this leg the replay has no first parent anywhere:
        every task's opening peer — and every peer arriving after the
        compressed-TTL GC emptied a task's swarm — escalated to
        back-to-source, ~25% of completions at 10k hosts (VERDICT r3
        weak #6)."""
        svc = self.scheduler
        with svc.mu:
            triggers, svc.seed_triggers = svc.seed_triggers, []
        by_task = {t["task_id"]: t for t in self._tasks}
        for trig in triggers:
            task = by_task.get(trig.task_id)
            info = self._host_info.get(trig.host_id)
            if task is None or info is None:
                continue
            if self._det_ids:
                peer_id = f"seed-{self._reg_index}"
                self._reg_index += 1
            else:
                peer_id = f"seed-{uuid.uuid4()}"
            self._peer_host[peer_id] = trig.host_id
            self._task_of[peer_id] = task
            svc.register_peer(msg.RegisterPeerRequest(
                peer_id=peer_id,
                task_id=trig.task_id,
                host=info,
                url=trig.url,
                content_length=task["content_length"],
                piece_length=self.piece_length,
                total_piece_count=task["pieces"],
                priority=1,  # the seed itself must not re-trigger a seed
                tag=trig.tag,
                application=trig.application,
            ))
            svc.back_to_source_started(
                msg.DownloadPeerBackToSourceStartedRequest(peer_id=peer_id)
            )
            svc.back_to_source_finished(
                msg.DownloadPeerBackToSourceFinishedRequest(
                    peer_id=peer_id,
                    content_length=task["content_length"],
                    piece_count=task["pieces"],
                )
            )
            self.stats.seed_downloads += 1
        return len(triggers)

    def _extra_offline(self, round_idx: int) -> set[str]:
        """Additional hosts off the announce plane this round beyond the
        engine's churn epochs — the megascale engine contributes its
        rolling-upgrade cohort here. Base: none."""
        return set()

    def _apply_host_churn(self) -> None:
        """Scenario churn: flap hosts off/onto the announce plane. A host
        going offline LEAVES (LeaveHost drops its peers mid-download —
        the reference's host-GC/leave path); a returning host re-announces
        and rejoins scheduling with fresh per-connection state. Leaves go
        through the scheduler's batched `leave_hosts_batch` (one peer-
        table pass for the whole cohort instead of one per host) in
        sorted host-id order, which also makes the leave order — and
        therefore slot-free-list order — identical across runs."""
        offline_now = self.engine.offline_hosts(self._round) | self._extra_offline(self._round)
        leaving = sorted(
            h for h in offline_now - self._offline if h in self._host_info
        )
        if leaving:
            self.scheduler.leave_hosts_batch(leaving)
            self.stats.injected_host_leaves += len(leaving)
        for host_id in sorted(self._offline - offline_now):
            info = self._host_info.get(host_id)
            if info is not None:
                self.scheduler.announce_host(info)
        self._offline = offline_now
        self._online_cache = None

    def _act(self, resp) -> None:
        if isinstance(resp, msg.NormalTaskResponse):
            self._download_from_parents(resp)
        elif isinstance(resp, msg.NeedBackToSourceResponse):
            self._back_to_source(resp.peer_id)
        elif isinstance(resp, msg.EmptyTaskResponse):
            self.stats.completed += 1
        elif isinstance(resp, msg.ScheduleFailure):
            if resp.code == "Retry":
                return  # stays pending; next tick retries
            self.stats.schedule_failures += 1

    def _download_from_parents(self, resp: msg.NormalTaskResponse) -> None:
        peer_id = resp.peer_id
        child_host = self._hosts_by_id[self._peer_host[peer_id]]
        task = self._task_of[peer_id]
        n_pieces = task["pieces"]
        parents = resp.candidate_parents
        if self.engine is None:
            # legacy homogeneous replay: latent host quality + IDC RTT,
            # vectorised per wave (same distributions as the per-piece
            # rtt_ns + lognormvariate calls — base RTT by IDC/region tier
            # with lognorm(0, 0.3) jitter, service time from the parent's
            # latent quality with lognorm(0, 0.25) jitter) and reported
            # as ONE pieces_finished_batch call into the scheduler's
            # columnar report buffer instead of n_pieces message objects.
            base_ms = np.empty(len(parents))
            svc_ms = np.empty(len(parents))
            for pi, parent in enumerate(parents):
                ph = self._hosts_by_id[
                    self._peer_host.get(parent.peer_id, parent.host_id)
                ]
                base_ms[pi] = self.cluster.base_rtt_ms(child_host, ph)
                svc_ms[pi] = (
                    self.piece_length / (max(ph.quality, 0.05) * 100e6) * 1e3
                )
            psel = np.arange(n_pieces) % len(parents)
            rtt = np.maximum(
                1,
                (base_ms[psel]
                 * self._nprng.lognormal(0.0, synth.RTT_JITTER_SIGMA, n_pieces)
                 * 1e6).astype(np.int64),
            )
            cost = rtt + (
                svc_ms[psel] * self._nprng.lognormal(0.0, 0.25, n_pieces) * 1e6
            ).astype(np.int64)
            self.scheduler.pieces_finished_batch(
                peer_id,
                range(n_pieces),
                np.full(n_pieces, self.piece_length, np.int64),
                cost,
                parent_ids=[p.peer_id for p in parents],
                parent_sel=psel,
            )
            self.stats.pieces += n_pieces
            self.stats.piece_cost_ns_total += int(cost.sum())
            self.scheduler.peer_finished(
                msg.DownloadPeerFinishedRequest(
                    peer_id=peer_id, content_length=task["content_length"], piece_count=n_pieces
                )
            )
            self.stats.completed += 1
            return
        # ---- scenario path: per-peer progress across waves, piece costs
        # from the scenario link model, deterministic faults. An injected
        # piece error reports DownloadPieceFailed (the real protocol edge)
        # and ABORTS the wave — the scheduler blocklists that parent and
        # the peer retries from its kept progress on a later tick.
        have = self._peer_have.setdefault(peer_id, set())
        wave = self._peer_waves.get(peer_id, 0) + 1
        self._peer_waves[peer_id] = wave
        if wave > 1:
            self.stats.retry_waves += 1
        crash_after = self.engine.crash_point(self._peer_reg.get(peer_id, 0), n_pieces)
        # Per-piece costs/faults stay on the engine's counter-hashed
        # deterministic draws, but the finished reports accumulate and
        # land in ONE pieces_finished_batch call (flushed before any
        # fault/crash report so the scheduler observes the same
        # report-then-fail order the per-piece path produced).
        parent_ids = [p.peer_id for p in parents]
        batch_nums: list[int] = []
        batch_costs: list[int] = []
        batch_sel: list[int] = []

        def flush_batch():
            if batch_nums:
                self.scheduler.pieces_finished_batch(
                    peer_id, batch_nums,
                    [self.piece_length] * len(batch_nums),
                    batch_costs, parent_ids=parent_ids, parent_sel=batch_sel,
                )
                batch_nums.clear()
                batch_costs.clear()
                batch_sel.clear()

        # Wave-invariant work hoisted out of the piece loop (this loop is
        # the oracle's hot path — it runs per PIECE at equivalence-test
        # scale): the parent-slot resolution (two dict hops per parent),
        # the missing-piece enumeration (the `have` membership test per
        # piece), and the bound methods/attrs the loop re-read per
        # iteration. Resolving parents once per wave is exact: a wave's
        # parent set is fixed by the response.
        parent_hosts = [
            self._hosts_by_id[self._peer_host.get(p.peer_id, p.host_id)]
            for p in parents
        ]
        n_parents = len(parents)
        task_index = task["index"]
        piece_cost_ns = self.engine.piece_cost_ns
        piece_length = self.piece_length
        stats = self.stats
        missing = (
            [p for p in range(n_pieces) if p not in have]
            if have else range(n_pieces)
        )
        for piece in missing:
            sel = piece % n_parents
            parent = parents[sel]
            parent_host = parent_hosts[sel]
            cost, fault = piece_cost_ns(
                child_host, parent_host, piece_length,
                task_index, piece, wave,
            )
            if fault == "error":
                stats.injected_piece_failures += 1
                flush_batch()
                self.scheduler.piece_failed(
                    msg.DownloadPieceFailedRequest(
                        peer_id=peer_id, parent_peer_id=parent.peer_id
                    )
                )
                return
            if fault == "corrupt":
                # the modeled child verified the piece against the
                # attested digest, refused the bytes, and attributed the
                # failure — the scheduler quarantines the parent host
                stats.injected_corruptions += 1
                flush_batch()
                self.scheduler.piece_failed(
                    msg.DownloadPieceFailedRequest(
                        peer_id=peer_id, parent_peer_id=parent.peer_id,
                        reason="corruption",
                    )
                )
                return
            if fault == "stall":
                stats.injected_stalls += 1
            batch_nums.append(piece)
            batch_costs.append(cost)
            batch_sel.append(sel)
            have.add(piece)
            stats.pieces += 1
            stats.piece_cost_ns_total += cost
            if crash_after is not None and len(have) >= crash_after:
                stats.injected_crashes += 1
                flush_batch()
                self.scheduler.peer_failed(
                    msg.DownloadPeerFailedRequest(
                        peer_id=peer_id, description="scenario churn: crashed"
                    )
                )
                return
        flush_batch()
        self.scheduler.peer_finished(
            msg.DownloadPeerFinishedRequest(
                peer_id=peer_id, content_length=task["content_length"], piece_count=n_pieces
            )
        )
        self.stats.completed += 1

    def _service_for_peer(self, peer_id: str, task_id: str):
        """The SchedulerService holding this peer's state. Base: the one
        scheduler. The fleet engine resolves the peer's ring-owner replica
        here so cause-split introspection (which reads service-internal
        state, not the wire protocol) lands on the right shard."""
        return self.scheduler

    def _back_to_source(self, peer_id: str) -> None:
        task = self._task_of[peer_id]
        # cause split: was there a live finished peer this child COULD
        # have pulled from when the scheduler gave up on it?
        from dragonfly2_tpu_torch.state.fsm import PeerState

        svc = self._service_for_peer(peer_id, task["task_id"])
        st = svc.state
        starved = True
        for pid in svc._task_peers.get(task["task_id"], []):
            if pid == peer_id:
                continue
            pidx = st.peer_index(pid)
            if pidx is not None and st.peer_state[pidx] in (
                int(PeerState.SUCCEEDED), int(PeerState.BACK_TO_SOURCE)
            ):
                starved = False
                break
        if starved:
            self.stats.back_to_source_starved += 1
        else:
            self.stats.back_to_source_with_parents += 1
        self.scheduler.back_to_source_started(
            msg.DownloadPeerBackToSourceStartedRequest(peer_id=peer_id)
        )
        self.scheduler.back_to_source_finished(
            msg.DownloadPeerBackToSourceFinishedRequest(
                peer_id=peer_id, content_length=task["content_length"], piece_count=task["pieces"]
            )
        )
        self.stats.back_to_source += 1
        self.stats.completed += 1

    def run_probe_round(self, sources: int = 8) -> int:
        """Probe cycle (SyncProbes flow, SURVEY.md §3.3): random sources ping
        scheduler-chosen least-probed targets; results land in the ProbeStore."""
        probes = self.scheduler.probes
        if probes is None:
            return 0
        n = 0
        alive = np.asarray(self.scheduler.state.host_alive[: self.scheduler.state.max_hosts])
        # slot -> host resolved once per round (a 10k-entry dict per
        # SOURCE dominated the probe round's wall at scale)
        slot_to_host = {
            self.scheduler.state.host_index(h.id): h for h in self.cluster.hosts
            if self.scheduler.state.host_index(h.id) is not None
        }
        for _ in range(sources):
            src = self.rng.choice(self.cluster.hosts)
            src_slot = self.scheduler.state.host_index(src.id)
            if src_slot is None:
                continue
            targets = probes.find_probed_hosts(
                alive, prng.key(self.rng.randint(0, 1 << 30)), k=5
            )
            srcs, dsts, rtts = [], [], []
            for t in targets:
                dst = slot_to_host.get(int(t))
                if dst is None or dst.id == src.id:
                    continue
                srcs.append(src_slot)
                dsts.append(int(t))
                rtts.append(float(self._probe_rtt_ns(src, dst)))
            if srcs:
                probes.enqueue(np.asarray(srcs), np.asarray(dsts), np.asarray(rtts))
                n += len(srcs)
        return n

    def _probe_rtt_ns(self, src, dst) -> int:
        """One probe measurement: scenario link model when a scenario is
        active (the probe loop MEASURES the injected topology — the
        NetworkTopology traces it snapshots then carry scenario structure
        into training data), else the latent synth model."""
        if self.engine is not None:
            self._probe_seq += 1
            return self.engine.rtt_ns(src, dst, key=("probe", self._probe_seq))
        return self.cluster.rtt_ns(src, dst)
