"""Port of dragonfly2_tpu/megascale/fleet.py, whole: the K replicas are
K of the port's ``SchedulerService`` on one device (the card unless
``megascale_fleet`` is asked for the CPU), routed over the port's
``utils/hashring.py``. A replica's tick returns after its selections
reached the host; the per-shard seconds ledger also waits for the card's
queued work after each tick, so it counts the device seconds a replica
caused.

Horizontally-sharded scheduler control plane — K task-sharded
scheduler replicas behind one consistent hashring.

One scheduler process was the last scale wall in the megascale lab:
its pieces/s at 10^5 hosts is one process's ceiling, and nothing above
it could grow the control plane horizontally. The
reference system shards exactly this way — pkg/balancer consistent
hashing over a scheduler cluster, every request for a task id landing on
the scheduler whose in-memory DAG for that task is authoritative — and
every ingredient already exists in this repo: the hashring with failover
walk (`utils/hashring.py`), partial-download adoption on re-announce
(`RegisterPeerRequest.finished_pieces` → ``state.adopt_pieces``), and
the bulk register/report/leave APIs the event-batch engine drives.

:class:`SchedulerFleet` composes them: K live
:class:`~dragonfly2_tpu_torch.cluster.scheduler.SchedulerService` replicas,
one :class:`~dragonfly2_tpu_torch.utils.hashring.HashRing` over their names,
and a task-affinity router — task-keyed messages (register, seed
trigger, handoff) go to the ring owner, peer-keyed reports follow the
peer's recorded shard, host-plane messages broadcast (every replica
sees every host, as every reference scheduler does via the manager).

Cross-scheduler peer handoff is the new protocol edge: when a replica
crashes, restarts under a rolling upgrade, or rejoins the ring, every
in-flight peer whose task's ring owner moved is released by the old
owner and re-announced to the new one via
:class:`~dragonfly2_tpu_torch.cluster.messages.PeerHandoffRequest` — carrying
the pieces the daemon kept, so the receiving scheduler ADOPTS the
partial download through the same ``finished_pieces`` path a
single-scheduler crash exercises, now scheduler-to-scheduler.

:class:`FleetEventBatchEngine` drives a fleet through the megascale lab
with the single-scheduler engine's exact protocol behavior at K=1 (the
equivalence oracle test pins SimStats, the fault digest, and the
tail/decision digests bit-identical), while K>1 adds ring maintenance:
crash victims leave the ring and hand off, upgrade windows roll
replicas gracefully, rejoins rebalance peers back. Determinism contract:
ring-rebalance iteration is SORTED (the handoff order drives the
receiving replica's pending-queue order — the exact class of bug the
simulator's partition paths fixed), and the only clock in this module
is ``perf_counter`` for the per-shard timing ledger that the
modeled-parallel wall accounting reads.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.megascale.engine import EventBatchEngine, megascale_service
from dragonfly2_tpu_torch.utils.hashring import HashRing

HANDOFF_REASONS = ("crash", "upgrade", "rebalance")


class _FleetQuarantineView:
    """Fleet-wide quarantine census: each replica quarantines parents
    independently (its own corruption evidence), the fleet view sums."""

    def __init__(self, fleet: "SchedulerFleet"):
        self._fleet = fleet

    def active_count(self) -> int:
        return sum(r.quarantine.active_count() for r in self._fleet.replicas)


class _FleetRecorderView:
    """Tick-phase view over the replicas' PhaseRecorders: per phase, the
    slowest replica's p50 — the fleet's critical-path tick breakdown
    (replicas tick on separate machines in production, so the max is the
    honest per-phase wall, not the sum)."""

    def __init__(self, fleet: "SchedulerFleet"):
        self._fleet = fleet

    def phase_p50s(self) -> dict:
        merged: dict = {}
        for r in self._fleet.replicas:
            for phase, p50 in r.recorder.phase_p50s().items():
                if merged.get(phase) is None or (
                    p50 is not None and p50 > merged[phase]
                ):
                    merged[phase] = p50
        return merged


class FleetDecisionView:
    """Decision-ledger facade over the replicas' ledgers.

    K=1 returns the single ledger's report and digest VERBATIM — the
    K=1 equivalence oracle compares decision digests bit-for-bit against
    a bare single-scheduler run, so even hashing one digest again would
    break the contract. K>1 merges: counters sum, divergence aggregates
    weight by each replica's compared/disagreement volume, and the
    digest chains the per-replica digests in replica order (replica
    order is construction order — deterministic)."""

    def __init__(self, fleet: "SchedulerFleet"):
        self._fleet = fleet

    def _ledgers(self) -> list:
        return [
            r.decisions for r in self._fleet.replicas
            if r.decisions is not None
        ]

    def counters(self) -> dict:
        out = {
            "decisions": 0, "joined": 0,
            "shadow_compared": 0, "shadow_top1_disagree": 0,
        }
        for led in self._ledgers():
            for key, v in led.counters().items():
                out[key] = out.get(key, 0) + int(v)
        return out

    def report(self) -> dict:
        ledgers = self._ledgers()
        if len(ledgers) == 1:
            return ledgers[0].report()
        reports = [led.report() for led in ledgers]
        out: dict = dict(self.counters())
        compared = [r["shadow_compared"] for r in reports]
        dis = [r["n_disagreements"] for r in reports]

        def wmean(key: str, weights: list, nd: int):
            num = den = 0.0
            for r, w in zip(reports, weights):
                if r.get(key) is not None and w > 0:
                    num += r[key] * w
                    den += w
            return round(num / den, nd) if den else None

        out["top1_disagreement"] = wmean("top1_disagreement", compared, 4)
        out["rank_corr"] = wmean("rank_corr", compared, 4)
        out["n_disagreements"] = sum(dis)
        out["regret_ttc_ms"] = wmean("regret_ttc_ms", dis, 3)
        out["regret_fail_rate"] = wmean("regret_fail_rate", dis, 4)
        by_arm: dict = {}
        for r in reports:
            for arm, e in (r.get("regret_by_arm") or {}).items():
                acc = by_arm.setdefault(arm, {"n": 0, "_ttc": [], "_fail": []})
                acc["n"] += e["n"]
                if e.get("regret_ttc_ms") is not None:
                    acc["_ttc"].append((e["regret_ttc_ms"], max(e["n"], 1)))
                if e.get("regret_fail_rate") is not None:
                    acc["_fail"].append((e["regret_fail_rate"], max(e["n"], 1)))

        def pooled(pairs: list, nd: int):
            den = sum(w for _, w in pairs)
            return (
                round(sum(v * w for v, w in pairs) / den, nd) if den else None
            )

        out["regret_by_arm"] = {
            arm: {
                "n": acc["n"],
                "regret_ttc_ms": pooled(acc["_ttc"], 3),
                "regret_fail_rate": pooled(acc["_fail"], 4),
            }
            for arm, acc in sorted(by_arm.items())
        }
        out["regret_fail_rate_by_arm"] = {
            arm: e["regret_fail_rate"]
            for arm, e in out["regret_by_arm"].items()
        }
        return out

    def deterministic_digest(self) -> str:
        ledgers = self._ledgers()
        if len(ledgers) == 1:
            return ledgers[0].deterministic_digest()
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        for led in ledgers:
            h.update(led.deterministic_digest().encode())
        return h.hexdigest()


def _synced_tick(replica) -> list:
    """The replica's tick, then a wait for what it left queued on the
    card: the per-shard ledger's seconds are compute seconds."""
    out = replica.tick()
    if replica.device.type == "cuda":
        import torch

        torch.cuda.synchronize(replica.device)
    return out


class SchedulerFleet:
    """K task-sharded scheduler replicas behind one consistent hashring.

    Capability parity with the reference's scheduler cluster: pkg/
    balancer consistent hashing routes every task to one scheduler whose
    in-memory state for it is authoritative (the dynconfig-fed resolver
    keeps daemons on that affinity), and a replica leaving the ring
    moves its ranges to the survivors. The fleet exposes the same
    surface a single :class:`SchedulerService` does (register/report/
    leave/tick/counts/…) so the simulator and event-batch engine drive
    it unchanged; routing is:

    - task-keyed → ring owner: ``register_peer`` / ``register_peers_
      batch`` / ``PeerHandoffRequest`` / ``trigger_seed_download``;
    - peer-keyed → recorded shard: every piece/peer report, ``leave_
      peer``, ``reschedule`` (a daemon keeps reporting to the scheduler
      that answered its announce);
    - host-plane → broadcast: ``announce_host`` / ``leave_hosts_batch``
      (every reference scheduler learns every host via the manager).

    Every routed call is timed per shard (``perf_counter`` — DET-exempt)
    into a seconds ledger the engine folds into serial vs critical-path
    scheduler time: replicas run on separate machines in production, so
    the per-round max across shards is the honest parallel wall.
    """

    def __init__(self, replicas, names=None, registry=None, vnodes=64):
        if not replicas:
            raise ValueError("SchedulerFleet needs at least one replica")
        self.replicas = list(replicas)
        self.names = (
            list(names) if names is not None
            else [f"scheduler-{k}" for k in range(len(self.replicas))]
        )
        if len(self.names) != len(self.replicas):
            raise ValueError("one name per replica")
        self._shard_of_name = {n: k for k, n in enumerate(self.names)}
        # `vnodes` = virtual nodes per replica on the ring: more vnodes
        # cut the ring into finer bands, so each replica's share of the
        # task catalog tracks 1/K more closely — at the default 64 a
        # 4-replica fleet can own a third of a 256-task catalog on one
        # shard purely from lumpy band boundaries
        self.ring = HashRing(self.names, replicas=vnodes)
        # fleet-level lock: the simulator's seed-trigger drain swap-
        # assigns under `scheduler.mu`; reentrant because routed calls
        # may nest (register inside a drain)
        self.mu = threading.RLock()
        # peer -> shard that answered its announce (the reporting
        # affinity); set at register, moved at handoff, dropped at leave
        self._peer_shard: dict[str, int] = {}
        self._down: set[int] = set()
        self._sched_seconds = [0.0] * len(self.replicas)
        self.pieces_by_shard = [0] * len(self.replicas)
        self.handoffs = {reason: 0 for reason in HANDOFF_REASONS}
        self.restarts = 0
        # the fleet does not model a cluster-wide probe plane (each
        # replica's ProbeStore stays per-shard); the simulator's probe
        # round checks this and no-ops
        self.probes = None
        self.quarantine = _FleetQuarantineView(self)
        self.recorder = _FleetRecorderView(self)
        self._decisions_view = FleetDecisionView(self)
        from dragonfly2_tpu_torch.telemetry import default_registry
        from dragonfly2_tpu_torch.telemetry.series import fleet_series

        series = fleet_series(
            registry if registry is not None else default_registry()
        )
        self._m_handoffs = {
            reason: series.handoffs.labels(reason)
            for reason in HANDOFF_REASONS
        }
        self._m_pieces = [series.shard_pieces.labels(n) for n in self.names]
        self._m_restarts = [
            series.shard_restarts.labels(n) for n in self.names
        ]
        self._m_shards = series.shards_in_ring.labels()
        self._m_shards.set(float(len(self.ring)))

    # ------------------------------------------------------------ routing

    @property
    def k(self) -> int:
        return len(self.replicas)

    @property
    def decisions(self):
        if all(r.decisions is None for r in self.replicas):
            return None
        return self._decisions_view

    def shard_of_task(self, task_id: str) -> int:
        name = self.ring.pick(task_id)
        if name is None:  # whole ring down — degrade to replica 0
            return 0
        return self._shard_of_name[name]

    def shard_of_peer(self, peer_id: str) -> int | None:
        return self._peer_shard.get(peer_id)

    def _timed(self, shard: int, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self._sched_seconds[shard] += time.perf_counter() - t0

    def sched_seconds(self) -> list[float]:
        """Cumulative routed-call seconds per shard (the engine's
        serial/critical-path accounting snapshots deltas per round)."""
        return list(self._sched_seconds)

    # ------------------------------------------------------- task-keyed

    def register_peer(self, req: msg.RegisterPeerRequest):
        with self.mu:
            shard = self.shard_of_task(req.task_id)
            prev = self._peer_shard.get(req.peer_id)
            if prev is not None and prev != shard:
                # the ring moved while this peer was stalled/partitioned:
                # release the old owner's row first so the register below
                # is a clean adoption on the new owner, not a split brain
                self._timed(prev, self.replicas[prev].leave_peer, req.peer_id)
                self._peer_shard.pop(req.peer_id, None)
            resp = self._timed(shard, self.replicas[shard].register_peer, req)
            if isinstance(resp, msg.ScheduleFailure):
                self._peer_shard.pop(req.peer_id, None)
            else:
                self._peer_shard[req.peer_id] = shard
            return resp

    def register_peers_batch(self, reqs) -> list:
        """Bulk register routed per shard: requests group by ring owner
        PRESERVING list order within each shard (slot allocation and
        seed-trigger round-robin are order-dependent), one bulk call per
        shard in ascending shard order, responses reassembled in the
        original request order. K=1 degenerates to exactly one bulk call
        with the untouched list — bit-identical to the bare service."""
        with self.mu:
            by_shard: dict[int, list[int]] = {}
            for i, req in enumerate(reqs):
                by_shard.setdefault(self.shard_of_task(req.task_id), []).append(i)
            out: list = [None] * len(reqs)
            for shard in sorted(by_shard):
                idxs = by_shard[shard]
                resps = self._timed(
                    shard, self.replicas[shard].register_peers_batch,
                    [reqs[i] for i in idxs],
                )
                for i, resp in zip(idxs, resps):
                    out[i] = resp
                    if isinstance(resp, msg.ScheduleFailure):
                        self._peer_shard.pop(reqs[i].peer_id, None)
                    else:
                        self._peer_shard[reqs[i].peer_id] = shard
            return out

    def trigger_seed_download(self, task_id: str, url: str, **kwargs) -> bool:
        shard = self.shard_of_task(task_id)
        return self._timed(
            shard, self.replicas[shard].trigger_seed_download,
            task_id, url, **kwargs,
        )

    # ------------------------------------------------------- peer-keyed

    def _route_peer(self, peer_id: str):
        shard = self._peer_shard.get(peer_id)
        if shard is None:
            return None, None
        return shard, self.replicas[shard]

    def _peer_call(self, method: str, req):
        shard, replica = self._route_peer(getattr(req, "peer_id", ""))
        if replica is None:
            return msg.ScheduleFailure(
                getattr(req, "peer_id", ""), "NotFound",
                "peer unknown to the fleet router",
            )
        return self._timed(shard, getattr(replica, method), req)

    def piece_finished(self, req: msg.DownloadPieceFinishedRequest):
        shard = self._peer_shard.get(req.peer_id)
        if shard is not None:
            self.pieces_by_shard[shard] += 1
            self._m_pieces[shard].inc()
        return self._peer_call("piece_finished", req)

    def pieces_finished_batch(
        self, peer_id, piece_numbers, lengths, costs_ns,
        parent_ids=(), parent_sel=None,
    ):
        shard, replica = self._route_peer(peer_id)
        if replica is None:
            return msg.ScheduleFailure(
                peer_id, "NotFound", "peer unknown to the fleet router"
            )
        n = len(piece_numbers)
        self.pieces_by_shard[shard] += n
        self._m_pieces[shard].inc(n)
        return self._timed(
            shard, replica.pieces_finished_batch,
            peer_id, piece_numbers, lengths, costs_ns,
            parent_ids=parent_ids, parent_sel=parent_sel,
        )

    def piece_failed(self, req):
        return self._peer_call("piece_failed", req)

    def peer_finished(self, req):
        return self._peer_call("peer_finished", req)

    def peer_failed(self, req):
        return self._peer_call("peer_failed", req)

    def back_to_source_started(self, req):
        return self._peer_call("back_to_source_started", req)

    def back_to_source_finished(self, req):
        return self._peer_call("back_to_source_finished", req)

    def back_to_source_failed(self, req):
        return self._peer_call("back_to_source_failed", req)

    def reschedule(self, req):
        return self._peer_call("reschedule", req)

    def leave_peer(self, peer_id: str) -> None:
        with self.mu:
            shard = self._peer_shard.pop(peer_id, None)
            if shard is not None:
                self._timed(shard, self.replicas[shard].leave_peer, peer_id)

    # ---------------------------------------------------------- dispatch

    def handle(self, request):
        """Announce-stream dispatch with fleet routing: handoffs and
        registers route by task ring, every other message follows the
        peer's recorded shard — the wire surface the RPC edge (and the
        skew proxy's N-1 codec round-trip) drives."""
        if isinstance(request, msg.PeerHandoffRequest):
            return self._handle_handoff(request)
        if isinstance(request, msg.RegisterPeerRequest):
            return self.register_peer(request)
        shard, replica = self._route_peer(getattr(request, "peer_id", ""))
        if replica is None:
            return msg.ScheduleFailure(
                getattr(request, "peer_id", ""), "NotFound",
                "peer unknown to the fleet router",
            )
        return self._timed(shard, replica.handle, request)

    def _handle_handoff(self, req: msg.PeerHandoffRequest):
        with self.mu:
            shard = self.shard_of_task(req.task_id)
            reason = req.reason if req.reason in self.handoffs else "rebalance"
            self.handoffs[reason] += 1
            self._m_handoffs[reason].inc()
            resp = self._timed(shard, self.replicas[shard].handle, req)
            if isinstance(resp, msg.ScheduleFailure):
                self._peer_shard.pop(req.peer_id, None)
            else:
                self._peer_shard[req.peer_id] = shard
            return resp

    # ---------------------------------------------------------- host plane

    def announce_host(self, host: msg.HostInfo):
        out = None
        for shard, replica in enumerate(self.replicas):
            out = self._timed(shard, replica.announce_host, host)
        return out

    def leave_hosts_batch(self, host_ids) -> int:
        ids = list(host_ids)
        dropped = 0
        for shard, replica in enumerate(self.replicas):
            dropped = self._timed(shard, replica.leave_hosts_batch, ids)
        return dropped

    def leave_host(self, host_id: str) -> None:
        for shard, replica in enumerate(self.replicas):
            self._timed(shard, replica.leave_host, host_id)

    def apply_dynconfig(self, data: dict) -> None:
        for replica in self.replicas:
            replica.apply_dynconfig(data)

    def warmup(self) -> None:
        for shard, replica in enumerate(self.replicas):
            self._timed(shard, replica.warmup)

    def flush_piece_reports(self) -> int:
        return sum(
            self._timed(shard, replica.flush_piece_reports)
            for shard, replica in enumerate(self.replicas)
        )

    # --------------------------------------------------------------- tick

    def tick(self) -> list:
        """One scheduling round across the fleet: every replica ticks in
        replica order (down replicas tick too — their drained pending
        queues make it a no-op — so rejoin cannot reorder the loop), and
        the responses concatenate in that order. K=1 is the bare
        service's tick, response-for-response."""
        out: list = []
        for shard, replica in enumerate(self.replicas):
            out.extend(self._timed(shard, _synced_tick, replica))
        return out

    @property
    def seed_triggers(self) -> list:
        """Fleet-wide seed-trigger queue view in replica order. The
        simulator drains it with a swap-assign under ``mu``; assignment
        routes each trigger back to its task's ring owner (an empty
        assignment — the drain — just clears every replica)."""
        out: list = []
        for replica in self.replicas:
            out.extend(replica.seed_triggers)
        return out

    @seed_triggers.setter
    def seed_triggers(self, value) -> None:
        with self.mu:
            for replica in self.replicas:
                replica.seed_triggers = []
            for trig in value:
                self.replicas[self.shard_of_task(trig.task_id)] \
                    .seed_triggers.append(trig)

    # ------------------------------------------------------ ring lifecycle

    def shard_down(self, shard: int) -> None:
        """Take a replica out of the ring (crash or rolling-upgrade
        restart). Its ranges move to ring successors; the engine hands
        its in-flight peers off. A lone replica restarts in place — a
        K=1 fleet has nowhere to move ownership, which is exactly the
        single-scheduler crash semantics the oracle models."""
        if self.k == 1:
            return
        self.ring.remove(self.names[shard])
        self._down.add(shard)
        self._m_shards.set(float(len(self.ring)))

    def shard_up(self, shard: int) -> None:
        """Re-admit a replica to the ring after a restart."""
        if shard in self._down:
            self._down.discard(shard)
            self.restarts += 1
            self._m_restarts[shard].inc()
        self.ring.add(self.names[shard])
        self._m_shards.set(float(len(self.ring)))

    def down_shards(self) -> list[int]:
        return sorted(self._down)

    # ----------------------------------------------------------- reporting

    def counts(self) -> dict:
        """Entity counts summed across replicas — the same keys a single
        service's ``counts()`` reports, so report consumers are
        layout-compatible. Hosts count K× at K>1 (every replica
        announces every host, as in the reference deployment)."""
        total: dict = {}
        for replica in self.replicas:
            for key, v in replica.counts().items():
                total[key] = total.get(key, 0) + int(v)
        return total

    def counts_by_shard(self) -> dict:
        return {
            name: self.replicas[shard].counts()
            for shard, name in enumerate(self.names)
        }

    def fleet_counters(self) -> dict:
        """Deterministic fleet-plane counters for the megascale report's
        ``fleet`` block."""
        live_by_shard = [0] * self.k
        for shard in self._peer_shard.values():
            live_by_shard[shard] += 1
        return {
            "handoffs": dict(self.handoffs),
            "handoffs_total": sum(self.handoffs.values()),
            "restarts": int(self.restarts),
            "pieces_by_shard": {
                name: int(self.pieces_by_shard[shard])
                for shard, name in enumerate(self.names)
            },
            "routed_peers_by_shard": {
                name: live_by_shard[shard]
                for shard, name in enumerate(self.names)
            },
            "shards_in_ring": len(self.ring),
            "down_shards": self.down_shards(),
        }


class FleetEventBatchEngine(EventBatchEngine):
    """Event-batch engine over a :class:`SchedulerFleet`.

    Single-scheduler protocol behavior is inherited unchanged — at K=1
    every routed call degenerates to the bare service call, so SimStats,
    the fault digest, and the tail/decision digests are bit-identical to
    an :class:`EventBatchEngine` run on paired seeds (the equivalence
    oracle test pins this). K>1 adds the fleet plane:

    - scheduler crashes pick a round-robin victim replica; its pending
      peers are released and handed off to the new ring owners via
      ``PeerHandoffRequest`` (through ``scheduler.handle`` so the skew
      proxy's N-1 codec covers the frame), and the victim leaves the
      ring for ``crash_down_rounds`` rounds;
    - rolling-upgrade windows (scenarios UpgradeSpec) gracefully restart
      the replica whose ring band the host sweep crosses — handoff away,
      one round out, rebalance back;
    - every ring change triggers a SORTED rebalance walk moving
      in-flight peers whose owner moved (kept pieces adopted);
    - the timeline grows per-shard piece columns, handoff deltas and
      ring census; a second TailTrace attributes completion phases per
      shard; per-round scheduler seconds split serial vs critical-path.
    """

    def __init__(self, scheduler, fleet: SchedulerFleet | None = None,
                 crash_down_rounds: int = 2, **kwargs):
        # the scheduler handed in may be a SkewProxy over the fleet; keep a direct
        # handle for ring lifecycle + counters (the proxy only mediates
        # message-shaped calls)
        self.fleet = fleet if fleet is not None else scheduler
        self._col_shard = np.full(1024, -1, np.int16)
        super().__init__(scheduler, **kwargs)
        self._crash_down_rounds = max(int(crash_down_rounds), 1)
        self._crash_counter = 0
        self._crash_victims: list[tuple[int, int]] = []  # (round, shard)
        self._down_until: dict[int, int] = {}
        self._upgrade_last = [-(1 << 30)] * self.fleet.k
        self._sched_round_s = [0.0] * self.fleet.k
        self._sched_prev = self.fleet.sched_seconds()
        self._tl_prev_shard = [0] * self.fleet.k
        self._tl_prev_handoffs = 0
        from dragonfly2_tpu_torch.telemetry import tailtrace as _tailtrace

        self.tail_shard = _tailtrace.TailTrace(
            list(self.fleet.names),
            seed=kwargs.get("seed", 0),
            name="megascale.fleet.tail",
        )

    # ------------------------------------------------------------ columns

    def _ensure_cols(self, n: int) -> None:
        super()._ensure_cols(n)
        cap = self._col_task.shape[0]
        if self._col_shard.shape[0] < cap:
            grown = np.full(cap, -1, np.int16)
            grown[: self._col_shard.shape[0]] = self._col_shard
            self._col_shard = grown

    def _new_download_request(self, host=None, task=None):
        reg = self._reg_index
        req = super()._new_download_request(host, task)
        self._col_shard[reg] = self.fleet.shard_of_task(req.task_id)
        return req

    def _service_for_peer(self, peer_id: str, task_id: str):
        shard = self.fleet.shard_of_peer(peer_id)
        if shard is None:
            shard = self.fleet.shard_of_task(task_id)
        return self.fleet.replicas[shard]

    # ------------------------------------------------------- ring events

    def _apply_host_churn(self) -> None:
        # ring maintenance rides the fault phase, before host churn: at
        # K=1 this is a no-op, so the base engine's round structure (and
        # the equivalence oracle) is untouched
        self._fleet_ring_step()
        super()._apply_host_churn()

    def _fleet_ring_step(self) -> None:
        fleet = self.fleet
        if fleet.k <= 1:
            return
        # rejoins first: a restarted replica re-enters the ring, then the
        # rebalance walk hands its tasks' in-flight peers back (adoption)
        for shard in sorted(self._down_until):
            if self._down_until[shard] <= self._round:
                del self._down_until[shard]
                fleet.shard_up(shard)
                self.timeline.mark_event(self._round, f"fleet_rejoin:{shard}")
                self._rebalance_handoffs("rebalance")
        if self.engine is None:
            return
        window = self.engine.upgrade_window(self._round)
        if window is None:
            return
        # rolling upgrade: replica k restarts when the host-order sweep
        # crosses its ring band's midpoint (k + 0.5)/K — a graceful
        # drain: handoff away, one round out, rebalance back on rejoin
        lo, hi = window
        wave_gap = max(self.engine.spec.upgrade.wave_rounds, 1)
        for shard in range(fleet.k):
            mid = (shard + 0.5) / fleet.k
            if not lo <= mid < hi:
                continue
            if self._round - self._upgrade_last[shard] < wave_gap:
                continue
            if shard in self._down_until or shard in fleet._down:
                continue
            self._upgrade_last[shard] = self._round
            self.timeline.mark_event(self._round, f"fleet_restart:{shard}")
            fleet.shard_down(shard)
            self._rebalance_handoffs("upgrade")
            self._down_until[shard] = self._round + 1

    def _rebalance_handoffs(self, reason: str) -> int:
        """Move every in-flight peer whose task's ring owner is no
        longer the replica holding it. Iteration is SORTED by peer id:
        the handoff order drives the receiving replica's pending-queue
        order (which maps candidate rows to children next tick), so set/
        dict iteration order must never leak into it — the exact
        determinism class the simulator's partition paths pin."""
        fleet = self.fleet
        moved = 0
        done_cap = self._col_done_round.shape[0]
        for pid in sorted(fleet._peer_shard):
            if not pid.startswith("peer-"):
                continue  # seed rows are serving state, not downloads
            task = self._task_of.get(pid)
            if task is None or pid in self._partition_stalled:
                continue  # retired, or waiting on a partition heal
            host_id = self._peer_host.get(pid)
            if (host_id is None or host_id in self._offline
                    or host_id in self._partitioned):
                continue  # its daemon cannot re-announce right now
            reg = self._reg_of(pid)
            if reg >= done_cap or self._col_done_round[reg] >= 0:
                continue  # completed — nothing in flight to move
            if fleet.shard_of_task(task["task_id"]) == fleet._peer_shard[pid]:
                continue
            self._handoff_peer(pid, task, reason)
            moved += 1
        return moved

    def _handoff_peer(self, pid: str, task: dict, reason: str) -> None:
        """Release one in-flight peer from its current shard and
        re-announce it to the task's ring owner, kept pieces riding the
        handoff frame for adoption. Goes through ``scheduler.handle`` so
        the mixed-version soak's skew proxy round-trips the frame."""
        fleet = self.fleet
        info = self._host_info.get(self._peer_host.get(pid))
        if info is None:
            return
        from_name = ""
        shard = fleet.shard_of_peer(pid)
        if shard is not None:
            from_name = fleet.names[shard]
        fleet.leave_peer(pid)
        self.scheduler.handle(msg.PeerHandoffRequest(
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
            from_scheduler=from_name,
            reason=reason,
        ))
        reg = self._reg_of(pid)
        new_shard = fleet.shard_of_peer(pid)
        self._col_shard[reg] = -1 if new_shard is None else new_shard

    def _apply_scheduler_crash(self) -> None:
        """Fleet crash: ONE replica dies (round-robin victim — the
        deterministic stand-in for 'the unlucky process'), not the whole
        control plane. Victim-owned in-flight rows get the crash stamp
        (the base engine stamps every row — here only the victim's
        downloads lose their scheduler), its pending peers are released
        and handed off to the new ring owners with their kept pieces,
        and at K>1 the victim leaves the ring for ``crash_down_rounds``.
        At K=1 the sequence reduces exactly to the oracle's crash replay
        (leave stalled + pending, re-register with finished_pieces) —
        the handoff handler constructs the identical register request."""
        fleet = self.fleet
        victim = self._crash_counter % fleet.k
        self._crash_counter += 1
        self._crash_victims.append((self._round, victim))
        n = self._reg_index
        alive = (
            (self._col_task[:n] >= 0)
            & (self._col_done_round[:n] < 0)
            & (self._col_shard[:n] == victim)
        )
        self._col_crash_round[:n][alive] = self._round
        self._col_crash_cost_ns[:n][alive] = self._col_cost_ns[:n][alive]
        self.stats.injected_scheduler_crashes += 1
        self.timeline.mark_event(self._round, f"fleet_crash:{victim}")
        vsvc = fleet.replicas[victim]
        victims = [pid for pid in list(vsvc._pending) if pid in self._task_of]
        # sorted: _partition_stalled is a set of peer-id strings and the
        # leave order drives free-list and pending order (oracle contract)
        for pid in sorted(self._partition_stalled):
            if (pid in self._task_of and pid not in vsvc._pending
                    and fleet.shard_of_peer(pid) == victim):
                fleet.leave_peer(pid)
        for pid in victims:
            fleet.leave_peer(pid)
        if fleet.k > 1:
            fleet.shard_down(victim)
            self._down_until[victim] = self._round + self._crash_down_rounds
        for pid in victims:
            task = self._task_of[pid]
            info = self._host_info.get(self._peer_host.get(pid))
            if info is None:
                continue
            self.scheduler.handle(msg.PeerHandoffRequest(
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
                from_scheduler=fleet.names[victim],
                reason="crash",
            ))
            new_shard = fleet.shard_of_peer(pid)
            self._col_shard[self._reg_of(pid)] = (
                -1 if new_shard is None else new_shard
            )
            self.stats.crash_reannounced_peers += 1
        if fleet.k > 1:
            # the victim's remaining in-flight peers (mid-download, not
            # pending) lost their scheduler too: their daemons re-dial
            # via the ring walk and land on the new owners. These are
            # scheduler-loss re-announces, so they burn the announce-
            # stability SLI with the pending victims — the kill round's
            # reannounce_backlog spike is what pages
            self.stats.crash_reannounced_peers += (
                self._rebalance_handoffs("crash")
            )

    # ------------------------------------------------------------- round

    def run_round(self, new_downloads: int = 8) -> list:
        responses = super().run_round(new_downloads)
        cur = self.fleet.sched_seconds()
        # per-shard scheduler-compute totals over the rounds (setup /
        # warmup excluded): replicas are independent machines in
        # production — no round barrier — so the fleet's critical path
        # is the BUSIEST shard's total, the makespan bound for
        # independent servers, not a per-round max
        for k, (c, p) in enumerate(zip(cur, self._sched_prev)):
            self._sched_round_s[k] += c - p
        self._sched_prev = cur
        return responses

    @property
    def _sched_serial_s(self) -> float:
        return sum(self._sched_round_s)

    @property
    def _sched_critical_s(self) -> float:
        return max(self._sched_round_s, default=0.0)

    def _timeline_sample(self, crashed: bool) -> None:
        super()._timeline_sample(crashed)
        fleet = self.fleet
        # TimelineRecorder.sample COPIES the values dict into the ring
        # entry — fleet columns mutate the entry in place, after the SLO
        # feed (they are fleet-plane attribution, not SLI inputs)
        entry = self.timeline.ring[-1]
        pieces = [int(v) for v in fleet.pieces_by_shard]
        entry["fleet_pieces"] = {
            name: pieces[shard] - self._tl_prev_shard[shard]
            for shard, name in enumerate(fleet.names)
        }
        self._tl_prev_shard = pieces
        handoffs = sum(fleet.handoffs.values())
        entry["fleet_handoffs"] = handoffs - self._tl_prev_handoffs
        self._tl_prev_handoffs = handoffs
        entry["shards_in_ring"] = len(fleet.ring)
        entry["shards_down"] = len(fleet.down_shards())

    def _observe_tail(self, reg: int) -> None:
        super()._observe_tail(reg)
        if not self.tail_capture or int(self._col_host[reg]) < 0:
            return
        shard = int(self._col_shard[reg])
        if shard < 0:
            return
        # the phase vector super() just built for this download; it sums
        # to the recorded TTC exactly (disjoint components)
        vec = self._tail_vec
        self.tail_shard.observe(
            shard, reg, float(vec.sum()), vec,
            round_idx=int(self._col_done_round[reg]),
        )

    # ---------------------------------------------------------- reporting

    def fleet_report(self) -> dict:
        """The deterministic ``fleet`` block for megascale reports:
        fleet-plane counters, per-shard entity counts and decision
        digests, the crash victim schedule with per-victim recovery
        measured on the victim shard's OWN piece-rate series, and the
        per-shard tail attribution."""
        from dragonfly2_tpu_torch.telemetry.timeline import recovery_time

        fleet = self.fleet
        tl = self.timeline.timeline()
        shard_series: dict[str, list[dict]] = {
            name: [
                {"t": s["t"], "pieces": s["fleet_pieces"][name]}
                for s in tl if "fleet_pieces" in s
            ]
            for name in fleet.names
        }
        victim_recovery = []
        for r, shard in self._crash_victims:
            name = fleet.names[shard]
            victim_recovery.append({
                "round": int(r),
                "shard": name,
                **recovery_time(
                    shard_series[name], "pieces", r,
                    baseline_window=8, threshold=0.9,
                ),
            })
        return {
            "replicas": fleet.k,
            "names": list(fleet.names),
            **fleet.fleet_counters(),
            "counts_by_shard": fleet.counts_by_shard(),
            "decision_digests_by_shard": {
                name: (
                    replica.decisions.deterministic_digest()
                    if replica.decisions is not None else None
                )
                for name, replica in zip(fleet.names, fleet.replicas)
            },
            "crash_victims": [
                {"round": int(r), "shard": fleet.names[s]}
                for r, s in self._crash_victims
            ],
            "victim_recovery": victim_recovery,
            "tail_by_shard": self.tail_shard.report(
                crash_rounds=[r for r, _ in self._crash_victims]
            ),
        }

    def fleet_timing(self, wall_s: float) -> dict:
        """Wall-derived (NON-deterministic — rides the report's `timing`
        block only) fleet throughput accounting. The in-process replay
        runs K replicas serially on one core; in production each replica
        is its own machine with no round barrier, so:

        - ``sched_serial_s``: summed per-shard scheduler-compute seconds
          — what this replay actually paid for the control plane;
        - ``sched_critical_s``: the BUSIEST shard's total — the makespan
          bound for K independent servers (at K=1 the two are equal);
        - ``modeled_parallel_wall_s``: this replay's wall with the
          serial scheduler time replaced by the critical path;
        - ``aggregate_pieces_per_sec``: pieces over the critical path —
          the control-plane capacity of the fleet. The event-batch
          engine's own numpy time prices the DATA plane (a million
          client machines in production, not scheduler compute), so it
          stays out of this cell; it still dominates
          ``modeled_parallel_wall_s`` for the replay-speed view.

        The 1-vs-K scaling artifact compares ``aggregate_pieces_per_sec``
        across replica counts."""
        modeled = max(
            wall_s - self._sched_serial_s + self._sched_critical_s, 1e-9
        )
        return {
            "sched_serial_s": round(self._sched_serial_s, 2),
            "sched_critical_s": round(self._sched_critical_s, 2),
            "sched_seconds_by_shard": {
                name: round(s, 2)
                for name, s in zip(self.fleet.names, self._sched_round_s)
            },
            "modeled_parallel_wall_s": round(modeled, 2),
            "aggregate_pieces_per_sec": round(
                self.stats.pieces / max(self._sched_critical_s, 1e-9), 1
            ),
        }


def megascale_fleet(
    num_hosts: int,
    num_tasks: int = 64,
    max_live_peers: int | None = None,
    algorithm: str = "default",
    seed: int = 0,
    max_peers_per_task: int = 2048,
    replicas: int = 1,
    device=None,
) -> SchedulerFleet:
    """A SchedulerFleet sized for a megascale run. K=1 builds the exact
    ``megascale_service`` configuration (bit-identical Config + seed —
    the equivalence oracle's precondition). K>1 seeds replica k with
    ``seed + k`` and sizes each peer table to its ring share with 1.5x
    slack for ring-cut jitter and crash-handoff bursts; task/host tables
    stay full-size (a hot task lives WHOLE on one shard, and every
    replica announces every host). Every replica runs on ``device``: None
    is the card (``device.resolve_device``), and raises where there is
    none."""
    k = max(int(replicas), 1)
    if k == 1:
        services = [megascale_service(
            num_hosts, num_tasks=num_tasks, max_live_peers=max_live_peers,
            algorithm=algorithm, seed=seed,
            max_peers_per_task=max_peers_per_task, device=device,
        )]
    else:
        live = max_live_peers or max(4 * num_hosts, 4096)
        # 1.5x slack over an even 1/K cut: the 256-vnode ring keeps each
        # replica's band within a few percent of 1/K, and a crashed
        # replica's band redistributes to the survivors at ~1.33/K peak
        # — oversizing beyond that only inflates every replica's
        # fixed per-tick sweep cost, which is pure serial overhead the
        # 1-vs-K scaling cell then charges to the fleet
        per_shard = -(-(live * 3) // (2 * k))
        services = [
            megascale_service(
                num_hosts, num_tasks=num_tasks, max_live_peers=per_shard,
                algorithm=algorithm, seed=seed + shard,
                max_peers_per_task=max_peers_per_task, device=device,
            )
            for shard in range(k)
        ]
    # megascale catalogs are a few hundred tasks over a handful of
    # replicas: 256 vnodes per replica keeps each shard's cut of the
    # catalog near 1/K (the 64-vnode default leaves ~±30% band lumps,
    # which at 10^6 hosts turns one replica into the fleet's critical
    # path before popularity skew even enters)
    return SchedulerFleet(services, vnodes=256)
