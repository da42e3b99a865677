"""Port of dragonfly2_tpu/telemetry/decisions.py, whole: ``DecisionLedger``.

Decision provenance ledger + counterfactual shadow scoring.

The reference scheduler's whole reason for collecting download records is
to feed parent-ranking training (SURVEY §2.3), yet until this module the
observability stack stopped at *timings*: phase rings (PR 1), cost cards
and soak timelines (PR 12). Nothing recorded WHY a parent was chosen, or
what the inactive arm would have picked — so "ml beats rule" was judged
only by end-to-end A/B cost, and the trainer never saw the serving path's
own decisions as labeled data.

:class:`DecisionLedger` is a bounded columnar ring (struct-of-arrays, no
per-decision Python dicts on the hot path) recording, for every APPLIED
selection the scheduler emits:

- the candidate slot set (peer rows + host slots) and a compact
  per-candidate feature row (:data:`DECISION_FEATURES`);
- the active arm's ranked selection (candidate positions + device
  scores), which of those survived DAG legality, and the chosen parent;
- the shadow arm's ranking of the SAME candidate set (counterfactual:
  the rule blend when ml serves, the committed ml snapshot when the rule
  serves), recorded off the critical path from the tick's end-of-round
  drain valve;
- the joined outcome once the peer's terminal event lands
  (completed / failed / back-to-source, corruption attribution,
  failover re-announce) with decision→outcome join latency.

Per-tick divergence (top-1 disagreement rate, rank correlation of the
active top-``limit`` against the shadow ranking) and measured per-arm
regret (outcome deltas on disagreement decisions, estimated from the
joined per-host outcome table) are exported as
``dragonfly_scheduler_decision_*`` metrics, ride ``flight.dump()`` /
``/debug/flight`` under the ``decisions`` key, and feed ``tools/dfwhy.py``
("why did peer X get parent Y") plus the ledger→training-trace exporter
in :mod:`dragonfly2_tpu_torch.training.data`.

Determinism contract: every column except the wall-clock ones
(``decided_at_ns``, ``outcome_ttc_ns``) is a pure function of the replay
— :meth:`DecisionLedger.deterministic_digest` is pinned identical across
paired-seed megascale runs (tests/test_megascale.py). The failure-rate
regret basis is likewise wall-free so it may ride deterministic timeline
samples; the TTC-ms basis is wall-derived and stays out of them.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np

# Compact per-candidate feature row recorded with every decision — the
# subset of the scoring features that (a) explains the rule blend's
# ordering (dfwhy) and (b) the trainer exporter needs (pair features).
DECISION_FEATURES = (
    "finished_pieces",
    "upload_count",
    "upload_failed_count",
    "free_upload",
    "host_type",
    "in_degree",
    "same_idc",
    "loc_match",
)
_F = len(DECISION_FEATURES)
_IDX = {name: i for i, name in enumerate(DECISION_FEATURES)}

ARM_CODES = {"default": 0, "nt": 1, "ml": 2, "plugin": 3}
ARM_NAMES = {v: k for k, v in ARM_CODES.items()}

OUTCOME_PENDING = 0
OUTCOME_COMPLETED = 1
OUTCOME_FAILED = 2
OUTCOME_BACK_TO_SOURCE = 3
OUTCOME_NAMES = {
    OUTCOME_PENDING: "pending",
    OUTCOME_COMPLETED: "completed",
    OUTCOME_FAILED: "failed",
    OUTCOME_BACK_TO_SOURCE: "back_to_source",
}


def compact_features(fd: dict, in_degree: np.ndarray,
                     max_location_elements: int = 5) -> np.ndarray:
    """(B, K, F) float32 ledger feature matrix from the tick's host-side
    feature dict (state.gather_candidates output) — one vectorised stack
    per tick, shared by every chunk's record."""
    child_idc = np.asarray(fd["child_idc"])[:, None]
    parent_idc = np.asarray(fd["parent_idc"])
    same_idc = ((parent_idc == child_idc) & (child_idc != 0)).astype(np.float32)
    ploc = np.asarray(fd["parent_location"])
    cloc = np.asarray(fd["child_location"])[:, None, :]
    elem_eq = (ploc == cloc) & (ploc != 0) & (cloc != 0)
    prefix = np.cumprod(elem_eq.astype(np.int32), axis=-1)
    loc_match = prefix.sum(axis=-1).astype(np.float32) / max_location_elements
    return np.stack(
        [
            np.asarray(fd["finished_pieces"], np.float32),
            np.asarray(fd["upload_count"], np.float32),
            np.asarray(fd["upload_failed_count"], np.float32),
            (np.asarray(fd["upload_limit"], np.float32)
             - np.asarray(fd["upload_used"], np.float32)),
            np.asarray(fd["host_type"], np.float32),
            np.asarray(in_degree, np.float32),
            same_idc,
            loc_match,
        ],
        axis=-1,
    )


# Weak named registry (mirrors flight.register_recorder / the timeline
# registry) so the process-wide /debug/flight dump finds the live
# scheduler's ledger without a handle on the service. Last wins.
_LEDGERS: dict[str, "weakref.ref[DecisionLedger]"] = {}
_ledgers_mu = threading.Lock()


def register_ledger(name: str, ledger: "DecisionLedger") -> None:
    with _ledgers_mu:
        _LEDGERS[name] = weakref.ref(ledger)


def live_ledgers() -> dict[str, "DecisionLedger"]:
    out = {}
    with _ledgers_mu:
        for name, ref in list(_LEDGERS.items()):
            led = ref()
            if led is None:
                del _LEDGERS[name]
            else:
                out[name] = led
    return out


class DecisionLedger:
    """Bounded SoA ring of applied scheduling decisions.

    The hot path touches it twice per tick: one ``record_batch`` per
    applied chunk (block column assigns, one lock acquisition) and one
    ``record_shadow`` at the tick's end-of-round shadow drain. Outcome
    joins are O(1) per terminal peer event via the bounded
    peer→slot map. Everything else (dump/regret/export) runs off the
    hot path.
    """

    def __init__(self, capacity: int = 4096, k: int = 15, limit: int = 4,
                 registry=None, name: str | None = None,
                 peer_resolver=None, host_resolver=None):
        cap = max(int(capacity), 8)
        self.capacity = cap
        self.k = int(k)
        self.limit = int(limit)
        self._peer_resolver = peer_resolver
        self._host_resolver = host_resolver
        # --- SoA columns. seq == 0 marks an empty slot.
        self.seq = np.zeros(cap, np.int64)
        self.tick = np.zeros(cap, np.int64)
        self.arm = np.full(cap, -1, np.int8)
        self.child_peer_row = np.full(cap, -1, np.int32)
        self.child_host_slot = np.full(cap, -1, np.int32)
        self.cand_rows = np.full((cap, k), -1, np.int32)
        self.cand_hosts = np.full((cap, k), -1, np.int32)
        self.cand_count = np.zeros(cap, np.int16)
        self.cand_feats = np.zeros((cap, k, _F), np.float32)
        self.sel_pos = np.full((cap, limit), -1, np.int16)
        self.sel_scores = np.full((cap, limit), np.nan, np.float32)
        self.sel_accepted = np.zeros((cap, limit), bool)
        self.chosen_pos = np.full(cap, -1, np.int16)
        self.shadow_arm = np.full(cap, -1, np.int8)
        self.shadow_pos = np.full((cap, limit), -1, np.int16)
        self.shadow_scores = np.full((cap, limit), np.nan, np.float32)
        self.outcome = np.zeros(cap, np.int8)
        self.outcome_bytes = np.zeros(cap, np.int64)
        # measured download cost from the peer's REPORTED piece costs
        # (virtual time in replays, measured transfer time in
        # production) — the replay-safe label basis; -1 = not joined
        self.outcome_cost_ns = np.full(cap, -1, np.int64)
        self.outcome_corruption = np.zeros(cap, bool)
        self.outcome_failover = np.zeros(cap, bool)
        # wall-clock columns — EXCLUDED from the determinism digest
        self.decided_at_ns = np.zeros(cap, np.int64)
        self.outcome_ttc_ns = np.full(cap, -1, np.int64)
        # identity strings for dfwhy / the trainer exporter: one store
        # per decision (object columns, not per-decision dicts)
        self.child_peer_id = np.empty(cap, object)
        self.task_id = np.empty(cap, object)
        self.chosen_parent_id = np.empty(cap, object)
        # peer -> slot of its latest pending decision (bounded by cap)
        self._by_peer: dict[str, int] = {}
        self._head = 0
        self._seq = 0
        self._mu = threading.Lock()
        # cumulative shadow counters (deterministic — counts only)
        self.shadow_compared = 0
        self.shadow_top1_disagree = 0
        self.joined = 0
        # per-tick divergence entries (plain data, bounded)
        from collections import deque

        self.divergence_ring: "deque[dict]" = deque(maxlen=512)
        from dragonfly2_tpu_torch.telemetry import metrics as _metrics
        from dragonfly2_tpu_torch.telemetry.series import decision_series

        reg = registry if registry is not None else _metrics.default_registry()
        self._series = decision_series(reg)
        if name is not None:
            register_ledger(name, self)

    # ------------------------------------------------------------ record

    def record_batch(
        self,
        tick_id: int,
        arm: int,
        child_rows: np.ndarray,
        child_hosts: np.ndarray,
        cand_rows: np.ndarray,
        cand_hosts: np.ndarray,
        cand_count: np.ndarray,
        feats: np.ndarray,
        sel_pos: np.ndarray,
        sel_scores: np.ndarray,
        sel_accepted: np.ndarray,
        chosen_pos: np.ndarray,
        peer_ids: list,
        task_ids: list,
        chosen_ids: list,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Record N applied decisions as block column assigns; returns
        (ring slots, their seq numbers) — the tick's later shadow join
        passes BOTH back so a mid-tick ring wrap (a single tick applying
        more decisions than the capacity) can never attach shadow data
        to a slot a later chunk already overwrote. All array args are
        already sliced to the applied rows."""
        n = len(peer_ids)
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        drop = 0
        if n > self.capacity:
            # ONE batch larger than the whole ring: only the newest
            # `capacity` decisions can survive, and assigning duplicate
            # slots within a single call would leave earlier rows'
            # peer→slot mappings pointing at columns a later row owns —
            # a cross-peer outcome join. Drop the oldest overflow up
            # front; their returned slots stay -1 (the shadow join
            # skips them) and their peers never map.
            drop = n - self.capacity
            child_rows = np.asarray(child_rows)[drop:]
            child_hosts = np.asarray(child_hosts)[drop:]
            cand_rows = np.asarray(cand_rows)[drop:]
            cand_hosts = np.asarray(cand_hosts)[drop:]
            cand_count = np.asarray(cand_count)[drop:]
            feats = np.asarray(feats)[drop:]
            sel_pos = np.asarray(sel_pos)[drop:]
            sel_scores = np.asarray(sel_scores)[drop:]
            sel_accepted = np.asarray(sel_accepted)[drop:]
            chosen_pos = np.asarray(chosen_pos)[drop:]
            peer_ids = list(peer_ids)[drop:]
            task_ids = list(task_ids)[drop:]
            chosen_ids = list(chosen_ids)[drop:]
            n = self.capacity
        kk = min(self.k, cand_rows.shape[1])
        ll = min(self.limit, sel_pos.shape[1])
        with self._mu:
            slots = (self._head + np.arange(n, dtype=np.int64)) % self.capacity
            self._head = int((self._head + n) % self.capacity)
            # evict overwritten slots' peer map entries (ring reuse)
            for s in slots:
                old = self.child_peer_id[s]
                if old is not None and self._by_peer.get(old) == int(s):
                    del self._by_peer[old]
            self._reset_slots(slots)
            seqs = self._seq + 1 + np.arange(n)
            self.seq[slots] = seqs
            self._seq += n
            self.tick[slots] = tick_id
            self.arm[slots] = arm
            self.child_peer_row[slots] = np.asarray(child_rows, np.int32)
            self.child_host_slot[slots] = np.asarray(child_hosts, np.int32)
            self.cand_rows[slots[:, None], np.arange(kk)] = (
                np.asarray(cand_rows, np.int32)[:, :kk]
            )
            self.cand_hosts[slots[:, None], np.arange(kk)] = (
                np.asarray(cand_hosts, np.int32)[:, :kk]
            )
            self.cand_count[slots] = np.minimum(
                np.asarray(cand_count, np.int64), kk
            ).astype(np.int16)
            self.cand_feats[slots[:, None], np.arange(kk)] = (
                np.asarray(feats, np.float32)[:, :kk]
            )
            self.sel_pos[slots[:, None], np.arange(ll)] = (
                np.asarray(sel_pos, np.int64)[:, :ll].astype(np.int16)
            )
            self.sel_scores[slots[:, None], np.arange(ll)] = (
                np.asarray(sel_scores, np.float32)[:, :ll]
            )
            self.sel_accepted[slots[:, None], np.arange(ll)] = (
                np.asarray(sel_accepted, bool)[:, :ll]
            )
            self.chosen_pos[slots] = np.asarray(chosen_pos, np.int64).astype(np.int16)
            self.decided_at_ns[slots] = time.time_ns()
            for i, s in enumerate(slots):
                self.child_peer_id[s] = peer_ids[i]
                self.task_id[s] = task_ids[i]
                self.chosen_parent_id[s] = chosen_ids[i]
                self._by_peer[peer_ids[i]] = int(s)
            self._series.decisions.labels(ARM_NAMES.get(int(arm), "?")).inc(n)
            self._series.occupancy.labels().set(int((self.seq > 0).sum()))
        if drop:
            pad = np.full(drop, -1, np.int64)
            slots = np.concatenate([pad, slots])
            seqs = np.concatenate([pad, seqs])
        return slots, seqs

    def _reset_slots(self, slots: np.ndarray) -> None:
        """Clear reused ring slots so a short selection cannot inherit a
        previous occupant's tail columns (caller holds the lock)."""
        self.cand_rows[slots] = -1
        self.cand_hosts[slots] = -1
        self.cand_feats[slots] = 0.0
        self.sel_pos[slots] = -1
        self.sel_scores[slots] = np.nan
        self.sel_accepted[slots] = False
        self.shadow_arm[slots] = -1
        self.shadow_pos[slots] = -1
        self.shadow_scores[slots] = np.nan
        self.outcome[slots] = OUTCOME_PENDING
        self.outcome_bytes[slots] = 0
        self.outcome_cost_ns[slots] = -1
        self.outcome_corruption[slots] = False
        self.outcome_failover[slots] = False
        self.outcome_ttc_ns[slots] = -1
        self.chosen_parent_id[slots] = None

    # ------------------------------------------------------------ shadow

    def record_shadow(self, slots: np.ndarray, seqs: np.ndarray,
                      shadow_pos: np.ndarray, shadow_scores: np.ndarray,
                      shadow_arm: int, tick_id: int) -> dict | None:
        """Attach the inactive arm's ranking for this tick's recorded
        decisions and compute the tick's divergence. ``slots``/``seqs``
        align row-for-row with ``shadow_pos``/``shadow_scores``; slot -1
        rows (selections that never applied) and slots whose seq no
        longer matches (overwritten by a mid-tick ring wrap) are
        skipped. Returns the per-tick divergence entry, or None when
        nothing compared."""
        slots = np.asarray(slots, np.int64)
        seqs = np.asarray(seqs, np.int64)
        keep = slots >= 0
        if not keep.any():
            return None
        keep &= self.seq[np.clip(slots, 0, self.capacity - 1)] == seqs
        if not keep.any():
            return None
        s = slots[keep]
        ll = min(self.limit, shadow_pos.shape[1])
        with self._mu:
            self.shadow_arm[s] = shadow_arm
            self.shadow_pos[s[:, None], np.arange(ll)] = (
                np.asarray(shadow_pos, np.int64)[keep][:, :ll].astype(np.int16)
            )
            self.shadow_scores[s[:, None], np.arange(ll)] = (
                np.asarray(shadow_scores, np.float32)[keep][:, :ll]
            )
            active = self.sel_pos[s].astype(np.int64)
            shadow = self.shadow_pos[s].astype(np.int64)
            entry = self._divergence(active, shadow, tick_id)
            if entry is not None:
                self.divergence_ring.append(entry)
                self.shadow_compared += entry["compared"]
                self.shadow_top1_disagree += entry["top1_disagreements"]
                self._series.shadow_scored.labels().inc(int(keep.sum()))
                self._series.top1_disagreement.labels().set(
                    entry["top1_disagreement"]
                )
                if entry["rank_corr"] is not None:
                    self._series.rank_corr.labels().set(entry["rank_corr"])
            return entry

    @staticmethod
    def _divergence(active: np.ndarray, shadow: np.ndarray,
                    tick_id: int) -> dict | None:
        """Top-1 disagreement + mean Spearman rank correlation between
        the two arms' ranked candidate-position lists. Both arms rank
        the SAME candidate set, so position equality is candidate
        identity equality."""
        both = (active[:, 0] >= 0) & (shadow[:, 0] >= 0)
        n = int(both.sum())
        if n == 0:
            return None
        disagree = int((active[both, 0] != shadow[both, 0]).sum())
        # rank of each active pick in the shadow list (missing -> limit)
        a = active[both]
        sh = shadow[both]
        limit = a.shape[1]
        match = (a[:, :, None] == sh[:, None, :]) & (a[:, :, None] >= 0)
        found = match.any(axis=2)
        pos_in_shadow = np.where(found, match.argmax(axis=2), limit).astype(
            np.float64
        )
        valid = a >= 0
        counts = valid.sum(axis=1)
        rho_rows = []
        rank_a = np.arange(limit, dtype=np.float64)
        for i in np.flatnonzero(counts >= 2):
            m = valid[i]
            ra = rank_a[m]
            rb = pos_in_shadow[i][m]
            sa = ra.std()
            sb = rb.std()
            if sa == 0 or sb == 0:
                rho_rows.append(1.0 if np.array_equal(ra, rb) else 0.0)
                continue
            rho_rows.append(float(np.corrcoef(ra, rb)[0, 1]))
        return {
            "tick": int(tick_id),
            "compared": n,
            "top1_disagreements": disagree,
            "top1_disagreement": round(disagree / n, 4),
            "rank_corr": round(float(np.mean(rho_rows)), 4) if rho_rows else None,
        }

    # ----------------------------------------------------------- outcome

    def join_outcome(self, peer_id: str, outcome: int,
                     bytes_: int = 0, cost_ns: int = 0) -> bool:
        """Join a terminal peer event to its latest recorded decision.
        O(1); the join latency (decision→outcome wall time) feeds the
        histogram and the per-decision TTC column. ``cost_ns`` is the
        download's cost summed from the peer's REPORTED piece costs —
        virtual time in a replay, measured transfer time in production
        — and is the label basis the trainer exporter prefers (wall TTC
        would encode simulator host speed, not parent quality)."""
        with self._mu:
            slot = self._by_peer.pop(peer_id, None)
            if slot is None:
                return False
            self.outcome[slot] = outcome
            self.outcome_bytes[slot] = int(bytes_ or 0)
            if cost_ns and cost_ns > 0:
                self.outcome_cost_ns[slot] = int(cost_ns)
            ttc = time.time_ns() - int(self.decided_at_ns[slot])
            self.outcome_ttc_ns[slot] = max(ttc, 0)
            self.joined += 1
            self._series.outcomes.labels(
                OUTCOME_NAMES.get(outcome, "?")
            ).inc()
            self._series.join_latency.labels().observe(max(ttc, 0) / 1e9)
            return True

    def mark_corruption(self, peer_id: str) -> None:
        """The peer's decision led it to a digest-failing parent."""
        with self._mu:
            slot = self._by_peer.get(peer_id)
            if slot is not None:
                self.outcome_corruption[slot] = True

    def mark_failover(self, peer_id: str) -> None:
        """The peer re-announced with kept pieces (scheduler failover)."""
        with self._mu:
            slot = self._by_peer.get(peer_id)
            if slot is not None:
                self.outcome_failover[slot] = True

    def discard(self, peer_id: str) -> None:
        """Forget the pending-join mapping for a departing peer (the
        decision row itself stays until the ring recycles it)."""
        with self._mu:
            self._by_peer.pop(peer_id, None)

    # ------------------------------------------------------------ regret

    def regret(self) -> dict:
        """Measured per-arm regret on disagreement decisions.

        Estimator: the joined decisions give a per-HOST outcome table
        (mean TTC of completed downloads whose chosen parent lived on
        that host; failure rate = failed/back-to-source/corrupt share).
        For each decision where the arms' top-1 picks differ, the active
        arm's regret is ``est(active_host) − est(shadow_host)`` —
        positive means the shadow's pick historically did better. Both
        bases ride the report; ``fail_rate`` is wall-free (deterministic
        in a replay), ``ttc_ms`` uses the joined wall TTC."""
        with self._mu:
            live = self.seq > 0
            joined = live & (self.outcome != OUTCOME_PENDING)
            chosen_ok = joined & (self.chosen_pos >= 0)
            rows = np.flatnonzero(chosen_ok)
            host_of = lambda slot_idx, pos: self.cand_hosts[  # noqa: E731
                slot_idx, np.clip(pos, 0, self.k - 1)
            ]
            out: dict = {
                "n_joined": int(joined.sum()),
                "n_disagreements": 0,
                "by_arm": {},
            }
            if rows.size == 0:
                return out
            hosts = host_of(rows, self.chosen_pos[rows].astype(np.int64))
            hmax = int(hosts.max()) + 1 if hosts.size else 1
            cnt = np.zeros(hmax)
            done_cnt = np.zeros(hmax)
            ttc_sum = np.zeros(hmax)
            fail_sum = np.zeros(hmax)
            ok = hosts >= 0
            bad = (
                (self.outcome[rows] != OUTCOME_COMPLETED)
                | self.outcome_corruption[rows]
            ).astype(np.float64)
            ttc_ms = np.maximum(self.outcome_ttc_ns[rows], 0) / 1e6
            np.add.at(cnt, hosts[ok], 1.0)
            np.add.at(fail_sum, hosts[ok], bad[ok])
            # TTC means over COMPLETED downloads only: a fast failure's
            # tiny TTC would otherwise make an always-failing host look
            # like the quickest pick and invert the regret sign —
            # failures are what the fail-rate basis measures
            done = ok & (bad == 0.0)
            np.add.at(done_cnt, hosts[done], 1.0)
            np.add.at(ttc_sum, hosts[done], ttc_ms[done])
            mean_ttc = ttc_sum / np.maximum(done_cnt, 1.0)
            fail_rate = fail_sum / np.maximum(cnt, 1.0)
            dis = np.flatnonzero(
                live & (self.sel_pos[:, 0] >= 0) & (self.shadow_pos[:, 0] >= 0)
                & (self.sel_pos[:, 0] != self.shadow_pos[:, 0])
            )
            out["n_disagreements"] = int(dis.size)
            for arm_code in np.unique(self.arm[dis]) if dis.size else ():
                d = dis[self.arm[dis] == arm_code]
                ah = host_of(d, self.sel_pos[d, 0].astype(np.int64))
                sh = host_of(d, self.shadow_pos[d, 0].astype(np.int64))
                in_range = (
                    (ah >= 0) & (sh >= 0) & (ah < hmax) & (sh < hmax)
                )
                ah_c = np.clip(ah, 0, hmax - 1)
                sh_c = np.clip(sh, 0, hmax - 1)
                # fail basis: any joined outcome on both hosts; TTC
                # basis: a COMPLETED mean must exist on both hosts
                known_fail = in_range & (cnt[ah_c] > 0) & (cnt[sh_c] > 0)
                known_ttc = in_range & (done_cnt[ah_c] > 0) & (
                    done_cnt[sh_c] > 0
                )
                entry = {"n": int(known_fail.sum()),
                         "regret_ttc_ms": None, "regret_fail_rate": None}
                name = ARM_NAMES.get(int(arm_code), "?")
                if known_ttc.any():
                    entry["regret_ttc_ms"] = round(
                        float((mean_ttc[ah[known_ttc]]
                               - mean_ttc[sh[known_ttc]]).mean()),
                        3,
                    )
                    self._series.regret.labels(name).set(entry["regret_ttc_ms"])
                if known_fail.any():
                    entry["regret_fail_rate"] = round(
                        float((fail_rate[ah[known_fail]]
                               - fail_rate[sh[known_fail]]).mean()),
                        4,
                    )
                out["by_arm"][name] = entry
            return out

    # ----------------------------------------------------------- reading

    def counters(self) -> dict:
        """Deterministic cumulative counters (wall-free — safe for
        megascale timeline samples)."""
        with self._mu:
            return {
                "decisions": int(self._seq),
                "joined": int(self.joined),
                "shadow_compared": int(self.shadow_compared),
                "shadow_top1_disagree": int(self.shadow_top1_disagree),
            }

    def divergence_summary(self) -> dict:
        """Aggregate divergence over the retained per-tick entries plus
        the regret estimate — the bench artifact's decision block."""
        with self._mu:
            entries = list(self.divergence_ring)
        compared = sum(e["compared"] for e in entries)
        disagree = sum(e["top1_disagreements"] for e in entries)
        corrs = [e["rank_corr"] for e in entries if e["rank_corr"] is not None]
        return {
            "ticks_compared": len(entries),
            "compared": compared,
            "top1_disagreement": round(disagree / compared, 4) if compared else None,
            "rank_corr": round(float(np.mean(corrs)), 4) if corrs else None,
            "regret": self.regret(),
        }

    def report(self) -> dict:
        """THE flattened decision block for artifact writers (bench_loop
        / megascale soak / bench_megascale all consume this — one
        layout, so a key rename cannot silently drop a cell in one
        artifact): counters + aggregate divergence + both regret bases,
        per-arm and averaged. ``regret_ttc_ms`` and anything derived
        from wall TTC is NOT replay-deterministic; deterministic
        surfaces pick the fail-rate keys."""
        summary = self.divergence_summary()
        regret = summary.pop("regret")
        ttc = [e["regret_ttc_ms"] for e in regret["by_arm"].values()
               if e["regret_ttc_ms"] is not None]
        fail = [e["regret_fail_rate"] for e in regret["by_arm"].values()
                if e["regret_fail_rate"] is not None]
        return {
            **self.counters(),
            "top1_disagreement": summary["top1_disagreement"],
            "rank_corr": summary["rank_corr"],
            "n_disagreements": regret["n_disagreements"],
            "regret_ttc_ms": round(sum(ttc) / len(ttc), 3) if ttc else None,
            "regret_fail_rate": (
                round(sum(fail) / len(fail), 4) if fail else None
            ),
            "regret_by_arm": regret["by_arm"],
            "regret_fail_rate_by_arm": {
                arm: e["regret_fail_rate"]
                for arm, e in regret["by_arm"].items()
            },
        }

    def deterministic_columns(self) -> dict[str, np.ndarray]:
        """Every replay-determined column, in ring order — the megascale
        paired-seed determinism test compares these array-for-array.
        Wall-clock columns (decided_at_ns, outcome_ttc_ns) and the
        identity object columns (compared via the digest's string walk)
        are excluded."""
        with self._mu:
            order = np.argsort(self.seq, kind="stable")
            return {
                "seq": self.seq[order].copy(),
                "tick": self.tick[order].copy(),
                "arm": self.arm[order].copy(),
                "child_peer_row": self.child_peer_row[order].copy(),
                "child_host_slot": self.child_host_slot[order].copy(),
                "cand_rows": self.cand_rows[order].copy(),
                "cand_hosts": self.cand_hosts[order].copy(),
                "cand_count": self.cand_count[order].copy(),
                "cand_feats": self.cand_feats[order].copy(),
                "sel_pos": self.sel_pos[order].copy(),
                "sel_scores": self.sel_scores[order].copy(),
                "sel_accepted": self.sel_accepted[order].copy(),
                "chosen_pos": self.chosen_pos[order].copy(),
                "shadow_arm": self.shadow_arm[order].copy(),
                "shadow_pos": self.shadow_pos[order].copy(),
                "shadow_scores": self.shadow_scores[order].copy(),
                "outcome": self.outcome[order].copy(),
                "outcome_cost_ns": self.outcome_cost_ns[order].copy(),
                "outcome_corruption": self.outcome_corruption[order].copy(),
                "outcome_failover": self.outcome_failover[order].copy(),
            }

    def deterministic_digest(self) -> str:
        """Stable digest over the deterministic columns + the identity
        strings — two paired-seed replays must produce the same value."""
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        cols = self.deterministic_columns()
        for name in sorted(cols):
            h.update(name.encode())
            arr = cols[name]
            if arr.dtype == np.float32:
                # NaN payloads are stable within a platform; normalize
                # anyway so the digest never depends on NaN bit noise
                arr = np.nan_to_num(arr, nan=-1.0)
            h.update(np.ascontiguousarray(arr).tobytes())
        with self._mu:
            order = np.argsort(self.seq, kind="stable")
            for col in (self.child_peer_id, self.task_id, self.chosen_parent_id):
                for s in order:
                    v = col[s]
                    h.update(b"\x00" if v is None else str(v).encode())
        return h.hexdigest()

    def dump(self, last_n: int = 128) -> dict:
        """Plain-data snapshot for /debug/flight, bench artifacts, and
        dfwhy: the newest ``last_n`` decisions fully resolved (candidate
        peer/host ids via the attached resolvers — a recycled row
        resolves to its CURRENT occupant or None; the chosen parent's id
        was captured at decision time and cannot go stale)."""
        with self._mu:
            live = np.flatnonzero(self.seq > 0)
            order = live[np.argsort(self.seq[live], kind="stable")]
            # explicit zero guard: [-0:] is the WHOLE array in numpy/
            # python slicing, and last_n=0 is reachable from the HTTP
            # query surface — it must mean "no rows", not "all of them"
            order = order[-last_n:] if last_n > 0 else order[:0]
            rows = [self._row_dict(int(s)) for s in order]
        return {
            "config": {"capacity": self.capacity, "k": self.k,
                       "limit": self.limit},
            "counters": {
                "decisions": int(self._seq),
                "joined": int(self.joined),
                "shadow_compared": int(self.shadow_compared),
                "shadow_top1_disagree": int(self.shadow_top1_disagree),
            },
            "features": list(DECISION_FEATURES),
            "divergence": list(self.divergence_ring)[-32:],
            "rows": rows,
        }

    def _row_dict(self, s: int) -> dict:
        """One decision as plain data (caller holds the lock)."""
        count = int(self.cand_count[s])
        resolve_p = self._peer_resolver or (lambda _r: None)
        resolve_h = self._host_resolver or (lambda _h: None)
        cands = []
        rank_of = {int(p): j for j, p in enumerate(self.sel_pos[s]) if p >= 0}
        shadow_rank_of = {
            int(p): j for j, p in enumerate(self.shadow_pos[s]) if p >= 0
        }
        for pos in range(count):
            row = int(self.cand_rows[s, pos])
            entry = {
                "pos": pos,
                "peer_row": row,
                "peer": resolve_p(row),
                "host_slot": int(self.cand_hosts[s, pos]),
                "host": resolve_h(int(self.cand_hosts[s, pos])),
                "features": {
                    name: round(float(self.cand_feats[s, pos, i]), 4)
                    for name, i in _IDX.items()
                },
            }
            j = rank_of.get(pos)
            if j is not None:
                entry["rank"] = j
                entry["score"] = round(float(self.sel_scores[s, j]), 5)
                entry["accepted"] = bool(self.sel_accepted[s, j])
            sj = shadow_rank_of.get(pos)
            if sj is not None:
                entry["shadow_rank"] = sj
                entry["shadow_score"] = round(float(self.shadow_scores[s, sj]), 5)
            cands.append(entry)
        ttc = int(self.outcome_ttc_ns[s])
        cost = int(self.outcome_cost_ns[s])
        return {
            "seq": int(self.seq[s]),
            "tick": int(self.tick[s]),
            "arm": ARM_NAMES.get(int(self.arm[s]), None),
            "peer": self.child_peer_id[s],
            "task": self.task_id[s],
            "child_peer_row": int(self.child_peer_row[s]),
            "child_host_slot": int(self.child_host_slot[s]),
            "child_host": resolve_h(int(self.child_host_slot[s])),
            "candidates": cands,
            "chosen_pos": int(self.chosen_pos[s]),
            "chosen_parent": self.chosen_parent_id[s],
            "shadow_arm": ARM_NAMES.get(int(self.shadow_arm[s]), None),
            "shadow_top1_pos": int(self.shadow_pos[s, 0]),
            "shadow_agrees_top1": (
                bool(self.sel_pos[s, 0] == self.shadow_pos[s, 0])
                if self.sel_pos[s, 0] >= 0 and self.shadow_pos[s, 0] >= 0
                else None
            ),
            "outcome": {
                "state": OUTCOME_NAMES.get(int(self.outcome[s]), "?"),
                "ttc_ms": round(ttc / 1e6, 3) if ttc >= 0 else None,
                # replay-safe cost basis (reported piece costs): what
                # the trainer exporter labels from; ttc_ms is wall
                "cost_ms": round(cost / 1e6, 3) if cost >= 0 else None,
                "bytes": int(self.outcome_bytes[s]),
                "corruption": bool(self.outcome_corruption[s]),
                "failover": bool(self.outcome_failover[s]),
            },
        }
