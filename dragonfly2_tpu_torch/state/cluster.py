"""Struct-of-arrays cluster state with fixed capacities and free lists.

A copy of dragonfly2_tpu/state/cluster.py (host-side numpy, no device
code), the replacement for the upstream pointer-graph resource layer
(scheduler/resource/: Host host.go:126-337, Task task.go:105-155, Peer
peer.go:137 + managers with TTL GC). Instead of millions of tiny objects
behind mutexes, cluster state is a set of preallocated numpy columns; every
entity is a row index. The batched evaluator tick gathers candidate rows
into `records.features.CandidateFeatures` and makes ONE device call; the
fused tick (ops/tick.py) mirrors the hot columns on the device instead,
through the dirty tracking below.

Capacity limits replace the reference's unbounded maps; slot reuse is via
free lists, and TTL GC (pkg/gc semantics) is a vectorised sweep over the
`updated_at` column.
"""

from __future__ import annotations

import time

import numpy as np

from dragonfly2_tpu_torch.config.constants import CONSTANTS
from dragonfly2_tpu_torch.records.features import (
    NUM_HOST_FEATURES,
    CandidateFeatures,
    MAX_LOC,
)
from dragonfly2_tpu_torch.state.fsm import (
    HostType,
    PeerEvent,
    PeerState,
    TaskEvent,
    TaskState,
    peer_transition,
    task_transition,
)

_NO_SLOT = -1

# Byte-wise popcount table for the batched bitset update: uint64 columns
# viewed as uint8 give per-word set-bit counts without a Python loop.
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint16)


def _popcount64(a: np.ndarray) -> np.ndarray:
    """Per-element popcount of a 1-D uint64 array."""
    if a.size == 0:
        return np.zeros(0, np.int64)
    return (
        _POPCOUNT8[np.ascontiguousarray(a).view(np.uint8).reshape(a.shape[0], 8)]
        .sum(axis=1)
        .astype(np.int64)
    )


class CapacityError(RuntimeError):
    pass


class _FreeList:
    def __init__(self, capacity: int):
        self._free = list(range(capacity - 1, -1, -1))

    def acquire(self, kind: str) -> int:
        if not self._free:
            raise CapacityError(f"{kind} table full")
        return self._free.pop()

    def release(self, idx: int) -> None:
        self._free.append(idx)

    def used(self, capacity: int) -> int:
        return capacity - len(self._free)


class ClusterState:
    def __init__(
        self,
        max_hosts: int = 16384,
        max_tasks: int = 4096,
        max_peers: int = 65536,
        piece_cost_capacity: int = CONSTANTS.PIECE_COST_CAPACITY,
        piece_bitset_words: int = 64,  # 64*64 = 4096 pieces per peer
    ):
        self.max_hosts = max_hosts
        self.max_tasks = max_tasks
        self.max_peers = max_peers
        self.piece_cost_capacity = piece_cost_capacity
        self.piece_bitset_words = piece_bitset_words

        # --- hosts ---
        self.host_alive = np.zeros(max_hosts, bool)
        self.host_id_hash = np.zeros(max_hosts, np.int64)
        self.host_type = np.zeros(max_hosts, np.int8)
        self.host_idc = np.zeros(max_hosts, np.int64)
        self.host_location = np.zeros((max_hosts, MAX_LOC), np.int64)
        self.host_upload_limit = np.zeros(max_hosts, np.int32)
        self.host_upload_used = np.zeros(max_hosts, np.int32)
        self.host_upload_count = np.zeros(max_hosts, np.int64)
        self.host_upload_failed = np.zeros(max_hosts, np.int64)
        self.host_numeric = np.zeros((max_hosts, NUM_HOST_FEATURES), np.float32)
        self.host_updated_at = np.zeros(max_hosts, np.float64)
        self._host_free = _FreeList(max_hosts)
        self._host_by_id: dict[str, int] = {}
        self._host_id: list[str | None] = [None] * max_hosts

        # --- tasks ---
        self.task_alive = np.zeros(max_tasks, bool)
        self.task_state = np.zeros(max_tasks, np.int8)
        self.task_total_pieces = np.zeros(max_tasks, np.int32)
        self.task_content_length = np.zeros(max_tasks, np.int64)
        self.task_back_to_source_limit = np.zeros(max_tasks, np.int32)
        self.task_back_to_source_count = np.zeros(max_tasks, np.int32)
        self.task_updated_at = np.zeros(max_tasks, np.float64)
        self._task_free = _FreeList(max_tasks)
        self._task_by_id: dict[str, int] = {}
        self._task_id: list[str | None] = [None] * max_tasks

        # --- peers ---
        self.peer_alive = np.zeros(max_peers, bool)
        self.peer_state = np.zeros(max_peers, np.int8)
        self.peer_task = np.full(max_peers, _NO_SLOT, np.int32)
        self.peer_host = np.full(max_peers, _NO_SLOT, np.int32)
        self.peer_finished_bitset = np.zeros((max_peers, piece_bitset_words), np.uint64)
        self.peer_finished_count = np.zeros(max_peers, np.int32)
        self.peer_piece_costs = np.zeros((max_peers, piece_cost_capacity), np.float32)
        self.peer_piece_cost_count = np.zeros(max_peers, np.int32)
        self.peer_cost_cursor = np.zeros(max_peers, np.int32)
        self.peer_updated_at = np.zeros(max_peers, np.float64)
        self._peer_free = _FreeList(max_peers)
        self._peer_by_id: dict[str, int] = {}
        self._peer_id: list[str | None] = [None] * max_peers

        # --- device-mirror change tracking (ops/tick.py TickMirror) ---
        # peer_dirty: rows whose hot columns changed since the mirror's
        # last incremental sync — set by every peer-column mutator below,
        # cleared by the mirror. A boolean store per mutation, cheap
        # enough to maintain unconditionally (fused tick off included).
        # host_epoch: bumped on any host upsert/remove so the mirror can
        # re-upload the static host columns (type/idc/location/id_hash/
        # numeric) only when one actually changed; the per-tick dynamic
        # columns (upload counts/limits) are re-uploaded every sync.
        self.peer_dirty = np.zeros(max_peers, bool)
        self.host_epoch = 0

    # ------------------------------------------------------------- hosts

    def upsert_host(
        self,
        host_id: str,
        *,
        id_hash: int,
        host_type: HostType = HostType.NORMAL,
        idc: int = 0,
        location: np.ndarray | None = None,
        upload_limit: int = 50,
        upload_count: int = 0,
        upload_failed: int = 0,
        numeric: np.ndarray | None = None,
    ) -> int:
        idx = self._host_by_id.get(host_id)
        if idx is None:
            idx = self._host_free.acquire("host")
            self._host_by_id[host_id] = idx
            self._host_id[idx] = host_id
            # Zero every column: the slot may be reused from a removed host
            # and absent kwargs below must not inherit its values.
            self.host_upload_used[idx] = 0
            self.host_location[idx] = 0
            self.host_numeric[idx] = 0
        self.host_alive[idx] = True
        self.host_id_hash[idx] = id_hash
        self.host_type[idx] = int(host_type)
        self.host_idc[idx] = idc
        if location is not None:
            self.host_location[idx] = location
        self.host_upload_limit[idx] = upload_limit
        self.host_upload_count[idx] = upload_count
        self.host_upload_failed[idx] = upload_failed
        if numeric is not None:
            self.host_numeric[idx] = numeric
        self.host_updated_at[idx] = time.time()
        self.host_epoch += 1
        return idx

    def host_index(self, host_id: str) -> int | None:
        return self._host_by_id.get(host_id)

    def host_id_at(self, idx: int) -> str | None:
        return self._host_id[idx] if 0 <= idx < self.max_hosts else None

    def host_alive_mask(self) -> np.ndarray:
        return self.host_alive.copy()

    def remove_host(self, host_id: str) -> None:
        idx = self._host_by_id.pop(host_id, None)
        if idx is None:
            return
        self.host_alive[idx] = False
        self._host_id[idx] = None
        self._host_free.release(idx)
        self.host_epoch += 1

    def host_free_upload(self, idx: int) -> int:
        return int(self.host_upload_limit[idx] - self.host_upload_used[idx])

    # ------------------------------------------------------------- tasks

    def upsert_task(
        self,
        task_id: str,
        *,
        total_pieces: int = 0,
        content_length: int = 0,
        back_to_source_limit: int = 3,
    ) -> int:
        idx = self._task_by_id.get(task_id)
        if idx is None:
            idx = self._task_free.acquire("task")
            self._task_by_id[task_id] = idx
            self._task_id[idx] = task_id
            self.task_state[idx] = int(TaskState.PENDING)
            self.task_back_to_source_count[idx] = 0
        self.task_alive[idx] = True
        self.task_total_pieces[idx] = total_pieces
        self.task_content_length[idx] = content_length
        self.task_back_to_source_limit[idx] = back_to_source_limit
        self.task_updated_at[idx] = time.time()
        return idx

    def task_index(self, task_id: str) -> int | None:
        return self._task_by_id.get(task_id)

    def task_event(self, idx: int, event: TaskEvent) -> None:
        current = TaskState(int(self.task_state[idx]))
        self.task_state[idx] = int(task_transition(current, event))
        self.task_updated_at[idx] = time.time()

    def remove_task(self, task_id: str) -> None:
        idx = self._task_by_id.pop(task_id, None)
        if idx is None:
            return
        self.task_alive[idx] = False
        self._task_id[idx] = None
        self._task_free.release(idx)

    # ------------------------------------------------------------- peers

    def add_peer(self, peer_id: str, task_idx: int, host_idx: int) -> int:
        existing = self._peer_by_id.get(peer_id)
        if existing is not None:
            return existing
        idx = self._peer_free.acquire("peer")
        self._peer_by_id[peer_id] = idx
        self._peer_id[idx] = peer_id
        self.peer_alive[idx] = True
        self.peer_state[idx] = int(PeerState.PENDING)
        self.peer_task[idx] = task_idx
        self.peer_host[idx] = host_idx
        self.peer_finished_bitset[idx] = 0
        self.peer_finished_count[idx] = 0
        self.peer_piece_costs[idx] = 0
        self.peer_piece_cost_count[idx] = 0
        self.peer_cost_cursor[idx] = 0
        self.peer_updated_at[idx] = time.time()
        self.peer_dirty[idx] = True
        self.touch_peer_host(idx)
        return idx

    def peer_index(self, peer_id: str) -> int | None:
        return self._peer_by_id.get(peer_id)

    def touch_peer_host(self, peer_idx: int, now: float | None = None) -> None:
        """Peer activity counts as host liveness. The repo's daemons
        announce once per connection (not on the reference's ~5 min
        re-announce cadence, announcer.go), so without this the host-TTL
        sweep would reap every peer on a host after host_ttl_seconds of
        daemon uptime — including RUNNING downloads and long-TTL cache
        peers (ADVICE r3 high)."""
        h = int(self.peer_host[peer_idx])
        if 0 <= h < self.max_hosts and self.host_alive[h]:
            self.host_updated_at[h] = time.time() if now is None else now

    def peer_event(self, idx: int, event: PeerEvent) -> None:
        current = PeerState(int(self.peer_state[idx]))
        self.peer_state[idx] = int(peer_transition(current, event))
        self.peer_updated_at[idx] = time.time()
        self.peer_dirty[idx] = True
        self.touch_peer_host(idx)

    def remove_peer(self, peer_id: str) -> None:
        idx = self._peer_by_id.pop(peer_id, None)
        if idx is None:
            return
        self.peer_alive[idx] = False
        self._peer_id[idx] = None
        self._peer_free.release(idx)
        self.peer_dirty[idx] = True

    def record_piece(self, peer_idx: int, piece_number: int, cost_ns: float) -> None:
        """Piece finished: set bitset bit, append cost to the ring buffer
        (the IsBadNode sample window, evaluator.go:102-128)."""
        word, bit = divmod(piece_number, 64)
        if word < self.piece_bitset_words:
            mask = np.uint64(1) << np.uint64(bit)
            if not (self.peer_finished_bitset[peer_idx, word] & mask):
                self.peer_finished_bitset[peer_idx, word] |= mask
                self.peer_finished_count[peer_idx] += 1
        cursor = int(self.peer_cost_cursor[peer_idx])
        self.peer_piece_costs[peer_idx, cursor] = cost_ns
        self.peer_cost_cursor[peer_idx] = (cursor + 1) % self.piece_cost_capacity
        self.peer_piece_cost_count[peer_idx] = min(
            int(self.peer_piece_cost_count[peer_idx]) + 1, self.piece_cost_capacity
        )
        self.peer_updated_at[peer_idx] = time.time()
        self.peer_dirty[peer_idx] = True
        self.touch_peer_host(peer_idx)

    def record_pieces_batch(
        self,
        peer_idx: np.ndarray,
        piece_numbers: np.ndarray,
        cost_ns: np.ndarray,
        now: float | None = None,
    ) -> int:
        """Vectorised `record_piece` over many (peer, piece, cost) reports.

        Column-for-column equivalent to calling `record_piece` once per
        report in array order: bitset bits dedup (within the batch AND
        against already-set bits), the cost ring appends every report in
        order (wrapping like the sequential ring when a peer carries more
        reports than the ring holds), and `updated_at`/host liveness
        touch once per involved peer. One numpy pass per column instead
        of ~8 scalar ops per report — the piece-report ingestion hot path
        (tick report_ingest) runs through here. Returns the number of
        newly finished pieces across the batch."""
        peer_idx = np.asarray(peer_idx, np.int64)
        piece = np.asarray(piece_numbers, np.int64)
        cost = np.asarray(cost_ns, np.float32)
        n = peer_idx.shape[0]
        if n == 0:
            return 0
        now = time.time() if now is None else now
        capacity = self.piece_cost_capacity

        # --- finished bitset + counts (dedup-aware) -----------------------
        word, bit = np.divmod(piece, 64)
        in_range = (word >= 0) & (word < self.piece_bitset_words)
        newly = 0
        if in_range.any():
            pi = peer_idx[in_range]
            wd = word[in_range]
            masks = np.uint64(1) << bit[in_range].astype(np.uint64)
            key = pi * self.piece_bitset_words + wd
            uniq, inv = np.unique(key, return_inverse=True)
            or_acc = np.zeros(uniq.size, np.uint64)
            np.bitwise_or.at(or_acc, inv, masks)
            upi = uniq // self.piece_bitset_words
            uwd = uniq % self.piece_bitset_words
            before = self.peer_finished_bitset[upi, uwd]
            after = before | or_acc
            delta = _popcount64(after) - _popcount64(before)
            self.peer_finished_bitset[upi, uwd] = after
            np.add.at(self.peer_finished_count, upi, delta.astype(np.int32))
            newly = int(delta.sum())

        # --- cost ring append (every report, sequential-ring order) ------
        if peer_idx[0] == peer_idx[-1] and (peer_idx == peer_idx[0]).all():
            # single-peer batch (one wave per flush is the common shape on
            # the completion flush valve): no grouping machinery needed
            sp = peer_idx
            upeers = peer_idx[:1]
            counts = np.array([n])
            ranks = np.arange(n)
            keep = ranks >= n - capacity
            sp_k, ranks_k = sp[keep], ranks[keep]
            costs_ordered = cost
        else:
            order = np.argsort(peer_idx, kind="stable")
            sp = peer_idx[order]
            changed = np.empty(sp.size, bool)
            changed[0] = True
            np.not_equal(sp[1:], sp[:-1], out=changed[1:])
            grp_start = np.flatnonzero(changed)
            bounds = np.empty(grp_start.size + 1, np.int64)
            bounds[:-1] = grp_start
            bounds[-1] = sp.size
            counts = np.diff(bounds)
            ranks = np.arange(sp.size) - np.repeat(grp_start, counts)
            # a peer with more reports than the ring holds keeps only the
            # last `capacity` — the ones a sequential wrap would retain
            keep = ranks >= np.repeat(counts, counts) - capacity
            sp_k, ranks_k = sp[keep], ranks[keep]
            upeers = sp[grp_start]
            costs_ordered = cost[order]
        pos = (self.peer_cost_cursor[sp_k] + ranks_k) % capacity
        self.peer_piece_costs[sp_k, pos] = costs_ordered[keep]
        self.peer_cost_cursor[upeers] = (
            self.peer_cost_cursor[upeers] + counts
        ) % capacity
        self.peer_piece_cost_count[upeers] = np.minimum(
            self.peer_piece_cost_count[upeers] + counts, capacity
        )

        # --- liveness touch (peer + its host, like touch_peer_host) ------
        self.peer_updated_at[upeers] = now
        self.peer_dirty[upeers] = True
        hosts = self.peer_host[upeers]
        hosts = hosts[(hosts >= 0) & (hosts < self.max_hosts)]
        hosts = hosts[self.host_alive[hosts]]
        self.host_updated_at[hosts] = now
        return newly

    def adopt_pieces(self, peer_idx: int, piece_numbers: "np.ndarray | list[int] | tuple[int, ...]") -> int:
        """Mark pieces a re-announcing peer ALREADY holds (the failover
        resume path, cluster/scheduler.py register_peer): bitset +
        finished count only — no cost samples, because no transfer was
        observed and zero-cost entries would poison the 3-sigma IsBadNode
        window. Returns how many pieces were newly adopted."""
        adopted = 0
        for piece_number in piece_numbers:
            word, bit = divmod(int(piece_number), 64)
            if word >= self.piece_bitset_words:
                continue
            mask = np.uint64(1) << np.uint64(bit)
            if not (self.peer_finished_bitset[peer_idx, word] & mask):
                self.peer_finished_bitset[peer_idx, word] |= mask
                self.peer_finished_count[peer_idx] += 1
                adopted += 1
        if adopted:
            self.peer_updated_at[peer_idx] = time.time()
            self.peer_dirty[peer_idx] = True
            self.touch_peer_host(peer_idx)
        return adopted

    def peer_finished_pieces(self, peer_idx: int) -> np.ndarray:
        """Piece numbers set in the peer's finished bitset, ascending —
        the decode twin of `record_pieces_batch`/`adopt_pieces`, for
        inspection surfaces (tests, debug dumps) that need piece NUMBERS
        rather than the raw bitset words. The failover re-announce path
        does not read scheduler state (a crash wipes it first); the
        megascale engine decodes its own have-bitset columns instead
        (megascale/engine.EventBatchEngine._finished_pieces)."""
        words = self.peer_finished_bitset[peer_idx]
        bits = (
            words[:, None] >> np.arange(64, dtype=np.uint64)[None, :]
        ) & np.uint64(1)
        word_i, bit_i = np.nonzero(bits)
        return (word_i * 64 + bit_i).astype(np.int64)

    def peer_piece_costs_ordered(self, peer_idx: int) -> np.ndarray:
        """Costs oldest->newest (ring unrolled) for the 3-sigma rule."""
        count = int(self.peer_piece_cost_count[peer_idx])
        cursor = int(self.peer_cost_cursor[peer_idx])
        ring = self.peer_piece_costs[peer_idx]
        if count < self.piece_cost_capacity:
            return ring[:count].copy()
        return np.concatenate([ring[cursor:], ring[:cursor]])

    # ------------------------------------------------------- GC sweeps

    def gc_peers(self, ttl_seconds: float, now: float | None = None) -> int:
        """Vectorised TTL sweep (pkg/gc + peer_manager RunGC semantics)."""
        now = time.time() if now is None else now
        stale = self.peer_alive & (now - self.peer_updated_at > ttl_seconds)
        reaped = 0
        for idx in np.nonzero(stale)[0]:
            pid = self._peer_id[idx]
            if pid is not None:
                self.remove_peer(pid)
                reaped += 1
        return reaped

    def counts(self) -> dict[str, int]:
        return {
            "hosts": self._host_free.used(self.max_hosts),
            "tasks": self._task_free.used(self.max_tasks),
            "peers": self._peer_free.used(self.max_peers),
        }

    # ------------------------------------------- evaluator batch gather

    def gather_candidates(
        self,
        child_peer_idx: np.ndarray,
        candidate_peer_idx: np.ndarray,
        candidate_valid: np.ndarray,
        avg_rtt_ns: np.ndarray | None = None,
        has_rtt: np.ndarray | None = None,
    ) -> CandidateFeatures:
        """Gather evaluator inputs for B children x K candidate peers.

        All index math is vectorised numpy; the result feeds the jitted
        kernel in ops/evaluator.py unchanged.
        """
        b, k = candidate_peer_idx.shape
        safe_cand = np.where(candidate_valid, candidate_peer_idx, 0)
        cand_host = self.peer_host[safe_cand]
        safe_cand_host = np.clip(cand_host, 0, None)
        child_host = self.peer_host[child_peer_idx]
        safe_child_host = np.clip(child_host, 0, None)

        feats = CandidateFeatures.zeros(b, k, self.piece_cost_capacity)
        feats.valid = candidate_valid & self.peer_alive[safe_cand]
        feats.finished_pieces = self.peer_finished_count[safe_cand]
        feats.child_finished_pieces = self.peer_finished_count[child_peer_idx]
        feats.total_piece_count = self.task_total_pieces[
            np.clip(self.peer_task[child_peer_idx], 0, None)
        ]
        feats.upload_count = self.host_upload_count[safe_cand_host]
        feats.upload_failed_count = self.host_upload_failed[safe_cand_host]
        feats.upload_limit = self.host_upload_limit[safe_cand_host]
        feats.upload_used = self.host_upload_used[safe_cand_host]
        feats.host_type = self.host_type[safe_cand_host]
        feats.peer_state = self.peer_state[safe_cand]
        feats.parent_idc = self.host_idc[safe_cand_host]
        feats.child_idc = self.host_idc[safe_child_host]
        feats.parent_location = self.host_location[safe_cand_host]
        feats.child_location = self.host_location[safe_child_host]
        feats.parent_host_id = self.host_id_hash[safe_cand_host]
        feats.child_host_id = self.host_id_hash[safe_child_host]
        feats.piece_costs = _ordered_costs_batch(
            self.peer_piece_costs[safe_cand],
            self.peer_cost_cursor[safe_cand],
            self.peer_piece_cost_count[safe_cand],
            self.piece_cost_capacity,
        )
        feats.piece_cost_count = self.peer_piece_cost_count[safe_cand]
        feats.numeric = self.host_numeric[safe_cand_host]
        feats.child_numeric = self.host_numeric[safe_child_host]
        if avg_rtt_ns is not None:
            feats.avg_rtt_ns = avg_rtt_ns.astype(np.float32)
        if has_rtt is not None:
            feats.has_rtt = has_rtt
        return feats


def _ordered_costs_batch(
    costs: np.ndarray, cursor: np.ndarray, count: np.ndarray, capacity: int
) -> np.ndarray:
    """Unroll (..., C) ring buffers so index 0 is oldest, count-1 is newest."""
    idx = np.arange(capacity)
    # For full rings start at cursor; for partial rings the data already
    # starts at 0 (cursor == count position).
    start = np.where(count[..., None] >= capacity, cursor[..., None], 0)
    gather = (start + idx) % capacity
    return np.take_along_axis(costs, gather, axis=-1)
