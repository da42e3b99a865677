"""Device-backed network-topology probe store.

Port of dragonfly2_tpu/cluster/probes.py. The reference's Redis probe
state (scheduler/networktopology/: `probes:src:dst` bounded lists,
`networktopology:src:dst` avgRTT hashes, `probed-count:host` counters) is
fixed-capacity ring buffers on ``device`` (the card unless the caller
passes ``device="cpu"``), updated by one scatter batch per probe-sync
batch (ops/ewma.py), and a host mirror of the (pairs,) averages that the
evaluator's RTT gather reads.

SyncProbes parity (service_v2.go:675-817): `find_probed_hosts` returns the
least-probed alive hosts for a source to ping; `enqueue` ingests
ProbeFinished results; `snapshot` emits NetworkTopologyRecord rows (<=5
dest hosts each, network_topology.go:386-497) into trace storage.
"""

from __future__ import annotations

import numpy as np
import torch

from dragonfly2_tpu_torch.config.constants import CONSTANTS
from dragonfly2_tpu_torch.device import resolve_device
from dragonfly2_tpu_torch.ops import ewma
from dragonfly2_tpu_torch.records.schema import (
    DestHostRecord,
    NetworkStat,
    NetworkTopologyRecord,
    ProbesRecord,
    SrcHostRecord,
)


def warm_from_link_model(store: "ProbeStore", slotted_hosts, rtt_fn,
                         pairs_per_src: int = 4) -> int:
    """Seed a probe store from a scenario link model (scenarios/engine
    ``ScenarioEngine.rtt_ns``) before a replay starts.

    A cold ProbeStore scores every candidate's probe term at MIN until
    enough probe cycles ran, so a short A/B arm of the nt evaluator would
    measure warmup, not the algorithm. One warm pass enqueues
    ``pairs_per_src`` measurements per source host drawn from the link
    model (deterministic: pair choice is slot order, jitter is keyed on
    the pair).

    ``slotted_hosts`` is a list of (host, slot) pairs; ``rtt_fn(src, dst,
    key)`` returns ns. Returns measurements enqueued.
    """
    n = len(slotted_hosts)
    if n < 2:
        return 0
    total = 0
    srcs, dsts, rtts = [], [], []
    for i, (src, src_slot) in enumerate(slotted_hosts):
        for j in range(1, min(pairs_per_src, n - 1) + 1):
            dst, dst_slot = slotted_hosts[(i + j) % n]
            srcs.append(src_slot)
            dsts.append(dst_slot)
            rtts.append(float(rtt_fn(src, dst, ("warm", j))))
        if len(srcs) >= 1024:  # bound each device scatter batch
            store.enqueue(np.asarray(srcs), np.asarray(dsts), np.asarray(rtts, np.float32))
            total += len(srcs)
            srcs, dsts, rtts = [], [], []
    if srcs:
        store.enqueue(np.asarray(srcs), np.asarray(dsts), np.asarray(rtts, np.float32))
        total += len(srcs)
    return total


def _network_stat(info: dict) -> NetworkStat:
    return NetworkStat(
        tcp_connection_count=info.get("tcp_connection_count", 0),
        upload_tcp_connection_count=info.get("upload_tcp_connection_count", 0),
        location=info.get("location", ""),
        idc=info.get("idc", ""),
    )


class ProbeStore:
    def __init__(
        self,
        max_pairs: int = 1 << 16,
        max_hosts: int = 16384,
        queue_length: int = CONSTANTS.PROBE_QUEUE_LENGTH,
        device=None,
    ):
        self.device = resolve_device(device)
        self.max_pairs = max_pairs
        self.queue_length = queue_length
        # collision-free packing base for (src, dst) -> int64 keys
        self.max_pairs_key = max_hosts + 1
        self.ring = torch.zeros((max_pairs, queue_length), dtype=torch.float32, device=self.device)
        self.cursor = torch.zeros(max_pairs, dtype=torch.int32, device=self.device)
        self.count = torch.zeros(max_pairs, dtype=torch.int32, device=self.device)
        self.average = np.zeros(max_pairs, np.float32)  # host-readable mirror
        self.probed_count = torch.zeros(max_hosts, dtype=torch.int32, device=self.device)
        self._pair_index: dict[tuple[int, int], int] = {}
        self._pairs_by_src: dict[int, list[int]] = {}
        self._pair_dst: list[int] = []
        self._next = 0
        # Sorted-key mirror of _pair_index for batched (B, K) lookups in
        # gather_candidate_rtt; rebuilt lazily when pairs were added.
        self._sorted_keys = np.zeros(0, np.int64)
        self._sorted_idx = np.zeros(0, np.int32)
        self._sorted_dirty = False

    # ------------------------------------------------------------ indexing

    def pair_index(self, src_slot: int, dst_slot: int, create: bool = True) -> int | None:
        key = (src_slot, dst_slot)
        idx = self._pair_index.get(key)
        if idx is None and create:
            if self._next >= self.max_pairs:
                raise RuntimeError("probe pair table full")
            idx = self._next
            self._next += 1
            self._pair_index[key] = idx
            self._pairs_by_src.setdefault(src_slot, []).append(idx)
            self._pair_dst.append(dst_slot)
            self._sorted_dirty = True
        return idx

    # ------------------------------------------------------------- updates

    def enqueue(self, src_slots: np.ndarray, dst_slots: np.ndarray, rtt_ns: np.ndarray) -> None:
        """Ingest one ProbeFinished batch: ring scatter + EWMA folds +
        probed-count increments on the device, then the averages' one
        read-back into the host mirror."""
        pair_idx = np.asarray(
            [self.pair_index(int(s), int(d)) for s, d in zip(src_slots, dst_slots)],
            np.int64,
        )
        self.ring, self.cursor, self.count, avg = ewma.enqueue(
            self.ring, self.cursor, self.count,
            torch.from_numpy(pair_idx).to(self.device),
            torch.from_numpy(np.asarray(rtt_ns, np.float32)).to(self.device),
        )
        self.probed_count = ewma.probed_count_increment(
            self.probed_count, torch.from_numpy(np.asarray(dst_slots, np.int64)).to(self.device)
        )
        self.average = avg.cpu().numpy()

    # --------------------------------------------------------------- reads

    def average_rtt(self, src_slot: int, dst_slot: int) -> float | None:
        idx = self.pair_index(src_slot, dst_slot, create=False)
        if idx is None or self.average[idx] <= 0:
            return None
        return float(self.average[idx])

    def gather_candidate_rtt(
        self, child_host_slots: np.ndarray, cand_host_slots: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(B,K) avg RTT + has-probe mask for the nt evaluator. Probe
        direction follows the reference: Probes(parentID, childID) — dst is
        the parent being scored, src the child (evaluator_network_topology
        .go:217-224 scores parent->child RTT)."""
        b, k = cand_host_slots.shape
        if self._sorted_dirty:
            keys = np.fromiter(
                (s * self.max_pairs_key + d for (s, d) in self._pair_index),
                np.int64, count=self._next,
            )
            order = np.argsort(keys, kind="stable")
            self._sorted_keys = keys[order]
            self._sorted_idx = np.fromiter(
                self._pair_index.values(), np.int32, count=self._next
            )[order]
            self._sorted_dirty = False
        if self._sorted_keys.size == 0:
            return np.zeros((b, k), np.float32), np.zeros((b, k), bool)
        # one vectorized searchsorted instead of B*K dict lookups (this runs
        # inside every nt-mode scheduler tick at up to 1024x15 queries)
        want = (
            cand_host_slots.astype(np.int64) * self.max_pairs_key
            + child_host_slots.astype(np.int64)[:, None]
        )
        pos = np.searchsorted(self._sorted_keys, want)
        pos_c = np.minimum(pos, self._sorted_keys.size - 1)
        found = self._sorted_keys[pos_c] == want
        idx = self._sorted_idx[pos_c]
        avg = np.where(found, self.average[idx], 0.0).astype(np.float32)
        has = found & (avg > 0)
        return avg, has

    def find_probed_hosts(
        self, alive_mask: np.ndarray, key: tuple[int, int],
        k: int = CONSTANTS.FIND_PROBED_HOSTS_LIMIT,
    ) -> np.ndarray:
        """Least-probed-first alive host slots (FindProbedHosts,
        network_topology.go:190-257); ``key`` is utils/prng.key's."""
        n = min(self.probed_count.shape[0], alive_mask.shape[0])
        alive = torch.from_numpy(np.ascontiguousarray(alive_mask[:n], bool)).to(self.device)
        idx, valid = ewma.least_probed_hosts(self.probed_count[:n], alive, key, k=min(k, n))
        idx, valid = idx.cpu().numpy(), valid.cpu().numpy()
        return idx[valid]

    # ------------------------------------------------------------ snapshot

    def snapshot(
        self,
        host_info: dict[int, dict],
        now_ns: int,
        max_dest: int = CONSTANTS.MAX_DEST_HOSTS_PER_RECORD,
    ) -> list[NetworkTopologyRecord]:
        """Emit one record per probed source host (Snapshot,
        network_topology.go:386-497). `host_info[slot]` supplies identity
        fields: {id, type, hostname, ip, port, location, idc}."""
        records = []
        for src_slot, pair_idxs in sorted(self._pairs_by_src.items()):
            src = host_info.get(src_slot)
            if src is None:
                continue
            dests = []
            for idx in pair_idxs:
                if len(dests) >= max_dest:
                    break
                if self.average[idx] <= 0:
                    continue
                dst = host_info.get(self._pair_dst[idx])
                if dst is None:
                    continue
                dests.append(
                    DestHostRecord(
                        id=dst["id"],
                        type=dst.get("type", "normal"),
                        hostname=dst.get("hostname", ""),
                        ip=dst.get("ip", ""),
                        port=dst.get("port", 0),
                        network=_network_stat(dst),
                        probes=ProbesRecord(
                            average_rtt=int(self.average[idx]),
                            created_at=now_ns,
                            updated_at=now_ns,
                        ),
                    )
                )
            if not dests:
                continue
            records.append(
                NetworkTopologyRecord(
                    id=f"{src['id']}-{now_ns}",
                    host=SrcHostRecord(
                        id=src["id"],
                        type=src.get("type", "normal"),
                        hostname=src.get("hostname", ""),
                        ip=src.get("ip", ""),
                        port=src.get("port", 0),
                        network=_network_stat(src),
                    ),
                    dest_hosts=dests,
                    created_at=now_ns,
                )
            )
        return records
