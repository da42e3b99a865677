"""Port of dragonfly2_tpu/utils/hashring.py, whole: the ring hashes
through the port's own native loader (native/__init__.py), whose
pure-Python fallback is the same function.

Consistent-hash ring for task -> scheduler affinity.

Capability parity with pkg/balancer/consistent_hashing.go:40-57 + the
dynconfig-fed resolver (pkg/resolver/): every request for a given task id
must land on the same scheduler so its in-memory DAG/state is authoritative.
Implemented as a sorted ring of virtual-node hashes over FNV-1a 64 — the
same function in the native (dfnative.cpp) and Python paths, so mixed
fleets agree on placement.
"""

from __future__ import annotations

import bisect

from dragonfly2_tpu_torch import native


def _hash(key: str) -> int:
    return native.fnv1a64(key.encode("utf-8"))


class HashRing:
    def __init__(self, nodes: list[str] | None = None, replicas: int = 64):
        self._replicas = replicas
        self._ring: list[int] = []
        self._members: dict[int, str] = {}
        self._nodes: set[str] = set()
        for node in nodes or []:
            self.add(node)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self._replicas):
            h = _hash(f"{node}#{i}")
            idx = bisect.bisect(self._ring, h)
            self._ring.insert(idx, h)
            self._members[h] = node

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.remove(node)
        for i in range(self._replicas):
            h = _hash(f"{node}#{i}")
            idx = bisect.bisect_left(self._ring, h)
            if idx < len(self._ring) and self._ring[idx] == h:
                self._ring.pop(idx)
                self._members.pop(h, None)

    def pick(self, key: str) -> str | None:
        """Pick the node owning `key` (e.g. a task id)."""
        if not self._ring:
            return None
        h = _hash(key)
        idx = bisect.bisect(self._ring, h) % len(self._ring)
        return self._members[self._ring[idx]]

    def successors(self, key: str, limit: int | None = None) -> list[str]:
        """Distinct nodes in ring order starting at `key`'s owner — the
        failover order: when the primary is down (breaker open, dial
        refused), the task moves to the NEXT ring node, which is also
        where it lands permanently if the primary leaves the ring, so a
        failed-over task keeps its affinity across the outage."""
        if not self._ring:
            return []
        want = len(self._nodes) if limit is None else min(limit, len(self._nodes))
        h = _hash(key)
        start = bisect.bisect(self._ring, h) % len(self._ring)
        out: list[str] = []
        seen: set[str] = set()
        for i in range(len(self._ring)):
            node = self._members[self._ring[(start + i) % len(self._ring)]]
            if node not in seen:
                seen.add(node)
                out.append(node)
                if len(out) >= want:
                    break
        return out

    def pick_many(self, keys: list[str]) -> list[str | None]:
        """Batch pick (native ring lookup when available) — the trace
        replay / preheat fan-out path."""
        if not self._ring:
            return [None] * len(keys)
        import numpy as np

        ring = np.asarray(self._ring, np.uint64)
        hashes = native.fnv1a64_batch([k.encode("utf-8") for k in keys])
        idx = native.ring_pick_batch(ring, hashes)
        return [self._members[self._ring[int(i)]] for i in idx]

    def nodes(self) -> set[str]:
        return set(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)
