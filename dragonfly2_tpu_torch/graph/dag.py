"""Per-task peer DAG: mutable host-side adjacency and batched device
reachability.

Port of dragonfly2_tpu/graph/dag.py, after the upstream generic
concurrent DAG (pkg/graph/dag/dag.go:49-368: AddVertex/DeleteVertex/AddEdge
with cycle check `CanAddEdge`, DeleteEdge, in/out-degree,
GetRandomVertices) used for per-task peer graphs
(scheduler/resource/task.go:155).

The *mutation* path (one edge at a time, at announce-stream rate) stays
host-side on a numpy bitset matrix per task, capacity-bounded, with its
cycle checks in the repository's native/dfnative.cpp (the port's own
loader, dragonfly2_tpu_torch/native) or, where that library is absent, the
numpy BFS below: the same host semantics. The *query* twins
``batch_reachable`` / ``batch_can_add_edge`` answer B graphs x Q queries in
one device program: a bounded frontier expansion over stacked (B, P, P)
adjacency (child reaches parent => adding parent->child closes a cycle).
"""

from __future__ import annotations

import numpy as np
import torch

from dragonfly2_tpu_torch.device import resolve_device


class DAGError(Exception):
    pass


class TaskDAG:
    """Fixed-capacity DAG over peer slots 0..P-1 with uint64 bitset rows.

    `adj[u]` holds the bitset of direct children of u (edge u->v).
    """

    def __init__(self, capacity: int = 256):
        if capacity % 64 != 0:
            raise ValueError("capacity must be a multiple of 64")
        self.capacity = capacity
        self.words = capacity // 64
        self.adj = np.zeros((capacity, self.words), np.uint64)
        self.present = np.zeros(capacity, bool)
        self.in_degree = np.zeros(capacity, np.int32)
        self.out_degree = np.zeros(capacity, np.int32)

    # ------------------------------------------------------------ vertices

    def add_vertex(self, v: int) -> None:
        if self.present[v]:
            raise DAGError(f"vertex {v} already exists")
        self.present[v] = True

    def ensure_vertex(self, v: int) -> None:
        self.present[v] = True

    def delete_vertex(self, v: int) -> None:
        """Remove v and all incident edges (dag.go DeleteVertex)."""
        if not self.present[v]:
            return
        word, bit = divmod(v, 64)
        mask = np.uint64(1) << np.uint64(bit)
        # in-edges: every u with bit v set
        parents = np.nonzero(self.adj[:, word] & mask)[0]
        for u in parents:
            self.adj[u, word] &= ~mask
            self.out_degree[u] -= 1
        # out-edges of v
        children = self._children(v)
        self.in_degree[children] -= 1
        self.adj[v] = 0
        self.out_degree[v] = 0
        self.in_degree[v] = 0
        self.present[v] = False

    def _children(self, u: int) -> np.ndarray:
        bits = self.adj[u]
        out = []
        for w in range(self.words):
            word = int(bits[w])
            while word:
                b = word & -word
                out.append(w * 64 + b.bit_length() - 1)
                word ^= b
        return np.asarray(out, dtype=np.int64)

    # --------------------------------------------------------------- edges

    def has_edge(self, u: int, v: int) -> bool:
        word, bit = divmod(v, 64)
        return bool(self.adj[u, word] & (np.uint64(1) << np.uint64(bit)))

    def reachable(self, src: int, dst: int) -> bool:
        """BFS over bitset rows: can src reach dst? (dag.go DFS :84-86).
        Runs in native code when dfnative is built (cycle checks sit on
        the DAG-mutation hot path); the Python loop below is the
        fallback and the parity oracle for its tests."""
        if src == dst:
            return True
        from dragonfly2_tpu_torch import native

        result = native.dag_reachable(self.adj, src, dst)
        if result is not None:
            return result
        frontier = np.zeros(self.words, np.uint64)
        word, bit = divmod(src, 64)
        frontier[word] = np.uint64(1) << np.uint64(bit)
        visited = frontier.copy()
        dw, db = divmod(dst, 64)
        dmask = np.uint64(1) << np.uint64(db)
        while frontier.any():
            nxt = np.zeros(self.words, np.uint64)
            for w in range(self.words):
                word_bits = int(frontier[w])
                while word_bits:
                    b = word_bits & -word_bits
                    u = w * 64 + b.bit_length() - 1
                    nxt |= self.adj[u]
                    word_bits ^= b
            nxt &= ~visited
            if nxt[dw] & dmask:
                return True
            visited |= nxt
            frontier = nxt
        return False

    def can_add_edge(self, u: int, v: int) -> bool:
        """Edge u->v is legal iff both exist, it's not a self-loop or
        duplicate, and v cannot already reach u (dag.go CanAddEdge)."""
        if u == v or not (self.present[u] and self.present[v]):
            return False
        if self.has_edge(u, v):
            return False
        return not self.reachable(v, u)

    def can_add_edges(self, parents: np.ndarray, child: int) -> np.ndarray:
        """Vectorized `can_add_edge(p, child)` over candidate parents —
        `can_add_edges_pairs` with one shared child (the legality rules
        live ONLY there so the two batch paths cannot diverge)."""
        parents = np.asarray(parents, np.int64)
        n = parents.shape[0]
        # child may be an unassigned dag_slot (-1): nothing is legal then
        if n == 0 or not (0 <= child < self.capacity) or not self.present[child]:
            return np.zeros(n, bool)
        return self.can_add_edges_pairs(parents, np.full(n, child, np.int64))

    def can_add_edges_pairs(self, parents: np.ndarray, children: np.ndarray) -> np.ndarray:
        """`can_add_edge(p, c)` over ALIGNED (parent, child) pairs in one
        native call — `can_add_edges` with the child varying per pair.
        The tick batches EVERY pending peer of a task through here, so a
        task with m peers x k candidates pays one ctypes round-trip
        instead of m (the per-call marshalling cost ~100 us dominated the
        host-side tick at scale)."""
        parents = np.asarray(parents, np.int64)
        children = np.asarray(children, np.int64)
        n = parents.shape[0]
        if n == 0:
            return np.zeros(0, bool)
        if n <= 32:
            # scalar twin of the vectorised checks below: the tick calls
            # this once per task with a handful of pairs (one pending peer
            # x k samples, or a few selected parents), where a dozen
            # whole-array numpy ops on 4-element arrays are pure call
            # overhead (~25 us/call, two call sites per task per tick)
            pl = parents.tolist()
            cl = children.tolist()
            cap = self.capacity
            adj = self.adj
            present = self.present
            out_deg = self.out_degree
            ok = np.zeros(n, bool)
            need_idx: list[int] = []
            for i in range(n):
                p = pl[i]
                c = cl[i]
                if (
                    p == c
                    or not (0 <= p < cap and 0 <= c < cap)
                    or not (present[p] and present[c])
                    or (int(adj[p, c >> 6]) >> (c & 63)) & 1
                ):
                    continue
                ok[i] = True
                if out_deg[c] > 0:
                    need_idx.append(i)
            if need_idx:
                from dragonfly2_tpu_torch import native

                idx = np.asarray(need_idx, np.int64)
                batch = native.dag_reachable_batch(
                    self.adj, children[idx], parents[idx]
                )
                if batch is not None:
                    ok[idx] &= ~batch
                else:
                    for i in need_idx:
                        if self.reachable(cl[i], pl[i]):
                            ok[i] = False
            return ok
        p_in = (parents >= 0) & (parents < self.capacity)
        c_in = (children >= 0) & (children < self.capacity)
        safe_p = np.where(p_in, parents, 0)
        safe_c = np.where(c_in, children, 0)
        ok = (
            p_in & c_in
            & self.present[safe_p] & self.present[safe_c]
            & (parents != children)
        )
        word, bit = np.divmod(safe_c, 64)
        ok &= (self.adj[safe_p, word] & (np.uint64(1) << bit.astype(np.uint64))) == 0
        # Cycle check only where the child can reach ANYTHING: a child with
        # no out-edges (the common case — a fresh downloader serves nobody
        # yet) cannot reach the parent, so the edge is legal without a
        # reachability query. This drops the native round-trip from "every
        # scheduled peer" to "peers that already serve others".
        need = ok & (self.out_degree[safe_c] > 0)
        if not need.any():
            return ok
        from dragonfly2_tpu_torch import native

        idx = np.nonzero(need)[0]
        batch = native.dag_reachable_batch(self.adj, children[idx], parents[idx])
        if batch is not None:
            ok[idx] &= ~batch
        else:  # native lib unavailable: per-query fallback
            for i in idx:
                if self.reachable(int(children[i]), int(parents[i])):
                    ok[i] = False
        return ok

    def add_edge(self, u: int, v: int) -> None:
        if not self.can_add_edge(u, v):
            raise DAGError(f"edge {u}->{v} rejected (missing vertex, duplicate, or cycle)")
        self._add_edge_unchecked(u, v)

    def _add_edge_unchecked(self, u: int, v: int) -> None:
        word, bit = divmod(v, 64)
        self.adj[u, word] |= np.uint64(1) << np.uint64(bit)
        self.out_degree[u] += 1
        self.in_degree[v] += 1

    def add_edges_from(self, parents: np.ndarray, child: int) -> np.ndarray:
        """Add every legal `p -> child` edge in ONE legality batch; returns
        the per-parent accepted mask. Equivalent to sequential add_edge
        over the same list: all the new edges END at `child`, so none can
        change reachability FROM `child` — each edge's cycle check against
        the pre-call graph is exactly the check sequential adds would
        make. One native reachability round-trip per scheduled peer
        instead of one per selected parent (scheduler _apply_selection)."""
        parents = np.asarray(parents, np.int64)
        ok = self.can_add_edges(parents, child)
        # a parent repeated IN THIS BATCH must only add once
        if ok.any():
            seen: set[int] = set()
            for i in np.nonzero(ok)[0]:
                p = int(parents[i])
                if p in seen:
                    ok[i] = False
                    continue
                seen.add(p)
                self._add_edge_unchecked(p, child)
        return ok

    def add_edges_grouped(
        self, parents_list: list[np.ndarray], children: np.ndarray
    ) -> list[np.ndarray]:
        """Batched `add_edges_from` over MANY children in ONE legality
        round-trip, with sequential-equivalent semantics.

        Children must be distinct (one scheduling decision per peer per
        tick). The legality of every (parent, child) pair is checked in a
        single `can_add_edges_pairs` batch against the pre-batch graph;
        groups are then applied in list order. A pre-batch answer can only
        go stale for a pair whose parent became reachable from a child
        that gained in-edges EARLIER in this batch (every new path
        traverses some new edge, and all new edges end at batch
        children), so the apply loop tracks `affected` — the union of
        {child} ∪ descendants(child) bitsets of already-edged children,
        computed against the then-current graph — and re-checks exactly
        the pairs whose parent bit is set. In the common case (children
        with no out-edges) `affected` stays one bit per child and no pair
        ever re-checks, so the whole batch costs one native call where
        the per-peer path paid one per child.

        Returns the per-group accepted masks, identical to what
        sequential `add_edges_from` calls would have returned."""
        children = np.asarray(children, np.int64)
        lens = [len(p) for p in parents_list]
        if not lens or sum(lens) == 0:
            return [np.zeros(n, bool) for n in lens]
        flat_p = np.concatenate(
            [np.asarray(p, np.int64) for p in parents_list if len(p)]
        )
        flat_c = np.repeat(children, lens)
        ok0 = self.can_add_edges_pairs(flat_p, flat_c)
        results: list[np.ndarray] = []
        affected = np.zeros(self.words, np.uint64)
        any_touched = False
        off = 0
        for parents, child in zip(parents_list, children):
            n = len(parents)
            ok = ok0[off : off + n].copy()
            off += n
            child = int(child)
            seen: set[int] = set()
            touched = False
            for i in range(n):
                if not ok[i]:
                    continue
                p = int(parents[i])
                if p in seen:
                    ok[i] = False
                    continue
                if any_touched:
                    w, b = divmod(p, 64)
                    if affected[w] & (np.uint64(1) << np.uint64(b)):
                        # p is (possibly) reachable from an earlier-edged
                        # child — the pre-batch legality answer may be
                        # stale; re-check against the CURRENT graph
                        if self.reachable(child, p):
                            ok[i] = False
                            continue
                seen.add(p)
                self._add_edge_unchecked(p, child)
                touched = True
            if touched:
                any_touched = True
                if self.out_degree[child] == 0:
                    # no descendants: affected gains exactly the child bit
                    w, b = divmod(child, 64)
                    affected[w] |= np.uint64(1) << np.uint64(b)
                else:
                    affected |= self._reach_bitset(child)
            results.append(ok)
        return results

    def add_edges_single(self, parents: list, child: int) -> list:
        """Python-int twin of a ONE-group ``add_edges_grouped`` call — the
        dominant shape on the batched apply path (~one scheduling decision
        per task per tick leaves most groups with a single child). Same
        accepted mask, no array construction or staleness bookkeeping:
        with a single child the batch's `affected` set is always empty at
        check time, and legality against the pre-call graph is sound for
        the same reason as ``add_edges_from`` (every new edge ends at
        `child`, so no add changes reachability FROM `child`).

        `parents` is a plain list of python ints; returns a list of bools
        aligned with it."""
        cap = self.capacity
        present = self.present
        adj = self.adj
        out_deg = self.out_degree
        c = int(child)
        n = len(parents)
        ok = [False] * n
        if not (0 <= c < cap and present[c]):
            return ok
        check_cycle = out_deg[c] > 0
        need: list[int] = []
        for i in range(n):
            p = parents[i]
            if (
                p == c
                or not (0 <= p < cap)
                or not present[p]
                or (int(adj[p, c >> 6]) >> (c & 63)) & 1
            ):
                continue
            ok[i] = True
            if check_cycle:
                need.append(i)
        if need:
            from dragonfly2_tpu_torch import native

            idx = np.asarray(need, np.int64)
            pn = np.asarray([parents[i] for i in need], np.int64)
            batch = native.dag_reachable_batch(
                adj, np.full(len(need), c, np.int64), pn
            )
            if batch is not None:
                for j, i in enumerate(need):
                    if batch[j]:
                        ok[i] = False
            else:
                for i in need:
                    if self.reachable(c, parents[i]):
                        ok[i] = False
        seen: set[int] = set()
        for i in range(n):
            if not ok[i]:
                continue
            p = parents[i]
            if p in seen:
                ok[i] = False
                continue
            seen.add(p)
            self._add_edge_unchecked(p, c)
        return ok

    def _reach_bitset(self, src: int) -> np.ndarray:
        """{src} ∪ descendants(src) as a word-bitset (numpy BFS over
        adjacency rows; exits immediately for a vertex with no
        out-edges)."""
        out = np.zeros(self.words, np.uint64)
        w, b = divmod(src, 64)
        out[w] = np.uint64(1) << np.uint64(b)
        frontier = [src]
        while frontier:
            nxt = np.bitwise_or.reduce(self.adj[frontier], axis=0) & ~out
            if not nxt.any():
                break
            out |= nxt
            frontier = np.flatnonzero(
                np.unpackbits(nxt.view(np.uint8), bitorder="little")
            ).tolist()
        return out

    def delete_edge(self, u: int, v: int) -> None:
        if not self.has_edge(u, v):
            return
        word, bit = divmod(v, 64)
        self.adj[u, word] &= ~(np.uint64(1) << np.uint64(bit))
        self.out_degree[u] -= 1
        self.in_degree[v] -= 1

    def delete_in_edges(self, v: int) -> None:
        """Drop all parent->v edges (task.DeletePeerInEdges)."""
        word, bit = divmod(v, 64)
        mask = np.uint64(1) << np.uint64(bit)
        parents = np.nonzero(self.adj[:, word] & mask)[0]
        for u in parents:
            self.adj[u, word] &= ~mask
            self.out_degree[u] -= 1
        self.in_degree[v] = 0

    def delete_out_edges(self, u: int) -> None:
        children = self._children(u)
        self.in_degree[children] -= 1
        self.adj[u] = 0
        self.out_degree[u] = 0

    def random_vertices(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform sample of up to n present vertices (dag.go GetRandomVertices
        — the LoadRandomPeers feed for candidate filtering)."""
        live = np.nonzero(self.present)[0]
        if live.size == 0:
            return live
        take = min(n, live.size)
        return rng.choice(live, size=take, replace=False)

    def vertex_count(self) -> int:
        return int(self.present.sum())

    def edge_count(self) -> int:
        return int(self.out_degree.sum())


# ----------------------------------------------------------------- device


def _wrap(idx: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """An index as the reference reads it: negative values wrap once.
    Returns (the index clamped into range, whether it was out of range
    after the wrap); a plain gather clamps, ``take_along_axis`` fills."""
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp(0, size - 1), (idx < 0) | (idx >= size)


def batch_reachable(adj: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    max_depth: int = 0) -> torch.Tensor:
    """Batched reachability on stacked bool adjacency, on adj's device.

    adj:  (B, P, P) bool, adj[b, u, v] means edge u->v in graph b
    src:  (B, Q) int start vertices
    dst:  (B, Q) int targets
    Returns (B, Q) bool. Each step expands the frontier by one 0/1 float
    matmul (exact: the operands are 0 or 1 and a sum stays below 2^24),
    P steps or ``max_depth``, with the visited mask saturating. A source
    outside [0, P) reaches nothing and a target outside it is never hit,
    as in the reference."""
    b, p, _ = adj.shape
    depth = max_depth or p
    adj_f = adj.to(torch.float32)
    vertices = torch.arange(p, device=adj.device)
    frontier = (src.to(torch.int64)[..., None] == vertices).to(torch.float32)  # (B, Q, P)
    visited = frontier
    for _ in range(depth):
        nxt = torch.bmm(frontier, adj_f)
        nxt = torch.where(nxt > 0, 1.0, 0.0) * (1.0 - visited)
        visited = torch.clamp(visited + nxt, 0.0, 1.0)
        frontier = nxt
    d, out = _wrap(dst.to(torch.int64), p)
    hit = torch.take_along_dim(visited, d[..., None], dim=-1)[..., 0] > 0
    return hit & ~out


def batch_can_add_edge(adj: torch.Tensor, present: torch.Tensor, parent: torch.Tensor,
                       child: torch.Tensor, max_depth: int = 0) -> torch.Tensor:
    """(B, K) bool: adding parent->child keeps the graph acyclic and simple.

    adj (B, P, P) bool, present (B, P) bool, parent (B, K) int proposed
    parent vertices, child (B,) int. Mirrors TaskDAG.can_add_edge for a
    whole batch in one call: illegal if self-loop, either vertex absent,
    duplicate edge, or child already reaches parent."""
    b, k = parent.shape
    p = adj.shape[1]
    parent = parent.to(torch.int64)
    child_b = child.to(torch.int64)[:, None].expand(b, k)
    cycle = batch_reachable(adj, child_b, parent, max_depth)
    sp, p_out = _wrap(parent, p)
    sc, c_out = _wrap(child_b, p)
    # the reference's take_along_axis fills an out-of-range bool with True
    parent_present = torch.take_along_dim(present, sp, dim=1) | p_out
    child_present = torch.take_along_dim(present, sc[:, :1], dim=1) | c_out[:, :1]
    rows = torch.arange(b, device=adj.device)[:, None]
    dup = adj[rows, sp, sc]
    return (parent != child_b) & parent_present & child_present & ~dup & ~cycle


def stacked_adjacency(dags: list, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, P, P) bool adjacency and (B, P) presence of TaskDAGs of one
    capacity, unpacked from their bitset rows, on ``device`` (the card
    unless asked for the CPU): the inputs of the twins above."""
    dev = resolve_device(device)
    words = np.stack([d.adj for d in dags])  # (B, P, W) uint64
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little").astype(bool)
    present = np.stack([d.present for d in dags])
    return torch.from_numpy(bits).to(dev), torch.from_numpy(present).to(dev)
