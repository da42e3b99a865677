"""Device-resident fused tick: the scheduler's rule-arm decision for one
chunk of waiting peers as one program over device-resident column mirrors.

Port of dragonfly2_tpu/ops/tick.py. The hot scheduler columns live on the
device (``TickMirror``), updated incrementally from the SoA state's dirty
tracking (state/cluster.py), and ``fused_tick_chunk`` runs candidate fill
-> masking -> stable compaction -> feature gather -> scoring -> filtering
-> top-k in one call per chunk. The host keeps the candidate sampling, the
DAG legality prefilters, the re-check and the response.

Equivalence with the packed path (ops/evaluator.schedule_from_packed):

- the HOST draws the candidate samples; the program never randomizes;
- every gather reproduces the reference's index semantics: its explicit
  clips and ``maximum(..., 0)``, and where it has none, a JAX gather's own
  (a negative index wraps once, an out-of-range one clamps), so pad rows
  (samples -1) and ``task_row = -1`` run on every device, and invalid
  slots read row 0 junk exactly as the packed transport's gather does;
- int64 identity columns reach the mirrors truncated to int32 by numpy's
  C wrap, as the packed transport ships them;
- scoring and selection are the SAME functions as the packed path
  (ops/evaluator.evaluate / filter_candidates, ops/topk.masked_top_k).

Transport: one (bsz, ROW) uint8 staging buffer in (one host-to-device
copy, from pinned memory on CUDA), one flat float32 buffer out (selection,
compacted candidate columns, optional ledger rows, int fields bit-cast),
which the caller reads back once. Nothing inside the call reads a tensor
back. With ``emit_packed`` the program also builds a
``pack_eval_batch``-identical uint8 buffer on the device, which
``schedule_from_packed`` consumes as it is (the shadow arm).
"""

from __future__ import annotations

import numpy as np
import torch

from dragonfly2_tpu_torch.config.constants import CONSTANTS
from dragonfly2_tpu_torch.device import resolve_device
from dragonfly2_tpu_torch.ops import evaluator as ev
from dragonfly2_tpu_torch.ops.topk import masked_top_k

# Every chunk and every mirror update pads to one of these row counts, as
# in the reference (cluster/scheduler.py warms each).
_EVAL_BUCKETS = (64, 256, 1024)


def _bucket_rows(n: int) -> int:
    for cap in _EVAL_BUCKETS:
        if n <= cap:
            return cap
    return _EVAL_BUCKETS[-1]


# ---------------------------------------------------------------- inbuf
# Host -> device staging row: the per-tick control inputs the host still
# owns (sampled DAG slots, in-degrees, task/child rows, the blocklist and
# DAG-legality supersets). i4 fields first (4-aligned at offset 0), u1
# tails, row padded to x4.

def inbuf_row_bytes(k: int) -> int:
    return (4 * k + 4 * k + 4 + 4 + 2 * k + 3) // 4 * 4


def build_inbuf(bsz: int, samples: np.ndarray, in_degree: np.ndarray,
                task_row: np.ndarray, child_peer: np.ndarray,
                blocklist0: np.ndarray, can_add0: np.ndarray) -> np.ndarray:
    """(bsz, ROW) uint8 staging buffer for rows [0:b) of the tick's
    control inputs; pad rows carry samples == -1 (0xFF bytes) so they are
    fully invalid on device — a zero fill would alias DAG slot 0."""
    b, k = samples.shape
    buf = np.zeros((bsz, inbuf_row_bytes(k)), np.uint8)
    if bsz > b:
        buf[b:, : 4 * k] = 0xFF
    buf[:b, : 4 * k] = (
        np.ascontiguousarray(samples.astype(np.int32)).view(np.uint8).reshape(b, 4 * k)
    )
    buf[:b, 4 * k : 8 * k] = (
        np.ascontiguousarray(in_degree.astype(np.int32)).view(np.uint8).reshape(b, 4 * k)
    )
    buf[:b, 8 * k : 8 * k + 4] = (
        np.ascontiguousarray(task_row.astype(np.int32)).view(np.uint8).reshape(b, 4)
    )
    buf[:b, 8 * k + 4 : 8 * k + 8] = (
        np.ascontiguousarray(child_peer.astype(np.int32)).view(np.uint8).reshape(b, 4)
    )
    buf[:b, 8 * k + 8 : 9 * k + 8] = blocklist0.astype(np.uint8)
    buf[:b, 9 * k + 8 : 10 * k + 8] = can_add0.astype(np.uint8)
    return buf


def _decode_inbuf(buf: torch.Tensor, b: int, k: int) -> dict:
    """Inverse of `build_inbuf` on the device: the contiguous (b, ROW)
    uint8 buffer bit-cast to int32 words (ROW and every i4 field are
    4-aligned), and the two u1 tails as bools."""
    words = buf[:b].view(torch.int32)  # (b, ROW // 4)
    return {
        "samples": words[:, 0:k],
        "in_degree": words[:, k : 2 * k],
        "task_row": words[:, 2 * k],
        "child_peer": words[:, 2 * k + 1],
        "blocklist0": buf[:b, 8 * k + 8 : 9 * k + 8] != 0,
        "can_add0": buf[:b, 9 * k + 8 : 10 * k + 8] != 0,
    }


# ----------------------------------------------------------------- out
# Device -> host result: ONE flat float32 buffer per chunk (int segments
# bit-cast, never arithmetically converted), so the drain pays a single
# read-back however many logical outputs ride along.

def out_layout(b: int, k: int, limit: int, emit_led: bool) -> list[tuple]:
    """[(name, flat_size, shape, dtype)] segments of the flat output."""
    segs = [
        ("selection", b * limit * 2, (b, limit, 2), np.float32),
        ("cand_peer_idx", b * k, (b, k), np.int32),
        ("cand_slots", b * k, (b, k), np.int32),
        ("cand_host_slots", b * k, (b, k), np.int32),
        ("cand_valid", b * k, (b, k), np.int32),
        ("quarantine_skipped", 1, (1,), np.int32),
    ]
    if emit_led:
        segs.append(("led_feats", b * k * 8, (b, k, 8), np.float32))
    return segs


def decode_out(arr: np.ndarray, b: int, k: int, limit: int,
               emit_led: bool) -> dict:
    """Host-side decode of the flat fused output (a contiguous float32
    numpy array, the drain's single read-back) into named views."""
    out = {}
    off = 0
    for name, size, shape, dt in out_layout(b, k, limit, emit_led):
        seg = arr[off : off + size]
        if dt is np.int32:
            seg = seg.view(np.int32)
        out[name] = seg.reshape(shape)
        off += size
    return out


# ------------------------------------------------------------ the program

def _i32_as_f32(x: torch.Tensor) -> torch.Tensor:
    """Bit cast (not a conversion) of an integer tensor's int32 words."""
    return x.to(torch.int32).contiguous().view(torch.float32)


def _gather_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """An index as a JAX gather reads it: a negative value wraps once, an
    out-of-range one clamps to the ends. Torch would raise (CPU) or fire a
    device-side assert (CUDA) instead."""
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def _ring_ordered(ring: torch.Tensor, cursor: torch.Tensor, count: torch.Tensor, c: int):
    """Twin of state.cluster._ordered_costs_batch: unroll (..., C) cost
    rings so index 0 is oldest."""
    idx = torch.arange(c, dtype=torch.int32, device=ring.device)
    start = torch.where(count[..., None] >= c, cursor[..., None], 0)
    gather = torch.remainder(start + idx, c).to(torch.int64)
    return torch.take_along_dim(ring, gather, dim=-1)


def _device_pack(values: dict, b: int, k: int, c: int, l: int, n: int) -> torch.Tensor:
    """A `pack_eval_batch`-identical uint8 buffer built ON DEVICE from the
    fused program's gathered features: byte for byte the buffer the host
    would pack, for `schedule_from_packed` (the shadow arm)."""
    layout, total = ev._packed_layout(b, k, c, l, n)
    device = values["valid"].device
    segs = []
    pos = 0
    for name, dt, shape, off, nbytes in layout:
        if off > pos:
            segs.append(torch.zeros(off - pos, dtype=torch.uint8, device=device))
        v = values[name]
        if dt == "u1":
            seg = v.to(torch.uint8).reshape(-1)
        elif dt == "i1":
            seg = v.to(torch.int8).contiguous().view(torch.uint8).reshape(-1)
        elif dt == "i4":
            seg = v.to(torch.int32).contiguous().view(torch.uint8).reshape(-1)
        else:  # f4
            seg = v.to(torch.float32).contiguous().view(torch.uint8).reshape(-1)
        segs.append(seg)
        pos = off + nbytes
    if total > pos:
        segs.append(torch.zeros(total - pos, dtype=torch.uint8, device=device))
    return torch.cat(segs)


def _stage(inbuf: np.ndarray, device: torch.device) -> torch.Tensor:
    """The one host-to-device copy of the staging buffer: on CUDA from
    pinned memory, queued on the stream without waiting for it."""
    host = torch.from_numpy(np.ascontiguousarray(inbuf, np.uint8))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def fused_tick_chunk(
    inbuf,
    cols: dict,
    b: int,
    k: int,
    c: int,
    l: int,
    n: int,
    algorithm: str = "default",
    limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT,
    emit_led: bool = True,
    emit_packed: bool = False,
):
    """ONE call = slot->peer-row resolution + validity/self/quarantine
    masking + stable left-compaction + feature gather + scoring + masked
    top-k, over the device-resident column mirrors in `cols`, on their
    device. `inbuf` is the (b, ROW) host uint8 staging buffer.

    Returns the flat float32 result tensor (`decode_out` layout), plus a
    pack-identical uint8 shadow buffer when ``emit_packed``. Nothing here
    reads a tensor back to the host."""
    ps = cols["peer_scalars"]          # (P, 7) int32
    slot_tbl = cols["slot_pidx"]       # (T, S) int32
    device = ps.device
    f = _decode_inbuf(_stage(inbuf, device), b, k)
    samples, ind0 = f["samples"], f["in_degree"]
    task_row, child = f["task_row"], f["child_peer"]
    n_peers, n_hosts = ps.shape[0], cols["qmask"].shape[0]

    # --- fill: slot matrix -> peer rows, validity, quarantine ----------
    tclip = task_row.clamp(0, slot_tbl.shape[0] - 1).to(torch.int64)
    sclip = samples.clamp(0, slot_tbl.shape[1] - 1).to(torch.int64)
    pidx = slot_tbl[tclip[:, None], sclip]
    pidx = torch.where((samples >= 0) & (task_row[:, None] >= 0), pidx, -1)
    valid = pidx >= 0
    safe = torch.where(valid, pidx, 0)
    psg = ps[_gather_index(safe.to(torch.int64), n_peers)]          # (b, k, 7)
    valid = valid & (psg[..., _PS_ALIVE] != 0)
    valid = valid & (pidx != child[:, None])
    host = psg[..., _PS_HOST]
    qmask = cols["qmask"]
    would = valid & qmask[host.clamp(0, n_hosts - 1).to(torch.int64)]
    qskip = would.sum(dtype=torch.int32)
    valid = valid & ~would

    # --- stable left-compaction (preserves sample order): a stable sort
    # of an integer key, as the reference's argsort(~valid, stable) -----
    order = torch.argsort((~valid).to(torch.int32), dim=1, stable=True)

    def take(a):
        return torch.take_along_dim(a, order, dim=1)

    cand_valid = take(valid)
    cand_pidx = torch.where(cand_valid, take(safe), 0)
    cand_slots = torch.where(cand_valid, take(torch.where(valid, samples, 0)), -1)
    cand_host = torch.where(cand_valid, take(host), 0)
    in_degree = torch.where(cand_valid, take(ind0), 0)
    blocklist = take(f["blocklist0"]) & cand_valid
    can_add = take(f["can_add0"]) & cand_valid

    # --- feature gather: the state.gather_candidates formulas over the
    # mirrors, junk-at-invalid included (safe index 0 -> peer/host row 0,
    # clip like the host gather) ---------------------------------------
    safe_cand = torch.where(cand_valid, cand_pidx, 0).to(torch.int64)
    pg = ps[_gather_index(safe_cand, n_peers)]                       # (b, k, 7)
    cg = ps[_gather_index(child.to(torch.int64), n_peers)]           # (b, 7)
    cand_host_row = _gather_index(torch.clamp_min(pg[..., _PS_HOST], 0).to(torch.int64), n_hosts)
    child_host_row = _gather_index(torch.clamp_min(cg[:, _PS_HOST], 0).to(torch.int64), n_hosts)
    child_task = _gather_index(
        torch.clamp_min(cg[:, _PS_TASK], 0).to(torch.int64), cols["task_total"].shape[0]
    )
    feats = {
        "valid": cand_valid & (pg[..., _PS_ALIVE] != 0),
        "finished_pieces": pg[..., _PS_FINISHED],
        "child_finished_pieces": cg[:, _PS_FINISHED],
        "total_piece_count": cols["task_total"][child_task],
        "upload_count": cols["host_upload_count"][cand_host_row],
        "upload_failed_count": cols["host_upload_failed"][cand_host_row],
        "upload_limit": cols["host_upload_limit"][cand_host_row],
        "upload_used": cols["host_upload_used"][cand_host_row],
        "host_type": cols["host_type"][cand_host_row],
        "peer_state": pg[..., _PS_STATE],
        "parent_idc": cols["host_idc"][cand_host_row],
        "child_idc": cols["host_idc"][child_host_row],
        "parent_location": cols["host_location"][cand_host_row],
        "child_location": cols["host_location"][child_host_row],
        "parent_host_id": cols["host_id_hash"][cand_host_row],
        "child_host_id": cols["host_id_hash"][child_host_row],
        "piece_costs": _ring_ordered(
            cols["peer_ring"][_gather_index(safe_cand, n_peers)], pg[..., _PS_CURSOR],
            pg[..., _PS_COST_COUNT], c,
        ),
        "piece_cost_count": pg[..., _PS_COST_COUNT],
        # the fused gating excludes the probed-nt arm (host RTT gather), so
        # the probe inputs are the packed path's zero fill
        "avg_rtt_ns": torch.zeros((b, k), dtype=torch.float32, device=device),
        "has_rtt": torch.zeros((b, k), dtype=torch.bool, device=device),
    }

    # --- score + select: the SAME functions as the packed path ----------
    scores = ev.evaluate(feats, algorithm)
    mask = ev.filter_candidates(feats, blocklist, in_degree, can_add)
    values, indices, sel_valid = masked_top_k(scores, mask, limit)
    selection = ev._pack_selection(values, indices, sel_valid)

    parts = [
        selection.reshape(-1),
        _i32_as_f32(cand_pidx).reshape(-1),
        _i32_as_f32(cand_slots).reshape(-1),
        _i32_as_f32(cand_host).reshape(-1),
        _i32_as_f32(cand_valid).reshape(-1),
        _i32_as_f32(qskip.reshape(1)),
    ]
    if emit_led:
        # compact per-candidate ledger rows (telemetry.decisions
        # compact_features); int64 idc/location hashes ride the mirrors'
        # i32 truncation, equality-only fields
        child_idc = feats["child_idc"][:, None]
        same_idc = ((feats["parent_idc"] == child_idc) & (child_idc != 0)).to(torch.float32)
        cloc = feats["child_location"][:, None, :]
        ploc = feats["parent_location"]
        elem_eq = (ploc == cloc) & (ploc != 0) & (cloc != 0)
        prefix = torch.cumprod(elem_eq.to(torch.int32), dim=-1)
        loc_match = prefix.sum(dim=-1).to(torch.float32) / l
        led = torch.stack(
            [
                feats["finished_pieces"].to(torch.float32),
                feats["upload_count"].to(torch.float32),
                feats["upload_failed_count"].to(torch.float32),
                (feats["upload_limit"] - feats["upload_used"]).to(torch.float32),
                feats["host_type"].to(torch.float32),
                in_degree.to(torch.float32),
                same_idc,
                loc_match,
            ],
            dim=-1,
        )
        parts.append(led.reshape(-1))
    out = torch.cat(parts)

    if not emit_packed:
        return out
    shadow_values = dict(feats)
    shadow_values.update(
        blocklist=blocklist,
        can_add_edge=can_add,
        in_degree=in_degree,
        child_host_slot=cg[:, _PS_HOST],
        cand_host_slot=cand_host,
        numeric=cols["host_numeric"][cand_host_row],
        child_numeric=cols["host_numeric"][child_host_row],
    )
    return out, _device_pack(shadow_values, b, k, c, l, n)


# peer_scalars mirror column order (ONE (P, 7) int32 matrix so the fused
# gather reads every per-peer scalar in a single index)
(_PS_ALIVE, _PS_STATE, _PS_HOST, _PS_TASK, _PS_FINISHED, _PS_COST_COUNT,
 _PS_CURSOR) = range(7)
_PS_COLS = 7


def _snap(a: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    """Upload with SNAPSHOT semantics: a private copy of the column, never
    a view of it. On the CPU ``torch.from_numpy`` and ``torch.as_tensor``
    share memory with the array, so the mirror would alias the LIVE
    scheduler column and a chunk would read whatever the host mutated
    since the sync (the pipelined drain mutates upload accounting while
    the next chunk is in flight)."""
    return torch.from_numpy(np.array(a, dtype=dtype or a.dtype, copy=True)).to(device)


def _scatter_rows(col: torch.Tensor, idx: np.ndarray, rows: np.ndarray) -> torch.Tensor:
    """Incremental row scatter into a resident mirror column, in place:
    `col[idx] = rows` over a bucket-padded update batch. Indices out of
    range after a negative wrap are DROPPED, as the reference's
    ``.at[idx].set(rows, mode="drop")`` drops its pad rows (index == row
    count); torch's index_put_ would raise on them, so they are filtered on
    the host before the upload. Returns `col`."""
    size = col.shape[0]
    idx = np.asarray(idx, np.int64)
    idx = np.where(idx < 0, idx + size, idx)
    keep = (idx >= 0) & (idx < size)
    if keep.any():
        col[torch.from_numpy(idx[keep]).to(col.device)] = torch.from_numpy(
            np.ascontiguousarray(rows[keep])
        ).to(col.device)
    return col


class TickMirror:
    """Device-resident mirrors of the scheduler's hot SoA columns.

    Incremental by construction: peer rows ride `state.peer_dirty` (set by
    every peer-column mutator, cleared here) through bucket-padded row
    scatters; the slot->peer-row table rides the scheduler's dirty-task
    set; static host columns re-upload only when `state.host_epoch` moved;
    the small dynamic host/task columns (upload counters, total pieces)
    and the quarantine mask re-upload wholesale every sync. int64 identity
    columns are truncated to int32 with the same `astype` C-wrap as the
    packed transport.

    Not mirrored: the have-bitsets themselves; scoring consumes only their
    popcount projection (`peer_finished_count`), which IS mirrored.

    The mirrors live on ``device``: the card unless asked for the CPU."""

    def __init__(self, state, dag_capacity: int, device=None):
        self.state = state
        self.dag_capacity = dag_capacity
        self.device = resolve_device(device)
        self._host_epoch = -1
        scal = np.zeros((state.max_peers, _PS_COLS), np.int32)
        scal[:, _PS_HOST] = -1
        scal[:, _PS_TASK] = -1
        self.peer_scalars = torch.from_numpy(scal).to(self.device)
        self.peer_ring = torch.zeros(
            (state.max_peers, state.piece_cost_capacity), dtype=torch.float32,
            device=self.device,
        )
        self.slot_pidx = torch.full(
            (state.max_tasks, dag_capacity), -1, dtype=torch.int32, device=self.device
        )
        self.host_static: dict = {}
        self.host_dyn: dict = {}

    def _peer_rows(self, idx: np.ndarray) -> np.ndarray:
        st = self.state
        rows = np.empty((idx.size, _PS_COLS), np.int32)
        rows[:, _PS_ALIVE] = st.peer_alive[idx]
        rows[:, _PS_STATE] = st.peer_state[idx]
        rows[:, _PS_HOST] = st.peer_host[idx]
        rows[:, _PS_TASK] = st.peer_task[idx]
        rows[:, _PS_FINISHED] = st.peer_finished_count[idx]
        rows[:, _PS_COST_COUNT] = st.peer_piece_cost_count[idx]
        rows[:, _PS_CURSOR] = st.peer_cost_cursor[idx]
        return rows

    def sync(self, slot_pidx_host: dict, task_index, dirty_tasks: set,
             qmask: np.ndarray) -> dict:
        """Fold every change since the last sync into the mirrors and
        return the `cols` dict for this tick's fused calls."""
        st = self.state
        dev = self.device
        dirty = np.flatnonzero(st.peer_dirty)
        if dirty.size:
            st.peer_dirty[dirty] = False
            for s in range(0, dirty.size, _EVAL_BUCKETS[-1]):
                part = dirty[s : s + _EVAL_BUCKETS[-1]]
                nb = _bucket_rows(part.size)
                idx = np.full(nb, st.max_peers, np.int32)  # pad rows drop
                idx[: part.size] = part
                rows = np.zeros((nb, _PS_COLS), np.int32)
                rows[: part.size] = self._peer_rows(part)
                ring = np.zeros((nb, st.piece_cost_capacity), np.float32)
                ring[: part.size] = st.peer_piece_costs[part]
                self.peer_scalars = _scatter_rows(self.peer_scalars, idx, rows)
                self.peer_ring = _scatter_rows(self.peer_ring, idx, ring)
        if dirty_tasks:
            updates: dict[int, np.ndarray] = {}
            empty = np.full(self.dag_capacity, -1, np.int32)
            for task_id in dirty_tasks:
                row = task_index(task_id)
                spx = slot_pidx_host.get(task_id)
                if row is None:
                    continue  # dropped task: its row is only ever read
                    # again after a successor task re-registers it dirty
                if spx is None:
                    updates[row] = empty
                else:
                    updates[row] = spx.astype(np.int32, copy=False)
            dirty_tasks.clear()
            if updates:
                rlist = np.fromiter(updates.keys(), np.int64, len(updates))
                for s in range(0, rlist.size, _EVAL_BUCKETS[-1]):
                    part = rlist[s : s + _EVAL_BUCKETS[-1]]
                    nb = _bucket_rows(part.size)
                    idx = np.full(nb, st.max_tasks, np.int32)
                    idx[: part.size] = part
                    rows = np.zeros((nb, self.dag_capacity), np.int32)
                    for j, r in enumerate(part):
                        rows[j] = updates[int(r)]
                    self.slot_pidx = _scatter_rows(self.slot_pidx, idx, rows)
        if st.host_epoch != self._host_epoch:
            self._host_epoch = st.host_epoch
            self.host_static = {
                "host_type": _snap(st.host_type, dev),
                "host_idc": _snap(st.host_idc, dev, np.int32),
                "host_location": _snap(st.host_location, dev, np.int32),
                "host_id_hash": _snap(st.host_id_hash, dev, np.int32),
                "host_numeric": _snap(st.host_numeric, dev),
            }
        self.host_dyn = {
            "host_upload_count": _snap(st.host_upload_count, dev, np.int32),
            "host_upload_failed": _snap(st.host_upload_failed, dev, np.int32),
            "host_upload_limit": _snap(st.host_upload_limit, dev),
            "host_upload_used": _snap(st.host_upload_used, dev),
            "task_total": _snap(st.task_total_pieces, dev),
        }
        # the scattered mirrors are updated IN PLACE by the next sync: the
        # cols of this tick keep their own copies, frozen at this sync
        return {
            "peer_scalars": self.peer_scalars.clone(),
            "peer_ring": self.peer_ring.clone(),
            "slot_pidx": self.slot_pidx.clone(),
            "qmask": _snap(qmask, dev),
            **self.host_static,
            **self.host_dyn,
        }


def warm_cols(state, dag_capacity: int, device=None) -> dict:
    """Zero-filled cols dict with the serving shapes and dtypes, on
    ``device`` (the card unless asked for the CPU), for warm chunks. Reads
    only the state's DIMENSIONS, never its columns or a live mirror."""
    dev = resolve_device(device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "peer_scalars": zeros((state.max_peers, _PS_COLS), torch.int32),
        "peer_ring": zeros((state.max_peers, state.piece_cost_capacity), torch.float32),
        "slot_pidx": torch.full((state.max_tasks, dag_capacity), -1, dtype=torch.int32,
                                device=dev),
        "qmask": zeros(state.max_hosts, torch.bool),
        "host_type": zeros(state.max_hosts, torch.int8),
        "host_idc": zeros(state.max_hosts, torch.int32),
        "host_location": zeros(state.host_location.shape, torch.int32),
        "host_id_hash": zeros(state.max_hosts, torch.int32),
        "host_numeric": zeros(state.host_numeric.shape, torch.float32),
        "host_upload_count": zeros(state.max_hosts, torch.int32),
        "host_upload_failed": zeros(state.max_hosts, torch.int32),
        "host_upload_limit": zeros(state.max_hosts, torch.int32),
        "host_upload_used": zeros(state.max_hosts, torch.int32),
        "task_total": zeros(state.max_tasks, torch.int32),
    }


def warm_inputs(bsz: int, k: int) -> np.ndarray:
    """All-invalid staging inputs for one warm chunk: samples -1, zero
    grids; touches no real state."""
    samples = np.full((bsz, k), -1, np.int64)
    zi = np.zeros((bsz, k), np.int64)
    zt = np.full(bsz, -1, np.int64)
    zc = np.zeros(bsz, np.int64)
    zb = np.zeros((bsz, k), bool)
    return build_inbuf(bsz, samples, zi, zt, zc, zb, zb)


def warm_scatters(state, dag_capacity: int, device=None) -> None:
    """Run the mirror's row scatter for every (column kind x bucket) shape
    on throwaway tensors (all pad rows, so nothing is written), off the
    tick path."""
    dev = resolve_device(device)
    shapes = [
        ((state.max_peers, _PS_COLS), np.int32, torch.int32),
        ((state.max_peers, state.piece_cost_capacity), np.float32, torch.float32),
        ((state.max_tasks, dag_capacity), np.int32, torch.int32),
    ]
    for shape, np_dt, dt in shapes:
        for nb in _EVAL_BUCKETS:
            idx = np.full(nb, shape[0], np.int32)  # all pads: drop
            rows = np.zeros((nb, shape[1]), np_dt)
            _scatter_rows(torch.zeros(shape, dtype=dt, device=dev), idx, rows)


def _chunk_key(inbuf, cols, b, k, c, l, n, algorithm="default",
               limit=CONSTANTS.CANDIDATE_PARENT_LIMIT, emit_led=True, emit_packed=False):
    """fused_tick_chunk's call signature for its entry wrapper without
    hashing every column each call: the staging buffer, the columns that
    carry the state's dimensions (every other column is [max_hosts] or
    [max_tasks], of a dtype that TickMirror.sync and warm_cols fix) and
    the statics."""
    ps = cols["peer_scalars"]
    return (type(inbuf), tuple(inbuf.shape), ps.shape, ps.device, cols["peer_ring"].shape,
            cols["slot_pidx"].shape, cols["qmask"].shape, cols["host_location"].shape,
            cols["host_numeric"].shape, b, k, c, l, n, algorithm, limit, emit_led, emit_packed)


# Call and signature counters (telemetry/flight.py), as the reference
# instruments its jitted entries; nothing here waits for the device. The
# fused program keeps cost cards (telemetry/costcard.py): warmup's drain
# counts each bucket's signature on zeros; _chunk_key spots a new one.
from dragonfly2_tpu_torch.telemetry.flight import instrument_entry as _instrument_entry  # noqa: E402

fused_tick_chunk = _instrument_entry(
    fused_tick_chunk, "tick.fused_tick_chunk", service="scheduler", costcards=True,
    key=_chunk_key,
)
_scatter_rows = _instrument_entry(_scatter_rows, "tick.scatter_rows", service="scheduler")
