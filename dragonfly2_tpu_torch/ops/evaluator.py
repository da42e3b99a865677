"""Batched parent-selection evaluator: the rule arm's scoring, filtering
and selection as tensor programs.

Port of dragonfly2_tpu/ops/evaluator.py, whose semantics follow the
upstream evaluator family:

- base linear blend 0.2/0.2/0.15/0.15/0.15/0.15 over piece, upload-success,
  free-upload, host-type, IDC, location scores
  (scheduler/scheduling/evaluator/evaluator_base.go:28-46,71-188);
- network-topology blend with the extra 0.12 probe-RTT term
  `(1s - avgRTT)/1s` and 0.11 host-type/IDC/location weights
  (evaluator_network_topology.go:30-51,96-109,217-224);
- IsBadNode: bad states, then piece-cost outlier detection: 20x-mean rule
  under 30 samples, mean+3*sigma beyond (evaluator.go:93-129);
- candidate filtering: blocklist, same-host, rootless-normal-parent,
  bad-node, no-free-upload, DAG-cycle rules
  (scheduler/scheduling/scheduling.go:500-571).

Every function takes tensors and runs on their device. The reference's
device programs run in 32-bit mode, so int64 identity fields become int32
with numpy's C wrap on the way in: ``feats_to_tensors`` does the same.
``schedule_from_packed`` takes the single-buffer transport (a host uint8
array) and runs on the card unless asked for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from dragonfly2_tpu_torch.config.constants import CONSTANTS
from dragonfly2_tpu_torch.device import resolve_device
from dragonfly2_tpu_torch.ops.topk import masked_top_k
from dragonfly2_tpu_torch.state.fsm import BAD_NODE_STATES, PeerState

_BASE_WEIGHTS = dict(
    piece=CONSTANTS.W_FINISHED_PIECE,
    upload=CONSTANTS.W_UPLOAD_SUCCESS,
    free_upload=CONSTANTS.W_FREE_UPLOAD,
    host_type=CONSTANTS.W_HOST_TYPE,
    idc=CONSTANTS.W_IDC,
    location=CONSTANTS.W_LOCATION,
    probe=0.0,
)

_NT_WEIGHTS = dict(
    piece=CONSTANTS.NT_W_FINISHED_PIECE,
    upload=CONSTANTS.NT_W_UPLOAD_SUCCESS,
    free_upload=CONSTANTS.NT_W_FREE_UPLOAD,
    host_type=CONSTANTS.NT_W_HOST_TYPE,
    idc=CONSTANTS.NT_W_IDC,
    location=CONSTANTS.NT_W_LOCATION,
    probe=CONSTANTS.NT_W_PROBE,
)

MAX_SCORE = float(CONSTANTS.MAX_SCORE)
MIN_SCORE = float(CONSTANTS.MIN_SCORE)

# int8 codes of states where IsBadNode short-circuits true (evaluator.go:94-96)
_BAD_STATES = tuple(sorted(int(s) for s in BAD_NODE_STATES))


def feats_to_tensors(feats: dict, device) -> dict:
    """numpy feature dict -> tensors on ``device``, with int64 fields
    truncated to int32 by numpy's C wrap, as the reference's 32-bit device
    programs receive them. Copies: the tensors never alias the arrays."""
    out = {}
    for name, value in feats.items():
        a = np.asarray(value)
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def piece_score(finished, child_finished, total):
    """finished/total when total is known, else raw finished-count delta
    (evaluator_base.go:86-99). Unbounded by design."""
    total_f = total.to(torch.float32)[..., None]
    known = total_f > 0
    normalized = finished.to(torch.float32) / torch.clamp_min(total_f, 1.0)
    delta = finished.to(torch.float32) - child_finished.to(torch.float32)[..., None]
    return torch.where(known, normalized, delta)


def upload_success_score(upload_count, upload_failed):
    """(uc-ufc)/uc; never-scheduled hosts get max (evaluator_base.go:102-115)."""
    uc = upload_count.to(torch.float32)
    ufc = upload_failed.to(torch.float32)
    ratio = (uc - ufc) / torch.clamp_min(uc, 1.0)
    score = torch.where(uc < ufc, MIN_SCORE, ratio)
    return torch.where((upload_count == 0) & (upload_failed == 0), MAX_SCORE, score)


def free_upload_score(upload_limit, upload_used):
    free = (upload_limit - upload_used).to(torch.float32)
    limit = upload_limit.to(torch.float32)
    ok = (limit > 0) & (free > 0)
    return torch.where(ok, free / torch.clamp_min(limit, 1.0), MIN_SCORE)


def host_type_score(host_type, peer_state):
    """Seed peers max out while Received/Running, else 0; normal hosts 0.5
    (evaluator_base.go:129-143)."""
    is_normal = host_type == 0
    active = (peer_state == int(PeerState.RECEIVED_NORMAL)) | (
        peer_state == int(PeerState.RUNNING)
    )
    seed_score = torch.where(active, MAX_SCORE, MIN_SCORE)
    return torch.where(is_normal, MAX_SCORE * 0.5, seed_score)


def idc_affinity_score(parent_idc, child_idc):
    child = child_idc[..., None]
    both = (parent_idc != 0) & (child != 0)
    return torch.where(both & (parent_idc == child), MAX_SCORE, MIN_SCORE).to(torch.float32)


def location_affinity_score(parent_loc, child_loc):
    """Leading-element match depth / 5, exact match = 1.0, either side
    empty = 0 (evaluator_base.go:159-188). Operates on per-element hash
    codes; code 0 = absent element."""
    child = child_loc[:, None, :]  # (B,1,L)
    both_present = (parent_loc[..., 0] != 0) & (child[..., 0] != 0)
    exact = torch.all(parent_loc == child, dim=-1)
    elem_eq = (parent_loc == child) & (parent_loc != 0) & (child != 0)
    # prefix length: cumulative AND of leading matches
    prefix = torch.cumprod(elem_eq.to(torch.int32), dim=-1)
    depth = prefix.sum(dim=-1).to(torch.float32) / CONSTANTS.MAX_LOCATION_ELEMENTS
    score = torch.where(exact, MAX_SCORE, depth)
    return torch.where(both_present, score, MIN_SCORE)


def probe_score(avg_rtt_ns, has_rtt):
    """(pingTimeout - avgRTT) / pingTimeout, 0 when unprobed
    (evaluator_network_topology.go:217-224)."""
    timeout = float(CONSTANTS.PING_TIMEOUT_NS)
    return torch.where(has_rtt, (timeout - avg_rtt_ns) / timeout, MIN_SCORE)


def _blend(feats: dict, weights: dict):
    # the reference's sum order, term by term
    score = (
        weights["piece"]
        * piece_score(
            feats["finished_pieces"], feats["child_finished_pieces"], feats["total_piece_count"]
        )
        + weights["upload"]
        * upload_success_score(feats["upload_count"], feats["upload_failed_count"])
        + weights["free_upload"] * free_upload_score(feats["upload_limit"], feats["upload_used"])
        + weights["host_type"] * host_type_score(feats["host_type"], feats["peer_state"])
        + weights["idc"] * idc_affinity_score(feats["parent_idc"], feats["child_idc"])
        + weights["location"]
        * location_affinity_score(feats["parent_location"], feats["child_location"])
    )
    if weights["probe"]:
        score = score + weights["probe"] * probe_score(feats["avg_rtt_ns"], feats["has_rtt"])
    return score


def evaluate(feats: dict, algorithm: str = "default"):
    """Scores (B, K) for every candidate. `algorithm` in {default, nt}."""
    weights = _NT_WEIGHTS if algorithm == "nt" else _BASE_WEIGHTS
    return _blend(feats, weights)


def _sum_last(x):
    """Float32 sum over the last axis, left to right: the order in which
    the reference's reduction adds on its CPU backend, kept so that the
    moments (and the verdicts on them) come out the same on every device.
    One add per column, so callers stack what they sum."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def is_bad_node(piece_costs, piece_cost_count, peer_state):
    """(B, K) bool: IsBadNode's sampled-outlier rule on padded cost rings
    ordered oldest->newest (evaluator.go:93-129).

    The moments are computed on SHIFTED values, d = x - x[0] (the oldest
    ring entry): Var(x) = E[d^2] - E[d]^2 exactly, but with d centered near
    zero the float32 subtraction no longer catastrophically cancels (piece
    costs are nanoseconds, ~1e9). Operation for operation the reference's
    single fused pass: masked sum and sum of squares of d, and the newest
    element by a select and a sum."""
    count = piece_cost_count.to(torch.int32)
    idx = torch.arange(piece_costs.shape[-1], dtype=torch.int32, device=piece_costs.device)
    newest = idx == (count[..., None] - 1)
    prev = (idx < (count[..., None] - 1)).to(torch.float32)  # all but the newest

    shift = piece_costs[..., :1]  # oldest cost: same magnitude as the rest
    d = (piece_costs - shift) * prev
    # the three sums in one left-to-right pass over a (..., 3, C) stack
    prev_sum_d, prev_sumsq_d, last = _sum_last(torch.stack(
        (d, d * (piece_costs - shift), torch.where(newest, piece_costs, 0.0)), dim=-2
    )).unbind(-1)

    prev_n = torch.clamp_min(count - 1, 1).to(torch.float32)
    mean_d = prev_sum_d / prev_n
    mean = mean_d + shift[..., 0]
    var = torch.clamp_min(prev_sumsq_d / prev_n - mean_d * mean_d, 0.0)
    std = torch.sqrt(var)

    small_sample = count < CONSTANTS.NORMAL_DISTRIBUTION_LEN
    outlier_small = last > mean * CONSTANTS.BAD_NODE_MEAN_MULTIPLIER
    outlier_normal = last > mean + CONSTANTS.BAD_NODE_SIGMA * std
    cost_bad = torch.where(small_sample, outlier_small, outlier_normal)
    cost_bad = cost_bad & ~(count < CONSTANTS.MIN_AVAILABLE_COST_LEN)

    state_bad = torch.zeros(peer_state.shape, dtype=torch.bool, device=peer_state.device)
    for code in _BAD_STATES:
        state_bad = state_bad | (peer_state == code)
    return state_bad | cost_bad


def filter_candidates(feats: dict, blocklist=None, in_degree=None, can_add_edge=None):
    """(B, K) bool eligibility mask: scheduling.go:500-571 as vector ops.

    `in_degree`/`can_add_edge` come from the graph engine (graph/dag.py);
    None means "no DAG constraint" (trace replay mode)."""
    mask = feats["valid"]
    if blocklist is not None:
        mask = mask & ~blocklist
    # Same host can't serve itself (scheduling.go:519-525).
    mask = mask & (feats["parent_host_id"] != feats["child_host_id"][..., None])
    # A normal-host parent must itself have a parent, or have finished /
    # gone back-to-source (scheduling.go:534-544).
    state = feats["peer_state"]
    rooted = (
        (state == int(PeerState.BACK_TO_SOURCE))
        | (state == int(PeerState.SUCCEEDED))
        | (feats["host_type"] != 0)
    )
    if in_degree is not None:
        rooted = rooted | (in_degree > 0)
    mask = mask & rooted
    # Bad nodes are skipped (scheduling.go:546-550).
    mask = mask & ~is_bad_node(feats["piece_costs"], feats["piece_cost_count"], state)
    # Saturated uploaders are skipped (scheduling.go:552-557).
    mask = mask & ((feats["upload_limit"] - feats["upload_used"]) > 0)
    # Edges that would create a cycle are skipped (scheduling.go:559-563).
    if can_add_edge is not None:
        mask = mask & can_add_edge
    return mask


def _filter_and_select(feats: dict, scores, blocklist, in_degree, can_add_edge,
                       limit: int) -> dict:
    """Shared contract of every scheduling path: eligibility mask + masked
    top-k over the provided scores."""
    mask = filter_candidates(feats, blocklist, in_degree, can_add_edge)
    values, indices, valid = masked_top_k(scores, mask, limit)
    return {
        "scores": scores,
        "mask": mask,
        "selected": indices,
        "selected_valid": valid,
        "selected_scores": values,
    }


def _pack_selection(values, indices, valid):
    """Pack (indices, valid, scores) into ONE (B, limit, 2) float32 tensor:
    channel 0 = candidate index, or -1 for empty slots; channel 1 = score.
    Candidate indices are < 128 so float32 carries them exactly; one
    output means one device-to-host read per call."""
    idx = torch.where(valid, indices, -1).to(torch.float32)
    return torch.stack([idx, values], dim=-1)


def unpack_selection(packed) -> tuple:
    """Host-side decode of `_pack_selection` output: (indices int32,
    valid bool, scores). Takes numpy arrays (the tick's read-back) or
    tensors."""
    idx = packed[..., 0]
    if isinstance(idx, torch.Tensor):
        return idx.to(torch.int32), idx >= 0, packed[..., 1]
    return idx.astype("int32"), idx >= 0, packed[..., 1]


def schedule_candidate_parents_packed(feats: dict, blocklist=None, in_degree=None,
                                      can_add_edge=None, algorithm: str = "default",
                                      limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT):
    """Serving-path variant of `schedule_candidate_parents`: identical
    filter + score + select, returning ONLY the packed (B, limit, 2)
    selection."""
    scores = evaluate(feats, algorithm)
    mask = filter_candidates(feats, blocklist, in_degree, can_add_edge)
    values, indices, valid = masked_top_k(scores, mask, limit)
    return _pack_selection(values, indices, valid)


def select_with_scores_packed(feats: dict, scores, blocklist=None, in_degree=None,
                              can_add_edge=None,
                              limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT):
    """Packed single-output twin of `select_with_scores` (plugin/ml path)."""
    mask = filter_candidates(feats, blocklist, in_degree, can_add_edge)
    values, indices, valid = masked_top_k(scores, mask, limit)
    return _pack_selection(values, indices, valid)


def schedule_candidate_parents(feats: dict, blocklist=None, in_degree=None,
                               can_add_edge=None, algorithm: str = "default",
                               limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT) -> dict:
    """Filter + score + select top-`limit` parents for B children at once.

    Returns dict with `scores` (B,K), `mask` (B,K), `selected` (B,limit)
    candidate indices, `selected_valid` (B,limit), `selected_scores`."""
    scores = evaluate(feats, algorithm)
    return _filter_and_select(feats, scores, blocklist, in_degree, can_add_edge, limit)


def select_with_scores(feats: dict, scores, blocklist=None, in_degree=None,
                       can_add_edge=None,
                       limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT) -> dict:
    """Like schedule_candidate_parents but with externally supplied scores:
    the "ml" algorithm path, where a served model replaces the linear blend
    while every filter rule still applies."""
    return _filter_and_select(feats, scores, blocklist, in_degree, can_add_edge, limit)


# ------------------------------------------------------------------------
# Single-buffer transport: the serving tick's features as ONE uint8 array,
# so the whole call costs one host-to-device copy, one program and one
# read-back of the packed selection, whatever the field count. On the
# device the buffer is sliced at static offsets and bit-cast back to each
# field's dtype (Tensor.view). int64 identity/count fields travel as int32
# (equality-only or small counts).

_PACK_ONE_BYTE = (
    # (name, numpy dtype char): 1-byte fields first so the 4-byte block
    # that follows stays aligned after a single pad.
    ("valid", "u1"),
    ("has_rtt", "u1"),
    ("blocklist", "u1"),
    ("can_add_edge", "u1"),
    ("host_type", "i1"),
    ("peer_state", "i1"),
)


def _packed_field_specs(b: int, k: int, c: int, l: int, n: int
                        ) -> list[tuple[str, str, tuple[int, ...]]]:
    """Ordered (name, dtype_str, shape) for the packed transport."""
    shapes = {
        "valid": (b, k), "has_rtt": (b, k), "blocklist": (b, k),
        "can_add_edge": (b, k), "host_type": (b, k), "peer_state": (b, k),
        "finished_pieces": (b, k), "child_finished_pieces": (b,),
        "total_piece_count": (b,), "upload_count": (b, k),
        "upload_failed_count": (b, k), "upload_limit": (b, k),
        "upload_used": (b, k), "parent_idc": (b, k), "child_idc": (b,),
        "parent_location": (b, k, l), "child_location": (b, l),
        "parent_host_id": (b, k), "child_host_id": (b,),
        "piece_cost_count": (b, k), "in_degree": (b, k),
        "child_host_slot": (b,), "cand_host_slot": (b, k),
        "avg_rtt_ns": (b, k), "piece_costs": (b, k, c),
        "numeric": (b, k, n), "child_numeric": (b, n),
    }
    specs = [(name, dt, shapes[name]) for name, dt in _PACK_ONE_BYTE]
    for name in (
        "finished_pieces", "child_finished_pieces", "total_piece_count",
        "upload_count", "upload_failed_count", "upload_limit", "upload_used",
        "parent_idc", "child_idc", "parent_location", "child_location",
        "parent_host_id", "child_host_id", "piece_cost_count", "in_degree",
        "child_host_slot", "cand_host_slot",
    ):
        specs.append((name, "i4", shapes[name]))
    for name in ("avg_rtt_ns", "piece_costs", "numeric", "child_numeric"):
        specs.append((name, "f4", shapes[name]))
    return specs


def _packed_layout(b: int, k: int, c: int, l: int, n: int) -> tuple[list, int]:
    """[(name, dtype_str, shape, offset, nbytes)], total buffer size."""
    off = 0
    layout = []
    for name, dt, shape in _packed_field_specs(b, k, c, l, n):
        itemsize = np.dtype(dt).itemsize
        off = (off + itemsize - 1) // itemsize * itemsize
        nbytes = itemsize * int(np.prod(shape, dtype=np.int64)) if shape else itemsize
        layout.append((name, dt, shape, off, nbytes))
        off += nbytes
    return layout, (off + 3) // 4 * 4


def pack_eval_batch(feats: dict, blocklist=None, in_degree=None, can_add_edge=None,
                    child_host_slot=None, cand_host_slot=None) -> np.ndarray:
    """Host side: CandidateFeatures dict (+ filter aux + optional ml host
    slots) -> one contiguous np.uint8 buffer for `schedule_from_packed`."""
    b, k = feats["valid"].shape
    c = feats["piece_costs"].shape[-1]
    l = feats["parent_location"].shape[-1]
    n = feats["numeric"].shape[-1]
    extras = {
        "blocklist": blocklist, "in_degree": in_degree,
        "can_add_edge": can_add_edge if can_add_edge is not None
        else np.ones((b, k), bool),
        "child_host_slot": child_host_slot, "cand_host_slot": cand_host_slot,
    }
    layout, total = _packed_layout(b, k, c, l, n)
    buf = np.zeros(total, np.uint8)
    for name, dt, shape, off, nbytes in layout:
        src = feats.get(name)
        if src is None:
            src = extras.get(name)
        if src is None:
            continue  # stays zero (blocklist none = nothing blocked, etc.)
        a = np.ascontiguousarray(src).astype(np.dtype(dt), copy=False)
        buf[off : off + nbytes] = a.view(np.uint8).ravel()
    return buf


_VIEW_DTYPES = {"i1": torch.int8, "i4": torch.int32, "f4": torch.float32}


def unpack_eval_batch(buf: torch.Tensor, b: int, k: int, c: int, l: int, n: int) -> dict:
    """Inverse of `pack_eval_batch` on a 1-D uint8 tensor: static-offset
    slices and bit casts (Tensor.view), no arithmetic conversion."""
    layout, _ = _packed_layout(b, k, c, l, n)
    out = {}
    for name, dt, shape, off, nbytes in layout:
        seg = buf[off : off + nbytes]
        if dt == "u1":
            out[name] = seg.reshape(shape) != 0
        else:
            out[name] = seg.view(_VIEW_DTYPES[dt]).reshape(shape)
    return out


def schedule_from_packed(buf, b: int, k: int, c: int, l: int, n: int,
                         algorithm: str = "default",
                         limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT, device=None):
    """`schedule_candidate_parents_packed` over the single-buffer
    transport: one host-to-device copy (buf), the program, and one packed
    (B, limit, 2) selection out.

    ``buf`` is a host np.uint8 array, copied to ``device`` (the card
    unless asked for the CPU), or a uint8 tensor already on a device (the
    fused tick's device-built shadow buffer), which runs where it is."""
    if isinstance(buf, torch.Tensor):
        if device is not None and torch.device(device) != buf.device:
            raise ValueError(f"buf lies on {buf.device}, not {device}")
        t = buf
    else:
        dev = resolve_device(device)
        t = torch.from_numpy(np.ascontiguousarray(buf, np.uint8)).to(dev)
    f = unpack_eval_batch(t, b, k, c, l, n)
    scores = evaluate(f, algorithm)
    mask = filter_candidates(f, f["blocklist"], f["in_degree"], f["can_add_edge"])
    values, indices, valid = masked_top_k(scores, mask, limit)
    return _pack_selection(values, indices, valid)



# Call and signature counters (telemetry/flight.py), as the reference
# instruments its jitted entry; nothing here waits for the device, so the
# pipelined tick keeps its overlap. costcards: each new bucket signature
# queues a cost card (telemetry/costcard.py), counted at the next warmup
# or /debug/flight drain, never in the tick.
from dragonfly2_tpu_torch.telemetry.flight import instrument_entry as _instrument_entry  # noqa: E402

schedule_from_packed = _instrument_entry(
    schedule_from_packed, "evaluator.schedule_from_packed", service="scheduler",
    costcards=True,
)

def find_success_parent(feats: dict, blocklist=None, in_degree=None, can_add_edge=None,
                        algorithm: str = "default") -> dict:
    """Best already-Succeeded parent per child (FindSuccessParent,
    scheduling.go:442-497): the full candidate filter first (:478), then
    only Succeeded candidates (:484-489)."""
    mask = filter_candidates(feats, blocklist, in_degree, can_add_edge)
    mask = mask & (feats["peer_state"] == int(PeerState.SUCCEEDED))
    scores = evaluate(feats, algorithm)
    values, indices, valid = masked_top_k(scores, mask, 1)
    return {
        "parent": indices[..., 0],
        "found": valid[..., 0],
        "score": values[..., 0],
    }
