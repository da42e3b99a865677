"""Native model serving into the scheduler, in PyTorch.

Port of dragonfly2_tpu/registry/serving.py:

- ``ModelServer`` watches the registry's active-version pointer and
  hot-swaps the served version on activation flips, for the gnn, mlp and
  attention model types;
- ``MLEvaluator`` is the "ml" algorithm: GraphSAGE embeddings cached per
  host slot, the candidates' scores from the served ranker as a residual
  over the rule blend, then the SAME filter rules and masked top-k as the
  rule arm (ops/evaluator.select_with_scores_packed).

What differs from the reference:

- a gnn or mlp version is served as a module of its own with the
  version's weights loaded (``params`` is that module's state dict), built
  anew at every refresh and never written after: a committed embedding
  snapshot holds its module, and a later ``refresh()`` can never change
  the weights it scores with. The pure functions below (``mlp_apply``,
  ``_gnn_embed``, ``gnn_score``, ``_ml_schedule_from_packed``, ...) take
  that module where the reference takes ``(model, params)``. The
  attention ranker keeps its state dict applied through
  ``functional_call``;
- the reference's jitted programs are plain functions over tensors on one
  device (the server's: CUDA unless the caller asks for the CPU), and
  nothing compiles;
- the refresh runs its device work on a CUDA stream of its own and
  synchronizes that stream before it commits, where the reference lands
  the embed with ``block_until_ready``. A tick reads the committed table
  on its own stream and marks it used there (``Tensor.record_stream``), so
  the caching allocator cannot hand the table's memory to a later refresh
  while a tick kernel still reads it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import threading
import time
import weakref
from collections import deque
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from dragonfly2_tpu_torch.config.constants import CONSTANTS
from dragonfly2_tpu_torch.device import resolve_device
from dragonfly2_tpu_torch.models.attention import AttentionRanker
from dragonfly2_tpu_torch.models.convert import params_from_flax
from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
from dragonfly2_tpu_torch.models.mlp import ProbeRTTRegressor
from dragonfly2_tpu_torch.ops import evaluator as ev
from dragonfly2_tpu_torch.ops.segment import gather_coo_subgraph
from dragonfly2_tpu_torch.registry.registry import (
    MODEL_TYPE_ATTENTION,
    MODEL_TYPE_GNN,
    MODEL_TYPE_MLP,
)
from dragonfly2_tpu_torch.utils import dferrors

logger = logging.getLogger(__name__)

_GRAPH_KEYS = ("node_feats", "edge_src", "edge_dst", "edge_feats")
_ARCH_KEYS = ("hidden_dim", "num_heads", "num_layers")
# knobs a rebuilt module keeps from the served one besides the arch keys
_KEPT_KNOBS = ("compute_dtype", "in_features")
_MODELS = {
    MODEL_TYPE_GNN: GraphSAGERanker,
    MODEL_TYPE_MLP: ProbeRTTRegressor,
    MODEL_TYPE_ATTENTION: AttentionRanker,
}


def _graph_only(graph_arrays: dict) -> dict:
    """The four COO arrays the embed programs consume. The scheduler's
    serving_graph_arrays also carries incremental-refresh sideband
    ('dirty_slots', 'full_sync')."""
    return {k: graph_arrays[k] for k in _GRAPH_KEYS}


def _shape_knobs(model_type: str, state: dict) -> dict:
    """The input widths flax infers at init and no metadata records, read
    from the version's own weights."""
    if model_type == MODEL_TYPE_GNN:
        hidden = state["sage_0.self.weight"].shape[0]
        return {
            "in_features": state["sage_0.self.weight"].shape[1],
            "edge_features": state["sage_0.edge.weight"].shape[1],
            "pair_features": state["head_0.weight"].shape[1] - 2 * hidden,
        }
    if model_type == MODEL_TYPE_MLP:
        return {"in_features": state["Dense_0.weight"].shape[1]}
    return {}


class ModelServer:
    """Serves the ACTIVE version of one registered model, reloading on
    activation flips — the native ModelInfer replacement.

    gnn and mlp: ``model`` is the version's module with its weights and
    ``params`` its state dict. attention: ``model`` is the architecture
    (its own parameters are not served) and ``params`` the served state
    dict, applied by ``attention_score``. Both live on ``device``."""

    def __init__(
        self,
        registry,
        name: str,
        scheduler_host_id: str,
        model_type: str,
        template_params: Any = None,
        model: Any = None,
        device: str | torch.device | None = None,
    ):
        if model_type not in _MODELS:
            raise ValueError(model_type)
        self.registry = registry
        self.name = name
        self.model_type = model_type
        self.model_id = registry.model_id(name, scheduler_host_id)
        self.device = resolve_device(device)
        self._template = template_params
        self.params: dict[str, torch.Tensor] | None = None
        self.version: int | None = None
        self.model = model if model is not None else _MODELS[model_type]()
        self._served: tuple = (self.model, None, None)

    def refresh(self) -> bool:
        """Pick up a newly activated version; returns True if swapped. The
        version's metadata records its architecture (hidden_dim), so the
        served module always matches the trained one."""
        active = self.registry.active_version(self.model_id)
        if active is None or active.version == self.version:
            return False
        arch = {
            key: active.metadata[key]
            for key in _ARCH_KEYS
            if key in active.metadata and active.metadata[key] is not None
        }
        changed = {
            key: value
            for key, value in arch.items()
            if hasattr(self.model, key) and getattr(self.model, key) != value
        }
        # Load BEFORE assigning anything: a failed params read must leave
        # the served (model, params, version) triple untouched.
        try:
            tree = self.registry.load_params(
                self.model_id, active.version, template=self._template
            )
        except dferrors.DataLoss as e:
            # The version's bytes failed their integrity manifest: mark it
            # bad so the active pointer falls back to the newest GOOD
            # version — the next refresh then serves last-good instead of
            # retrying the corrupt blob forever.
            logger.error("refusing corrupt %s v%d: %s", self.model_id, active.version, e)
            mark_bad = getattr(self.registry, "mark_version_bad", None)
            if mark_bad is not None:
                mark_bad(self.model_id, active.version, reason=str(e))
            return False
        state = params_from_flax(tree)
        if self.model_type == MODEL_TYPE_ATTENTION:
            # num_heads/num_layers can change the function while every
            # param shape agrees: rebuild the architecture on a change
            new_model = self._rebuilt(arch, state) if changed else self.model
            new_model = new_model.to(self.device).eval()
            new_params = {key: value.to(self.device) for key, value in state.items()}
        else:
            with torch.device("meta"):
                new_model = self._rebuilt(arch, state)
            new_model.load_state_dict(state, strict=True, assign=True)
            new_model = new_model.to(self.device).eval().requires_grad_(False)
            new_params = dict(new_model.state_dict())
        self.model, self.params, self.version = new_model, new_params, active.version
        self._served = (new_model, new_params, active.version)
        return True

    def _rebuilt(self, arch: dict, state: dict):
        """A module of the served one's class with the served knobs and the
        version's metadata laid over them: a knob omitted from v_{n+1}'s
        metadata means "unchanged", never "reset to the class default"."""
        kwargs = {key: getattr(self.model, key) for key in _ARCH_KEYS + _KEPT_KNOBS
                  if hasattr(self.model, key)}
        kwargs.update({k: v for k, v in arch.items() if k in kwargs})
        kwargs.update(_shape_knobs(self.model_type, state))
        return type(self.model)(**kwargs)

    @property
    def ready(self) -> bool:
        return self.params is not None

    # ------------------------------------------------------------- infer

    def infer_mlp(self, x) -> torch.Tensor:
        """Predicted log1p(rtt_ms) for (N, F) pair features."""
        return mlp_apply(self.model, x)

    def embed_hosts(self, graph_arrays: dict) -> torch.Tensor:
        """(H, D) host embeddings for the current version."""
        return _gnn_embed(self.model, _graph_only(graph_arrays))

    def snapshot(self) -> tuple[Any, Any, int | None]:
        """(model, params, version) as one tuple, committed together by
        refresh() — callers that must not see a concurrent swap half
        applied (the inference RPC, the refresh worker) read this."""
        return self._served

    def score_set(self, child_feats, parent_feats, pair_feats, mask) -> torch.Tensor:
        """(B, P) float32 candidate scores from the set-transformer ranker."""
        return attention_score(
            self.model, self.params, child_feats, parent_feats, pair_feats, mask
        )


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _on(device: torch.device, x, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy or tensor -> a tensor on ``device`` (``dtype`` if given)."""
    if isinstance(x, np.ndarray):
        # wire tensors are read-only views of the frame: copy those
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    return x.to(device=device, dtype=dtype)


def _gather_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """An index as a JAX gather reads it: a negative value wraps once, an
    out-of-range one clamps to the ends (a slot past a table that an older
    refresh sized reads its last row, as in the reference)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


@torch.inference_mode()
def mlp_apply(model, x) -> torch.Tensor:
    return model(_on(_device_of(model), x, torch.float32))


@torch.inference_mode()
def _gnn_embed(model, graph_arrays: dict) -> torch.Tensor:
    """The whole table on the segment path (the reference calls ``embed``
    with no ``adj``)."""
    dev = _device_of(model)
    return model.embed(
        _on(dev, graph_arrays["node_feats"], torch.float32),
        _on(dev, graph_arrays["edge_src"]),
        _on(dev, graph_arrays["edge_dst"]),
        _on(dev, graph_arrays["edge_feats"], torch.float32),
    )


@torch.inference_mode()
def attention_score(model, params, child_feats, parent_feats, pair_feats, mask) -> torch.Tensor:
    """Scores [N, P] for one request (numpy or torch inputs) with ``params``
    applied to ``model``, on the params' device."""
    device = next(iter(params.values())).device
    args = (
        _on(device, child_feats, torch.float32),
        _on(device, parent_feats, torch.float32),
        _on(device, pair_feats, torch.float32),
        _on(device, mask, torch.bool),
    )
    return functional_call(model, params, args)


@torch.inference_mode()
def gnn_score(model, host_emb, child_host, cand_host, pair_feats) -> torch.Tensor:
    """(B, P) scores of candidates ``cand_host`` (B, P) for children
    ``child_host`` (B,), from the (H, D) embedding table."""
    dev = _device_of(model)
    host_emb = _on(dev, host_emb)
    h = host_emb.shape[0]
    child_emb = host_emb[_gather_index(_on(dev, child_host), h)]
    parent_emb = host_emb[_gather_index(_on(dev, cand_host), h)]
    return model.score(child_emb, parent_emb, _on(dev, pair_feats, torch.float32))


@dataclasses.dataclass(frozen=True)
class _EmbSnapshot:
    """One atomically-committed serving state: embeddings PLUS the exact
    (model, params) they were computed with. Serving reads the whole
    snapshot in one attribute load, so a params activation or an
    in-progress refresh can never pair a new scoring head with an old
    embedding table."""

    model: Any
    params: Any
    params_version: int | None
    host_emb: torch.Tensor
    emb_version: int
    # on CUDA: recorded on the refresh's stream after the table's last
    # kernel. The refresh lands that stream before it commits, which is
    # what makes the table complete; a tick's stream also waits on this
    # event, a device-side second guard should a commit ever skip the land
    ready: Any = None


def _refresh_worker_main(eval_ref: "weakref.ref[MLEvaluator]",
                         wake: threading.Event, stop: threading.Event) -> None:
    """Background refresh loop. Holds the evaluator only through a
    weakref between drains — a strong reference in this closure would pin
    the evaluator (and its device tensors) forever and keep the finalizer
    from ever firing."""
    while True:
        wake.wait()
        if stop.is_set():
            return
        wake.clear()
        evaluator = eval_ref()
        if evaluator is None:
            return
        evaluator._drain_requests()
        del evaluator


def _signal_worker_stop(stop: threading.Event, wake: threading.Event) -> None:
    stop.set()
    wake.set()


# sentinel distinguishing "caller did not pin a snapshot" from "caller
# pinned None" in MLEvaluator.schedule_from_packed
_UNPINNED = object()


class MLEvaluator:
    """The "ml" scheduling algorithm.

    Scores candidates with the served GraphSAGE ranker when a version is
    committed; falls back to the rule blend otherwise.

    Embedding refresh runs OFF the serving critical path: refresh
    requests land in a latest-wins mailbox (dirty frontiers merged, never
    dropped) drained by a background worker thread; each refresh commits
    a version-stamped `_EmbSnapshot` that serving reads atomically. When
    the scheduler's dirty frontier is small, the worker recomputes only
    the affected k-hop neighborhoods (`GraphSAGERanker.embed_subset`)
    into a copy of the committed table; params flips and structural graph
    changes fall back to the full recompute. The evaluator's device is
    the server's.
    """

    # keep at most this share of the graph on the incremental path; a
    # larger frontier recomputes everything (the gather wouldn't pay)
    INCREMENTAL_MAX_FRAC = 0.25
    # canary tolerance: the residual ensemble bounds per-row deviation at
    # ML_RESIDUAL_ALPHA * |z| * row_scale with |z| <= sqrt(K-1), so any
    # healthy version lands well inside this multiple of the rule
    # baseline's spread — exceeding it means numeric blowup, not opinion
    CANARY_SPREAD_MULT = 8.0

    def __init__(self, server: ModelServer, fallback_algorithm: str = "default",
                 metrics_registry=None):
        from dragonfly2_tpu_torch.telemetry import default_registry
        from dragonfly2_tpu_torch.telemetry.series import serving_series

        self.server = server
        self.device = server.device
        self.fallback = fallback_algorithm
        # the ensemble's residual base: the same rule blend the fallback
        # path uses ("plugin" has no blend of its own, so it bases on default)
        self._base_alg = (
            fallback_algorithm if fallback_algorithm in ("default", "nt")
            else "default"
        )
        self._committed: _EmbSnapshot | None = None
        # refresh mailbox: latest graph wins, dirty frontiers union
        self._req_mu = threading.Lock()
        self._request: dict | None = None
        self._compute_mu = threading.Lock()  # serializes commits in order
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        self._need_full = False
        # the refresh's own CUDA stream (made at the first refresh on CUDA)
        self._stream = None
        # stats the bench publishes: time callers spent BLOCKED inside
        # refresh_embeddings (the critical-path cost, ~0 once async) vs
        # compute time wherever it ran
        self.refresh_blocking_s = 0.0
        self.refresh_compute_s = 0.0
        self.refresh_count = 0
        self.incremental_refresh_count = 0
        # Guarded activation: every params version is gated (finite
        # leaves + canary scoring on a fixed probe batch) ON THE REFRESH
        # WORKER before it can become the committed snapshot — a rejected
        # version leaves serving on last-good and is marked bad in the
        # registry. gate_runs counts gate executions so tests can pin
        # that scheduling never pays for it.
        self._rejected_versions: set = set()
        self.gate_runs = 0
        self.rejection_count = 0
        self._metrics = serving_series(
            metrics_registry if metrics_registry is not None else default_registry()
        )
        # consistency audit trail for the refresh/serve race test: every
        # committed (params_version, emb_version) pair, and the pair the
        # last schedule call actually served from
        self.committed_versions: deque = deque(maxlen=256)
        self.last_used_versions: tuple | None = None
        # a GC'd evaluator must take its worker with it (the test
        # session's guard fails the suite on ml-embed-refresh survivors)
        self._finalizer = weakref.finalize(
            self, _signal_worker_stop, self._stop, self._wake
        )

    # ---------------------------------------------------------- refresh

    @property
    def _host_emb(self):
        """Committed embedding table (None before the first refresh)."""
        snap = self._committed
        return None if snap is None else snap.host_emb

    def serving_snapshot(self) -> _EmbSnapshot | None:
        """The currently committed snapshot, for callers that must pin
        ONE consistent (model, params, embeddings) across several
        schedule calls — the scheduler pins it once per tick."""
        return self._committed

    def refresh_embeddings(self, graph_arrays: dict, wait: bool = False) -> None:
        """Recompute host-slot embeddings (call after topology/trace sync,
        and after server.refresh() swaps params).

        wait=False (the serving default) enqueues the graph for the
        background worker and returns immediately — ticks keep serving
        the previous committed snapshot until the new one lands.
        wait=True computes inline before returning: the deterministic
        path (paired A/B arms must not depend on worker timing).
        """
        t0 = time.perf_counter()
        try:
            if not self.server.ready:
                return
            self._merge_request(graph_arrays)
            if wait:
                self._drain_requests()
            else:
                self._ensure_worker()
                self._wake.set()
                if self._stop.is_set():
                    # closed evaluator: no worker will ever drain the
                    # mailbox — compute inline rather than strand the
                    # request (and the consumed dirty frontier)
                    self._drain_requests()
        finally:
            self.refresh_blocking_s += time.perf_counter() - t0

    def close(self, timeout: float = 5.0, drain: bool = False) -> None:
        """Stop the refresh worker (idempotent). With `drain`, any
        enqueued-but-unprocessed request is computed inline first;
        otherwise pending mailbox entries are discarded. The committed
        snapshot keeps serving either way."""
        if drain:
            self._drain_requests()
        _signal_worker_stop(self._stop, self._wake)
        # swap the worker OUT under _req_mu, THEN join: the swap is atomic
        # with the spawn check (_ensure_worker holds _req_mu and sees
        # _stop set), so whatever we swap out is the only worker there
        # will ever be
        with self._req_mu:
            worker, self._worker = self._worker, None
        if worker is not None and worker is not threading.current_thread():
            worker.join(timeout)

    def _ensure_worker(self) -> None:
        # under _req_mu: two concurrent wait=False refreshers must not
        # spawn duplicate workers
        with self._req_mu:
            worker = self._worker
            if worker is not None and worker.is_alive():
                return
            if self._stop.is_set():  # closed evaluators stay closed
                return
            worker = threading.Thread(
                target=_refresh_worker_main,
                args=(weakref.ref(self), self._wake, self._stop),
                name="ml-embed-refresh",
                daemon=True,
            )
            self._worker = worker
            worker.start()

    def _merge_request(self, graph_arrays: dict) -> None:
        with self._req_mu:
            prev = self._request
            req = dict(graph_arrays)
            # normalize BEFORE merging: a request without a frontier means
            # "unknown what changed" = full sync — that implicit full must
            # survive a merge with a frontier-carrying request
            if "full_sync" not in req:
                req["full_sync"] = "dirty_slots" not in req
            if prev is not None:
                # latest graph wins, but dirty frontiers UNION: dropping a
                # superseded request's frontier would leave its hosts
                # permanently stale in the incremental path
                pd = prev.get("dirty_slots")
                rd = req.get("dirty_slots")
                if pd is not None and rd is not None:
                    req["dirty_slots"] = np.union1d(pd, rd)
                req["full_sync"] = bool(
                    prev.get("full_sync", False) or req.get("full_sync", False)
                )
            self._request = req

    def _take_request(self) -> dict | None:
        with self._req_mu:
            req, self._request = self._request, None
            return req

    def _drain_requests(self) -> None:
        with self._compute_mu:
            while True:
                req = self._take_request()
                if req is None:
                    return
                try:
                    t0 = time.perf_counter()
                    with torch.inference_mode(), self._refresh_stream():
                        self._perform_refresh(req)
                    self.refresh_compute_s += time.perf_counter() - t0
                except Exception:  # noqa: BLE001 - next refresh recovers
                    # the dropped request consumed a dirty frontier the
                    # table never absorbed — force the next refresh full
                    self._need_full = True
                    logger.exception("embedding refresh failed")

    def _refresh_stream(self):
        """The refresh's device work on its own CUDA stream (nothing on the
        CPU), ordered after what the calling thread already queued."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._stream)

    def _land(self) -> None:
        """Wait for the refresh's device work: committing a table still in
        flight would make the next tick's kernels wait for the embed."""
        if self._stream is not None:
            self._stream.synchronize()

    def _ready_event(self):
        """An event after the refresh's device work (None on the CPU).
        What guarantees a committed table is complete is ``_land()``: the
        refresh synchronises its stream before it commits, whichever
        thread refreshed (the evaluator's worker, or a caller's
        refresh_embeddings(graph, True) on a pool thread). The event is a
        second guard on the device: the reading stream waits on it, so the
        order would hold even for a commit that did not land first."""
        if self._stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self._stream)
        return event

    def _perform_refresh(self, graph: dict) -> None:
        """Compute + commit one refresh (caller holds _compute_mu)."""
        model, params, version = self.server.snapshot()
        if params is None:
            return
        graph = dict(graph)
        dirty = graph.pop("dirty_slots", None)
        full_sync = bool(graph.pop("full_sync", True))
        committed = self._committed
        if version in self._rejected_versions:
            # previously rejected activation still on the server: keep
            # the embedding table tracking topology with LAST-GOOD params
            # (or stay on the rule fallback if nothing good ever landed)
            if committed is None:
                return
            model, params, version = (
                committed.model, committed.params, committed.params_version
            )
        n = graph["node_feats"].shape[0]
        emb = None
        incremental_ok = (
            not full_sync
            and not self._need_full
            and dirty is not None
            and committed is not None
            and committed.params_version == version
            and committed.host_emb.shape[0] == n
        )
        if incremental_ok and len(dirty) == 0:
            return  # nothing changed since the last sync; table is current
        if incremental_ok:
            sub = gather_coo_subgraph(
                graph["edge_src"], graph["edge_dst"], dirty,
                num_nodes=n,
                hops=getattr(model, "num_layers", 2),
                max_frac=self.INCREMENTAL_MAX_FRAC,
            )
            if sub is not None:
                edge_feats = np.asarray(graph["edge_feats"])[sub["edge_index"]]
                edge_feats = np.where(
                    sub["edge_pad"][:, None], 0.0, edge_feats
                ).astype(np.float32)
                node_feats = np.asarray(graph["node_feats"])[sub["nodes"]]
                emb = _gnn_embed_subset(
                    model, committed.host_emb,
                    node_feats, sub["edge_src"], sub["edge_dst"], edge_feats,
                    sub["target_local"], sub["target_global"],
                )
                self.incremental_refresh_count += 1
        if emb is None:
            emb = _gnn_embed(model, _graph_only(graph))
        self._land()
        if committed is None or committed.params_version != version:
            # GUARDED ACTIVATION (on this worker, never the tick path): a
            # new params version must pass finite-leaves + a canary
            # scoring pass before it can serve. A rejected version leaves
            # serving on the last-good snapshot, is marked bad in the
            # registry, and never re-runs the gate.
            reason = self._activation_gate(model, params, emb)
            if reason is not None:
                self._reject_version(version, reason)
                if committed is None:
                    return  # no last-good: serving stays on the rule blend
                model, params, version = (
                    committed.model, committed.params, committed.params_version
                )
                emb = _gnn_embed(model, _graph_only(graph))
                self._land()
            else:
                self._metrics.activation_accepted.labels().inc()
        snapshot = _EmbSnapshot(
            model=model,
            params=params,
            params_version=version,
            host_emb=emb,
            emb_version=(committed.emb_version + 1) if committed else 1,
            ready=self._ready_event(),
        )
        self._committed = snapshot
        self.committed_versions.append(
            (snapshot.params_version, snapshot.emb_version)
        )
        self._need_full = False
        self.refresh_count += 1

    # ----------------------------------------------------- activation gate

    def _activation_gate(self, model, params, host_emb) -> str | None:
        """Decide whether a params version may serve; returns a rejection
        reason or None. Runs on the refresh worker (never a tick): checks
        every weight and the computed embedding table for non-finite
        values, then scores a fixed deterministic probe batch and requires
        the ml ensemble's deviation from the rule baseline to stay within
        a sane multiple of the baseline's own spread."""
        self.gate_runs += 1
        for leaf in params.values():
            if not bool(torch.isfinite(leaf).all()):
                return "nonfinite_params"
        if not bool(torch.isfinite(host_emb).all()):
            return "nonfinite_embeddings"
        feats = _canary_probe()
        b, k = feats["valid"].shape
        n = host_emb.shape[0]
        child_host = torch.arange(b, dtype=torch.int32) % n
        cand_host = (torch.arange(b * k, dtype=torch.int32) % n).reshape(b, k)
        f = ev.feats_to_tensors(feats, self.device)
        logits = gnn_score(model, host_emb, child_host, cand_host, _pair_feats(f))
        scores = _ensemble_scores(f, logits, self._base_alg).cpu().numpy()
        blend = ev.evaluate(f, self._base_alg).cpu().numpy()
        valid = feats["valid"].astype(bool)
        if not bool(np.all(np.isfinite(scores[valid]))):
            return "nonfinite_scores"
        cnt = np.maximum(valid.sum(-1, keepdims=True), 1)
        mean = (blend * valid).sum(-1, keepdims=True) / cnt
        row_std = np.sqrt((((blend - mean) ** 2) * valid).sum(-1, keepdims=True) / cnt)
        scale = float(np.max(np.maximum(row_std, ML_RESIDUAL_STD_FLOOR)))
        deviation = float(np.max(np.abs(scores - blend) * valid))
        if deviation > self.CANARY_SPREAD_MULT * scale:
            return "score_spread"
        return None

    def _reject_version(self, version, reason: str) -> None:
        self.rejection_count += 1
        self._rejected_versions.add(version)
        self._metrics.activation_rejected.labels(reason).inc()
        logger.error(
            "activation gate rejected %s v%s (%s): serving stays on "
            "last-good", self.server.model_id, version, reason,
        )
        mark_bad = getattr(self.server.registry, "mark_version_bad", None)
        if mark_bad is not None and version is not None:
            try:
                # flags the version AND falls the registry's active
                # pointer back, so the server's next refresh() reloads
                # the last good version instead of the rejected one
                mark_bad(self.server.model_id, version, reason=reason)
            except Exception:  # noqa: BLE001 - gate must not kill refresh
                logger.exception("mark_version_bad failed for %s v%s",
                                 self.server.model_id, version)

    # ---------------------------------------------------------- serving

    def _serve_from(self, snap: _EmbSnapshot, record_used: bool) -> None:
        """Book one schedule call on ``snap``: the audit pair, the
        caller's stream made to wait on the refresh's ``ready`` event (a
        second guard: the refresh landed its stream before it committed),
        and the table marked used on that stream
        (the allocator then keeps its memory until that stream's work on
        it is done)."""
        if record_used:
            self.last_used_versions = (snap.params_version, snap.emb_version)
        if snap.host_emb.is_cuda:
            stream = torch.cuda.current_stream(snap.host_emb.device)
            if snap.ready is not None:
                stream.wait_event(snap.ready)
            snap.host_emb.record_stream(stream)

    def schedule(
        self,
        feats: dict,
        child_host_slot=None,
        cand_host_slot=None,
        blocklist=None,
        in_degree=None,
        can_add_edge=None,
        limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT,
    ) -> dict:
        """Filter + score + select over a numpy feature dict (the dict
        transport), on the evaluator's device."""
        snap = self._committed  # one atomic read: model+params+emb agree
        f = ev.feats_to_tensors(feats, self.device)
        aux = [None if a is None else _on(self.device, a)
               for a in (blocklist, in_degree, can_add_edge)]
        if snap is not None and child_host_slot is not None:
            self._serve_from(snap, True)
            return _ml_schedule(
                snap.model, snap.host_emb, child_host_slot, cand_host_slot, f,
                *aux, limit, algorithm=self._base_alg,
            )
        return ev.schedule_candidate_parents(
            f, *aux, algorithm=self.fallback, limit=limit
        )

    def schedule_packed(
        self,
        feats: dict,
        child_host_slot=None,
        cand_host_slot=None,
        blocklist=None,
        in_degree=None,
        can_add_edge=None,
        limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT,
    ):
        """Serving-path twin of `schedule`: only the packed (B, limit, 2)
        selection comes out (ops/evaluator.py `_pack_selection`)."""
        snap = self._committed
        f = ev.feats_to_tensors(feats, self.device)
        aux = [None if a is None else _on(self.device, a)
               for a in (blocklist, in_degree, can_add_edge)]
        if snap is not None and child_host_slot is not None:
            self._serve_from(snap, True)
            return _ml_schedule_packed(
                snap.model, snap.host_emb, child_host_slot, cand_host_slot, f,
                *aux, limit, algorithm=self._base_alg,
            )
        return ev.schedule_candidate_parents_packed(
            f, *aux, algorithm=self.fallback, limit=limit
        )

    def schedule_from_packed(
        self, buf, b, k, c, l, n,
        limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT,
        snap: Any = _UNPINNED,
        record_used: bool = True,
    ):
        """Single-buffer-transport twin of `schedule_packed` (the tick's
        one-copy contract; ops/evaluator.pack_eval_batch). Falls back to
        the linear blend over the same buffer until a snapshot commits.
        `snap` pins an explicit snapshot (serving_snapshot) for the whole
        call sequence — the scheduler passes one per tick so every chunk
        of a multi-chunk batch scores against the same committed table
        (pinning None pins the FALLBACK). `record_used=False` keeps
        `last_used_versions` untouched — the shadow-scoring path uses it,
        because a counterfactual re-score must not claim "this ml version
        SERVED"."""
        if snap is _UNPINNED:
            snap = self._committed
        if snap is not None:
            self._serve_from(snap, record_used)
            return _ml_schedule_from_packed(
                snap.model, snap.host_emb, buf, b, k, c, l, n, limit,
                algorithm=self._base_alg,
            )
        return ev.schedule_from_packed(
            buf, b, k, c, l, n, algorithm=self.fallback, limit=limit,
            device=self.device,
        )


@functools.lru_cache(maxsize=1)
def _canary_probe() -> dict:
    """Fixed probe batch for the activation gate: one small deterministic
    synthetic cluster's download records replayed as scoring requests
    (the same records/synth + features pipeline the trainer uses). Cached
    — the gate scores the SAME batch for every version, so rejections are
    reproducible. Callers must not write into the arrays."""
    from dragonfly2_tpu_torch.records import synth
    from dragonfly2_tpu_torch.records.features import downloads_to_eval_batch

    cluster = synth.make_cluster(16, seed=0)
    records = synth.gen_download_records(cluster, 8)
    return downloads_to_eval_batch(
        records, batch_tasks=8, batch_candidates=8
    ).as_dict()


def _loc_match_fraction(parent_loc, child_loc) -> torch.Tensor:
    child = child_loc[:, None, :]
    elem_eq = (parent_loc == child) & (parent_loc != 0) & (child != 0)
    prefix = torch.cumprod(elem_eq.to(torch.int32), dim=-1)
    return prefix.sum(-1).to(torch.float32) / CONSTANTS.MAX_LOCATION_ELEMENTS


def _pair_feats(f: dict) -> torch.Tensor:
    """(B, K, 2) [same_idc, loc_match] pair features of a feature dict."""
    child_idc = f["child_idc"][..., None]
    return torch.stack(
        [
            ((f["parent_idc"] == child_idc) & (child_idc != 0)).to(torch.float32),
            _loc_match_fraction(f["parent_location"], f["child_location"]),
        ],
        dim=-1,
    )


# The served model REFINES the rule blend instead of replacing it: final
# score = blend + ALPHA * z(gnn) * max(std(blend_row), STD_FLOOR). The
# learned logits are z-scored within each candidate row (scale-free), then
# bounded by the row's own blend spread, so the model can reorder
# candidates the blend finds comparable but can never promote one the
# blend rules out — and a cold/weak model degrades to the blend, not to
# noise.
ML_RESIDUAL_ALPHA = 0.5
ML_RESIDUAL_STD_FLOOR = 0.02


def _ensemble_scores(feats: dict, gnn_logits: torch.Tensor,
                     algorithm: str = "default") -> torch.Tensor:
    """The residual ensemble over (B, K) rows. The masked moments add
    left to right (ops/evaluator._sum_last), in the order the reference's
    reduction adds on its CPU backend, on every device. A row with one
    valid candidate or equal logits has variance 0 and takes the
    reference's rsqrt(1e-6); a row with none has count 1 and finite
    scores that the selection's mask drops."""
    valid = feats["valid"].to(torch.float32)
    # the residual base is the CONFIGURED rule blend (the evaluator's
    # fallback algorithm): an nt cluster keeps its probe/RTT prior
    blend = ev.evaluate(feats, algorithm)
    cnt = torch.clamp_min(ev._sum_last(valid), 1.0)
    g_sum, b_sum = ev._sum_last(torch.stack([gnn_logits * valid, blend * valid]))
    g_mean, b_mean = (g_sum / cnt)[..., None], (b_sum / cnt)[..., None]
    g_sq, b_sq = ev._sum_last(torch.stack([((gnn_logits - g_mean) ** 2) * valid,
                                           ((blend - b_mean) ** 2) * valid]))
    g_var, b_var = (g_sq / cnt)[..., None], (b_sq / cnt)[..., None]
    z = (gnn_logits - g_mean) * torch.rsqrt(g_var + 1e-6)
    scale = torch.clamp_min(torch.sqrt(b_var), ML_RESIDUAL_STD_FLOOR)
    return blend + ML_RESIDUAL_ALPHA * z * scale


def _ml_scores(model, host_emb, child_host, cand_host, f: dict, algorithm: str):
    logits = gnn_score(model, host_emb, child_host, cand_host, _pair_feats(f))
    return _ensemble_scores(f, logits, algorithm)


@torch.inference_mode()
def _ml_schedule(model, host_emb, child_host, cand_host, feats, blocklist, in_degree,
                 can_add_edge, limit, algorithm="default") -> dict:
    """ml-path schedule over a feature dict of tensors: pair features,
    embedding gathers, scoring and the masked selection."""
    scores = _ml_scores(model, host_emb, child_host, cand_host, feats, algorithm)
    return ev.select_with_scores(feats, scores, blocklist, in_degree, can_add_edge, limit=limit)


@torch.inference_mode()
def _ml_schedule_packed(model, host_emb, child_host, cand_host, feats, blocklist, in_degree,
                        can_add_edge, limit, algorithm="default") -> torch.Tensor:
    """`_ml_schedule` with the packed single-output selection contract."""
    scores = _ml_scores(model, host_emb, child_host, cand_host, feats, algorithm)
    return ev.select_with_scores_packed(feats, scores, blocklist, in_degree, can_add_edge,
                                        limit=limit)


@torch.inference_mode()
def _ml_schedule_from_packed(model, host_emb, buf, b, k, c, l, n, limit,
                             algorithm="default") -> torch.Tensor:
    """`_ml_schedule_packed` over the single-buffer transport
    (ops/evaluator.pack_eval_batch): ``buf`` is a host np.uint8 array,
    copied once to the table's device, or a uint8 tensor already there
    (the fused tick's device-built shadow buffer). Nothing is read back:
    the caller's drain makes the one read-back of the packed selection."""
    dev = host_emb.device
    if isinstance(buf, torch.Tensor):
        if buf.device != dev:
            raise ValueError(f"buf lies on {buf.device}, the table on {dev}")
        t = buf
    else:
        t = torch.from_numpy(np.ascontiguousarray(buf, np.uint8)).to(dev)
    f = ev.unpack_eval_batch(t, b, k, c, l, n)
    scores = _ml_scores(model, host_emb, f["child_host_slot"], f["cand_host_slot"], f,
                        algorithm)
    return ev.select_with_scores_packed(
        f, scores, f["blocklist"], f["in_degree"], f["can_add_edge"], limit=limit
    )


@torch.inference_mode()
def _gnn_embed_subset(model, table, node_feats, edge_src, edge_dst, edge_feats,
                      target_local, target_global) -> torch.Tensor:
    """Incremental refresh program: embed a gathered dirty-frontier
    subgraph (ops/segment.gather_coo_subgraph) and write the fresh rows
    into a COPY of the table. ``table`` is never written: the previous
    snapshot may be serving a concurrent tick while the worker computes."""
    dev = table.device
    return model.embed_subset(
        _on(dev, node_feats, torch.float32), _on(dev, edge_src), _on(dev, edge_dst),
        _on(dev, edge_feats, torch.float32), table, _on(dev, target_local),
        _on(dev, target_global),
    )


# Call and signature counters (telemetry/flight.py) on the ml serving
# entry points, under the reference's names: the ml tick call and the
# embedding refresh programs. Nothing here waits for the device. Each
# keeps cost cards (telemetry/costcard.py): a pending note holds shapes and
# a weak reference to the model, so it cannot pin a params or table
# snapshot, and the capture drains off the hot path.
from dragonfly2_tpu_torch.telemetry.flight import instrument_entry as _instrument_entry  # noqa: E402

_ml_schedule_from_packed = _instrument_entry(
    _ml_schedule_from_packed, "ml.schedule_from_packed", service="scheduler", costcards=True,
)
_gnn_embed = _instrument_entry(_gnn_embed, "ml.embed_hosts", service="scheduler",
                               costcards=True)
_gnn_embed_subset = _instrument_entry(_gnn_embed_subset, "ml.embed_subset",
                                      service="scheduler", costcards=True)
