"""Training loops, in PyTorch: the GNN and MLP trainers and the attention
parent ranker.

Port of dragonfly2_tpu/training/train.py: ``train_mlp`` (train.py:570),
``train_gnn`` (:649) and ``train_attention`` (:746) on one device and on a
mesh, checkpoint resume (``_resume_hooks``, :512), ``TrainResult``,
``flops_basis``, the analytic flop floors of the three families and the
GNN's roofline card (``gnn_roofline_bound``, :137), the edge-sharded
graph embed (``embed_graph_sharded``, :1053), and the split and
throughput helpers they share. The models are models/graphsage.py's
``GraphSAGERanker``, models/mlp.py's ``ProbeRTTRegressor`` and
models/attention.py's ``AttentionRanker``.

- One device (``mesh=None``): as in the reference's ``_make_epoch_indexed``
  path, the training rows live on the device once and each step gathers its
  batch by index there, in timed blocks of ``epoch_fusion`` epochs. The
  GNN aggregates through the dense adjacency (``D.dense_graph_arrays``, one
  product a layer) when the graph has at most ``D.DENSE_ADJ_MAX_NODES``
  nodes, else through segment sums over edges padded to ``D.edge_bucket``;
  it embeds the whole graph every step. The attention ranker's attention
  goes through ops/flash.py: on CUDA the forward-with-lse kernel and the
  dK/dV and dQ backward kernels, on the CPU their plain versions. The GNN
  and the MLP reach no hand kernel (the reference's are XLA programs).
- A mesh (parallel/mesh.py): batches follow the reference's
  ``_stacked_epochs`` step for step, padded to a multiple of dp; the GNN
  takes the segment path and ``D.rank_batches``, the MLP ``D.minibatches``,
  the ranker full batches of a new permutation. Only the ranker is
  sharded. Its attention over sp > 1 (ring attention or Ulysses,
  ``sp_strategy``): its
  training steps take the ring's einsum path, as the reference does (the
  partials have no gradient), and its no-grad eval forward the ring's
  flash path, the partial kernel. With ``config.attention_tp`` and tp > 1
  its blocks run tensor-parallel (models/attention.py), each tp shard's
  head group through the attention of its own (dp, sp) sub-mesh; with
  ``config.attention_moe_experts`` its MLPs are top-1 MoEs, over the ep
  axis's all_to_alls when ep > 1 (parallel/moe.py); with
  ``config.attention_pp`` and pp > 1 it is the reference's deep
  ``PipelineRanker``, one block a stage (parallel/pipeline.py). The rest
  computes on the mesh's first device, so a dp-only mesh takes the mesh
  path for the reference's batch order and nothing else.
- A mesh across processes (parallel/mesh.py ``make_hybrid_mesh`` after
  ``initialize_distributed``): every process draws the same batches from
  the same seed and trains on its block of each; each step divides the
  loss's sum by the count of every process's rows and all-reduces the
  gradients (and the loss) before the optimizer step, so the processes
  keep equal weights; each evaluates every eval row.
- ``embed_graph_sharded`` splits the GraphSAGE embed's edge set over the
  mesh's dp x graph places and sums their float32 segment sums on the
  first device.

The host reads each block's losses once, and the throughput is timed
against that read. The optimizer is AdamW with optax's ``adamw`` defaults,
not torch's (weight decay 1e-4, not 1e-2). Weights start from a flax
params tree ``params`` when given, else are drawn from ``seed`` on the CPU
(every device starts from the same weights); ``TrainResult.params`` is the
trained flax tree, which either package's registry can publish and serve.
Each trainer takes a ``stop`` event (a departure: the reference has
none), checked before every step, so a stopping trainer process ends a
training within one step (TrainingAborted) instead of running it out.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.config.config import TrainerConfig
from dragonfly2_tpu_torch.device import resolve_device
from dragonfly2_tpu_torch.models import metrics as M
from dragonfly2_tpu_torch.models.attention import AttentionRanker, PipelineRanker
from dragonfly2_tpu_torch.models.convert import params_from_flax, params_to_flax
from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker, RankBatch, listwise_rank_terms
from dragonfly2_tpu_torch.models.mlp import ProbeRTTRegressor
from dragonfly2_tpu_torch.ops.flash import flash_attention
from dragonfly2_tpu_torch.ops.segment import segment_sum
from dragonfly2_tpu_torch.parallel.mesh import (
    DP_AXIS,
    GRAPH_AXIS,
    PP_AXIS,
    SP_AXIS,
    TP_AXIS,
    shard_stacked_batches,
)
from dragonfly2_tpu_torch.parallel.tensor import sum_to
from dragonfly2_tpu_torch.parallel.ring import sharded_ring_attention
from dragonfly2_tpu_torch.parallel.ulysses import sharded_ulysses_attention
from dragonfly2_tpu_torch.records.features import HostGraph, RankingDataset
from dragonfly2_tpu_torch.telemetry import costcard as _costcard
from dragonfly2_tpu_torch.telemetry.costcard import H100_HBM_BYTES_PER_S, H100_PEAK_FLOPS_BF16
from dragonfly2_tpu_torch.telemetry.flight import instrument_entry
from dragonfly2_tpu_torch.training import data as D

SP_STRATEGIES = ("ring", "ulysses")

@dataclasses.dataclass
class TrainResult:
    params: dict
    losses: list[float]
    eval_metrics: dict[str, float]
    samples_per_sec: float
    steps: int
    # model FLOPs per trained sample from a compiler's cost analysis; the
    # port runs eagerly and has none, so it stays 0.0 and flops_basis falls
    # to the analytic floor (the counted cost card of the epoch lands in
    # telemetry/costcard.py's ledger, not here)
    flops_per_sample: float = 0.0
    # hand-counted matmul-only FLOPs per sample (a lower bound on the work
    # a step must do)
    analytic_flops_per_sample: float = 0.0
    # best single timed block's rate, the first block excluded when more
    # than one ran
    peak_samples_per_sec: float = 0.0

    @property
    def flops_per_sec(self) -> float:
        return self.flops_per_sample * self.samples_per_sec


def flops_basis(result: TrainResult) -> tuple[str, float]:
    """(source, flops_per_sample) every utilization claim must use: the
    analytic matmul floor when present (a lower bound on executed work);
    a cost analysis below that floor is invalid and flagged; "none" when
    no basis exists."""
    analytic, xla = result.analytic_flops_per_sample, result.flops_per_sample
    if analytic > 0:
        if 0 < xla < analytic:
            return (
                "analytic_matmul_floor (xla_cost_analysis invalid: below floor)",
                analytic,
            )
        return "analytic_matmul_floor", analytic
    if xla > 0:
        return "xla_cost_analysis", xla
    return "none", 0.0


def analytic_gnn_flops_per_sample(
    n_nodes: int,
    node_feat_dim: int,
    edge_feat_dim: int,
    hidden: int,
    batch: int,
    parents: int,
    pair_feat_dim: int,
    num_layers: int = 2,
    dense_adj: bool = True,
) -> float:
    """Matmul-only FLOP lower bound per trained sample for one
    GraphSAGERanker train step (fwd + bwd ~ 3x fwd): the dense layers and,
    on the dense path, the 2*N^2*F_in adjacency product a layer. The graph
    embedding runs once a step and is shared by the batch, so its cost is
    divided by ``batch``."""
    fwd = 0.0
    f_in = node_feat_dim
    for _ in range(num_layers):
        if dense_adj:
            fwd += 2.0 * n_nodes * n_nodes * f_in          # adj @ h
        fwd += 2.0 * n_nodes * f_in * hidden               # W_self
        fwd += 2.0 * n_nodes * f_in * hidden               # W_neigh
        fwd += 2.0 * n_nodes * edge_feat_dim * hidden      # W_edge
        f_in = hidden
    # scoring head: B*P rows of [child, parent, pair] -> hidden -> hidden/2 -> 1
    rows = float(batch) * parents
    head_in = 2 * hidden + pair_feat_dim
    fwd += 2.0 * rows * head_in * hidden
    fwd += 2.0 * rows * hidden * (hidden // 2)
    fwd += 2.0 * rows * (hidden // 2)
    step = 3.0 * fwd  # the backward ~ 2x the forward
    return step / max(batch, 1)


def gnn_roofline_bound(
    n_nodes: int,
    node_feat_dim: int,
    edge_feat_dim: int,
    hidden: int,
    batch: int,
    parents: int,
    pair_feat_dim: int,
    num_layers: int = 2,
    dense_adj: bool = True,
    peak_flops: float = H100_PEAK_FLOPS_BF16,
    hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S,
    compute_bytes: int = 2,         # bf16 activations/weights
) -> dict:
    """Per-train-step roofline for the GraphSAGERanker: which stages are
    compute- vs memory-bound, and the MFU ceiling their byte traffic
    imposes.

    Per stage: matmul FLOPs and the bytes its operands and results move;
    a stage's time lower bound is max(flops/peak, bytes/bw), summed over
    the stages (no overlap credit); ceiling = total_flops / (peak * the
    summed bound). The backward counts as 2x the forward for both FLOPs
    and bytes. Elementwise ops and the optimizer are not modeled, so the
    achieved MFU lands below this ceiling. The platform defaults are this
    port's card (``H100_PEAK_FLOPS_BF16``, ``H100_HBM_BYTES_PER_S``)."""
    ridge = peak_flops / hbm_bytes_per_s
    stages: list[dict] = []

    def stage(name: str, flops: float, nbytes: float) -> None:
        t = max(flops / peak_flops, nbytes / hbm_bytes_per_s)
        stages.append({
            "stage": name,
            "gflops": round(flops / 1e9, 2),
            "mbytes": round(nbytes / 1e6, 2),
            "ai_flops_per_byte": round(flops / max(nbytes, 1.0), 1),
            "bound": "compute" if flops / max(nbytes, 1.0) >= ridge else "memory",
            "time_us_lb": round(t * 1e6, 2),
        })

    f_in = node_feat_dim
    for layer in range(num_layers):
        if dense_adj:
            stage(
                f"sage_{layer}.adj_matmul",
                2.0 * n_nodes * n_nodes * f_in,
                # adjacency + input nodes + aggregated output
                compute_bytes * (n_nodes * n_nodes + 2.0 * n_nodes * f_in),
            )
        else:
            # gather + segment-sum path: ~zero matmul FLOPs, pure traffic
            stage(
                f"sage_{layer}.segment_sum",
                0.0,
                compute_bytes * 3.0 * n_nodes * f_in,  # gather+scatter+out
            )
        stage(
            f"sage_{layer}.dense",
            2.0 * n_nodes * f_in * hidden * 2        # W_self + W_neigh
            + 2.0 * n_nodes * edge_feat_dim * hidden,  # W_edge
            compute_bytes * (
                n_nodes * (2.0 * f_in + edge_feat_dim + hidden)
                + (2.0 * f_in + edge_feat_dim) * hidden
            ),
        )
        f_in = hidden
    rows = float(batch) * parents
    head_in = 2 * hidden + pair_feat_dim
    stage(
        "emb_gather",
        0.0,
        compute_bytes * (batch * hidden + rows * hidden),
    )
    stage(
        "score_head",
        2.0 * rows * (head_in * hidden + hidden * (hidden // 2) + (hidden // 2)),
        compute_bytes * (
            rows * (head_in + hidden + hidden // 2 + 1)
            + head_in * hidden + hidden * (hidden // 2) + hidden // 2
        ),
    )

    fwd_flops = sum(s["gflops"] for s in stages) * 1e9
    fwd_time = sum(s["time_us_lb"] for s in stages) / 1e6
    step_flops = 3.0 * fwd_flops          # fwd + ~2x fwd backward
    step_time_lb = 3.0 * fwd_time
    ceiling = 100.0 * step_flops / (peak_flops * max(step_time_lb, 1e-12))
    mem_stages = [s["stage"] for s in stages if s["bound"] == "memory"]
    out = {
        "peak_tflops": peak_flops / 1e12,
        "hbm_gbps": hbm_bytes_per_s / 1e9,
        "ridge_flops_per_byte": round(ridge, 1),
        "stages": stages,
        "step_gflops": round(step_flops / 1e9, 2),
        "step_time_us_lb": round(step_time_lb * 1e6, 2),
        "mfu_ceiling_pct": round(ceiling, 1),
        "memory_bound_stages": mem_stages,
        "method": (
            "per-stage max(flops/peak, bytes/bw), summed (no overlap "
            "credit); bwd = 2x fwd; elementwise/optimizer unmodeled, so "
            "achieved MFU must land BELOW the ceiling"
        ),
    }
    # the dominant memory-bound stage by its bound, not by stage order
    dominant = max(
        (s for s in stages if s["bound"] == "memory"),
        key=lambda s: s["time_us_lb"],
        default=stages[0],
    )
    out["statement"] = (
        f"matmul roofline ceiling {out['mfu_ceiling_pct']}% MFU at this "
        f"shape (ridge {out['ridge_flops_per_byte']} FLOPs/B): "
        f"{len(mem_stages)}/{len(stages)} stages memory-bound, led by "
        f"{dominant['stage']} (AI ~{dominant['ai_flops_per_byte']}); "
        "the scatter/segment_sum serving path is pure bandwidth (AI ~0)"
    )
    return out


def analytic_mlp_flops_per_sample(
    feat_dim: int, hidden: int, num_layers: int = 3
) -> float:
    """Matmul-only FLOP floor per trained sample for ProbeRTTRegressor
    ((num_layers-1) hidden Dense + 1 output Dense; fwd + bwd ~ 3x fwd)."""
    fwd = 2.0 * feat_dim * hidden
    fwd += max(num_layers - 2, 0) * 2.0 * hidden * hidden
    fwd += 2.0 * hidden
    return 3.0 * fwd


def analytic_attention_flops_per_sample(
    token_feat_dim: int,
    hidden: int,
    parents: int,
    num_layers: int = 2,
) -> float:
    """Matmul-only FLOP lower bound per trained sample for one
    AttentionRanker train step (embed Dense, per block qkv/attention/proj
    + 4x FFN, score head; fwd + bwd ~ 3x fwd). Each sample is one row of P
    candidate tokens."""
    p, h = float(parents), float(hidden)
    fwd = 2.0 * p * token_feat_dim * h                      # embed
    per_block = (
        2.0 * p * h * 3 * h        # qkv
        + 4.0 * p * p * h          # scores + weighted sum (2 matmuls)
        + 2.0 * p * h * h          # proj
        + 2.0 * p * h * 4 * h      # mlp_up
        + 2.0 * p * 4 * h * h      # mlp_down
    )
    fwd += num_layers * per_block
    fwd += 2.0 * p * h             # score head
    return 3.0 * fwd


def _peak_rate(epoch_samples: list, epoch_secs: list) -> float:
    """Best timed block's samples/s, first block excluded when more than
    one ran."""
    rates = [s / max(t, 1e-9) for s, t in zip(epoch_samples, epoch_secs)]
    if not rates:
        return 0.0
    return max(rates[1:] if len(rates) > 1 else rates)


def _steady_state_throughput(epoch_samples: list, epoch_secs: list) -> tuple:
    """(samples, seconds) for the throughput metric: with 2+ timed blocks
    the first (which carries the warm-up: kernel loads, allocator growth)
    is excluded."""
    if len(epoch_secs) > 1:
        return sum(epoch_samples[1:]), max(sum(epoch_secs[1:]), 1e-9)
    return sum(epoch_samples), max(sum(epoch_secs), 1e-9)


def _train_eval_split(perm, eval_fraction: float):
    """Shuffled (eval_idx, train_idx). The eval split is capped so at least
    one training sample remains; n == 1 trains and evals on the row."""
    n = len(perm)
    if n == 0:
        raise ValueError("cannot train on an empty dataset")
    n_eval = min(max(1, int(n * eval_fraction)), max(n - 1, 1))
    eval_idx, train_idx = perm[:n_eval], perm[n_eval:]
    if len(train_idx) == 0:
        train_idx = eval_idx
    return eval_idx, train_idx


def _pair_feats(ds: RankingDataset, idx: np.ndarray) -> np.ndarray:
    """(B, P, 2) pair features: same IDC and location match."""
    return np.concatenate(
        [ds.same_idc[idx, :, None], ds.loc_match[idx, :, None]], axis=-1
    ).astype(np.float32)


def take(ds: RankingDataset, idx: np.ndarray) -> dict[str, np.ndarray]:
    """The attention ranker's inputs and the loss's labels for rows ``idx``."""
    return {
        "child": ds.child[idx],
        "parents": ds.parents[idx],
        "pair": _pair_feats(ds, idx),
        "mask": ds.mask[idx],
        "throughput": ds.throughput[idx],
    }


def _take_rank_batch(ds: RankingDataset, idx: np.ndarray) -> RankBatch:
    return RankBatch(
        child_idx=ds.child_host_idx[idx],
        parent_idx=ds.parent_host_idx[idx],
        pair_feats=_pair_feats(ds, idx),
        throughput=ds.throughput[idx],
        mask=ds.mask[idx],
    )


def _subset_rank_dataset(ds: RankingDataset, idx: np.ndarray) -> RankingDataset:
    return RankingDataset(
        child=ds.child[idx],
        parents=ds.parents[idx],
        same_idc=ds.same_idc[idx],
        loc_match=ds.loc_match[idx],
        mask=ds.mask[idx],
        throughput=ds.throughput[idx],
        child_host_idx=ds.child_host_idx[idx],
        parent_host_idx=ds.parent_host_idx[idx],
    )


def _rank_rows(batch: RankBatch) -> dict[str, np.ndarray]:
    return {field.name: getattr(batch, field.name) for field in dataclasses.fields(batch)}


def _stack(batches: list[dict]) -> dict[str, np.ndarray]:
    """Same-shape batches -> one dict with a leading [S] dim."""
    return {key: np.stack([b[key] for b in batches]) for key in batches[0]}


def adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """optax.adamw(learning_rate) with its defaults: betas (0.9, 0.999),
    eps 1e-8, weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def _initialised(model, seed: int, params: dict | None, device):
    """``model`` with weights from a flax params tree when given, else drawn
    from ``seed`` on the CPU (so every device starts from the same
    weights), on ``device``."""
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params_from_flax(params))
    return model.to(device)


def build_ranker(
    config: TrainerConfig, in_features: int, seed: int, params: dict | None, device
) -> AttentionRanker:
    """The ranker of ``train_attention`` on ``device`` (its MLPs MoEs when
    ``config.attention_moe_experts`` > 0)."""
    return _initialised(AttentionRanker(
        hidden_dim=config.hidden_dim,
        num_layers=config.attention_num_layers,
        moe_experts=config.attention_moe_experts,
        in_features=in_features,
    ), seed, params, device)


def build_pp_ranker(config: TrainerConfig, stages: int, in_features: int, seed: int,
                    params: dict | None, device) -> PipelineRanker:
    """``train_attention``'s pipeline-parallel ranker on ``device``: one
    block a stage, whatever ``config.attention_num_layers`` says, as in the
    reference; bf16."""
    return _initialised(PipelineRanker(
        config.hidden_dim, stages, config.attention_pp_microbatches, in_features=in_features,
    ), seed, params, device)


def build_graphsage(config: TrainerConfig, graph: HostGraph, seed: int, params: dict | None,
                    device) -> GraphSAGERanker:
    """The ranker of ``train_gnn`` on ``device``, its input widths the graph's."""
    return _initialised(GraphSAGERanker(
        hidden_dim=config.hidden_dim,
        in_features=graph.node_feats.shape[1],
        edge_features=graph.edge_feats.shape[1],
    ), seed, params, device)


def build_regressor(config: TrainerConfig, in_features: int, seed: int, params: dict | None,
                    device) -> ProbeRTTRegressor:
    """The regressor of ``train_mlp`` on ``device``."""
    return _initialised(ProbeRTTRegressor(hidden_dim=config.hidden_dim, in_features=in_features),
                        seed, params, device)


def _on_device(arrays: dict, device) -> dict[str, torch.Tensor]:
    return {key: torch.from_numpy(np.ascontiguousarray(value)).to(device)
            for key, value in (arrays or {}).items()}


class Trainer:
    """One module, its AdamW state and, when given, its training rows on
    one device. ``step`` runs a train step on the rows at ``idx`` (positions
    into those rows), ``step_batch`` on a batch already on the device; both
    return the loss on the device, unread. A subclass gives the loss of a
    batch as a sum and a count (``batch_terms``). Given ``group``, the
    processes of a mesh across processes, a step divides the sum by every
    process's count and all-reduces the gradients and the loss."""

    def __init__(self, model: torch.nn.Module, rows: dict[str, np.ndarray] | None,
                 learning_rate: float, device, group=None):
        self.model = model
        self.device = torch.device(device)
        self.rows = _on_device(rows, self.device)
        self.optimizer = adamw(model.parameters(), learning_rate)
        self.group = group

    def batch_terms(self, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def batch_loss(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        total, count = self.batch_terms(batch)
        return total / count.clamp_min(1)

    def loss(self, idx: torch.Tensor) -> torch.Tensor:
        return self.batch_loss({key: value[idx] for key, value in self.rows.items()})

    def _apply(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        if self.group is None:
            loss = self.batch_loss(batch)
            loss.backward()
        else:
            total, count = self.batch_terms(batch)
            loss = total / self._all_reduce(count.detach()).clamp_min(1)
            loss.backward()
            loss = self._all_reduce_grads(loss.detach())
        self.optimizer.step()
        return loss.detach()

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group (gloo reduces host copies)."""
        dist = torch.distributed
        with _costcard.uncounted():
            buf = t.cpu().clone() if dist.get_backend(self.group) == "gloo" else t.clone()
            dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def _all_reduce_grads(self, loss: torch.Tensor) -> torch.Tensor:
        """Every parameter's gradient summed over the group, with the loss,
        in one all-reduce; returns the summed loss."""
        params = list(self.model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = self._all_reduce(torch.cat([g.reshape(-1).float() for g in grads]
                                          + [loss.reshape(1).float()]))
        start = 0
        for p in params:
            p.grad = flat[start:start + p.numel()].view_as(p).to(p.dtype)
            start += p.numel()
        return flat[-1].to(loss.dtype)

    def step(self, idx: torch.Tensor) -> torch.Tensor:
        return self._apply({key: value[idx] for key, value in self.rows.items()})

    def step_batch(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        return self._apply(batch)

    # ---------------------------------------------------- checkpoint state

    def opt_state(self) -> dict:
        """The AdamW state as a tree of numpy leaves keyed by parameter
        name: ``{name: {"step", "exp_avg", "exp_avg_sq"}}`` (empty before
        the first step)."""
        names = {id(p): name for name, p in self.model.named_parameters()}
        return {
            names[id(p)]: {key: value.detach().cpu().numpy() for key, value in state.items()}
            for p, state in self.optimizer.state.items()
        }

    def load(self, params: dict, opt_state: dict) -> None:
        """Weights from a flax params tree and the AdamW state from
        ``opt_state``'s tree, as a checkpoint holds them."""
        self.model.load_state_dict(params_from_flax(params))
        index = {name: i for i, (name, _) in enumerate(self.model.named_parameters())}
        state = self.optimizer.state_dict()
        state["state"] = {
            index[name]: {key: torch.from_numpy(np.array(value)) for key, value in leaves.items()}
            for name, leaves in opt_state.items()
        }
        self.optimizer.load_state_dict(state)


class AttentionTrainer(Trainer):
    """The attention ranker, trained through ``attention_fn`` (and, given
    ``tp_attention_fns``, tensor-parallel over ``mesh``'s tp axis); the
    model reads ``mesh`` for its MoE and its pipeline."""

    def __init__(self, model: AttentionRanker | PipelineRanker,
                 rows: dict[str, np.ndarray] | None, learning_rate: float, device,
                 attention_fn=flash_attention, mesh=None, tp_attention_fns=None, group=None):
        super().__init__(model, rows, learning_rate, device, group)
        self.attention_fn = attention_fn
        self.mesh = mesh
        self.tp_attention_fns = tp_attention_fns

    def batch_terms(self, batch: dict[str, torch.Tensor]):
        scores = self.model(batch["child"], batch["parents"], batch["pair"], batch["mask"],
                            attention_fn=self.attention_fn, mesh=self.mesh,
                            tp_attention_fns=self.tp_attention_fns)
        return listwise_rank_terms(scores, batch["throughput"], batch["mask"])


def graph_on_device(garrs: dict, device, compute_dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The graph arrays on ``device`` once; the dense path's adjacency in
    the model's compute dtype (the cast every layer would make anyway)."""
    graph = _on_device(garrs, device)
    if "adj" in graph:
        graph["adj"] = graph["adj"].to(compute_dtype)
    return graph


class GNNTrainer(Trainer):
    """The GraphSAGE ranker over one graph on the device: every step embeds
    the whole graph and scores its batch's (child, parents) rows."""

    def __init__(self, model: GraphSAGERanker, rows: dict[str, np.ndarray] | None,
                 garrs: dict, learning_rate: float, device, group=None):
        super().__init__(model, rows, learning_rate, device, group)
        self.graph = graph_on_device(garrs, self.device, model.compute_dtype)

    def batch_terms(self, batch: dict[str, torch.Tensor]):
        scores = self.model(self.graph, batch["child_idx"], batch["parent_idx"], batch["pair_feats"])
        return listwise_rank_terms(scores, batch["throughput"], batch["mask"])


class MLPTrainer(Trainer):
    """The probe-RTT regressor under the reference's weighted MSE."""

    def batch_terms(self, batch: dict[str, torch.Tensor]):
        err = (self.model(batch["x"]) - batch["y"]) ** 2
        return (err * batch["w"]).sum(), batch["w"].sum()


def attention_fns(mesh, sp_strategy: str):
    """(training attention, eval attention) of the ranker. Without a mesh,
    or with sp = 1, both are ``flash_attention``. At sp > 1 the strategy's
    sharded attention: the ring trains through its einsum path and
    evaluates through the partial kernel (``use_flash=True``); Ulysses
    runs ``flash_attention`` on each head group either way."""
    if mesh is None or mesh.shape[SP_AXIS] == 1:
        return flash_attention, flash_attention
    if sp_strategy == "ring":
        return (functools.partial(sharded_ring_attention, mesh),
                functools.partial(sharded_ring_attention, mesh, use_flash=True))
    ulysses = functools.partial(sharded_ulysses_attention, mesh)
    return ulysses, ulysses


def epoch_batches(ds: RankingDataset, train_idx: np.ndarray, batch_size: int,
                  rng: np.random.Generator) -> dict[str, np.ndarray]:
    """One epoch of the ranker's mesh-path batches as the reference's
    ``make_epoch_batches`` draws them (train.py:862-867): a new permutation
    of the training rows, full batches only, stacked [steps, batch, ...]."""
    order = rng.permutation(len(train_idx))
    starts = range(0, len(order) - batch_size + 1, batch_size)
    idx = np.stack([train_idx[order[s:s + batch_size]] for s in starts])
    return take(ds, idx)


def tp_attention_fns(mesh, sp_strategy: str):
    """(training, eval) attention of each tp shard of the ranker's tensor-
    parallel blocks: ``attention_fns`` over the shard's own (dp, sp)
    sub-mesh."""
    fns = [attention_fns(mesh.slice(TP_AXIS, j), sp_strategy) for j in range(mesh.shape[TP_AXIS])]
    return [f[0] for f in fns], [f[1] for f in fns]


def eval_scores(model: AttentionRanker | PipelineRanker, rows: dict[str, np.ndarray],
                attention_fn=flash_attention, mesh=None, tp_attention_fns=None) -> torch.Tensor:
    """The ranker's scores of ``rows`` under inference mode, on the model's
    device. On a mesh the rows are padded with zero (masked-out) rows to a
    multiple of the global dp (every process's) and the scores sliced
    back, as the reference pads its eval batch (train.py:877-892)."""
    n_real = rows["mask"].shape[0]
    if mesh is not None:
        pad = (-n_real) % (mesh.dcn * mesh.shape[DP_AXIS])
        rows = {
            key: np.concatenate([value, np.zeros((pad,) + value.shape[1:], value.dtype)])
            for key, value in rows.items()
        }
    device = next(model.parameters()).device
    with torch.inference_mode():
        scores = model(
            *(torch.from_numpy(rows[key]).to(device) for key in ("child", "parents", "pair", "mask")),
            attention_fn=attention_fn, mesh=mesh, tp_attention_fns=tp_attention_fns,
        )
    return scores[:n_real]


def _check_supported(sp_strategy: str) -> None:
    # validated even without a mesh, so a typo fails on one device too
    if sp_strategy not in SP_STRATEGIES:
        raise ValueError(f"unknown sp_strategy {sp_strategy!r}")


def _group(mesh):
    """The process group a mesh's dp axis spans, or None."""
    return None if mesh is None else mesh.group


def _train_device(mesh, device) -> torch.device:
    """The device the model trains on: the mesh's first device on a mesh
    (``device``, if given, must agree), else ``device`` (CUDA by default)."""
    if mesh is None:
        return resolve_device(device)
    dev = mesh.first_device
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} disagrees with the mesh's first device {dev}")
    return resolve_device(dev)  # a CUDA mesh without CUDA raises


def _resume_hooks(checkpointer, trainer: Trainer):
    """(start_epoch, on_epoch) for checkpoint resume (training/checkpoint.py;
    the reference's train.py:512-531): restore the newest step that loads
    into ``trainer`` if one exists, and save after every timed block."""
    if checkpointer is None:
        return 0, None
    saved = checkpointer.restore(
        template={"params": params_to_flax(trainer.model), "opt_state": None, "epoch": 0}
    )
    start_epoch = 0
    if saved is not None:
        trainer.load(saved["params"], saved["opt_state"])
        start_epoch = int(np.asarray(saved["epoch"])) + 1

    def on_epoch(e: int) -> None:
        checkpointer.save(e, {"params": params_to_flax(trainer.model),
                              "opt_state": trainer.opt_state(), "epoch": e})

    return start_epoch, on_epoch


class TrainingAborted(RuntimeError):
    """A training stopped at a step boundary because its ``stop`` event
    was set (the trainer process's SIGTERM, rpc/server.py
    TrainerRPCServer.stop); nothing is published."""


def _check_stop(stop) -> None:
    if stop is not None and stop.is_set():
        raise TrainingAborted("training aborted: the trainer is stopping")


def _register_card(entry: str, trainer, batches, step, stop=None):
    """The trainer's one-shot cost card (the reference's ``_epoch_flops``,
    train.py:305-336, which hands the lowering it already pays for to the
    ledger and runs before the timed block): where this process holds no
    card for ``entry`` at this (model, ``batches``) signature, ``step()``,
    the block's first step, runs under the counting mode
    (telemetry/costcard.py), and the card holds as many such steps as
    ``batches`` stacks. The count rides the real step, so it launches
    nothing extra; the caller times the block from the step after it.
    Returns the step's loss, already read, or None where the card was
    there (the step has not run)."""
    rep = _costcard._sig_repr((trainer.model, batches))
    if _costcard.ledger().card(entry, _costcard._signature(rep)) is not None:
        return None
    _check_stop(stop)
    with _costcard.counting() as count:
        loss = step()
    steps = next(iter(batches.values())).shape[0] if isinstance(batches, dict) else batches.shape[0]
    _costcard.ledger().register_count(entry, count.scaled(steps), signature_repr=rep)
    return float(loss)  # waits for the counted step, so none of it lands in the timing


def _run_epoch_indexed(trainer, idx: torch.Tensor, stop=None, start: int = 0):
    """One block of fused epochs over the device-resident rows (the
    reference's scanned ``run_epoch``, train.py:381-406): a step for each
    [B] row of ``idx`` [S, B] from row ``start`` (1 where the cost-card
    registration took row 0). Returns the stacked losses, unread."""
    losses = []
    for s in range(start, idx.shape[0]):
        _check_stop(stop)
        losses.append(trainer.step(idx[s]))
    return torch.stack(losses)


def _run_epoch(trainer, stack: dict, stop=None, start: int = 0):
    """One epoch of the mesh path over the host-built, sharded batches
    ``stack`` ({name: [steps, batch, ...]}; the reference's scanned
    ``run_epoch``, train.py:350-373), from step ``start`` as in
    _run_epoch_indexed. Returns the stacked losses, unread."""
    losses = []
    for s in range(start, next(iter(stack.values())).shape[0]):
        _check_stop(stop)
        losses.append(trainer.step_batch({key: value[s] for key, value in stack.items()}))
    return torch.stack(losses)


# the epoch entries under the reference's flight-recorder names (its
# instrument_jit wrappers at train.py:373,406): call counters; the cost
# card comes from the one-shot registration, not from a replay
_run_epoch_indexed = instrument_entry(_run_epoch_indexed, "trainer.epoch_indexed",
                                      service="trainer")
_run_epoch = instrument_entry(_run_epoch, "trainer.epoch", service="trainer")


def _index_epochs(trainer, n_train, batch_size, epochs, epoch_fusion, rng, dev,
                  start_epoch=0, on_epoch=None, stop=None):
    """The single-device epochs from ``start_epoch``: index batches into the
    device-resident rows, in timed blocks of ``fusion`` epochs (the fusion
    normalised to a divisor of the epochs left, as the reference's
    train.py:431-434 does); each block's losses are read once, then
    ``on_epoch(last epoch of the block)`` runs. A set ``stop`` event
    raises TrainingAborted before the next step (a host check, no device
    wait). The first block of more than one step registers the epoch's
    cost card with its first step, which the block's time and samples
    leave out (a block of one step would leave nothing to time). Returns
    (losses, samples per block, seconds per block)."""
    span = max(epochs - start_epoch, 1)
    fusion = max(min(int(epoch_fusion), span), 1)
    while span % fusion:
        fusion -= 1
    losses: list[float] = []
    block_samples, block_secs = [], []
    register = True
    e = start_epoch
    while e < epochs:
        k = min(fusion, epochs - e)
        idx = np.concatenate(
            [np.stack(list(D.minibatches(n_train, batch_size, rng))) for _ in range(k)]
        )
        idx_dev = torch.from_numpy(idx).to(dev)
        first = None
        if register and idx.shape[0] > 1:
            register = False
            first = _register_card("trainer.trainer.epoch_indexed", trainer, idx_dev,
                                   lambda: trainer.step(idx_dev[0]), stop)
        start = 0 if first is None else 1
        t0 = time.perf_counter()
        stacked = _run_epoch_indexed(trainer, idx_dev, stop, start)
        block = stacked.cpu().numpy()  # the one read per block
        block_secs.append(time.perf_counter() - t0)
        block_samples.append(idx[start:].size)
        if first is not None:
            losses.append(first)
        losses.extend(float(v) for v in block.astype(np.float64))
        e += k
        if on_epoch is not None:
            on_epoch(e - 1)
    return losses, block_samples, block_secs


def _stacked_epochs(trainer, mesh, epochs, batch_size, make_epoch_batches,
                    start_epoch=0, on_epoch=None, stop=None):
    """The mesh path's epochs from ``start_epoch`` (the reference's
    ``_stacked_epochs``, train.py:475-509): per epoch, the host batches from
    ``make_epoch_batches()`` (a dict stacked [steps, batch, ...]) placed by
    ``shard_stacked_batches`` (batch padded to a multiple of dp), then one
    step a batch, timed from the first step to the epoch's one loss read,
    then ``on_epoch(epoch)``; ``stop`` and the cost card as in
    _index_epochs. Returns (losses, samples per epoch, seconds per
    epoch)."""
    losses: list[float] = []
    epoch_samples, epoch_secs = [], []
    register = True
    for e in range(start_epoch, epochs):
        stack = shard_stacked_batches(mesh, make_epoch_batches())
        steps = next(iter(stack.values())).shape[0]
        first = None
        if register and steps > 1:
            register = False
            first = _register_card(
                "trainer.trainer.epoch", trainer, stack,
                lambda: trainer.step_batch({key: value[0] for key, value in stack.items()}),
                stop)
        start = 0 if first is None else 1
        t0 = time.perf_counter()
        stacked = _run_epoch(trainer, stack, stop, start)
        ep_losses = stacked.cpu().numpy()  # the one read per epoch
        epoch_secs.append(time.perf_counter() - t0)
        epoch_samples.append((steps - start) * batch_size)
        if first is not None:
            losses.append(first)
        losses.extend(float(v) for v in ep_losses.astype(np.float64))
        if on_epoch is not None:
            on_epoch(e)
    return losses, epoch_samples, epoch_secs


def _result(params: dict, losses, block_samples, block_secs, eval_metrics,
            analytic: float) -> TrainResult:
    n_samples, dt = _steady_state_throughput(block_samples, block_secs)
    return TrainResult(
        params=params,
        losses=losses,
        eval_metrics=eval_metrics,
        samples_per_sec=n_samples / max(dt, 1e-9),
        steps=len(losses),
        peak_samples_per_sec=_peak_rate(block_samples, block_secs),
        analytic_flops_per_sample=analytic,
    )


def train_mlp(
    x: np.ndarray,
    y: np.ndarray,
    config: TrainerConfig | None = None,
    mesh=None,
    seed: int = 0,
    eval_fraction: float = 0.2,
    checkpointer=None,
    device: str | torch.device | None = None,
    params: dict | None = None,
    stop=None,
) -> TrainResult:
    """Train the probe-RTT regressor under a weighted MSE; returns the flax
    params and the MSE and MAE on held-out pairs (the registry's
    evaluation fields). On one device (CUDA unless ``device="cpu"``) or on
    a mesh's first device, the batch order the reference's either way."""
    config = config or TrainerConfig()
    dev = _train_device(mesh, device)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(x.shape[0])
    eval_idx, train_idx = _train_eval_split(perm, eval_fraction)
    model = build_regressor(config, x.shape[1], seed, params, dev)
    batch_size = min(config.batch_size, len(train_idx))
    rows = {"x": x[train_idx], "y": y[train_idx], "w": np.ones(len(train_idx), np.float32)}
    trainer = MLPTrainer(model, rows if mesh is None else None, config.learning_rate, dev,
                         _group(mesh))
    start_epoch, on_epoch = _resume_hooks(checkpointer, trainer)

    model.train()
    if mesh is None:
        losses, block_samples, block_secs = _index_epochs(
            trainer, len(train_idx), batch_size, config.epochs, config.epoch_fusion, rng, dev,
            start_epoch, on_epoch, stop,
        )
    else:
        def make_epoch_batches():
            return _stack([{key: value[idx] for key, value in rows.items()}
                           for idx in D.minibatches(len(train_idx), batch_size, rng)])

        losses, block_samples, block_secs = _stacked_epochs(
            trainer, mesh, config.epochs, batch_size, make_epoch_batches, start_epoch, on_epoch,
            stop,
        )

    model.eval()
    with torch.inference_mode():
        pred = model(torch.from_numpy(np.ascontiguousarray(x[eval_idx])).to(dev))
    eval_metrics = M.regression_report(pred.float().cpu(), torch.from_numpy(y[eval_idx]))
    return _result(params_to_flax(model), losses, block_samples, block_secs, eval_metrics,
                   analytic_mlp_flops_per_sample(x.shape[1], config.hidden_dim, model.num_layers))


def gnn_graph_arrays(graph: HostGraph, mesh=None) -> tuple[dict, bool]:
    """(graph arrays, dense) as ``train_gnn`` takes them (train.py:669-673):
    the dense adjacency without a mesh when the graph has at most
    ``D.DENSE_ADJ_MAX_NODES`` nodes, else the segment arrays with edges
    padded to ``D.edge_bucket``."""
    dense = mesh is None and graph.node_feats.shape[0] <= D.DENSE_ADJ_MAX_NODES
    if dense:
        return D.dense_graph_arrays(graph), True
    return D.graph_arrays(graph, pad_edges_to=D.edge_bucket(graph.edge_src.shape[0])), False


def train_gnn(
    ds: RankingDataset,
    graph: HostGraph,
    config: TrainerConfig | None = None,
    mesh=None,
    seed: int = 0,
    eval_fraction: float = 0.2,
    checkpointer=None,
    device: str | torch.device | None = None,
    params: dict | None = None,
    stop=None,
) -> TrainResult:
    """Train the GraphSAGE parent ranker under the listwise loss over the
    whole graph's embedding, recomputed every step; eval = precision,
    recall and F1 of its top-1 parent picks on held-out downloads. On one
    device (CUDA unless ``device="cpu"``) or on a mesh's first device, the
    split and the batch order the reference's either way."""
    config = config or TrainerConfig()
    dev = _train_device(mesh, device)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.child.shape[0])
    eval_idx, train_idx = _train_eval_split(perm, eval_fraction)
    garrs, dense = gnn_graph_arrays(graph, mesh)
    model = build_graphsage(config, graph, seed, params, dev)
    batch_size = min(config.batch_size, len(train_idx))
    rows = _rank_rows(_take_rank_batch(ds, train_idx)) if mesh is None else None
    trainer = GNNTrainer(model, rows, garrs, config.learning_rate, dev, _group(mesh))
    start_epoch, on_epoch = _resume_hooks(checkpointer, trainer)

    model.train()
    if mesh is None:
        losses, block_samples, block_secs = _index_epochs(
            trainer, len(train_idx), batch_size, config.epochs, config.epoch_fusion, rng, dev,
            start_epoch, on_epoch, stop,
        )
    else:
        sub = _subset_rank_dataset(ds, train_idx)
        losses, block_samples, block_secs = _stacked_epochs(
            trainer, mesh, config.epochs, batch_size,
            lambda: _stack([_rank_rows(b) for b in D.rank_batches(sub, batch_size, rng)]),
            start_epoch, on_epoch, stop,
        )

    eb = _rank_rows(_take_rank_batch(ds, eval_idx))
    model.eval()
    with torch.inference_mode():
        e = _on_device(eb, dev)
        scores = model(trainer.graph, e["child_idx"], e["parent_idx"], e["pair_feats"])
    stats = M.top1_selection_stats(scores.float().cpu(), torch.from_numpy(eb["throughput"]),
                                   torch.from_numpy(eb["mask"]))
    analytic = analytic_gnn_flops_per_sample(
        n_nodes=graph.node_feats.shape[0],
        node_feat_dim=graph.node_feats.shape[1],
        edge_feat_dim=graph.edge_feats.shape[1],
        hidden=config.hidden_dim,
        batch=batch_size,
        parents=eb["parent_idx"].shape[1],
        pair_feat_dim=eb["pair_feats"].shape[-1],
        num_layers=model.num_layers,
        dense_adj=dense,
    )
    return _result(params_to_flax(model), losses, block_samples, block_secs,
                   {key: float(value) for key, value in stats.items()}, analytic)


def train_attention(
    ds: RankingDataset,
    config: TrainerConfig | None = None,
    mesh=None,
    seed: int = 0,
    eval_fraction: float = 0.2,
    checkpointer=None,
    sp_strategy: str | None = None,
    device: str | torch.device | None = None,
    params: dict | None = None,
    stop=None,
) -> TrainResult:
    """Train the set-transformer parent ranker and evaluate its top-1 picks
    on a held-out split: on one device (CUDA unless ``device="cpu"``), or
    on a mesh (parallel/mesh.py ``make_mesh``), the model on the mesh's
    first device. Every parallelism axis turns on from the config and the
    mesh alone, as in the reference:

    - sp > 1: ring attention or Ulysses per ``sp_strategy`` (default
      ``config.sp_strategy``);
    - tp > 1 and ``config.attention_tp`` (not with pp): the blocks run
      tensor-parallel, each tp shard's head group through its own
      sub-mesh's attention;
    - ``config.attention_moe_experts`` > 0: top-1 MoE MLPs, over the ep
      axis's all_to_alls when ep > 1, the exact ``moe_reference`` without;
    - pp > 1 and ``config.attention_pp``: the deep ``PipelineRanker``, one
      block a pp stage over ``config.attention_pp_microbatches``
      microbatches; ``TrainResult.params`` is then the reference's
      ``{"embed", "blocks", "ln", "score"}`` tree.

    A mesh axis whose flag is off trains the plain model; a flag without a
    mesh is ignored. The split and the minibatch order come from
    ``np.random.default_rng(seed)`` exactly as in the reference. The
    initial weights are drawn from ``seed`` (``reset_parameters``), or
    carried across from a flax params tree ``params``; ``TrainResult.params``
    is the trained flax tree, which either package's registry can publish
    and serve."""
    config = config or TrainerConfig()
    sp_strategy = sp_strategy or config.sp_strategy
    _check_supported(sp_strategy)
    dev = _train_device(mesh, device)
    rng = np.random.default_rng(seed)
    n = ds.child.shape[0]
    perm = rng.permutation(n)
    eval_idx, train_idx = _train_eval_split(perm, eval_fraction)

    train_rows = take(ds, train_idx)
    in_features = sum(train_rows[key].shape[-1] for key in ("parents", "child", "pair"))
    use_pp = config.attention_pp and mesh is not None and mesh.shape[PP_AXIS] > 1
    use_tp = (config.attention_tp and mesh is not None and mesh.shape[TP_AXIS] > 1
              and not use_pp)
    tp_train = tp_eval = None
    if use_pp:
        # the reference's stages apply the block's default attention
        model = build_pp_ranker(config, mesh.shape[PP_AXIS], in_features, seed, params, dev)
        train_fn = eval_fn = flash_attention
    else:
        model = build_ranker(config, in_features, seed, params, dev)
        train_fn, eval_fn = attention_fns(mesh, sp_strategy)
        if use_tp:
            tp_train, tp_eval = tp_attention_fns(mesh, sp_strategy)
    batch_size = min(config.batch_size, len(train_idx))
    trainer = AttentionTrainer(model, train_rows if mesh is None else None,
                               config.learning_rate, dev, attention_fn=train_fn, mesh=mesh,
                               tp_attention_fns=tp_train, group=_group(mesh))
    start_epoch, on_epoch = _resume_hooks(checkpointer, trainer)

    model.train()
    if mesh is None:
        losses, block_samples, block_secs = _index_epochs(
            trainer, len(train_idx), batch_size, config.epochs, config.epoch_fusion, rng, dev,
            start_epoch, on_epoch, stop,
        )
    else:
        losses, block_samples, block_secs = _stacked_epochs(
            trainer, mesh, config.epochs, batch_size,
            lambda: epoch_batches(ds, train_idx, batch_size, rng), start_epoch, on_epoch,
            stop,
        )

    eb = take(ds, eval_idx)
    model.eval()
    scores = eval_scores(model, eb, eval_fn, mesh, tp_eval)
    stats = M.top1_selection_stats(
        scores.float().cpu(), torch.from_numpy(eb["throughput"]), torch.from_numpy(eb["mask"])
    )
    analytic = analytic_attention_flops_per_sample(
        token_feat_dim=eb["parents"].shape[-1] + eb["child"].shape[1] + eb["pair"].shape[-1],
        hidden=config.hidden_dim,
        parents=eb["parents"].shape[1],
        num_layers=config.attention_num_layers,
    )
    return _result(params_to_flax(model), losses, block_samples, block_secs,
                   {key: float(value) for key, value in stats.items()}, analytic)


def embed_graph_sharded(model: GraphSAGERanker, params: dict | None, graph_arrays: dict,
                        mesh) -> torch.Tensor:
    """Host embeddings with the EDGE set sharded across the mesh (the
    reference's train.py:1053): the edges, padded to a multiple of
    ``mesh.size`` with weight-0 pads, split into contiguous blocks over the
    dp x graph places (dp-major), block k on its device. Each layer, every
    block computes float32 segment sums (ops/segment.py) of its edges'
    messages, counts and edge features into full-size node accumulators;
    the partials are summed on the mesh's first device (the reference's
    psum over both axes), and the layer's products run there in the
    compute dtype. ``params`` is a flax tree, or None for ``model``'s own
    weights. ``graph_arrays`` holds numpy arrays or tensors
    (``training.data.graph_arrays``). Returns [nodes, hidden] on the first
    device."""
    dev = mesh.first_device
    if params is not None:
        model = GraphSAGERanker(model.hidden_dim, model.num_layers, model.compute_dtype,
                                model.layers()[0].neigh.in_features,
                                model.layers()[0].edge.in_features)
        model.load_state_dict(params_from_flax(params))
    model = model.to(dev)
    arrays = {key: torch.as_tensor(value).to(dev) for key, value in graph_arrays.items()}
    node_feats = arrays["node_feats"]
    n_nodes, dt = node_feats.shape[0], model.compute_dtype
    e = arrays["edge_src"].shape[0]
    pad = (-e) % mesh.size

    def padded(t):
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    edge_src, edge_dst = padded(arrays["edge_src"]), padded(arrays["edge_dst"])
    edge_feats = padded(arrays["edge_feats"].float())
    weight = padded(torch.ones(e, dtype=torch.float32, device=dev))[:, None]
    devices = [mesh.at(dp=i, graph=g)
               for i in range(mesh.shape[DP_AXIS]) for g in range(mesh.shape[GRAPH_AXIS])]
    size = edge_src.shape[0] // len(devices)
    blocks = [
        {key: t[k * size:(k + 1) * size].to(d)
         for key, t in (("src", edge_src), ("dst", edge_dst), ("feats", edge_feats),
                        ("w", weight))}
        for k, d in enumerate(devices)
    ]
    h = node_feats
    for layer in model.layers():
        h_c = h.to(dt)
        partials = []
        for block, d in zip(blocks, devices):
            h_d = h_c.to(d)
            w = block["w"]
            msgs = h_d[block["dst"].long()].float() * w
            partials.append(torch.cat([
                segment_sum(msgs, block["src"], n_nodes),
                segment_sum(w, block["src"], n_nodes),
                segment_sum(block["feats"] * w, block["src"], n_nodes),
            ], dim=-1))
        total = sum_to(partials, dev)
        width = h_c.shape[-1]
        agg, cnt, e_agg = total.split([width, 1, total.shape[-1] - width - 1], dim=-1)
        cnt = cnt.clamp_min(1.0)
        out = (getattr(layer, "self")(h_c) + layer.neigh((agg / cnt).to(dt))
               + layer.edge((e_agg / cnt).to(dt)))
        h = F.gelu(out, approximate="tanh")
    return h
