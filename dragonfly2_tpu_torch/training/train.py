"""Training of the attention parent ranker, in PyTorch.

Port of the attention family of dragonfly2_tpu/training/train.py:
``train_attention`` (train.py:746-914) on one device and on a dp x sp mesh,
with ``TrainResult``, ``flops_basis``, ``analytic_attention_flops_per_sample``
and the split/throughput helpers it uses. The model is
models/attention.py's ``AttentionRanker``.

- One device (``mesh=None``): attention through ops/flash.py, on CUDA the
  forward-with-lse kernel and the dK/dV and dQ backward kernels, on the CPU
  their plain versions. As in the reference's ``_make_epoch_indexed`` path,
  the training rows live on the device once and each step gathers its
  batch by index there.
- A mesh (parallel/mesh.py) with sp > 1: attention through ring attention
  or Ulysses over the mesh's sp shards (``sp_strategy``), the rest of the
  model on the mesh's first device. The training steps take the ring's
  einsum path, as the reference does (the partials have no gradient); the
  no-grad eval forward takes the ring's flash path, the partial kernel.
  Batches follow the reference's ``_stacked_epochs`` step for step: a new
  permutation each epoch, full batches only, padded to a multiple of dp.
  Only the attention is sharded, so a dp-only mesh (sp = 1) computes on
  its first device alone: it takes the mesh path for the reference's batch
  order and nothing else.

Either way the host reads each epoch's losses once, and the throughput is
timed against that read. The optimizer is AdamW with optax's ``adamw``
defaults, not torch's (weight decay 1e-4, not 1e-2). ``train_mlp``,
``train_gnn``, checkpoint resume, tensor/pipeline/expert parallelism and
the MoE scorer are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from dragonfly2_tpu_torch.config.config import TrainerConfig
from dragonfly2_tpu_torch.device import resolve_device
from dragonfly2_tpu_torch.models import metrics as M
from dragonfly2_tpu_torch.models.attention import AttentionRanker
from dragonfly2_tpu_torch.models.convert import (
    attention_params_from_flax,
    attention_params_to_flax,
)
from dragonfly2_tpu_torch.models.graphsage import listwise_rank_loss
from dragonfly2_tpu_torch.ops.flash import flash_attention
from dragonfly2_tpu_torch.parallel.mesh import (
    DP_AXIS,
    EP_AXIS,
    PP_AXIS,
    SP_AXIS,
    TP_AXIS,
    shard_stacked_batches,
)
from dragonfly2_tpu_torch.parallel.ring import sharded_ring_attention
from dragonfly2_tpu_torch.parallel.ulysses import sharded_ulysses_attention
from dragonfly2_tpu_torch.records.features import RankingDataset
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
    # to the analytic floor
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
    """The model's inputs and the loss's labels for rows ``idx``."""
    return {
        "child": ds.child[idx],
        "parents": ds.parents[idx],
        "pair": _pair_feats(ds, idx),
        "mask": ds.mask[idx],
        "throughput": ds.throughput[idx],
    }


def adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """optax.adamw(learning_rate) with its defaults: betas (0.9, 0.999),
    eps 1e-8, weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def build_ranker(
    config: TrainerConfig, in_features: int, seed: int, params: dict | None, device
) -> AttentionRanker:
    """The ranker of ``train_attention`` on ``device``: weights from a flax
    params tree when given, else drawn from ``seed`` on the CPU (so every
    device starts from the same weights)."""
    model = AttentionRanker(
        hidden_dim=config.hidden_dim,
        num_layers=config.attention_num_layers,
        in_features=in_features,
    )
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(attention_params_from_flax(params))
    return model.to(device)


class AttentionTrainer:
    """One attention ranker, its AdamW state, the attention it trains
    through and, when given, its training rows on one device. ``step`` runs
    a train step on the rows at ``idx`` (positions into those rows),
    ``step_batch`` on a batch of model inputs and labels already on the
    device; both return the loss on the device, unread."""

    def __init__(self, model: AttentionRanker, rows: dict[str, np.ndarray] | None,
                 learning_rate: float, device, attention_fn=flash_attention):
        self.model = model
        self.device = torch.device(device)
        self.rows = {
            key: torch.from_numpy(np.ascontiguousarray(value)).to(self.device)
            for key, value in (rows or {}).items()
        }
        self.attention_fn = attention_fn
        self.optimizer = adamw(model.parameters(), learning_rate)

    def batch_loss(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        scores = self.model(batch["child"], batch["parents"], batch["pair"], batch["mask"],
                            attention_fn=self.attention_fn)
        return listwise_rank_loss(scores, batch["throughput"], batch["mask"])

    def loss(self, idx: torch.Tensor) -> torch.Tensor:
        return self.batch_loss({key: value[idx] for key, value in self.rows.items()})

    def _apply(self, loss: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def step(self, idx: torch.Tensor) -> torch.Tensor:
        return self._apply(self.loss(idx))

    def step_batch(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        return self._apply(self.batch_loss(batch))


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
    """One epoch of the mesh path's batches as the reference's
    ``make_epoch_batches`` draws them (train.py:862-867): a new permutation
    of the training rows, full batches only, stacked [steps, batch, ...]."""
    order = rng.permutation(len(train_idx))
    starts = range(0, len(order) - batch_size + 1, batch_size)
    idx = np.stack([train_idx[order[s:s + batch_size]] for s in starts])
    return take(ds, idx)


def eval_scores(model: AttentionRanker, rows: dict[str, np.ndarray],
                attention_fn=flash_attention, mesh=None) -> torch.Tensor:
    """The ranker's scores of ``rows`` under inference mode, on the model's
    device. On a mesh the rows are padded with zero (masked-out) rows to a
    multiple of dp and the scores sliced back, as the reference pads its
    eval batch (train.py:877-892)."""
    n_real = rows["mask"].shape[0]
    if mesh is not None:
        pad = (-n_real) % mesh.shape[DP_AXIS]
        rows = {
            key: np.concatenate([value, np.zeros((pad,) + value.shape[1:], value.dtype)])
            for key, value in rows.items()
        }
    device = next(model.parameters()).device
    with torch.inference_mode():
        scores = model(
            *(torch.from_numpy(rows[key]).to(device) for key in ("child", "parents", "pair", "mask")),
            attention_fn=attention_fn, mesh=mesh,
        )
    return scores[:n_real]


def _check_supported(config: TrainerConfig, mesh, checkpointer, sp_strategy: str) -> None:
    # validated even without a mesh, so a typo fails on one device too
    if sp_strategy not in SP_STRATEGIES:
        raise ValueError(f"unknown sp_strategy {sp_strategy!r}")
    if mesh is not None and any(mesh.shape[axis] > 1 for axis in (TP_AXIS, PP_AXIS, EP_AXIS)):
        raise NotImplementedError(
            f"train_attention over a mesh with tp, pp or ep > 1 ({mesh.shape}) is not "
            "ported yet: ROADMAP queue A12"
        )
    if checkpointer is not None:
        raise NotImplementedError(
            "checkpoint resume (training/checkpoint.py) is not ported yet: ROADMAP queue A8"
        )
    if config.attention_tp or config.attention_pp:
        raise NotImplementedError(
            "tensor and pipeline parallelism of the ranker are not ported yet: ROADMAP queue A12"
        )
    if config.attention_moe_experts > 0:
        raise NotImplementedError(
            "the mixture-of-experts scorer is not ported yet: ROADMAP queue A12"
        )


def _train_device(mesh, device) -> torch.device:
    """The device the model trains on: the mesh's first device on a mesh
    (``device``, if given, must agree), else ``device`` (CUDA by default)."""
    if mesh is None:
        return resolve_device(device)
    dev = mesh.first_device
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} disagrees with the mesh's first device {dev}")
    return resolve_device(dev)  # a CUDA mesh without CUDA raises


def _index_epochs(trainer, n_train, batch_size, epochs, epoch_fusion, rng, dev):
    """The single-device epochs: index batches into the device-resident rows,
    in timed blocks of ``fusion`` epochs (a divisor of the epoch count, as
    the reference's epoch fusion); each block's losses are read once.
    Returns (losses, samples per block, seconds per block)."""
    fusion = max(min(int(epoch_fusion), max(epochs, 1)), 1)
    while max(epochs, 1) % fusion:
        fusion -= 1
    losses: list[float] = []
    block_samples, block_secs = [], []
    for start in range(0, epochs, fusion):
        t0 = time.perf_counter()
        block_losses, samples = [], 0
        for _ in range(min(fusion, epochs - start)):
            idx = np.stack(list(D.minibatches(n_train, batch_size, rng)))
            idx_dev = torch.from_numpy(idx).to(dev)
            for s in range(idx.shape[0]):
                block_losses.append(trainer.step(idx_dev[s]))
            samples += idx.size
        block = torch.stack(block_losses).cpu().numpy()  # the one read per block
        block_secs.append(time.perf_counter() - t0)
        block_samples.append(samples)
        losses.extend(float(v) for v in block.astype(np.float64))
    return losses, block_samples, block_secs


def _stacked_epochs(trainer, mesh, epochs, batch_size, make_epoch_batches):
    """The mesh path's epochs (the reference's ``_stacked_epochs``,
    train.py:475-509): per epoch, the host batches from
    ``make_epoch_batches()`` stacked and placed by ``shard_stacked_batches``
    (batch padded to a multiple of dp), then one step a batch, timed from
    the first step to the epoch's one loss read. Returns (losses, samples
    per epoch, seconds per epoch)."""
    losses: list[float] = []
    epoch_samples, epoch_secs = [], []
    for _ in range(epochs):
        stack = shard_stacked_batches(mesh, make_epoch_batches())
        steps = stack["mask"].shape[0]
        t0 = time.perf_counter()
        ep = [trainer.step_batch({key: value[s] for key, value in stack.items()})
              for s in range(steps)]
        ep_losses = torch.stack(ep).cpu().numpy()  # the one read per epoch
        epoch_secs.append(time.perf_counter() - t0)
        epoch_samples.append(steps * batch_size)
        losses.extend(float(v) for v in ep_losses.astype(np.float64))
    return losses, epoch_samples, epoch_secs


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
) -> TrainResult:
    """Train the set-transformer parent ranker and evaluate its top-1 picks
    on a held-out split: on one device (CUDA unless ``device="cpu"``), or
    on a mesh (parallel/mesh.py ``make_mesh``) whose sp > 1 turns on ring
    attention or Ulysses per ``sp_strategy`` (default
    ``config.sp_strategy``), the model on the mesh's first device. A mesh
    with sp = 1 computes on that one device.

    The split and the minibatch order come from ``np.random.default_rng(seed)``
    exactly as in the reference, on one device and on a mesh alike. The
    initial weights are drawn from ``seed``
    (``AttentionRanker.reset_parameters``), or carried across from a flax
    params tree ``params``; ``TrainResult.params`` is the trained flax tree,
    which either package's registry can publish and serve."""
    config = config or TrainerConfig()
    sp_strategy = sp_strategy or config.sp_strategy
    _check_supported(config, mesh, checkpointer, sp_strategy)
    dev = _train_device(mesh, device)
    rng = np.random.default_rng(seed)
    n = ds.child.shape[0]
    perm = rng.permutation(n)
    eval_idx, train_idx = _train_eval_split(perm, eval_fraction)

    train_rows = take(ds, train_idx)
    in_features = sum(train_rows[key].shape[-1] for key in ("parents", "child", "pair"))
    model = build_ranker(config, in_features, seed, params, dev)
    train_fn, eval_fn = attention_fns(mesh, sp_strategy)
    batch_size = min(config.batch_size, len(train_idx))

    model.train()
    if mesh is None:
        trainer = AttentionTrainer(model, train_rows, config.learning_rate, dev)
        losses, block_samples, block_secs = _index_epochs(
            trainer, len(train_idx), batch_size, config.epochs, config.epoch_fusion, rng, dev
        )
    else:
        trainer = AttentionTrainer(model, None, config.learning_rate, dev, attention_fn=train_fn)
        losses, block_samples, block_secs = _stacked_epochs(
            trainer, mesh, config.epochs, batch_size,
            lambda: epoch_batches(ds, train_idx, batch_size, rng),
        )
    n_samples, dt = _steady_state_throughput(block_samples, block_secs)
    peak = _peak_rate(block_samples, block_secs)

    eb = take(ds, eval_idx)
    model.eval()
    scores = eval_scores(model, eb, eval_fn, mesh)
    stats = M.top1_selection_stats(
        scores.float().cpu(), torch.from_numpy(eb["throughput"]), torch.from_numpy(eb["mask"])
    )
    analytic = analytic_attention_flops_per_sample(
        token_feat_dim=eb["parents"].shape[-1] + eb["child"].shape[1] + eb["pair"].shape[-1],
        hidden=config.hidden_dim,
        parents=eb["parents"].shape[1],
        num_layers=config.attention_num_layers,
    )
    return TrainResult(
        params=attention_params_to_flax(model),
        losses=losses,
        eval_metrics={key: float(value) for key, value in stats.items()},
        samples_per_sec=n_samples / max(dt, 1e-9),
        steps=len(losses),
        peak_samples_per_sec=peak,
        analytic_flops_per_sample=analytic,
    )
