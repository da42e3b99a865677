"""Model evaluation metrics — the fields the manager's model registry
records per version: Recall / Precision / F1 / MSE / MAE.

Port of dragonfly2_tpu/models/metrics.py. Inputs are tensors or numpy
arrays; results are 0-dim tensors (``regression_report`` gives floats).
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def mse(pred, target, mask=None) -> torch.Tensor:
    err = (_tensor(pred) - _tensor(target)) ** 2
    if mask is None:
        return err.mean()
    mask = _tensor(mask)
    return (err * mask).sum() / mask.sum().clamp_min(1.0)


def mae(pred, target, mask=None) -> torch.Tensor:
    err = (_tensor(pred) - _tensor(target)).abs()
    if mask is None:
        return err.mean()
    mask = _tensor(mask)
    return (err * mask).sum() / mask.sum().clamp_min(1.0)


def _nanquantile_nearest(x: torch.Tensor, q: float) -> torch.Tensor:
    """Row-wise quantile over the last dim ignoring NaNs, "nearest" as
    jnp.nanquantile takes it: a position exactly halfway between two order
    statistics takes the LOWER one (torch.nanquantile rounds half to even,
    which differs at positions such as 1.5 and 7.5). Rows with no finite
    value give NaN."""
    ordered = torch.sort(x, dim=-1).values  # NaNs sort last
    counts = (~torch.isnan(x)).sum(-1).to(x.dtype)
    pos = q * (counts - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    pick_low = (pos - low) <= 0.5

    def at(i):
        i = torch.maximum(torch.zeros_like(i), torch.minimum(i, counts - 1)).long()
        return torch.gather(ordered, -1, i[..., None])[..., 0]

    return torch.where(pick_low, at(low), at(high))


def top1_selection_stats(scores, throughput, mask, good_quantile: float = 0.75):
    """Precision/recall/F1 of the ranker's top-1 pick per row.

    A candidate is "relevant" if its observed throughput is in the top
    (1-good_quantile) share of its row's valid candidates. The ranker's
    pick is a true positive when it selects a relevant candidate. With one
    pick per row, precision = fraction of rows whose pick was relevant;
    recall = TP / total relevant; F1 combines them.

    Also reports `regret`: the top-1 pick's position in the row's observed
    throughput range, (best - picked) / (best - worst), averaged over valid
    rows — 0 means always picking the best candidate, ~0.5 is a uniform
    random picker, 1 means always picking the worst.

    Recall is structurally capped below 1.0: one pick per row while a row
    can hold several relevant candidates. `recall_ceiling` is that
    perfect-picker bound — judge recall against it, not against 1.0.
    """
    scores, throughput, mask = _tensor(scores), _tensor(throughput), _tensor(mask).bool()
    neg = torch.tensor(_NEG, dtype=torch.float32, device=throughput.device)
    valid_rows = mask.sum(-1) >= 2
    masked_tp = torch.where(mask, throughput, neg)
    thresh = _nanquantile_nearest(
        torch.where(mask, throughput, torch.full_like(throughput, float("nan"))), good_quantile
    )
    relevant = mask & (throughput >= thresh[..., None]) & torch.isfinite(masked_tp)
    pick = torch.argmax(torch.where(mask, scores, neg), dim=-1)  # first of ties, as jnp
    picked_relevant = torch.gather(relevant, -1, pick[..., None])[..., 0]
    tp = (picked_relevant & valid_rows).sum()
    n_rows = valid_rows.sum().clamp_min(1)
    n_relevant = (relevant & valid_rows[..., None]).sum().clamp_min(1)
    precision = tp / n_rows
    recall = tp / n_relevant
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-9)

    # non-finite throughputs are excluded from best/worst/picked so one NaN
    # slot cannot poison the batch
    finite = mask & torch.isfinite(throughput)
    finite_tp = torch.where(finite, throughput, neg)
    picked_tp = torch.gather(finite_tp, -1, pick[..., None])[..., 0]
    best = finite_tp.max(-1).values
    worst = torch.where(finite, throughput, torch.full_like(throughput, 1e30)).min(-1).values
    span = torch.clamp_min(best - worst, 1e-9)
    per_row_regret = torch.clamp((best - picked_tp) / span, 0.0, 1.0)
    regret_rows = valid_rows & (finite.sum(-1) >= 2) & (picked_tp > neg / 2)
    regret = (per_row_regret * regret_rows).sum() / regret_rows.sum().clamp_min(1)
    rows_with_relevant = (relevant.any(-1) & valid_rows).sum()
    recall_ceiling = rows_with_relevant / n_relevant
    return {
        "precision": precision, "recall": recall, "f1": f1, "regret": regret,
        "recall_ceiling": recall_ceiling,
    }


def regression_report(pred, target, mask=None) -> dict:
    return {"mse": float(mse(pred, target, mask)), "mae": float(mae(pred, target, mask))}
