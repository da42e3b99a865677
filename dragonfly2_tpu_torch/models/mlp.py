"""MLP probe-RTT regressor, in PyTorch.

Port of dragonfly2_tpu/models/mlp.py. Input: pairwise (src, dst) host
features (records/features.topology_to_pairs, NUM_PAIR_FEATURES columns).
Output: predicted log1p(average RTT in ms). Dense layers compute in the
compute dtype (bf16 by default) from float32 parameters, gelu is the tanh
approximation, the output is float32. The layers carry flax's automatic
names (``Dense_0`` .. ``Dense_{num_layers - 1}``) so models/convert.py maps
the trees by path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dragonfly2_tpu_torch.models.attention import Dense, flax_init_
from dragonfly2_tpu_torch.records.features import NUM_PAIR_FEATURES


class ProbeRTTRegressor(nn.Module):
    def __init__(self, hidden_dim: int = 128, num_layers: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 in_features: int = NUM_PAIR_FEATURES):
        super().__init__()
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        widths = [in_features] + [hidden_dim] * (num_layers - 1) + [1]
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1], compute_dtype))

    def reset_parameters(self, generator: torch.Generator) -> "ProbeRTTRegressor":
        return flax_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for i in range(self.num_layers - 1):
            x = F.gelu(getattr(self, f"Dense_{i}")(x), approximate="tanh")
        x = getattr(self, f"Dense_{self.num_layers - 1}")(x)
        return x[..., 0].float()


def mse_loss(model: ProbeRTTRegressor, x: torch.Tensor, y: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    err = (model(x) - y) ** 2
    if mask is not None:
        mask = mask.to(err.dtype)
        return (err * mask).sum() / mask.sum().clamp_min(1.0)
    return err.mean()
