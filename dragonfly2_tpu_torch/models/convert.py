"""Carry model weights between the flax params tree and torch.

The reference publishes params as flax trees with numpy leaves (what a
template-less msgpack restore returns):

- ``AttentionRanker``: ``{"params": {"embed": {"kernel", "bias"},
  "block_i": {...}, "LayerNorm_0": {"scale", "bias"}, "score": {...}}}``;
- ``GraphSAGERanker``: ``sage_i/{self, neigh, edge}``, ``head_0``,
  ``head_1``, ``head_out``; ``neigh`` and ``edge`` have no bias;
- ``ProbeRTTRegressor``: ``Dense_0`` .. ``Dense_{n-1}``.

The port's modules carry the same names, so the mapping is by path; a
flax Dense kernel is (in, out) and a torch Linear weight (out, in), so
kernels are transposed both ways. A Dense without a bias has no bias
entry on either side.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from dragonfly2_tpu_torch.models.attention import Dense, LayerNorm


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax params tree (numpy leaves) -> the port's ``state_dict``."""
    params = tree["params"] if "params" in tree else tree
    state: dict[str, torch.Tensor] = {}

    def walk(node: Any, prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{name}.")
                continue
            array = np.array(value, dtype=np.float32)  # owned, writable copy
            if name == "kernel":
                state[f"{prefix}weight"] = torch.from_numpy(np.ascontiguousarray(array.T))
            else:  # bias, scale
                state[f"{prefix}{name}"] = torch.from_numpy(array)

    walk(params, "")
    return state


def params_to_flax(module: nn.Module) -> dict:
    """The port's module -> the flax params tree (float32 numpy leaves), as
    the reference's ``init`` lays it out."""
    params: dict = {}
    for path, sub in module.named_modules():
        if not isinstance(sub, (Dense, LayerNorm)):
            continue
        node = params
        for part in path.split("."):
            node = node.setdefault(part, {})
        if isinstance(sub, Dense):
            node["kernel"] = _to_numpy(sub.weight).T.copy()
            if sub.bias is not None:
                node["bias"] = _to_numpy(sub.bias)
        else:
            node["scale"] = _to_numpy(sub.scale)
            node["bias"] = _to_numpy(sub.bias)
    return {"params": params}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


# one mapping serves every model; the names say which tree a caller holds
attention_params_from_flax = graphsage_params_from_flax = mlp_params_from_flax = params_from_flax
attention_params_to_flax = graphsage_params_to_flax = mlp_params_to_flax = params_to_flax
