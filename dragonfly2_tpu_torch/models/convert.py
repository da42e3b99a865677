"""Carry model weights between the flax params tree and torch.

The reference publishes params as flax trees with numpy leaves (what a
template-less msgpack restore returns):

- ``AttentionRanker``: ``{"params": {"embed": {"kernel", "bias"},
  "block_i": {...}, "LayerNorm_0": {"scale", "bias"}, "score": {...}}}``;
- ``GraphSAGERanker``: ``sage_i/{self, neigh, edge}``, ``head_0``,
  ``head_1``, ``head_out``; ``neigh`` and ``edge`` have no bias;
- ``ProbeRTTRegressor``: ``Dense_0`` .. ``Dense_{n-1}``.

- the attention ranker with ``moe_experts > 0``: each ``block_i`` holds
  the raw MoE leaves ``moe_gate``, ``moe_w1``, ``moe_b1``, ``moe_w2`` and
  ``moe_b2`` in place of ``mlp_up`` and ``mlp_down``;
- the pipeline-parallel ranker (``PipelineRanker``): ``{"embed", "blocks",
  "ln", "score"}``, each wrapped in ``{"params": ...}``, every leaf of
  ``blocks`` stacked [pp, ...].

The port's modules carry the same names, so the mapping is by path; a
flax Dense kernel is (in, out) and a torch Linear weight (out, in), so
kernels swap their last two axes both ways (a stacked kernel keeps its
leading dim). A Dense without a bias has no bias entry on either side. The
MoE leaves are raw parameters, not Dense kernels: they cross unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from dragonfly2_tpu_torch.models.attention import Dense, LayerNorm


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax params tree (numpy leaves) -> the port's ``state_dict``."""
    state: dict[str, torch.Tensor] = {}

    def walk(node: Any, prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, dict):
                # a "params" level is a flax collection, not a module
                walk(value, prefix if name == "params" else f"{prefix}{name}.")
                continue
            array = np.array(value, dtype=np.float32)  # owned, writable copy
            if name == "kernel":
                state[f"{prefix}weight"] = torch.from_numpy(
                    np.ascontiguousarray(np.swapaxes(array, -1, -2)))
            else:  # bias, scale, the raw MoE leaves
                state[f"{prefix}{name}"] = torch.from_numpy(array)

    walk(tree, "")
    return state


def params_to_flax(module: nn.Module) -> dict:
    """The port's module -> the flax params tree (float32 numpy leaves), as
    the reference's ``init`` lays it out."""
    params: dict = {}
    for path, sub in module.named_modules():
        if isinstance(sub, Dense):
            leaves = {"kernel": np.swapaxes(_to_numpy(sub.weight), -1, -2).copy()}
            if sub.bias is not None:
                leaves["bias"] = _to_numpy(sub.bias)
        elif isinstance(sub, LayerNorm):
            leaves = {"scale": _to_numpy(sub.scale), "bias": _to_numpy(sub.bias)}
        else:  # a module's own raw parameters (the MoE leaves), if any
            leaves = {name: _to_numpy(p) for name, p in sub.named_parameters(recurse=False)}
        if not leaves:
            continue
        node = params
        for part in path.split(".") if path else ():
            node = node.setdefault(part, {})
        node.update(leaves)
    if getattr(module, "flax_collections", False):
        return {name: {"params": entry} for name, entry in params.items()}
    return {"params": params}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


# one mapping serves every model; the names say which tree a caller holds
attention_params_from_flax = graphsage_params_from_flax = mlp_params_from_flax = params_from_flax
attention_params_to_flax = graphsage_params_to_flax = mlp_params_to_flax = params_to_flax
