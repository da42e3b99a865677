"""Native model serving — the attention ranker's part of
dragonfly2_tpu/registry/serving.py, in PyTorch.

``ModelServer`` watches the registry's active-version pointer and hot-swaps
the served params on activation flips; ``attention_score`` runs the
set-transformer ranker on one request's candidate sets. The params live on
``ModelServer.device`` (CUDA unless the caller asks for the CPU) and are
moved there once, at refresh. The GNN and MLP model types and the "ml"
evaluator (``MLEvaluator``) are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from dragonfly2_tpu_torch.device import resolve_device
from dragonfly2_tpu_torch.models.attention import AttentionRanker
from dragonfly2_tpu_torch.models.convert import attention_params_from_flax
from dragonfly2_tpu_torch.registry.registry import (
    MODEL_TYPE_ATTENTION,
    MODEL_TYPE_GNN,
    MODEL_TYPE_MLP,
)
from dragonfly2_tpu_torch.utils import dferrors

logger = logging.getLogger(__name__)

_ARCH_KEYS = ("hidden_dim", "num_heads", "num_layers")


class ModelServer:
    """Serves the ACTIVE version of one registered model, reloading on
    activation flips — the native ModelInfer replacement.

    ``model`` is the architecture (an nn.Module whose own parameters are
    not served) and ``params`` the served weights, a state dict on
    ``device``; ``attention_score`` applies one to the other."""

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
        self.registry = registry
        self.name = name
        self.model_type = model_type
        self.model_id = registry.model_id(name, scheduler_host_id)
        self.device = resolve_device(device)
        self._template = template_params
        self.params: dict[str, torch.Tensor] | None = None
        self.version: int | None = None
        if model_type in (MODEL_TYPE_GNN, MODEL_TYPE_MLP):
            raise NotImplementedError(f"{model_type} serving is not ported yet")
        if model_type != MODEL_TYPE_ATTENTION:
            raise ValueError(model_type)
        self.model = model if model is not None else AttentionRanker()

    def refresh(self) -> bool:
        """Pick up a newly activated version; returns True if swapped. The
        version's metadata records its architecture, so the served module
        always matches the trained one."""
        active = self.registry.active_version(self.model_id)
        if active is None or active.version == self.version:
            return False
        # Rebuild the module if the version's recorded architecture differs
        # from the served one — num_heads/num_layers can change the function
        # while every param shape agrees.
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
        new_model = self.model
        if changed:
            cls = type(self.model)
            # start from the currently-served knobs and overlay the new
            # metadata: a knob omitted from v_{n+1}'s metadata means
            # "unchanged", never "reset to class default"
            kwargs = {key: getattr(self.model, key) for key in _ARCH_KEYS if hasattr(self.model, key)}
            for key in ("compute_dtype", "in_features"):
                if hasattr(self.model, key):
                    kwargs[key] = getattr(self.model, key)
            kwargs.update({k: v for k, v in arch.items() if k in kwargs})
            new_model = cls(**kwargs)
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
        new_params = {
            key: value.to(self.device)
            for key, value in attention_params_from_flax(tree).items()
        }
        self.model = new_model.to(self.device).eval()
        self.params = new_params
        self.version = active.version
        return True

    @property
    def ready(self) -> bool:
        return self.params is not None

    def snapshot(self) -> tuple[Any, Any, int | None]:
        """(model, params, version) read together — callers that must not
        see a concurrent refresh() swap half-applied (the inference RPC)
        take this under their lock and run attention_score on it."""
        return self.model, self.params, self.version

    def score_set(self, child_feats, parent_feats, pair_feats, mask) -> torch.Tensor:
        """(B, P) float32 candidate scores from the set-transformer ranker."""
        return attention_score(
            self.model, self.params, child_feats, parent_feats, pair_feats, mask
        )


class MLEvaluator:
    """The "ml" evaluator of dragonfly2_tpu/registry/serving.py (GraphSAGE
    host embeddings + candidate scoring in the tick) is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("MLEvaluator is not ported to the torch package yet")


def _on(device: torch.device, x, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        # wire tensors are read-only views of the frame: copy those
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    return x.to(device=device, dtype=dtype)


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
