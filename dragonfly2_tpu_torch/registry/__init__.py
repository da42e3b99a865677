"""Model registry (bucket layout) and model serving: the attention, gnn
and mlp servers and the ml evaluator."""

from dragonfly2_tpu_torch.registry.registry import (
    GNN_MODEL_NAME,
    ModelEvaluation,
    ModelVersion,
)
from dragonfly2_tpu_torch.registry.bucket import BucketModelRegistry, open_registry
from dragonfly2_tpu_torch.registry.serving import MLEvaluator, ModelServer

__all__ = [
    "GNN_MODEL_NAME",
    "ModelVersion",
    "ModelEvaluation",
    "BucketModelRegistry",
    "open_registry",
    "ModelServer",
    "MLEvaluator",
]
