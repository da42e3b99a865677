"""Model registry (the filesystem ModelRegistry and the bucket layout) and
model serving: the attention, gnn and mlp servers and the ml evaluator."""

from dragonfly2_tpu_torch.registry.registry import (
    ModelEvaluation,
    ModelRegistry,
    ModelVersion,
)
from dragonfly2_tpu_torch.registry.bucket import BucketModelRegistry, open_registry
from dragonfly2_tpu_torch.registry.serving import MLEvaluator, ModelServer

__all__ = [
    "GNN_MODEL_NAME",
    "ModelRegistry",
    "ModelVersion",
    "ModelEvaluation",
    "BucketModelRegistry",
    "open_registry",
    "ModelServer",
    "MLEvaluator",
]


def __getattr__(name: str):
    # the parent ranker's registered name lives with the trainer that
    # publishes under it (cluster/trainer_service.py), which imports this
    # package: read lazily, so neither import needs the other first
    if name == "GNN_MODEL_NAME":
        from dragonfly2_tpu_torch.cluster.trainer_service import GNN_MODEL_NAME

        return GNN_MODEL_NAME
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
