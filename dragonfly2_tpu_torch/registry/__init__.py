"""Model registry (bucket layout) and attention-model serving."""

from dragonfly2_tpu_torch.registry.registry import ModelEvaluation, ModelVersion
from dragonfly2_tpu_torch.registry.bucket import BucketModelRegistry, open_registry
from dragonfly2_tpu_torch.registry.serving import MLEvaluator, ModelServer

__all__ = [
    "ModelVersion",
    "ModelEvaluation",
    "BucketModelRegistry",
    "open_registry",
    "ModelServer",
    "MLEvaluator",
]
