"""Training: the GNN, MLP and attention trainers (training/train.py), their
input pipeline (training/data.py) and train-state checkpoints
(training/checkpoint.py)."""

from dragonfly2_tpu_torch.training.checkpoint import TrainCheckpointer
from dragonfly2_tpu_torch.training.train import (
    TrainResult,
    train_attention,
    train_gnn,
    train_mlp,
)

__all__ = ["TrainResult", "train_mlp", "train_gnn", "train_attention", "TrainCheckpointer"]
