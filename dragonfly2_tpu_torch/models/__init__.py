"""Models: the attention ranker (models/attention.py), the GraphSAGE ranker
(models/graphsage.py), the probe-RTT regressor (models/mlp.py), and their
weight conversion from the reference's flax params (models/convert.py)."""

from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker, RankBatch, SAGELayer
from dragonfly2_tpu_torch.models.mlp import ProbeRTTRegressor, mse_loss

__all__ = ["GraphSAGERanker", "ProbeRTTRegressor", "RankBatch", "SAGELayer", "mse_loss"]
