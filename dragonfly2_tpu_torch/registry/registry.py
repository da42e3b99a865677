"""Model registry types — the manager's model lifecycle records.

Port of the jax-free half of dragonfly2_tpu/registry/registry.py: the
model-type and state constants, ``ModelEvaluation``, ``ModelVersion`` and
``_version_from_json``. The reference's orbax-backed filesystem
``ModelRegistry`` is not ported yet; the port serves from the bucket layout
(registry/bucket.py), which needs no orbax.
"""

from __future__ import annotations

import dataclasses

MODEL_TYPE_GNN = "gnn"
MODEL_TYPE_MLP = "mlp"
# beyond the reference's gnn|mlp enum (manager/models/model.go:19-46): the
# set-transformer ranker family (models/attention.py)
MODEL_TYPE_ATTENTION = "attention"

# The registered name of the scheduler's parent ranker (the ml arm's gnn
# model). A copy of dragonfly2_tpu/cluster/trainer_service.py:52's, which
# the trainer publishes under; it moves there when the trainer service is
# ported (ROADMAP A8).
GNN_MODEL_NAME = "parent-ranker"

STATE_INACTIVE = "inactive"
STATE_ACTIVE = "active"
# A version that failed an integrity or canary check. Bad versions can
# never be (re)activated; marking the ACTIVE version bad falls the pointer
# back to the newest good version, so serving recovers to last-good.
STATE_BAD = "bad"


@dataclasses.dataclass
class ModelEvaluation:
    """manager/types/model.go:58-64."""

    recall: float = 0.0
    precision: float = 0.0
    f1_score: float = 0.0
    mse: float = 0.0
    mae: float = 0.0


@dataclasses.dataclass
class ModelVersion:
    model_id: str
    name: str
    type: str
    version: int
    state: str
    evaluation: ModelEvaluation
    scheduler_host_id: str
    created_at: float
    metadata: dict = dataclasses.field(default_factory=dict)


def _version_from_json(data: dict) -> ModelVersion:
    data = dict(data)
    data["evaluation"] = ModelEvaluation(**data["evaluation"])
    return ModelVersion(**data)
