"""Trainer configuration.

The ``TrainerConfig`` dataclass of dragonfly2_tpu/config/config.py, with
its defaults (the rest of that config system — the scheduler, evaluator,
probe and storage sections, YAML/env loading and ``DynConfig`` — is not
ported yet).
"""

from __future__ import annotations

import dataclasses

from dragonfly2_tpu_torch.config.constants import CONSTANTS


@dataclasses.dataclass
class TrainerConfig:
    interval_seconds: int = CONSTANTS.TRAIN_INTERVAL_SECONDS
    upload_timeout_seconds: int = CONSTANTS.TRAIN_UPLOAD_TIMEOUT_SECONDS
    upload_chunk_bytes: int = CONSTANTS.TRAIN_UPLOAD_CHUNK_BYTES
    batch_size: int = 256
    learning_rate: float = 1e-3
    epochs: int = 10
    hidden_dim: int = 128
    # non-empty -> per-model train-state checkpoints under this dir, so an
    # interrupted training resumes at the next epoch (not ported yet: the
    # port's train_attention refuses a checkpointer)
    checkpoint_dir: str = ""
    # >1 times this many epochs as one block: the loss read and the
    # throughput bookkeeping coarsen to the block
    epoch_fusion: int = 1
    # also train and publish the attention parent ranker
    train_attention: bool = False
    # --- parallelism knobs for the attention ranker; each axis turns on
    # from the config alone with a mesh that has it (none of the mesh paths
    # is ported yet: the port trains on one device)
    # sequence parallelism: "ring" or "ulysses", when the mesh has sp > 1
    sp_strategy: str = "ring"
    # tensor parallelism of qkv/proj and the FFN, when the mesh has tp > 1
    attention_tp: bool = False
    # >0 swaps the block MLP for a top-1 mixture of this many experts
    attention_moe_experts: int = 0
    # pipeline parallelism: one block per pp stage, when the mesh has pp > 1
    attention_pp: bool = False
    attention_pp_microbatches: int = 4
    attention_num_layers: int = 2
