"""Trainer service: ingest per-host datasets, train the models, publish
them to the registry.

Port of dragonfly2_tpu/cluster/trainer_service.py (the reference's Train
RPC: per-host dataset files from chunked streams, cleanup on error,
training on stream end, then the CreateModel upload). ``train_finish``
trains the GNN, then the attention ranker when ``config.train_attention``
is set, then the probe-RTT MLP when the topology gives at least 8 pairs,
publishes each with its evaluation and auto-activates it. The trainers run
on ``device`` (CUDA unless ``device="cpu"``) or on ``mesh``'s first device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import pathlib

from dragonfly2_tpu_torch.config.config import TrainerConfig
from dragonfly2_tpu_torch.device import resolve_device
from dragonfly2_tpu_torch.records.features import downloads_to_ranking_dataset, topology_to_pairs
from dragonfly2_tpu_torch.records.storage import HostTraceStorage
from dragonfly2_tpu_torch.registry.registry import (
    MODEL_TYPE_ATTENTION,
    MODEL_TYPE_GNN,
    MODEL_TYPE_MLP,
    ModelEvaluation,
    ModelRegistry,
    ModelVersion,
)
from dragonfly2_tpu_torch.training.checkpoint import TrainCheckpointer
from dragonfly2_tpu_torch.training.train import (
    TrainResult,
    train_attention,
    train_gnn,
    train_mlp,
)

logger = logging.getLogger(__name__)

# the registered names of the three families; the scheduler's ml arm
# serves GNN_MODEL_NAME
GNN_MODEL_NAME = "parent-ranker"
MLP_MODEL_NAME = "rtt-regressor"
ATTENTION_MODEL_NAME = "parent-ranker-attention"


def _ranker_evaluation(result: TrainResult) -> ModelEvaluation:
    """Registry evaluation fields for the parent-ranker families (GNN and
    attention share the top-1 selection metrics)."""
    return ModelEvaluation(
        recall=result.eval_metrics.get("recall", 0.0),
        precision=result.eval_metrics.get("precision", 0.0),
        f1_score=result.eval_metrics.get("f1", 0.0),
    )


@dataclasses.dataclass
class TrainOutcome:
    host_id: str
    gnn: ModelVersion | None
    mlp: ModelVersion | None
    gnn_result: TrainResult | None
    mlp_result: TrainResult | None
    attention: ModelVersion | None = None
    attention_result: TrainResult | None = None


class TrainerService:
    """In-proc trainer; a transport adapts chunk streams onto these calls
    (cluster/announcer.py's ``TrainerSink``)."""

    def __init__(
        self,
        storage: HostTraceStorage,
        registry: ModelRegistry,
        config: TrainerConfig | None = None,
        mesh=None,
        auto_activate: bool = True,
        device=None,
    ):
        self.storage = storage
        self.registry = registry
        self.config = config or TrainerConfig()
        self.mesh = mesh
        # the reference leaves activation to an operator; auto_activate
        # closes the loop unattended
        self.auto_activate = auto_activate
        # the card unless the caller asks for the CPU; no CUDA raises here,
        # nothing falls back (a mesh names its own devices)
        self.device = resolve_device(device) if mesh is None else device

    # ------------------------------------------------- TrainerSink protocol

    def train_mlp_chunk(self, host_id: str, data: bytes) -> None:
        self.storage.append_download_bytes(host_id, data)

    def train_gnn_chunk(self, host_id: str, data: bytes) -> None:
        self.storage.append_network_topology_bytes(host_id, data)

    def train_abort(self, host_id: str) -> None:
        """Stream error: clear ONLY the failing host's partial files; other
        schedulers' uploads survive."""
        self.storage.clear_host(host_id)

    def train_finish(self, host_id: str) -> TrainOutcome:
        """Stream end: train the GNN (then the attention ranker when
        enabled) on the downloads and the MLP on the topology, publish the
        versions, clear the datasets."""
        outcome = TrainOutcome(host_id, None, None, None, None)
        where = {"mesh": self.mesh, "device": self.device}
        try:
            downloads = self.storage.list_downloads()
            topologies = self.storage.list_network_topologies()
            if downloads:
                ds, graph = downloads_to_ranking_dataset(downloads)
                with self._checkpoint(GNN_MODEL_NAME) as ck:
                    result = train_gnn(ds, graph, self.config, checkpointer=ck, **where)
                outcome.gnn_result = result
                outcome.gnn = self._publish(
                    GNN_MODEL_NAME, MODEL_TYPE_GNN, host_id, result,
                    _ranker_evaluation(result),
                    extra={"num_downloads": len(downloads), "num_hosts": len(graph.host_ids)},
                )
                if self.config.train_attention:
                    with self._checkpoint(ATTENTION_MODEL_NAME) as ck:
                        result = train_attention(ds, self.config, checkpointer=ck, **where)
                    outcome.attention_result = result
                    outcome.attention = self._publish(
                        ATTENTION_MODEL_NAME, MODEL_TYPE_ATTENTION, host_id, result,
                        _ranker_evaluation(result),
                        extra={"num_downloads": len(downloads)},
                    )
            if topologies:
                x, y = topology_to_pairs(topologies)
                if x.shape[0] >= 8:
                    with self._checkpoint(MLP_MODEL_NAME) as ck:
                        result = train_mlp(x, y, self.config, checkpointer=ck, **where)
                    outcome.mlp_result = result
                    outcome.mlp = self._publish(
                        MLP_MODEL_NAME, MODEL_TYPE_MLP, host_id, result,
                        ModelEvaluation(
                            mse=result.eval_metrics.get("mse", 0.0),
                            mae=result.eval_metrics.get("mae", 0.0),
                        ),
                        extra={"num_pairs": int(x.shape[0])},
                    )
        finally:
            self.storage.clear_downloads()
            self.storage.clear_network_topologies()
        return outcome

    @contextlib.contextmanager
    def _checkpoint(self, model_name: str):
        """Per-model train-state checkpointer when checkpoint_dir is set: a
        trainer killed mid-run resumes at the next epoch on restart. Cleared
        on success, or the NEXT train_finish would "resume" past its final
        epoch, run zero steps on the fresh traces and publish stale params."""
        if not self.config.checkpoint_dir:
            yield None
            return
        ck = TrainCheckpointer(pathlib.Path(self.config.checkpoint_dir) / model_name)
        try:
            yield ck
            ck.clear()  # success: the next run starts fresh
        finally:
            ck.close()

    def _publish(self, name, model_type, host_id, result: TrainResult,
                 evaluation: ModelEvaluation, extra: dict) -> ModelVersion:
        mv = self.registry.create_model_version(
            name=name,
            model_type=model_type,
            scheduler_host_id=host_id,
            params=result.params,
            evaluation=evaluation,
            metadata={
                "steps": result.steps,
                "final_loss": result.losses[-1] if result.losses else None,
                "samples_per_sec": result.samples_per_sec,
                "hidden_dim": self.config.hidden_dim,
                # structural bound on single-pick recall: judge recall
                # against this, not 1.0 (models/metrics.py)
                "recall_ceiling": result.eval_metrics.get("recall_ceiling", 0.0),
                **extra,
            },
        )
        if self.auto_activate:
            self.registry.activate(mv.model_id, mv.version)
        logger.info("published %s v%d (%s)", mv.model_id, mv.version, name)
        return mv
