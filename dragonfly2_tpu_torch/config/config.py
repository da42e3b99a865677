"""Config system: typed dataclasses and YAML/JSON/env loading.

Port of dragonfly2_tpu/config/config.py: every section (``evaluator``,
``probe``, ``scheduler``, ``storage``, ``trainer``) with the reference's
defaults, ``Config.load`` and its ``DRAGONFLY_*`` env overrides. The
reference's ``DynConfig`` (the manager-polled runtime overrides) is not
ported yet. The capacities and batch widths here fix the shapes of the
device programs downstream (ops/tick.py pads every chunk to one of them).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Any

from dragonfly2_tpu_torch.config.constants import CONSTANTS

ENV_PREFIX = "DRAGONFLY_"


@dataclasses.dataclass
class EvaluatorConfig:
    # "default" | "nt" | "ml" | "plugin" — unlike the reference
    # (evaluator.go:84-86, where "ml" silently falls back to base), "ml" here
    # is actually wired to a served model (registry/serving.py), and "plugin"
    # loads a scorer via utils/plugins (plugin.go + dfplugin.go:43-81).
    algorithm: str = "default"
    batch_tasks: int = CONSTANTS.EVAL_BATCH_TASKS
    batch_candidates: int = CONSTANTS.EVAL_BATCH_CANDIDATES
    plugin_dir: str = ""
    plugin_name: str = ""


@dataclasses.dataclass
class ProbeConfig:
    queue_length: int = CONSTANTS.PROBE_QUEUE_LENGTH
    ewma_weight: float = CONSTANTS.EWMA_WEIGHT
    ping_timeout_ns: int = CONSTANTS.PING_TIMEOUT_NS
    find_probed_hosts_limit: int = CONSTANTS.FIND_PROBED_HOSTS_LIMIT
    interval_seconds: float = 20 * 60.0


@dataclasses.dataclass
class SchedulerConfig:
    filter_parent_limit: int = CONSTANTS.FILTER_PARENT_LIMIT
    candidate_parent_limit: int = CONSTANTS.CANDIDATE_PARENT_LIMIT
    retry_limit: int = CONSTANTS.RETRY_LIMIT
    retry_back_to_source_limit: int = CONSTANTS.RETRY_BACK_TO_SOURCE_LIMIT
    retry_interval_seconds: float = CONSTANTS.RETRY_INTERVAL_SECONDS
    # capacities for the struct-of-arrays cluster state (state/cluster.py)
    max_hosts: int = 16384
    max_peers_per_task: int = 256
    max_tasks: int = 4096
    # Absolute peer-table capacity; 0 keeps the historical max_hosts * 4.
    # The megascale scenario lab sizes this to its planned download count
    # so a 10^6-host state does not allocate 4M rows it will never use.
    max_peers: int = 0
    # uint64 words per peer finished-piece bitset (64 pieces per word).
    # The default supports 4096-piece tasks; megascale runs cap tasks at
    # 64 pieces and shrink this to 1 word — at 10^6 hosts the bitset
    # column is the difference between 16 MB and 2 GB.
    piece_bitset_words: int = 64
    # Route a cold task's seed trigger to a seed peer in the SAME region
    # (first location element) as the requesting host when one exists.
    # Off by default: single-region deployments keep the plain
    # round-robin the reference uses (seed_peer.go TriggerTask); the
    # megascale WAN topology turns it on so origin fetches land in-region.
    region_aware_seeds: bool = False
    # Columnar control plane (PR 8): candidate fill, selection apply and
    # piece-report absorption run as vectorised batch ops over the SoA
    # columns. False falls back to the per-peer loop path — kept as the
    # decision-equivalence oracle (tests/test_control_equivalence.py),
    # not as a production mode.
    vectorized_control: bool = True
    # Device-resident fused tick (ops/tick.py): candidate fill, feature
    # gather, scoring and selection run as ONE donated bucket-padded XLA
    # program over device-mirrored SoA columns; only DAG legality,
    # blocklist resolution and response emission stay host-side. False
    # falls back to the numpy fill + packed-transport path, kept as the
    # decision-equivalence oracle (tests/test_fused_tick.py) — paired
    # seeds must produce IDENTICAL selections including scores. Only
    # effective with vectorized_control on a rule-blend arm (the ml and
    # plugin arms keep the packed/dict transports).
    fused_tick: bool = True
    # Decision provenance ledger (telemetry/decisions.py): a bounded
    # columnar ring recording every applied selection's candidate set,
    # feature rows, scores, chosen parent and joined outcome. On by
    # default — recording is a handful of block column assigns per tick.
    decision_ledger: bool = True
    decision_ledger_capacity: int = 4096
    # Counterfactual shadow scoring: the INACTIVE arm (rule when ml is
    # active, the committed ml snapshot when the rule is) re-scores the
    # already-packed device batch off the critical path, producing
    # per-tick divergence and, once outcomes join, measured per-arm
    # regret. No-ops when no inactive arm is available (rule active
    # without a served ml snapshot), so the default costs nothing there.
    shadow_scoring: bool = True
    # Shadow every Nth tick (deterministic — keyed on the tick counter,
    # never wall time). 1 = every tick. On a CPU-device rig the shadow
    # pass shares host cores with the "device" and costs a real slice of
    # the tick (measured ~3.8 ms at 10k hosts); a real accelerator pays
    # only the staging-buffer copy + dispatch. Raise this to thin the
    # counterfactual sample at 1/N of the cost.
    shadow_every: int = 1
    # Streaming SLO engine (telemetry/slo.py): the live scheduler keeps
    # sliding good/bad counters for tick latency (against the budget
    # below), shadow regret and the breaker census, evaluated on the
    # wall clock with multi-window burn-rate alerts feeding the
    # /debug/health verdict. Recording is a few dict ops per tick.
    slo_enabled: bool = True
    # a tick slower than this counts against the tick_latency error
    # budget (generous on CPU rigs; a real accelerator tick p50 is ms)
    slo_tick_budget_ms: float = 250.0
    # resource GC (scheduler/config/config.go GCConfig; pkg/gc/gc.go
    # interval runner semantics — swept from the live tick loop)
    peer_gc_interval_seconds: float = CONSTANTS.PEER_GC_INTERVAL_SECONDS
    peer_ttl_seconds: float = CONSTANTS.PEER_TTL_SECONDS
    piece_download_timeout_seconds: float = CONSTANTS.PIECE_DOWNLOAD_TIMEOUT_SECONDS
    task_gc_interval_seconds: float = CONSTANTS.TASK_GC_INTERVAL_SECONDS
    host_gc_interval_seconds: float = CONSTANTS.HOST_GC_INTERVAL_SECONDS
    host_ttl_seconds: float = CONSTANTS.HOST_TTL_SECONDS


@dataclasses.dataclass
class StorageConfig:
    data_dir: str = "data"
    max_size_mb: int = CONSTANTS.STORAGE_MAX_SIZE_MB
    max_backups: int = CONSTANTS.STORAGE_MAX_BACKUPS


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
    # interrupted training resumes at the next epoch
    checkpoint_dir: str = ""
    # >1 times this many epochs as one block: the loss read and the
    # throughput bookkeeping coarsen to the block
    epoch_fusion: int = 1
    # also train and publish the attention parent ranker
    train_attention: bool = False
    # --- parallelism knobs for the attention ranker; each axis turns on
    # from the config alone with a mesh that has it (the port trains on dp
    # and sp; tp, pp and ep raise, ROADMAP A12)
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


@dataclasses.dataclass
class Config:
    name: str = "dragonfly2-tpu"
    evaluator: EvaluatorConfig = dataclasses.field(default_factory=EvaluatorConfig)
    probe: ProbeConfig = dataclasses.field(default_factory=ProbeConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)

    @classmethod
    def load(cls, path: str | os.PathLike | None = None) -> "Config":
        """Load from a YAML/JSON file, then apply DRAGONFLY_* env overrides.

        Env override syntax mirrors the reference's viper env binding:
        ``DRAGONFLY_SCHEDULER_FILTER_PARENT_LIMIT=20`` maps to
        ``scheduler.filter_parent_limit``.
        """
        cfg = cls()
        if path is not None:
            text = pathlib.Path(path).read_text()
            data = _parse_config_text(text)
            _apply_dict(cfg, data)
        _apply_env(cfg)
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _parse_config_text(text: str) -> dict:
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml  # type: ignore

            return yaml.safe_load(text) or {}
        except ImportError:
            return _parse_simple_yaml(text)


def _parse_simple_yaml(text: str) -> dict:
    """Two-level key: value parser so config files work without PyYAML."""
    root: dict[str, Any] = {}
    section: dict[str, Any] | None = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip() or ":" not in line:
            continue
        key, _, value = line.partition(":")
        value = value.strip()
        indented = key.startswith((" ", "\t"))
        key = key.strip()
        if not indented:
            if value == "":
                section = {}
                root[key] = section
            else:
                section = None
                root[key] = _coerce(value)
        elif section is not None:
            section[key] = _coerce(value)
    return root


def _coerce(value: str) -> Any:
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value.strip("'\"")


def _apply_dict(cfg: Any, data: dict) -> None:
    for key, value in (data or {}).items():
        if not hasattr(cfg, key):
            continue
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _apply_dict(current, value)
        else:
            setattr(cfg, key, value)


def _apply_env(cfg: Config) -> None:
    for name, value in os.environ.items():
        if not name.startswith(ENV_PREFIX):
            continue
        parts = name[len(ENV_PREFIX):].lower().split("_")
        # Longest-prefix match of parts[0] against section names.
        for i in range(len(parts), 0, -1):
            section_name = "_".join(parts[:i])
            if hasattr(cfg, section_name):
                section = getattr(cfg, section_name)
                field = "_".join(parts[i:])
                if field and hasattr(section, field):
                    setattr(section, field, _coerce(value))
                elif not field and not dataclasses.is_dataclass(section):
                    # whole suffix names a top-level scalar, e.g. DRAGONFLY_NAME
                    setattr(cfg, section_name, _coerce(value))
                break
