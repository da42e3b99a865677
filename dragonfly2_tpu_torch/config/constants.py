"""Workload constants mirrored from the reference's config defaults.

A copy of dragonfly2_tpu/config/constants.py. Upstream source:
scheduler/config/constants.go (filter/candidate
limits :33-37, probe queue length :111-112, storage defaults :183-190,
trainer interval :197-201) and scheduler/scheduling/scheduling.go:128,156
(retry limits). These bound the shapes of every batched kernel: candidate
axes are padded to FILTER_PARENT_LIMIT, trace records carry at most
MAX_PARENTS_PER_RECORD parents x MAX_PIECES_PER_PARENT pieces
(scheduler/storage/types.go:169,218,293).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Constants:
    # --- scheduling (scheduler/config/constants.go:33-37) ---
    FILTER_PARENT_LIMIT: int = 15
    CANDIDATE_PARENT_LIMIT: int = 4
    # scheduling.go retry loop (:128,:156)
    RETRY_LIMIT: int = 5
    RETRY_BACK_TO_SOURCE_LIMIT: int = 3
    RETRY_INTERVAL_SECONDS: float = 0.05

    # --- resource GC (scheduler/config/constants.go:75-91 + pkg/gc) ---
    PEER_GC_INTERVAL_SECONDS: float = 10.0
    PEER_TTL_SECONDS: float = 24 * 3600.0
    PIECE_DOWNLOAD_TIMEOUT_SECONDS: float = 30 * 60.0
    TASK_GC_INTERVAL_SECONDS: float = 30 * 60.0
    HOST_GC_INTERVAL_SECONDS: float = 6 * 3600.0
    HOST_TTL_SECONDS: float = 3600.0

    # --- evaluator (evaluator.go:42-61) ---
    MAX_SCORE: float = 1.0
    MIN_SCORE: float = 0.0
    MAX_LOCATION_ELEMENTS: int = 5  # maxElementLen
    NORMAL_DISTRIBUTION_LEN: int = 30  # piece-cost sample count for 3-sigma
    MIN_AVAILABLE_COST_LEN: int = 2
    BAD_NODE_MEAN_MULTIPLIER: float = 20.0
    BAD_NODE_SIGMA: float = 3.0

    # --- evaluator weights (evaluator_base.go:28-46) ---
    W_FINISHED_PIECE: float = 0.2
    W_UPLOAD_SUCCESS: float = 0.2
    W_FREE_UPLOAD: float = 0.15
    W_HOST_TYPE: float = 0.15
    W_IDC: float = 0.15
    W_LOCATION: float = 0.15

    # --- network-topology evaluator weights (evaluator_network_topology.go:30-51) ---
    NT_W_FINISHED_PIECE: float = 0.2
    NT_W_UPLOAD_SUCCESS: float = 0.2
    NT_W_FREE_UPLOAD: float = 0.15
    NT_W_PROBE: float = 0.12
    NT_W_HOST_TYPE: float = 0.11
    NT_W_IDC: float = 0.11
    NT_W_LOCATION: float = 0.11
    PING_TIMEOUT_NS: int = 1_000_000_000  # defaultPingTimeout = 1s

    # --- probes (constants.go:111-112, probes.go:39) ---
    PROBE_QUEUE_LENGTH: int = 5
    EWMA_WEIGHT: float = 0.1  # defaultMovingAverageWeight: new = 0.1*old + 0.9*sample
    FIND_PROBED_HOSTS_LIMIT: int = 50

    # --- trace storage (constants.go:183-190, types.go:169,218,293) ---
    MAX_PARENTS_PER_RECORD: int = 20
    MAX_PIECES_PER_PARENT: int = 10
    MAX_DEST_HOSTS_PER_RECORD: int = 5
    STORAGE_MAX_SIZE_MB: int = 100
    STORAGE_MAX_BACKUPS: int = 10

    # --- trainer cadence (constants.go:197-201, announcer.go:40) ---
    TRAIN_INTERVAL_SECONDS: int = 7 * 24 * 3600
    TRAIN_UPLOAD_TIMEOUT_SECONDS: int = 3600
    TRAIN_UPLOAD_CHUNK_BYTES: int = 128 * 1024 * 1024

    # --- batch shapes of the scoring kernels (BASELINE.json configs[2]) ---
    EVAL_BATCH_TASKS: int = 1024
    EVAL_BATCH_CANDIDATES: int = 64
    PIECE_COST_CAPACITY: int = 32  # >= NORMAL_DISTRIBUTION_LEN, ring buffer per peer


CONSTANTS = Constants()
