"""Manager: the control plane (SURVEY.md §2.2).

Port of dragonfly2_tpu/manager/, whole. It imports no torch until a
model registry is attached: the control plane drives no device program.

Capability parity with manager — REST + RPC control plane,
RBAC, searcher, jobs, model lifecycle — rebuilt host-side in Python around
the same sqlite-backed document store the TPU framework uses for all
durable control-plane state (the reference uses MySQL/Postgres via GORM,
manager/database/database.go:185).
"""

from dragonfly2_tpu_torch.manager.models import Database
from dragonfly2_tpu_torch.manager.service import ManagerService

__all__ = ["Database", "ManagerService"]
