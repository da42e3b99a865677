"""Versioned model registry: the manager's model lifecycle, on a filesystem.

Port of dragonfly2_tpu/registry/registry.py: the model-type and state
constants, ``ModelEvaluation``, ``ModelVersion``, ``_version_from_json``,
``_atomic_write_json`` and the filesystem ``ModelRegistry`` with the
reference's public surface and state machine (create a version, activate
exactly one, mark a version bad with fallback to the newest loadable good
one, delete any but the active one).

The one difference is where the params go. The reference's filesystem
registry saves them with orbax, as a ``<model_id>/<version>/params/``
tree; the card's machine has no orbax. The port's ``ModelRegistry`` is the
bucket registry (registry/bucket.py) over the filesystem backend rooted at
``base_dir``'s parent, the bucket being ``base_dir``'s name, so its layout
is the reference's manifests with the bucket's params beside them:

    <base_dir>/<model_id>/model.json                 active-version pointer
    <base_dir>/<model_id>/<version>/version.json     metadata + evaluation
    <base_dir>/<model_id>/<version>/params.msgpack   the flax msgpack layout
    <base_dir>/<model_id>/<version>/params.sha256    its integrity manifest

The reference reads every version the port publishes through its bucket
registry, ``open_registry("fs://<base_dir name>?base_dir=<parent>")``; its
orbax ``ModelRegistry(base_dir)`` does not (it looks for ``params/``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import shutil
import tempfile

MODEL_TYPE_GNN = "gnn"
MODEL_TYPE_MLP = "mlp"
# beyond the reference's gnn|mlp enum (manager/models/model.go:19-46): the
# set-transformer ranker family (models/attention.py)
MODEL_TYPE_ATTENTION = "attention"

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


def _atomic_write_json(path: pathlib.Path, data: dict) -> None:
    """A concurrent reader (a scheduler's ModelServer.refresh mid-activation)
    must never see a half-written manifest: write a UNIQUE temp file (two
    writers must not rename each other's away), fsync, and rename (atomic
    on POSIX)."""
    fd, tmp_name = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp", dir=path.parent)
    try:
        with os.fdopen(fd, "w") as f:
            # mkstemp creates 0600; manifests stay readable by other users
            os.fchmod(f.fileno(), 0o644)
            f.write(json.dumps(data, indent=2))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_name, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp_name)
        raise


# Imported here, after the types above that bucket.py reads from this
# module: the package's __init__ imports this module first, so bucket.py
# always finds them.
from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend  # noqa: E402
from dragonfly2_tpu_torch.registry.bucket import BucketModelRegistry  # noqa: E402


class ModelRegistry(BucketModelRegistry):
    """Filesystem registry: ``<base>/<model_id>/<version>/{version.json,
    params.msgpack, params.sha256}`` plus ``<base>/<model_id>/model.json``
    recording the active version. Manifests are written by
    ``_atomic_write_json``; a deleted version's directory goes whole."""

    def __init__(self, base_dir: str | pathlib.Path):
        self.base = pathlib.Path(base_dir).absolute()
        self.base.mkdir(parents=True, exist_ok=True)
        super().__init__(FilesystemBackend(self.base.parent), self.base.name)

    def _put_json(self, data: dict, *parts: str) -> None:
        path = self.base / self._key(*parts)
        path.parent.mkdir(parents=True, exist_ok=True)
        _atomic_write_json(path, data)

    def delete_version(self, model_id: str, version: int) -> None:
        super().delete_version(model_id, version)  # refuses the active version
        shutil.rmtree(self.base / model_id / str(version), ignore_errors=True)
