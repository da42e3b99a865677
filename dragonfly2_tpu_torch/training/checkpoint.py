"""Train-state checkpointing, without orbax.

Port of dragonfly2_tpu/training/checkpoint.py. The reference saves through
orbax's ``CheckpointManager``; the port writes one msgpack file a step in
the flax byte layout (utils/flax_msgpack.py), so a checkpoint's params are
the tree either package publishes. The same semantics:

- step-indexed directories, ``<directory>/<step>/state.msgpack``, the
  newest ``max_to_keep`` kept;
- a save commits atomically: the state is written and fsynced into a
  temporary directory that is then renamed onto ``<step>``;
- ``restore()`` with no step falls back past a step that does not load
  (a torn or truncated payload) to the newest one that does; an explicit
  ``restore(step)`` raises; when steps exist and none loads, the last
  error is raised, never ``None``.

A state is a dict tree whose leaves are numpy arrays, torch tensors
(copied to host numpy), numbers or strings: the trainers save
``{"params": <flax tree>, "opt_state": <AdamW moments>, "epoch": e}``
(training/train.py ``_resume_hooks``). Nothing is pickled.
"""

from __future__ import annotations

import logging
import os
import pathlib
import shutil
import tempfile
from typing import Any

from dragonfly2_tpu_torch.utils import flax_msgpack

logger = logging.getLogger(__name__)

STATE_FILE = "state.msgpack"


class TrainCheckpointer:
    """Step-indexed checkpoints of a train state."""

    def __init__(self, directory: str | pathlib.Path, max_to_keep: int = 3):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, step: int, state: Any) -> None:
        blob = flax_msgpack.serialize(state)
        tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".{step}.", suffix=".tmp", dir=self.directory))
        try:
            with open(tmp / STATE_FILE, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            target = self.directory / str(int(step))
            if target.exists():
                shutil.rmtree(target)
            os.replace(tmp, target)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else ():
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def restore(self, step: int | None = None, template: Any = None) -> Any:
        """Restore ``step``, or, with no step given, the NEWEST checkpoint
        that loads. A ``template`` must have the restored tree's keys and
        leaf shapes; a ``None`` in it matches any subtree."""
        if step is not None:
            blob = (self.directory / str(int(step)) / STATE_FILE).read_bytes()
            tree = flax_msgpack.restore(blob)
            if template is not None:
                _check_against_template(template, tree)
            return tree
        last_err: Exception | None = None
        for candidate in reversed(self.all_steps()):
            try:
                return self.restore(candidate, template=template)
            except Exception as e:  # noqa: BLE001 - a torn checkpoint: try an older one
                last_err = e
                logger.warning("checkpoint step %d failed to restore (%s); "
                               "falling back to the previous step", candidate, e)
        if last_err is not None:
            # steps EXIST but none loads: a systematic fault (a template
            # mismatch, a format skew), not a torn write; restarting an
            # expensive run from step 0 in silence would hide it
            raise last_err
        return None  # nothing saved yet

    def close(self) -> None:
        """Nothing to release: every save finishes before it returns."""

    def clear(self) -> None:
        """Completed-run cleanup: delete the saved state, so the NEXT
        training run starts from scratch instead of 'resuming' past its
        final epoch and publishing stale params."""
        shutil.rmtree(self.directory, ignore_errors=True)


def _check_against_template(template: Any, tree: Any, path: str = "") -> None:
    if template is None:
        return
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(map(str, template)) != set(tree):
            raise ValueError(f"checkpoint at {path or '/'} does not match the template's keys")
        for key, sub in template.items():
            _check_against_template(sub, tree[str(key)], f"{path}/{key}")
    elif tuple(getattr(template, "shape", ())) != tuple(getattr(tree, "shape", ())):
        raise ValueError(
            f"checkpoint leaf {path} has shape {getattr(tree, 'shape', None)}, "
            f"template {tuple(template.shape)}"
        )


def params_to_bytes(params: Any) -> bytes:
    """Serialize a params tree for the wire (the CreateModel stream): the
    flax msgpack layout, byte for byte the reference's."""
    return flax_msgpack.serialize(params)


def params_from_bytes(blob: bytes) -> Any:
    return flax_msgpack.restore(blob)
