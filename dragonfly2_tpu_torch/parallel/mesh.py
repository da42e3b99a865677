"""Device mesh and sharding helpers, in one process.

Port of dragonfly2_tpu/parallel/mesh.py. JAX's mesh is single-controller:
one process holds every device, and ``shard_map`` runs a per-shard body
over all of them with global shapes in and global shapes out. The port
keeps that contract in one process too. A ``Mesh`` is an array of
``torch.device``s shaped (dp, graph, sp, tp, pp, ep); the sharded wrappers
(parallel/ring.py, parallel/ulysses.py) split a global tensor into
per-device blocks with ``shard_rows``, run the per-shard body over every
block in lockstep, and join the results with ``unshard_rows``. The
collectives are explicit moves between blocks with ``Tensor.to(device)``,
which autograd differentiates.

The same device may fill several places of a mesh: ``devices=["cpu"] * 8``
is the tests' counterpart of the reference's 8 fake CPU devices, and
``devices=[torch.device("cuda", 0)] * 4`` runs a 4-way mesh on one card.
A ``torch.distributed`` group could not do that: NCCL refuses two ranks on
one device. Not ported: ``initialize_distributed`` (multi-host) and
``make_hybrid_mesh``.
"""

from __future__ import annotations

import numpy as np
import torch

DP_AXIS = "dp"
GRAPH_AXIS = "graph"
SP_AXIS = "sp"  # sequence/context parallelism (ring/ulysses attention)
TP_AXIS = "tp"  # tensor parallelism
PP_AXIS = "pp"  # pipeline parallelism
EP_AXIS = "ep"  # expert parallelism
AXES = (DP_AXIS, GRAPH_AXIS, SP_AXIS, TP_AXIS, PP_AXIS, EP_AXIS)


class Mesh:
    """``devices``: an object array of ``torch.device``s, one axis per name
    of ``AXES``; ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh has {len(AXES)} axes {AXES}, got {devices.ndim}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def first_device(self) -> torch.device:
        """Where the model and the unsharded tensors live."""
        return self.devices.flat[0]

    def device(self, dp: int = 0, sp: int = 0) -> torch.device:
        """The device holding batch shard ``dp`` and sequence shard ``sp``
        (the other axes replicate those blocks; their first replica works)."""
        return self.devices[dp, 0, sp, 0, 0, 0]


def _default_devices() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "make_mesh found no CUDA device; pass devices=[...] (for instance "
            "['cpu'] * 8) to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    n_devices: int | None = None,
    dp: int | None = None,
    graph: int = 1,
    sp: int = 1,
    tp: int = 1,
    pp: int = 1,
    ep: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a (dp, graph, sp, tp, pp, ep) mesh. Defaults: every CUDA
    device, all on the dp axis; no CUDA device raises. ``devices`` may name
    one device several times."""
    devices = [torch.device(d) for d in (devices if devices is not None else _default_devices())]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    model = graph * sp * tp * pp * ep
    if dp is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model axes={model}")
        dp = n // model
    if dp * model != n:
        raise ValueError(f"mesh {dp}x{graph}x{sp}x{tp}x{pp}x{ep} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, graph, sp, tp, pp, ep))


def shard_rows(mesh: Mesh, x: torch.Tensor, seq_dim: int | None) -> list[list[torch.Tensor]]:
    """Split ``x`` into blocks ``[i][j]``: batch shard i of ``dp`` along dim
    0, sequence shard j of ``sp`` along ``seq_dim`` (one shard when None),
    each contiguous on ``mesh.device(i, j)``. Raises unless both axes
    divide their dims, as ``shard_map`` does."""
    dp = mesh.shape[DP_AXIS]
    sp = mesh.shape[SP_AXIS] if seq_dim is not None else 1
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by dp={dp}")
    if seq_dim is not None and x.shape[seq_dim] % sp:
        raise ValueError(f"sequence length {x.shape[seq_dim]} not divisible by sp={sp}")
    rows = x.split(x.shape[0] // dp, dim=0)
    blocks = []
    for i, row in enumerate(rows):
        parts = row.split(row.shape[seq_dim] // sp, dim=seq_dim) if seq_dim is not None else (row,)
        blocks.append([part.to(mesh.device(i, j)).contiguous() for j, part in enumerate(parts)])
    return blocks


def unshard_rows(blocks: list[list[torch.Tensor]], seq_dim: int, device) -> torch.Tensor:
    """The inverse of ``shard_rows``: every block moved to ``device`` and
    joined back into the global tensor."""
    return torch.cat(
        [torch.cat([b.to(device) for b in row], dim=seq_dim) for row in blocks], dim=0
    )


def _pad_dim(x: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    """``x`` padded along ``dim`` to a multiple: bool leaves (masks) with
    False, so padded rows drop out of any masked loss or metric, other
    leaves by repeating the last element, which keeps index leaves in
    range."""
    pad = (-x.shape[dim]) % multiple
    if not pad:
        return x
    if x.dtype == torch.bool:
        shape = list(x.shape)
        shape[dim] = pad
        fill = torch.zeros(shape, dtype=torch.bool, device=x.device)
    else:
        last = x.narrow(dim, x.shape[dim] - 1, 1)
        fill = last.expand(*[pad if i == dim else -1 for i in range(x.dim())])
    return torch.cat([x, fill], dim=dim)


def _placed(value, mesh: Mesh) -> torch.Tensor:
    """A private copy on the mesh's first device: ``torch.as_tensor`` of a
    numpy array on the CPU would share the caller's memory."""
    return torch.as_tensor(value).to(mesh.first_device, copy=True)


def shard_batch(mesh: Mesh, tree: dict) -> dict:
    """Every leaf (numpy or torch) on the mesh's first device, its leading
    (batch) dim padded to a multiple of dp by the reference's rules (False
    for masks, the last row repeated otherwise)."""
    dp = mesh.shape[DP_AXIS]
    return {
        key: _pad_dim(_placed(value, mesh), 0, dp)
        for key, value in tree.items()
    }


def shard_stacked_batches(mesh: Mesh, tree: dict) -> dict:
    """A stack of batches [S, B, ...] on the mesh's first device, the batch
    dim (dim 1) padded to a multiple of dp by ``shard_batch``'s rules."""
    dp = mesh.shape[DP_AXIS]
    return {
        key: _pad_dim(_placed(value, mesh), 1, dp)
        for key, value in tree.items()
    }
