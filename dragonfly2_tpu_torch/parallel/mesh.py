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
one device.

Several processes (``initialize_distributed``, ``make_hybrid_mesh``) join
on the dp axis alone, as the reference's slices join over DCN: each
process holds its own (dp, graph, sp, tp, pp, ep) mesh, and the mesh
records the process group, the number of processes (``dcn``) and this
process's rank in it. The global batch is the processes' dp blocks side
by side, in rank order; the trainers all-reduce their gradients across
the group (training/train.py). The model axes never span processes.
"""

from __future__ import annotations

import os

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

    def __init__(self, devices: np.ndarray, group=None):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh has {len(AXES)} axes {AXES}, got {devices.ndim}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        # the torch.distributed group whose processes share the dp axis
        # (None: this process holds the whole mesh)
        self.group = group
        self.dcn = 1 if group is None else torch.distributed.get_world_size(group)
        self.dcn_rank = 0 if group is None else torch.distributed.get_rank(group)

    @property
    def size(self) -> int:
        """The number of places on this process's mesh (``jax.sharding.Mesh.size``)."""
        return self.devices.size

    @property
    def first_device(self) -> torch.device:
        """Where the model and the unsharded tensors live."""
        return self.devices.flat[0]

    def device(self, dp: int = 0, sp: int = 0) -> torch.device:
        """The device holding batch shard ``dp`` and sequence shard ``sp``
        (the other axes replicate those blocks; their first replica works)."""
        return self.devices[dp, 0, sp, 0, 0, 0]

    def at(self, dp: int = 0, graph: int = 0, sp: int = 0, tp: int = 0, pp: int = 0,
           ep: int = 0) -> torch.device:
        """The device at one coordinate of every axis."""
        return self.devices[dp, graph, sp, tp, pp, ep]

    def slice(self, axis: str, index: int) -> "Mesh":
        """The mesh of the places whose ``axis`` coordinate is ``index`` (that
        axis of size 1): the devices of one tp shard, for instance."""
        i = AXES.index(axis)
        return Mesh(np.take(self.devices, [index], axis=i), self.group)


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


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Multi-host bootstrap: ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` (host:port of process 0). Missing
    arguments come from torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``. After this,
    ``make_hybrid_mesh`` builds a mesh whose dp axis spans the processes.

    ``backend`` (not in the reference): None takes NCCL where CUDA is
    present and gloo otherwise. Processes that share one card must pass
    ``"gloo"``: NCCL refuses two ranks on one device."""
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator_address and no MASTER_ADDR/MASTER_PORT set")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None
    if process_id is None:
        process_id = int(env["RANK"]) if "RANK" in env else None
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are needed (or WORLD_SIZE and RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id,
    )


def make_hybrid_mesh(
    dcn_dp: int,
    dp: int = 1,
    graph: int = 1,
    sp: int = 1,
    tp: int = 1,
    pp: int = 1,
    ep: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Mesh for multi-host topologies: ``dcn_dp`` data-parallel replicas
    across processes, every other axis within a process. Only the dp axis
    crosses the slow network, so a step's one cross-process exchange is
    the gradient all-reduce.

    With ``torch.distributed`` initialised over N > 1 processes, ``dcn_dp``
    must be N: this process's mesh is (dp, graph, sp, tp, pp, ep) over
    ``devices`` (default: the CUDA devices; none raises), and it records the
    group and this process's rank in it. In one process there is no such
    topology, so the dcn replicas fold into dp (``make_mesh`` with dp =
    dcn_dp * dp), the reference's own path where the platform has no slice
    topology."""
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    model = graph * sp * tp * pp * ep
    if world == 1:
        return make_mesh(dcn_dp * dp * model, dp=dcn_dp * dp, graph=graph, sp=sp, tp=tp, pp=pp,
                         ep=ep, devices=devices)
    if dcn_dp != world:
        raise ValueError(f"dcn_dp={dcn_dp} must equal the {world} processes of the group")
    local = make_mesh(dp * model, dp=dp, graph=graph, sp=sp, tp=tp, pp=pp, ep=ep,
                      devices=devices)
    return Mesh(local.devices, dist.group.WORLD)


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


def _dcn_block(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """``x``, padded along ``dim`` to a multiple of the global dp (dcn x
    dp), cut to this process's contiguous block of it."""
    x = _pad_dim(x, dim, mesh.dcn * mesh.shape[DP_AXIS])
    if mesh.dcn == 1:
        return x
    size = x.shape[dim] // mesh.dcn
    return x.narrow(dim, mesh.dcn_rank * size, size).contiguous()


def shard_batch(mesh: Mesh, tree: dict) -> dict:
    """Every leaf (numpy or torch) on the mesh's first device, its leading
    (batch) dim padded to a multiple of dp by the reference's rules (False
    for masks, the last row repeated otherwise). On a mesh across
    processes, the padding is to the global dp and each process keeps its
    own block of rows."""
    return {key: _dcn_block(_placed(value, mesh), 0, mesh) for key, value in tree.items()}


def shard_stacked_batches(mesh: Mesh, tree: dict) -> dict:
    """A stack of batches [S, B, ...] on the mesh's first device, the batch
    dim (dim 1) padded and, across processes, cut by ``shard_batch``'s
    rules."""
    return {key: _dcn_block(_placed(value, mesh), 1, mesh) for key, value in tree.items()}
