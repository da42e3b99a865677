"""The device mesh and the parallel strategies over it.

``make_mesh``, ``make_hybrid_mesh``, ``shard_batch``, ``DP_AXIS`` and
``GRAPH_AXIS`` as the reference's package exports them (parallel/mesh.py),
with the strategies in their modules: ring attention (parallel/ring.py),
Ulysses (parallel/ulysses.py), tensor (parallel/tensor.py), pipeline
(parallel/pipeline.py) and expert parallelism (parallel/moe.py). The
reference's ``batch_sharding`` and ``replicated`` build JAX
``NamedSharding``s, which a mesh held in one process has no use for: the
port's wrappers split and join their blocks themselves.
"""

from dragonfly2_tpu_torch.parallel.mesh import (
    DP_AXIS,
    GRAPH_AXIS,
    make_hybrid_mesh,
    make_mesh,
    shard_batch,
)

__all__ = ["make_mesh", "make_hybrid_mesh", "shard_batch", "DP_AXIS", "GRAPH_AXIS"]
