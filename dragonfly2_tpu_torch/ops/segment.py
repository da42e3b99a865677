"""The serving graph's padding policy.

From dragonfly2_tpu/ops/segment.py: ``pad_pow2`` only, which is all the
scheduler service needs (``serving_graph_arrays``). The segment reductions
and the subgraph gather that the graph ranker's embedding refresh runs
are not ported yet.
"""

from __future__ import annotations

import numpy as np


def pad_pow2(n: int, min_pad: int = 64) -> int:
    """Min-`min_pad` power-of-two bucket for a count — THE serving-graph
    padding policy. The producer (scheduler.serving_graph_arrays: node
    and edge padding, whose last node row is the zero-feature sink) and
    its consumer must bucket identically."""
    return max(min_pad, 1 << int(np.ceil(np.log2(max(n, 1)))))
