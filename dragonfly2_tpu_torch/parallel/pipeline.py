"""Pipeline parallelism: a GPipe microbatch schedule over the ``pp`` axis.

Port of dragonfly2_tpu/parallel/pipeline.py. Each pp shard owns one
stage's params (the stage tree's leading [pp] dim), activations hop stage
to stage, and M microbatches fill the pipe (bubble (pp-1)/(M+pp-1)).
Homogeneous stages: ``stage_fn(params, a)`` keeps a's shape, the layer
stack case (the attention ranker's SelfAttentionBlocks, training/train.py).

The reference's scan runs every stage at every one of the M + pp - 1
ticks, bubble ticks included (on a clipped feed or a zero state), and
throws those results away. The port, in one process (parallel/mesh.py),
runs stage i at tick t only when it holds a real microbatch (t - i in
[0, M)): pp x M stage calls, the outputs and gradients the same, since
the discarded slots never reach the output. The hop is ``Tensor.to`` the
next stage's device; the last stage's outputs go to every shard.
"""

from __future__ import annotations

from typing import Callable

import torch

from dragonfly2_tpu_torch.parallel.mesh import PP_AXIS


def tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a tree of tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)


def pipeline_apply(stage_fn: Callable, stage_params: list, xs: list) -> list:
    """The pp shards in lockstep: ``stage_params[i]`` is stage i's params
    on its device, ``xs[i]`` the [M, ...] microbatches there (replicated);
    returns every shard's [M, ...] outputs, equal to the stages applied in
    sequence."""
    pp = len(stage_params)
    devices = [x.device for x in xs]
    num_micro = xs[0].shape[0]
    state: list = [None] * pp  # the activation each stage receives next
    outputs = [None] * num_micro
    for t in range(num_micro + pp - 1):
        incoming = [None] * pp
        for i in range(pp):
            m = t - i
            if not 0 <= m < num_micro:
                continue  # a bubble slot: the reference computes and drops it
            inp = xs[0][m] if i == 0 else state[i]
            y = stage_fn(stage_params[i], inp)
            if i == pp - 1:
                outputs[m] = y
            else:
                incoming[i + 1] = y.to(devices[i + 1])
        state = incoming
    stacked = torch.stack(outputs)
    return [stacked.to(dev) for dev in devices]


def sharded_pipeline_apply(mesh, stage_fn: Callable, stage_params, x):
    """Global shapes: ``stage_params`` is a tensor, or a tuple, list or dict
    of them, each with a leading [pp] dim (stage i's params at index i);
    x is [M, ...] microbatched input. Stage i runs on the pp axis's i-th
    device. Returns [M, ...] on x's device, differentiable in x and the
    params."""
    pp = mesh.shape[PP_AXIS]
    devices = [mesh.at(pp=i) for i in range(pp)]
    stages = [tree_map(lambda a, i=i, d=d: a[i].to(d), stage_params)
              for i, d in enumerate(devices)]
    out = pipeline_apply(stage_fn, stages, [x.to(d) for d in devices])
    return out[0].to(x.device)
