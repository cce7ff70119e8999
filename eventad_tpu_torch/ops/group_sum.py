"""Sums over a process group inside the model's arithmetic (the masked
batch statistics of BN, the detector loss's foreground count).

The JAX package's sharded step takes these over the whole batch and XLA
inserts the reductions across the mesh.  Here the step names the data
group for a block of code (:func:`batch_stats_group`) and the statistics
inside it are summed over that group; outside such a block the code runs
as it does in one process, unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

_GROUP = contextvars.ContextVar("eventad_batch_stats_group", default=None)


@contextlib.contextmanager
def batch_stats_group(group):
    """Within the block, batch statistics are taken over ``group`` (a
    ``torch.distributed`` process group, or None for this process's rows
    alone)."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def stats_group():
    """The group named by the innermost :func:`batch_stats_group`, or
    None."""
    return _GROUP.get()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable: the
    gradient of each rank's ``x`` is the sum of the ranks' output
    gradients, which is right where each rank's loss is its part of one
    global sum."""
    return _AllReduceSum.apply(x, group)
