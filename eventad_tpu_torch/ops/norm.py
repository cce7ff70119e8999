"""Masked batch normalization over node tables (counterpart of
``eventad_tpu/ops/norm.py``): running statistics in eval mode, the masked
batch statistics when training."""
from __future__ import annotations

import torch
from torch import nn

from ..utils.tensors import frozen_operands
from .group_sum import all_reduce_sum, stats_group


MOMENTUM = 0.1   # of the running statistics, torch's default


class BatchNorm(nn.Module):
    """torch ``BatchNorm1d`` parameters and running statistics, in the
    reference's names (scale/offset, mean/var)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.offset = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))


def batch_statistics(x: torch.Tensor, mask: torch.Tensor):
    """``(mean, biased var, count)`` of ``x [N, C]`` over the rows of
    ``mask [N]``, in f32.  Inside ``ops.group_sum.batch_stats_group`` the
    rows are those of every rank of the group, in the same two passes: the
    masked sums and the count, then the squared deviations from the mean."""
    xf = x.to(torch.float32)
    m = mask[:, None].to(torch.float32)
    group = stats_group()
    if group is None:
        cnt = m.sum().clamp(min=1.0)
        mean = (xf * m).sum(dim=0) / cnt
        d = (xf - mean) * m
        return mean, (d * d).sum(dim=0) / cnt, cnt
    sums = all_reduce_sum(torch.cat([(xf * m).sum(dim=0), m.sum()[None]]),
                          group)
    cnt = sums[-1].clamp(min=1.0)
    mean = sums[:-1] / cnt
    d = (xf - mean) * m
    return mean, all_reduce_sum((d * d).sum(dim=0), group) / cnt, cnt


def channel_statistics(h: torch.Tensor):
    """``(mean, biased var, count)`` of an NCHW map per channel, over the
    batch and the pixels of this map (``count`` an int), or of every rank
    of the group named by ``ops.group_sum.batch_stats_group`` inside one
    (``count`` a tensor), in :func:`batch_statistics`' two passes."""
    group = stats_group()
    if group is None:
        return (h.mean(dim=(0, 2, 3)), h.var(dim=(0, 2, 3), unbiased=False),
                h.numel() // h.shape[1])
    sums = all_reduce_sum(torch.cat([
        h.sum(dim=(0, 2, 3)), h.new_tensor([h.numel() // h.shape[1]])]),
        group)
    cnt = sums[-1]
    mean = sums[:-1] / cnt
    d = h - mean[:, None, None]
    return mean, all_reduce_sum((d * d).sum(dim=(0, 2, 3)), group) / cnt, cnt


def batch_norm(x: torch.Tensor, mask: torch.Tensor, bn: BatchNorm,
               eps: float = 1e-5, *, training: bool = False) -> torch.Tensor:
    """BN of ``x [N, C]``, rows outside ``mask [N]`` zeroed.  Eval mode
    normalises by the running statistics.  ``training`` normalises by the
    statistics of the masked rows (biased variance) and moves ``bn.mean`` /
    ``bn.var`` towards them in place (unbiased variance, torch
    ``BatchNorm1d``).  f32 follows torch's order of operations; other dtypes
    fold the affine in f32 from the parameters rounded to ``x.dtype`` (the
    reference casts a layer's parameters, not its statistics, to the compute
    dtype) and apply it in ``x.dtype``."""
    mean = bn.mean
    if training:
        mean, var, cnt = batch_statistics(x, mask)
        with torch.no_grad():
            unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
            bn.mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
            bn.var.mul_(1 - MOMENTUM).add_(MOMENTUM * unbiased)
        affine = _affine(bn, mean, var, eps, x.dtype)
    else:
        affine = eval_affine(bn, x.dtype, eps)
    if x.dtype == torch.float32:
        y = (x - mean) * affine
        y = y * bn.scale + bn.offset
    else:
        y = x * affine[0] + affine[1]
    return torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype,
                                                     device=y.device))


def _affine(bn: BatchNorm, mean, var, eps: float, dt: torch.dtype):
    inv = torch.reciprocal(torch.sqrt(var + eps))
    if dt == torch.float32:
        return inv
    a = bn.scale.to(dt).float() * inv
    return a.to(dt), (bn.offset.to(dt).float() - mean * a).to(dt)


def eval_affine(bn: BatchNorm, dt: torch.dtype, eps: float = 1e-5):
    """What :func:`batch_norm` in eval mode takes from ``bn`` for ``x`` in
    ``dt``: in f32 ``1 / sqrt(var + eps)``; otherwise the affine ``(a,
    b)`` in ``dt``, folded in f32 from the parameters rounded to ``dt``.
    Kept on ``bn`` (``utils/tensors.frozen_operands``): a training step
    moves the running statistics in place, so the next eval forward folds
    anew."""
    return frozen_operands(bn, "eval_affine",
                           (bn.scale, bn.offset, bn.mean, bn.var),
                           lambda: _affine(bn, bn.mean, bn.var, eps, dt),
                           key=(dt, eps))
