"""Masked batch normalization over node tables (counterpart of
``eventad_tpu/ops/norm.py``): running statistics in eval mode, the masked
batch statistics when training."""
from __future__ import annotations

import torch
from torch import nn


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
    ``mask [N]``, in f32."""
    xf = x.to(torch.float32)
    m = mask[:, None].to(torch.float32)
    cnt = m.sum().clamp(min=1.0)
    mean = (xf * m).sum(dim=0) / cnt
    d = (xf - mean) * m
    return mean, (d * d).sum(dim=0) / cnt, cnt


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
    mean, var = bn.mean, bn.var
    if training:
        mean, var, cnt = batch_statistics(x, mask)
        with torch.no_grad():
            unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
            bn.mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
            bn.var.mul_(1 - MOMENTUM).add_(MOMENTUM * unbiased)
    if x.dtype == torch.float32:
        y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
        y = y * bn.scale + bn.offset
    else:
        scale = bn.scale.to(x.dtype).float()
        offset = bn.offset.to(x.dtype).float()
        a = scale * torch.reciprocal(torch.sqrt(var + eps))
        b = offset - mean * a
        y = x * a.to(x.dtype) + b.to(x.dtype)
    return torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype,
                                                     device=y.device))
