"""Masked batch normalization over node tables, eval mode (counterpart of
``eventad_tpu/ops/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """torch ``BatchNorm1d`` parameters and running statistics, in the
    reference's names (scale/offset, mean/var)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.offset = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))


def batch_norm(x: torch.Tensor, mask: torch.Tensor, bn: BatchNorm,
               eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BN of ``x [N, C]``, rows outside ``mask [N]`` zeroed.  f32
    follows torch's order of operations; other dtypes fold the affine in f32
    from the parameters rounded to ``x.dtype`` (the reference casts a
    layer's parameters, not its running statistics, to the compute dtype)
    and apply it in ``x.dtype``."""
    if x.dtype == torch.float32:
        y = (x - bn.mean) * torch.reciprocal(torch.sqrt(bn.var + eps))
        y = y * bn.scale + bn.offset
    else:
        scale = bn.scale.to(x.dtype).float()
        offset = bn.offset.to(x.dtype).float()
        a = scale * torch.reciprocal(torch.sqrt(bn.var + eps))
        b = offset - bn.mean * a
        y = x * a.to(x.dtype) + b.to(x.dtype)
    return torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype,
                                                     device=y.device))
