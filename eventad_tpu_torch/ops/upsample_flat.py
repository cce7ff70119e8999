"""K4: the level-0/1 image rows — each event's row of the align-corners
bilinear upsample of CNN maps 0 and 1 (counterpart of
``eventad_tpu/ops/upsample_flat.py``; kernel ``csrc/upsample_rows.cu``).

The TPU kernel writes a flat full-resolution table and gathers one row per
event; the CUDA kernel computes each event's row directly from the four
align-corners taps of each map, in f32 with one bf16 rounding.  The plain
version is ``models/graph.upsample_lookup`` (two interpolation products in
the maps' dtype, W then H, then the row lookup), so kernel and plain agree
to bf16 rounding, not bitwise.  Any map and sensor size is taken.
"""
from __future__ import annotations

import torch

from ..models.graph import upsample_lookup
from .kernels import launch, ptr, require


def upsample_rows_plain(feats, pos, batch, full_width: int,
                        full_height: int) -> torch.Tensor:
    """Plain PyTorch version: ``upsample_lookup`` without row masking (every
    consumer re-masks by node or edge mask)."""
    return upsample_lookup(feats, pos, batch, None, full_width, full_height,
                           mask_rows=False)


def upsample_rows_cuda(feats, pos, batch, full_width: int,
                       full_height: int) -> torch.Tensor:
    """One launch of ``csrc/upsample_rows.cu`` per map into one
    ``[rows, sum C]`` bf16 table."""
    rows = pos.shape[0]
    require(pos, "pos", dtype=torch.float32, shape=(rows, 3))
    require(batch, "batch", dtype=torch.int32, shape=(rows,))
    b = feats[0].shape[0]
    for i, f in enumerate(feats):
        require(f, f"feats[{i}]", dtype=torch.bfloat16)
        if f.dim() != 4 or f.shape[0] != b:
            raise ValueError(f"feats[{i}]: expected [B, H, W, C] with B={b},"
                             f" got {tuple(f.shape)}")
    cols = sum(f.shape[3] for f in feats)
    out = torch.empty((rows, cols), dtype=torch.bfloat16, device=pos.device)
    col0 = 0
    for f in feats:
        _, hp, wp, c = f.shape
        if rows * c:
            launch("eventad_upsample_rows", ptr(f), b, hp, wp, c, ptr(pos),
                   ptr(batch), rows, full_width, full_height, cols, col0,
                   ptr(out))
            upsample_rows_cuda.launches += 1
        col0 += c
    return out


upsample_rows_cuda.launches = 0


def upsample_rows(feats, pos, batch, full_width: int,
                  full_height: int) -> torch.Tensor:
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if pos.is_cuda:
        return upsample_rows_cuda(feats, pos, batch, full_width, full_height)
    return upsample_rows_plain(feats, pos, batch, full_width, full_height)
