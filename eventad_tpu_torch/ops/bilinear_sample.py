"""K7: bilinear sample of one CNN map at node positions (counterpart of
``eventad_tpu/ops/bilinear_sample.py:sample_bilinear_mxu``; kernel
``csrc/bilinear_sample.cu``).

For ``feat [B, hp, wp, C]`` (f32 or bf16) and normalized positions
``pos [N, >=2]`` the sample lies at ``fx = x * W * (wp-1) / (W-1)``, ``fy``
likewise; a tap outside the map counts as zero and a masked row is zero
(``grid_sample(align_corners=True)`` with zero padding, the semantics of
``models/graph.sample_image_features``).  Both versions blend the four taps
in f32 and round once to ``feat.dtype``.  Any N and any C; the item of a row
comes from ``batch`` or, without it, from the row's block (``N / B`` rows
per item).
"""
from __future__ import annotations

import torch

from .kernels import launch, ptr, require


def _axis(p: torch.Tensor, full: int, size: int):
    """Floor tap, fraction and the two taps' in-map flags of one axis."""
    # a tensor divisor: PyTorch divides by a Python number on the card as a
    # product with its reciprocal, which moves the sample by one rounding
    f = p * full * (size - 1) / torch.full(
        (), float(max(full - 1, 1)), device=p.device)
    fl = torch.floor(f)
    return (fl.long(), f - fl, (fl >= 0) & (fl < size),
            (fl >= -1) & (fl < size - 1))


def _items(n: int, b: int, batch, device) -> torch.Tensor:
    if batch is not None:
        return batch.long()
    if n % b:
        raise ValueError(f"{n} rows do not split into {b} items: pass batch")
    return torch.arange(n, device=device) // max(n // b, 1)


def sample_bilinear_plain(feat, pos, node_mask, *, full_width: int,
                          full_height: int, batch=None) -> torch.Tensor:
    """Plain PyTorch version: four indexed taps, the blend in f32."""
    b, hp, wp, _ = feat.shape
    x0, tx, okx0, okx1 = _axis(pos[:, 0].float(), full_width, wp)
    y0, ty, oky0, oky1 = _axis(pos[:, 1].float(), full_height, hp)
    bi = _items(pos.shape[0], b, batch, pos.device)
    inside = (bi >= 0) & (bi < b)
    bi = bi.clamp(0, b - 1)

    def tap(yy, xx, ok):
        v = feat[bi, yy.clamp(0, hp - 1), xx.clamp(0, wp - 1)].float()
        return torch.where(ok[:, None], v, 0.0)

    tx, ty = tx[:, None], ty[:, None]
    out = ((1 - ty) * ((1 - tx) * tap(y0, x0, oky0 & okx0)
                       + tx * tap(y0, x0 + 1, oky0 & okx1))
           + ty * ((1 - tx) * tap(y0 + 1, x0, oky1 & okx0)
                   + tx * tap(y0 + 1, x0 + 1, oky1 & okx1)))
    return torch.where((node_mask & inside)[:, None], out, 0.0) \
        .to(feat.dtype)


def sample_bilinear_cuda(feat, pos, node_mask, *, full_width: int,
                         full_height: int, batch=None) -> torch.Tensor:
    """One launch of ``csrc/bilinear_sample.cu``."""
    if feat.dim() != 4:
        raise ValueError(f"feat: expected [B, H, W, C], got "
                         f"{tuple(feat.shape)}")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feat: expected float32 or bfloat16, got "
                         f"{feat.dtype}")
    b, hp, wp, c = feat.shape
    require(feat, "feat", dtype=feat.dtype)
    if pos.dim() != 2 or pos.shape[1] < 2:
        raise ValueError(f"pos: expected [N, >=2], got {tuple(pos.shape)}")
    n, stride = pos.shape
    require(pos, "pos", dtype=torch.float32, shape=(n, stride))
    mask_u8 = node_mask.to(torch.uint8).contiguous()
    require(mask_u8, "node_mask", dtype=torch.uint8, shape=(n,))
    per_item = 0
    if batch is not None:
        require(batch, "batch", dtype=torch.int32, shape=(n,))
    elif n % b:
        raise ValueError(f"{n} rows do not split into {b} items: pass batch")
    else:
        per_item = max(n // b, 1)
    out = torch.empty((n, c), dtype=feat.dtype, device=feat.device)
    if n * c == 0:
        return out
    launch("eventad_bilinear_sample", ptr(feat), b, hp, wp, c,
           feat.element_size(), ptr(pos), stride, ptr(batch), per_item,
           ptr(mask_u8), n, full_width, full_height, ptr(out))
    sample_bilinear_cuda.launches += 1
    return out


sample_bilinear_cuda.launches = 0


def sample_bilinear(feat, pos, node_mask, **kw) -> torch.Tensor:
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if feat.is_cuda:
        return sample_bilinear_cuda(feat, pos, node_mask, **kw)
    return sample_bilinear_plain(feat, pos, node_mask, **kw)
