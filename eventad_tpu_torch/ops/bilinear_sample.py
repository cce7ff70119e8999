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
per item).  ``out``, where given, is a ``[N, C]`` view with unit channel
stride and any row stride (a column range of a wider table) that receives
the result; nothing else of its storage is written.
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


def _check_out(out, feat, n: int, c: int) -> None:
    if out.device != feat.device or out.dtype != feat.dtype:
        raise ValueError(f"out: expected {feat.dtype} on {feat.device}, got "
                         f"{out.dtype} on {out.device}")
    if tuple(out.shape) != (n, c):
        raise ValueError(f"out: expected shape {(n, c)}, got "
                         f"{tuple(out.shape)}")
    if c > 1 and out.stride(1) != 1:
        raise ValueError("out: expected unit channel stride")
    if n > 1 and out.stride(0) < c:
        raise ValueError("out: rows overlap")


def sample_bilinear_plain(feat, pos, node_mask, *, full_width: int,
                          full_height: int, batch=None,
                          out=None) -> torch.Tensor:
    """Plain PyTorch version: four indexed taps, the blend in f32."""
    b, hp, wp, _ = feat.shape
    if out is not None:
        _check_out(out, feat, pos.shape[0], feat.shape[-1])
    x0, tx, okx0, okx1 = _axis(pos[:, 0].float(), full_width, wp)
    y0, ty, oky0, oky1 = _axis(pos[:, 1].float(), full_height, hp)
    bi = _items(pos.shape[0], b, batch, pos.device)
    inside = (bi >= 0) & (bi < b)
    bi = bi.clamp(0, b - 1)

    def tap(yy, xx, ok):
        v = feat[bi, yy.clamp(0, hp - 1), xx.clamp(0, wp - 1)].float()
        return torch.where(ok[:, None], v, 0.0)

    tx, ty = tx[:, None], ty[:, None]
    res = ((1 - ty) * ((1 - tx) * tap(y0, x0, oky0 & okx0)
                       + tx * tap(y0, x0 + 1, oky0 & okx1))
           + ty * ((1 - tx) * tap(y0 + 1, x0, oky1 & okx0)
                   + tx * tap(y0 + 1, x0 + 1, oky1 & okx1)))
    res = torch.where((node_mask & inside)[:, None], res, 0.0) \
        .to(feat.dtype)
    return res if out is None else out.copy_(res)


def sample_bilinear_cuda(feat, pos, node_mask, *, full_width: int,
                         full_height: int, batch=None,
                         out=None) -> torch.Tensor:
    """One launch of ``csrc/bilinear_sample.cu``.  The mask is read as the
    bytes of the ``bool`` (or ``uint8``) tensor it is."""
    if feat.dim() != 4:
        raise ValueError(f"feat: expected [B, H, W, C], got "
                         f"{tuple(feat.shape)}")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feat: expected float32 or bfloat16, got "
                         f"{feat.dtype}")
    if node_mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"node_mask: expected bool or uint8, got "
                         f"{node_mask.dtype}")
    b, hp, wp, c = feat.shape
    require(feat, "feat", dtype=feat.dtype)
    if pos.dim() != 2 or pos.shape[1] < 2:
        raise ValueError(f"pos: expected [N, >=2], got {tuple(pos.shape)}")
    n, stride = pos.shape
    require(pos, "pos", dtype=torch.float32, shape=(n, stride))
    require(node_mask, "node_mask", dtype=node_mask.dtype, shape=(n,))
    per_item = 0
    if batch is not None:
        require(batch, "batch", dtype=torch.int32, shape=(n,))
    elif n % b:
        raise ValueError(f"{n} rows do not split into {b} items: pass batch")
    else:
        per_item = max(n // b, 1)
    if out is None:
        out = torch.empty((n, c), dtype=feat.dtype, device=feat.device)
    else:
        _check_out(out, feat, n, c)
    if n * c == 0:
        return out
    launch("eventad_bilinear_sample", ptr(feat), b, hp, wp, c,
           feat.element_size(), ptr(pos), stride, ptr(batch), per_item,
           ptr(node_mask), n, full_width, full_height, ptr(out),
           out.stride(0) if n > 1 else c)
    sample_bilinear_cuda.launches += 1
    return out


sample_bilinear_cuda.launches = 0


def sample_bilinear(feat, pos, node_mask, **kw) -> torch.Tensor:
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if feat.is_cuda:
        return sample_bilinear_cuda(feat, pos, node_mask, **kw)
    return sample_bilinear_plain(feat, pos, node_mask, **kw)
