"""K4: the level-0/1 image rows — each event's row of the align-corners
bilinear upsample of CNN maps 0 and 1 (counterpart of
``eventad_tpu/ops/upsample_flat.py``; kernel ``csrc/upsample_rows.cu``).

The TPU kernel writes a flat full-resolution table and gathers one row per
event; here each event's row is computed directly from the four
align-corners taps of each map, found in per-axis tap tables
(``models/graph.axis_taps``, the taps ``_interp_matrix`` is built from,
kept on the device once per geometry, :func:`tap_tables`), in
f32 with one rounding to the maps' type at the end.  The plain version
(:func:`upsample_rows_plain`) does that arithmetic with tensor operations,
so on the card kernel and plain version round alike; against
``models/graph.upsample_lookup`` (two interpolation products in the maps'
type, W then H) they agree to the maps' rounding.  Any map and sensor size
is taken; one launch writes every map's column range.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models.graph import axis_taps, pixel_index
from .kernels import launch, ptr, require

MAX_MAPS = 4       # maps one launch takes


@functools.lru_cache(maxsize=None)
def tap_tables(full_width: int, full_height: int, sizes: tuple,
               device: str) -> torch.Tensor:
    """``[M, full_width + full_height, 4]`` int32 on ``device``: per map
    (``sizes[m] = (hp, wp)``) its x taps, then its y taps, each record
    ``(i0, i1, t as its bits, 0)``.  Cached: after the first call for a
    geometry nothing is copied to the card."""
    tab = np.zeros((len(sizes), full_width + full_height, 4), np.int32)
    for m, (hp, wp) in enumerate(sizes):
        for at, (full, size) in ((0, (full_width, wp)),
                                 (full_width, (full_height, hp))):
            i0, i1, t = axis_taps(full, size)
            tab[m, at:at + full, 0] = i0
            tab[m, at:at + full, 1] = i1
            tab[m, at:at + full, 2] = t.view(np.int32)
    return torch.from_numpy(tab).to(device)


def _sizes(feats) -> tuple:
    return tuple((int(f.shape[1]), int(f.shape[2])) for f in feats)


def upsample_rows_plain(feats, pos, batch, full_width: int,
                        full_height: int) -> torch.Tensor:
    """Plain PyTorch version: per map the four taps of each row's pixel
    from :func:`tap_tables`, interpolated in f32 along W, then H, and
    rounded once to the maps' type; the maps' column ranges side by side
    (no row masking: every consumer re-masks by node or edge mask)."""
    taps = tap_tables(full_width, full_height, _sizes(feats),
                      str(pos.device))
    tf = taps.view(torch.float32)
    xi, yi = pixel_index(pos, full_width, full_height)
    yi = yi + full_width
    bi = batch.long()
    rows = []
    for m, f in enumerate(feats):
        x0, x1 = taps[m, xi, 0].long(), taps[m, xi, 1].long()
        y0, y1 = taps[m, yi, 0].long(), taps[m, yi, 1].long()
        tx, ty = tf[m, xi, 2, None], tf[m, yi, 2, None]
        ff = f.float()

        def lerp(a, b, t):
            return (1 - t) * a + t * b
        top = lerp(ff[bi, y0, x0], ff[bi, y0, x1], tx)
        bot = lerp(ff[bi, y1, x0], ff[bi, y1, x1], tx)
        rows.append(lerp(top, bot, ty).to(f.dtype))
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=-1)


def upsample_rows_cuda(feats, pos, batch, full_width: int,
                       full_height: int) -> torch.Tensor:
    """One launch of ``csrc/upsample_rows.cu`` for all maps (at most
    :data:`MAX_MAPS`) into one ``[rows, sum C]`` bf16 table.  A map whose
    C is not a multiple of 8, or an operand not 16-byte aligned, takes the
    kernel's scalar path."""
    rows = pos.shape[0]
    require(pos, "pos", dtype=torch.float32, shape=(rows, 3))
    require(batch, "batch", dtype=torch.int32, shape=(rows,))
    if not 1 <= len(feats) <= MAX_MAPS:
        raise ValueError(f"feats: 1 to {MAX_MAPS} maps, got {len(feats)}")
    b = feats[0].shape[0]
    for i, f in enumerate(feats):
        require(f, f"feats[{i}]", dtype=torch.bfloat16)
        if f.dim() != 4 or f.shape[0] != b:
            raise ValueError(f"feats[{i}]: expected [B, H, W, C] with B={b},"
                             f" got {tuple(f.shape)}")
        if b * f.shape[1] * f.shape[2] >= 2 ** 31:
            raise ValueError(f"feats[{i}]: B * H * W must stay below 2^31")
    cols = sum(f.shape[3] for f in feats)
    out = torch.empty((rows, cols), dtype=torch.bfloat16, device=pos.device)
    if rows * cols:
        taps = tap_tables(full_width, full_height, _sizes(feats),
                          str(pos.device))
        maps = (ctypes.c_void_p * len(feats))(*(f.data_ptr() for f in feats))
        dims = (ctypes.c_int * (3 * len(feats)))(
            *(int(d) for f in feats for d in f.shape[1:]))
        launch("eventad_upsample_rows", maps, dims, len(feats), ptr(taps),
               ptr(pos), ptr(batch), rows, full_width, full_height,
               ptr(out))
        upsample_rows_cuda.launches += 1
    return out


upsample_rows_cuda.launches = 0


def upsample_rows(feats, pos, batch, full_width: int,
                  full_height: int) -> torch.Tensor:
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if pos.is_cuda:
        return upsample_rows_cuda(feats, pos, batch, full_width, full_height)
    return upsample_rows_plain(feats, pos, batch, full_width, full_height)
