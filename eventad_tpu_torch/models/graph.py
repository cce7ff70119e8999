"""Static-shape graph container shared by all network levels, and the
image-feature lookups (counterpart of ``eventad_tpu/models/graph.py``).

Level 0 is the padded event table (``B * N`` rows, ``node_mask`` marks real
events); level i >= 1 is the voxel-cell table (``B * nx_i * ny_i`` rows).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


class Graph(NamedTuple):
    x: torch.Tensor          # [N, C] node features
    pos: torch.Tensor        # [N, 3] normalized (x, y, t)
    nbr: torch.Tensor        # [N, K] int32
    nbr_mask: torch.Tensor   # [N, K] bool
    node_mask: torch.Tensor  # [N] bool
    batch: torch.Tensor      # [N] int32
    # level-0 only: per-edge integer pixel offsets (dst - src) [N, K, 2]
    off: Optional[torch.Tensor] = None


def neighbor_rows(src: torch.Tensor, grid, batch_size: int,
                  span: int) -> torch.Tensor:
    """Neighbour rows of a pooled cell table without a gather: slot ``s`` of
    cell ``(b, cy, cx)`` is cell ``(b, cy + oy, cx + ox)``, ``(oy, ox) =
    (s // side - span, s % side - span)``.  ``src [M, C]`` in (b, iy, ix)
    order; returns ``[M, S, C]`` with out-of-grid slots zero."""
    nx, ny = grid
    side = 2 * span + 1
    c = src.shape[1]
    g = src.reshape(batch_size, ny, nx, c)
    gp = F.pad(g, (0, 0, span, span, span, span))
    slots = [gp[:, span + oy:span + oy + ny, span + ox:span + ox + nx]
             for oy in range(-span, span + 1)
             for ox in range(-span, span + 1)]
    return torch.stack(slots, dim=3).reshape(batch_size * ny * nx,
                                             side * side, c)


def axis_taps(full: int, size: int):
    """``(i0, i1, t)`` of the align-corners map ``f(d) = d (size-1) /
    (full-1)`` from ``full`` output pixels to ``size`` source pixels, one
    entry per output pixel: source pixels ``i0``, ``i1`` (int32) and the
    weight ``t`` (f32, float64 coordinate cast) of ``i1`` (reference
    net.py:224)."""
    f = np.arange(full) * (size - 1) / max(full - 1, 1)
    i0 = np.floor(f).astype(np.int32)
    t = (f - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, size - 1).astype(np.int32)
    return i0, i1, t


@functools.lru_cache(maxsize=None)
def _interp_matrix(dst: int, src: int) -> np.ndarray:
    """``A[d, s]``: bilinear tap weights of source ``s`` for output pixel
    ``d``, the taps of :func:`axis_taps` as a matrix."""
    i0, i1, t = axis_taps(dst, src)
    a = np.zeros((dst, src), np.float32)
    a[np.arange(dst), i0] += 1 - t
    a[np.arange(dst), i1] += t
    return a


def pixel_index(pos: torch.Tensor, full_width: int, full_height: int):
    """Integer pixel of normalized positions: round half to even, clipped."""
    xi = torch.clamp(torch.round(pos[:, 0] * full_width).long(), 0,
                     full_width - 1)
    yi = torch.clamp(torch.round(pos[:, 1] * full_height).long(), 0,
                     full_height - 1)
    return xi, yi


def upsample_align_corners(feat: torch.Tensor, full_width: int,
                           full_height: int) -> torch.Tensor:
    """Align-corners bilinear upsample of an NHWC map to the full sensor
    resolution: two interpolation products in the map's dtype, W then H."""
    hp, wp = feat.shape[1:3]
    ay = torch.as_tensor(_interp_matrix(full_height, hp), dtype=feat.dtype,
                         device=feat.device)
    ax = torch.as_tensor(_interp_matrix(full_width, wp), dtype=feat.dtype,
                         device=feat.device)
    uw = torch.einsum("Ww,bhwc->bhWc", ax, feat)
    return torch.einsum("Hh,bhWc->bHWc", ay, uw)


def lookup_pixel_features(feat: torch.Tensor, pos: torch.Tensor,
                          batch: torch.Tensor, node_mask: torch.Tensor,
                          full_width: int,
                          full_height: int) -> torch.Tensor:
    """Row of a full-resolution NHWC map (``[B, full_height, full_width,
    C]``) at each node's pixel (:func:`pixel_index`), zero outside
    ``node_mask``."""
    xi, yi = pixel_index(pos, full_width, full_height)
    out = feat[batch.long(), yi, xi]
    return torch.where(node_mask[:, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def upsample_lookup(feats, pos: torch.Tensor, batch: torch.Tensor,
                    node_mask: torch.Tensor, full_width: int,
                    full_height: int, mask_rows: bool = True):
    """:func:`upsample_align_corners` of NHWC maps and the row of each
    node's pixel, channel-concatenated over ``feats``."""
    xi, yi = pixel_index(pos, full_width, full_height)
    bi = batch.long()
    rows = [upsample_align_corners(f, full_width, full_height)[bi, yi, xi]
            for f in feats]
    out = rows[0] if len(rows) == 1 else torch.cat(rows, dim=-1)
    if not mask_rows:
        return out
    return torch.where(node_mask[:, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def sample_image_features(feat: torch.Tensor, pos: torch.Tensor,
                          batch: torch.Tensor, node_mask: torch.Tensor,
                          full_width: int, full_height: int) -> torch.Tensor:
    """Bilinear lookup of ``feat [B, H', W', C]`` at normalized node
    positions under torch ``grid_sample(align_corners=True)`` semantics with
    zero padding (reference net.py:200-228)."""
    b, hp, wp, c = feat.shape
    fx = pos[:, 0] * full_width * (wp - 1) / max(full_width - 1, 1)
    fy = pos[:, 1] * full_height * (hp - 1) / max(full_height - 1, 1)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[:, None].to(feat.dtype)
    ty = (fy - y0)[:, None].to(feat.dtype)
    x0i = x0.long()
    y0i = y0.long()
    bi = batch.long()
    zero = torch.zeros((), dtype=feat.dtype, device=feat.device)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < hp) & (xx >= 0) & (xx < wp)
        v = feat[bi, yy.clamp(0, hp - 1), xx.clamp(0, wp - 1)]
        return torch.where(ok[:, None], v, zero)

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    out = ((1 - ty) * ((1 - tx) * v00 + tx * v01)
           + ty * ((1 - tx) * v10 + tx * v11))
    return torch.where(node_mask[:, None], out, zero)
