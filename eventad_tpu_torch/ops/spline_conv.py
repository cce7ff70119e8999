"""Spline convolution over fixed-K neighbour tables (counterpart of
``eventad_tpu/ops/spline_conv.py``).

Every edge touches at most 4 of the ``kernel_size**2`` kernel taps (degree-1
spline), so the convolution is a coefficient contraction followed by one
dense product:

    z[n, m, c] = sum_k coeff[n, k, m] * x[nbr[n, k], c]
    out[n, o]  = z[n].reshape(M * Cin) @ W.reshape(M * Cin, Cout)
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..utils.tensors import constant, frozen_operands


class SplineConv(nn.Module):
    """PyG ``SplineConv`` parameters: ``weight [K*K, Cin, Cout]`` (x tap
    fastest), ``root [Cin, Cout]`` and, for the detection head's prediction
    convs only, a zero-initialised ``bias [Cout]`` (the backbone's layers
    use none)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, generator: torch.Generator = None,
                 bias: bool = False):
        super().__init__()
        m = kernel_size * kernel_size
        s = 1.0 / (in_channels * m) ** 0.5
        sr = 1.0 / in_channels ** 0.5
        w = torch.empty(m, in_channels, out_channels)
        r = torch.empty(in_channels, out_channels)
        self.weight = nn.Parameter(w.uniform_(-s, s, generator=generator))
        self.root = nn.Parameter(r.uniform_(-sr, sr, generator=generator))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)


def cartesian_attr(pos: torch.Tensor, nbr: torch.Tensor,
                   nbr_mask: torch.Tensor, max_value: float,
                   clamp: bool = True) -> torch.Tensor:
    """Pseudo-coordinates ``[N, K, 2]`` of each (destination, slot) edge,
    PyG ``T.Cartesian(norm=True, cat=False)``: ``(pos[dst] - pos[src]) /
    (2 max) + 0.5``, clipped to [0, 1] with ``clamp``, 0.5 where masked
    (reference net.py:71-121)."""
    d = pos[:, None, :2] - pos[nbr.long()][..., :2]
    attr = d / (2.0 * max_value) + 0.5
    if clamp:
        attr = torch.clamp(attr, 0.0, 1.0)
    return torch.where(nbr_mask[..., None], attr, 0.5)


def tap_ranges(kernel_size: int,
               attr_range) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Static inclusive per-axis tap bounds ``((mx_lo, mx_hi), (my_lo,
    my_hi))`` implied by static attr bounds ``((ax_lo, ax_hi), (ay_lo,
    ay_hi))``."""
    k = kernel_size
    out = []
    for lo, hi in attr_range:
        u_lo = min(max(float(lo), 0.0), 1.0) * (k - 1)
        u_hi = min(max(float(hi), 0.0), 1.0) * (k - 1)
        i0 = max(min(math.floor(u_lo - 1e-5), k - 2), 0)
        i1 = max(min(math.floor(u_hi + 1e-5), k - 2), 0)
        out.append((i0, min(i1 + 1, k - 1)))
    return tuple(out)


def center_index(kernel_size: int) -> int:
    """Flat kernel tap hit by ``attr == 0.5`` with weight 1 (odd K)."""
    c = (kernel_size - 1) // 2
    return c + c * kernel_size


def sub_kernel_index(kernel_size: int, ranges) -> np.ndarray:
    """Flat kernel indices of the tap sub-rectangle (x fastest)."""
    (mx0, mx1), (my0, my1) = ranges
    return (np.arange(my0, my1 + 1)[:, None] * kernel_size
            + np.arange(mx0, mx1 + 1)[None, :]).reshape(-1)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    ar = torch.arange(n, device=idx.device)
    return (idx[..., None] == ar).to(dtype)


def spline_coeff_sep(attr: torch.Tensor, kernel_size: int, ranges,
                     dtype=torch.float32):
    """Separable tap weights ``(cx [..., nxs], cy [..., nys])`` restricted to
    the tap sub-rectangle ``ranges``; ``coeff[..., my*nxs+mx] = cy*cx``."""
    (mx0, mx1), (my0, my1) = ranges
    k = kernel_size
    u = torch.clamp(attr, 0.0, 1.0) * (k - 1)

    def axis(ud, m0, nsub):
        i0 = torch.clamp(torch.floor(ud).to(torch.int32), 0, k - 2)
        fr = (ud - i0).to(dtype)
        loc = i0 - m0
        return (_one_hot(loc, nsub, dtype) * (1.0 - fr)[..., None]
                + _one_hot(loc + 1, nsub, dtype) * fr[..., None])

    return (axis(u[..., 0], mx0, mx1 - mx0 + 1),
            axis(u[..., 1], my0, my1 - my0 + 1))


def offset_attr(off: torch.Tensor, nbr_mask: torch.Tensor, max_value: float,
                width: int, height: int) -> torch.Tensor:
    """Pseudo-coordinates from integer ``dst - src`` pixel offsets
    ``off [N, K, 2]``: ``off / (2 max size) + 0.5``, clipped, 0.5 where
    masked."""
    s = constant((1.0 / (2.0 * max_value * width),
                  1.0 / (2.0 * max_value * height)), torch.float32,
                 off.device)
    a = torch.clamp(off.to(torch.float32) * s + 0.5, 0.0, 1.0)
    return torch.where(nbr_mask[..., None], a, 0.5)


def conv_operands(conv: SplineConv, dt: torch.dtype, kernel_size: int,
                  ranges, add_center_to_root: bool):
    """What :func:`spline_conv` takes from ``conv`` in ``dt``: ``(w_sub,
    root, bias)``, the weights of the tap sub-rectangle ``ranges``, the
    root (plus the centre tap's weight with ``add_center_to_root``) and the
    bias (None without one), cast to ``dt``.  Kept on the conv
    (``utils/tensors.frozen_operands``), so a call with unchanged weights
    gathers, folds and copies nothing."""
    sources = [conv.weight, conv.root]
    if conv.bias is not None:
        sources.append(conv.bias)

    def make():
        weight = conv.weight.to(dt)
        idx = sub_kernel_index(kernel_size, ranges)
        w_sub = weight[constant(idx.tolist(), torch.int64, weight.device)]
        root = conv.root.to(dt)
        if add_center_to_root:
            root = root + weight[center_index(kernel_size)]
        return (w_sub, root,
                None if conv.bias is None else conv.bias.to(dt))
    return frozen_operands(conv, "conv_operands", sources, make,
                           key=(dt, kernel_size, ranges, add_center_to_root))


def spline_conv(x: torch.Tensor, nbr: torch.Tensor, nbr_mask: torch.Tensor,
                attr: torch.Tensor, conv: SplineConv, *, kernel_size: int,
                aggr: str = "sum", node_mask: torch.Tensor = None,
                x_dst: torch.Tensor = None, x_j: torch.Tensor = None,
                attr_range=None,
                add_center_to_root: bool = False) -> torch.Tensor:
    """Spline convolution of ``x [N, Cin]`` over ``nbr/nbr_mask [N_dst,
    K]`` with pseudo-coordinates ``attr [N_dst, K, 2]``, computed in
    ``x.dtype`` (weights cast to it); returns ``[N_dst, Cout]``.

    ``x_dst``: the destination rows ``[N_dst, Cin]`` when they are a subset
    of the gather source ``x`` (the incremental streaming path); default
    ``x`` itself (``N_dst = N``).  ``x_j``: pre-gathered neighbour rows
    ``[N_dst, K, Cin]``.  ``attr_range``: static attr bounds; the
    contraction runs on the implied tap sub-rectangle only (exact).
    ``add_center_to_root``: the caller removed the self edge (attr exactly
    0.5, the centre tap with weight 1) and its contribution ``x_dst @
    weight[centre]`` is added to the root product."""
    n, k = nbr.shape
    cin = x.shape[1]
    xd = x if x_dst is None else x_dst
    dt = x.dtype
    if attr_range is None:
        ranges = ((0, kernel_size - 1), (0, kernel_size - 1))
    else:
        ranges = tap_ranges(kernel_size, attr_range)
    (mx0, mx1), (my0, my1) = ranges
    m_sub = (mx1 - mx0 + 1) * (my1 - my0 + 1)

    cx, cy = spline_coeff_sep(attr, kernel_size, ranges, dtype=dt)
    cx = cx * nbr_mask[..., None]
    if aggr == "mean":
        deg = nbr_mask.sum(dim=1, keepdim=True).clamp(min=1)
        cx = cx / deg[..., None]
    coeff = (cy[..., :, None] * cx[..., None, :]).reshape(n, k, m_sub)
    if x_j is None:
        x_j = x[nbr.long()]
    z = torch.einsum("nkm,nkc->nmc", coeff, x_j)
    if add_center_to_root and aggr != "sum":
        raise ValueError("the self-edge fold requires sum aggregation")
    w_sub, root, bias = conv_operands(conv, dt, kernel_size, ranges,
                                      add_center_to_root)
    out = z.reshape(n, m_sub * cin) @ w_sub.reshape(m_sub * cin, -1)
    out = out + xd @ root
    if bias is not None:
        out = out + bias
    if node_mask is not None:
        out = torch.where(node_mask[:, None], out,
                          torch.zeros((), dtype=out.dtype, device=x.device))
    return out
