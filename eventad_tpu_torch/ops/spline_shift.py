"""K3: one pooled-level conv block over shift-sliced neighbours with
statically pruned taps, tail included (counterpart of
``eventad_tpu/ops/spline_shift.py``; kernel ``csrc/spline_shift.cu``).

At pooled levels slot ``s`` of cell ``n`` is cell ``n + d_off[s]`` of the
same table; reads that cross a grid row or an item are cancelled by the edge
mask ``mq``.  Each slot's attrs reach only a static tap window
(:func:`tap_windows`), so each tap has a static list of contributing slots.
Computes

    out = bf16(act(a * (sum_m z_m @ W[m] + src @ root) + b
                   [+ a_s * (x_skip @ skip_lin) + b_s]) * node_mask)

with ``z_m = sum_{s in slots(m)} mq cy[my] cx[mx] src[n + d_off[s]]``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .kernels import launch, ptr, require
from .spline_basis import ACT_CODES, ACTS, axis_weights


@functools.lru_cache(maxsize=None)
def tap_windows(grid: tuple, span: int, cart_max: float, width: int,
                height: int, kernel_size: int):
    """Static per-slot tap windows ``((x_lo, x_hi), (y_lo, y_hi))``
    (inclusive) from the pooled-graph geometry: both endpoint positions are
    pixel-rounded means inside their cells (+1 px rounding slack), so slot
    offset ``o`` bounds the attr to ``(-o cw - cw - m, -o cw + cw + m)``
    with ``cw = 1 / ncells`` and ``m = 2 / full_px``.  Slot order matches
    ``models/graph.neighbor_rows``."""
    nx, ny = grid
    side = 2 * span + 1
    ks = kernel_size

    def axis_win(o: int, ncells: int, full_px: int):
        cw = 1.0 / ncells
        m = 2.0 / full_px
        us = [min(max(d / (2.0 * cart_max) + 0.5, 0.0), 1.0) * (ks - 1)
              for d in (-o * cw - cw - m, -o * cw + cw + m)]
        i_lo = min(max(int(math.floor(min(us))), 0), ks - 2)
        i_hi = min(max(int(math.floor(max(us))), 0), ks - 2)
        return (i_lo, i_hi + 1)

    return tuple((axis_win(s % side - span, nx, width),
                  axis_win(s // side - span, ny, height))
                 for s in range(side * side))


class ShiftPrep(NamedTuple):
    """Source-independent operands, shared by both conv blocks of a layer."""
    u: torch.Tensor          # [N, S, 2] f32 spline coords
    mq: torch.Tensor         # [N, S] uint8 edge mask
    node_mask: torch.Tensor  # [N] bool
    d_offs: torch.Tensor     # [S] int32 flat row offset oy*nx + ox
    tap_mxy: torch.Tensor    # [T, 2] int32 (mx, my) of each used tap
    tap_ptr: torch.Tensor    # [T + 1] int32 CSR offsets into tap_slots
    tap_slots: torch.Tensor  # [nnz] int32 contributing slots per tap
    tap_idx: torch.Tensor    # [T] int64 flat kernel index my*ks + mx
    win_mask: torch.Tensor   # [S, ks*ks] bool: tap inside the slot window
    kernel_size: int
    offsets: Tuple[int, ...]


def prepare_shift(u: torch.Tensor, nbr_mask: torch.Tensor,
                  node_mask: torch.Tensor, *, grid: tuple, span: int,
                  cart_max: float, width: int, height: int,
                  kernel_size: int) -> ShiftPrep:
    """``u [N, S, 2]``: spline coords ``clip(attr,0,1)*(ks-1)`` in
    ``neighbor_rows`` slot order, ``N = batch * ny * nx``."""
    nx, ny = grid
    side = 2 * span + 1
    ks = kernel_size
    dev = u.device
    offsets = tuple((s // side - span) * nx + (s % side - span)
                    for s in range(side * side))
    wins = tap_windows((nx, ny), span, cart_max, width, height, ks)
    win_mask = torch.zeros(side * side, ks * ks, dtype=torch.bool)
    mxy, ptrs, slots = [], [0], []
    for my in range(ks):
        for mx in range(ks):
            hit = [s for s, ((xl, xh), (yl, yh)) in enumerate(wins)
                   if xl <= mx <= xh and yl <= my <= yh]
            for s in hit:
                win_mask[s, my * ks + mx] = True
            if hit:
                mxy.append((mx, my))
                slots += hit
                ptrs.append(len(slots))

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return ShiftPrep(
        u.to(torch.float32).contiguous(),
        nbr_mask.to(torch.uint8).contiguous(), node_mask, i32(offsets),
        i32(mxy).reshape(-1, 2), i32(ptrs), i32(slots),
        torch.tensor([my * ks + mx for mx, my in mxy], device=dev),
        win_mask.to(dev), ks, offsets)


def _masked_act(pre, node_mask, act):
    return torch.where(node_mask[:, None], ACTS[act](pre),
                       torch.zeros((), device=pre.device))


def shift_spline_conv_plain(src, prep: ShiftPrep, weight, root, a, b, *,
                            act: Optional[str],
                            skip: Optional[tuple] = None) -> torch.Tensor:
    """Plain PyTorch version.  ``skip = (x_skip, skip_lin, a_s, b_s)``.
    Sums in f32; returns ``[N, O]`` in ``src.dtype`` (bf16 on the kernel's
    path)."""
    n = src.shape[0]
    ks = prep.kernel_size
    pad = max(abs(d) for d in prep.offsets)
    xf = src.float()
    xp = F.pad(xf, (0, 0, pad, pad))
    xj = torch.stack([xp[pad + d:pad + d + n] for d in prep.offsets], 1)
    cxs, cys = axis_weights(prep.u[..., 0], prep.u[..., 1], ks)
    coeff = torch.stack([cys[my] * cxs[mx] for my in range(ks)
                         for mx in range(ks)], -1)       # [N, S, ks*ks]
    coeff = coeff * prep.mq[..., None].float() * prep.win_mask.float()
    z = torch.einsum("nsm,nsc->nmc", coeff, xj)
    wf = weight.float()
    pre = (z.reshape(n, -1) @ wf.reshape(-1, wf.shape[-1])
           + xf @ root.float()) * a.float() + b.float()
    if skip is not None:
        x_skip, skip_lin, a_s, b_s = skip
        pre = pre + (x_skip.float() @ skip_lin.float()) * a_s.float() \
            + b_s.float()
    return _masked_act(pre, prep.node_mask, act).to(src.dtype)


def shift_spline_conv_cuda(src, prep: ShiftPrep, weight, root, a, b, *,
                           act: Optional[str],
                           skip: Optional[tuple] = None) -> torch.Tensor:
    """One launch of ``csrc/spline_shift.cu``."""
    n, c = src.shape
    s_slots = len(prep.offsets)
    o = weight.shape[-1]
    if not (8 <= o <= 128 and 256 % o == 0):
        raise ValueError(f"output channels must divide 256 and lie in "
                         f"[8, 128], got {o}")
    require(src, "src", dtype=torch.bfloat16, shape=(n, c))
    require(prep.u, "prep.u", dtype=torch.float32, shape=(n, s_slots, 2))
    require(prep.mq, "prep.mq", dtype=torch.uint8, shape=(n, s_slots))
    ks = prep.kernel_size
    if weight.shape != (ks * ks, c, o):
        raise ValueError(f"weight: expected {(ks * ks, c, o)}, got "
                         f"{tuple(weight.shape)}")
    f32 = torch.float32
    w_sel = weight[prep.tap_idx].to(f32).contiguous()
    cols = [a.to(f32), b.to(f32)]
    xs = skl = None
    cs = 0
    if skip is not None:
        x_skip, skip_lin, a_s, b_s = skip
        cs = x_skip.shape[1]
        xs = x_skip.contiguous()
        require(xs, "x_skip", dtype=torch.bfloat16, shape=(n, cs))
        skl = skip_lin.to(f32).contiguous()
        cols += [a_s.to(f32), b_s.to(f32)]
    else:
        cols += [torch.zeros_like(cols[0])] * 2
    ab = torch.stack(cols, 1).contiguous()
    root_f = root.to(f32).contiguous()
    node_u8 = prep.node_mask.to(torch.uint8).contiguous()
    require(w_sel, "weight", dtype=f32)
    require(root_f, "root", dtype=f32, shape=(c, o))
    require(ab, "a/b", dtype=f32, shape=(o, 4))
    require(node_u8, "prep.node_mask", dtype=torch.uint8, shape=(n,))
    if skl is not None:
        require(skl, "skip_lin", dtype=f32, shape=(cs, o))
    out = torch.empty((n, o), dtype=torch.bfloat16, device=src.device)
    if n:
        launch("eventad_shift_block", ptr(src), c, ptr(prep.u), ptr(prep.mq),
               ptr(node_u8), ptr(prep.d_offs), s_slots, ptr(prep.tap_mxy),
               ptr(prep.tap_ptr), ptr(prep.tap_slots), len(prep.tap_idx),
               ptr(w_sel), ptr(root_f), ptr(ab), ptr(xs), cs, ptr(skl), n, o,
               ks, ACT_CODES[act], ptr(out))
        shift_spline_conv_cuda.launches += 1
    return out


shift_spline_conv_cuda.launches = 0


def shift_spline_conv(src, prep: ShiftPrep, *args, **kw) -> torch.Tensor:
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if src.is_cuda:
        return shift_spline_conv_cuda(src, prep, *args, **kw)
    return shift_spline_conv_plain(src, prep, *args, **kw)
