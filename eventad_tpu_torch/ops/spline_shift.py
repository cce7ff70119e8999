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

The CUDA kernel multiplies on the tensor cores from bf16 operands: ``z_m``
is rounded to bf16 before its product (as the TPU kernel rounds it), and the
weights are packed as a :class:`ShiftWeights` (:func:`pack_shift_weights`;
the owner of the weights keeps the pack, ``models/backbone.
whole_layer_operands``); the tables that depend on the geometry alone are
made once per geometry and device (:func:`static_tables`).  The plain
version sums ``z`` in f32 unless ``kernel_rounding`` is asked for.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .kernels import launch, ptr, require
from .spline_basis import ACT_CODES, ACTS, axis_weights

MAX_OUT = 256      # output channels K2 and K3 take


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
    """Source-independent operands, shared by both conv blocks of a layer.
    Everything from ``d_offs`` on depends on the geometry alone and is made
    once per geometry and device (:func:`static_tables`)."""
    u: torch.Tensor          # [N, S, 2] f32 spline coords
    mq: torch.Tensor         # [N, S] uint8 edge mask (the bool's own bytes)
    node_mask: torch.Tensor  # [N] bool
    d_offs: torch.Tensor     # [S] int32 flat row offset oy*nx + ox
    tap_mxy: torch.Tensor    # [T, 2] int32 (mx, my) of each used tap
    tap_ptr: torch.Tensor    # [T + 1] int32 CSR offsets into tap_slots
    tap_slots: torch.Tensor  # [nnz] int32 contributing slots per tap
    tap_idx: torch.Tensor    # [T] int64 flat kernel index my*ks + mx
    win_mask: torch.Tensor   # [S, ks*ks] bool: tap inside the slot window
    kernel_size: int
    offsets: Tuple[int, ...]
    halo: int                # max |offset|: rows a block reads beyond its own


@functools.lru_cache(maxsize=None)
def static_tables(grid: tuple, span: int, cart_max: float, width: int,
                  height: int, kernel_size: int, device: str) -> tuple:
    """The tables of :class:`ShiftPrep` that depend on the geometry alone
    (``d_offs`` ... ``halo``, in field order), on ``device``.  Cached: a
    second call returns the same tensors, so no forward after the first
    copies them to the card."""
    nx, ny = grid
    side = 2 * span + 1
    ks = kernel_size
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
        return torch.tensor(v, dtype=torch.int32, device=device)

    return (i32(offsets), i32(mxy).reshape(-1, 2), i32(ptrs), i32(slots),
            torch.tensor([my * ks + mx for mx, my in mxy], device=device),
            win_mask.to(device), ks, offsets, max(map(abs, offsets)))


def prepare_shift(u: torch.Tensor, nbr_mask: torch.Tensor,
                  node_mask: torch.Tensor, *, grid: tuple, span: int,
                  cart_max: float, width: int, height: int,
                  kernel_size: int) -> ShiftPrep:
    """``u [N, S, 2]``: spline coords ``clip(attr,0,1)*(ks-1)`` in
    ``neighbor_rows`` slot order, ``N = batch * ny * nx``.  A ``bool`` edge
    mask is taken as its bytes, an f32 contiguous ``u`` as it is: after the
    first call for a geometry this launches no device operation for them."""
    mq = nbr_mask.contiguous()
    mq = mq.view(torch.uint8) if mq.dtype == torch.bool \
        else mq.to(torch.uint8)
    return ShiftPrep(
        u.to(torch.float32).contiguous(), mq, node_mask,
        *static_tables(tuple(grid), span, float(cart_max), width, height,
                       kernel_size, str(u.device)))


def _masked_act(pre, node_mask, act):
    return torch.where(node_mask[:, None], ACTS[act](pre),
                       torch.zeros((), device=pre.device))


def shift_spline_conv_plain(src, prep: ShiftPrep, weight, root, a, b, *,
                            act: Optional[str],
                            skip: Optional[tuple] = None,
                            pack: Optional["ShiftWeights"] = None,
                            kernel_rounding: bool = False) -> torch.Tensor:
    """Plain PyTorch version.  ``skip = (x_skip, skip_lin, a_s, b_s)``.
    Sums in f32; returns ``[N, O]`` in ``src.dtype`` (bf16 on the kernel's
    path).  ``pack`` is the kernel's operand and unused here, so that one
    call site serves both.  ``kernel_rounding``: round where the kernels do
    (the TPU's and the card's): ``weight``, ``root`` and ``skip_lin`` to
    bf16 and each tap's ``z`` to bf16 before its product."""
    def wt(t):
        return (t.to(torch.bfloat16) if kernel_rounding else t).float()

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
    if kernel_rounding:
        z = z.to(torch.bfloat16).float()
    wf = wt(weight)
    pre = (z.reshape(n, -1) @ wf.reshape(-1, wf.shape[-1])
           + xf @ wt(root)) * a.float() + b.float()
    if skip is not None:
        x_skip, skip_lin, a_s, b_s = skip
        pre = pre + (x_skip.float() @ wt(skip_lin)) * a_s.float() \
            + b_s.float()
    return _masked_act(pre, prep.node_mask, act).to(src.dtype)


class ShiftWeights(NamedTuple):
    """One conv block's operands in the layout ``csrc/spline_shift.cu``
    multiplies from (``OP = pad_rows(O)``: the rows beyond ``O`` zero)."""
    w: torch.Tensor               # [T + 1, OP, CS] bf16: used taps, then root
    skip: Optional[torch.Tensor]  # [OP, CSS] bf16 or None
    ab: torch.Tensor              # [OP, 4] f32: a, b, a_s, b_s
    c: int
    cs: int                       # skip channels, 0 without skip
    o: int                        # output channels


def pad_stride(c: int) -> int:
    """Row stride of a packed operand: ``c`` padded to the MMA depth of 16,
    plus 8: an odd number of 16-byte units, so that eight consecutive rows
    fall into eight different bank groups of shared memory."""
    return -(-c // 16) * 16 + 8


def pad_rows(o: int) -> int:
    """Rows of a packed operand: ``o`` output channels padded to the MMA
    tile width of 8, so that any ``o`` runs on the kernels' tiles."""
    return -(-o // 8) * 8


def transpose_padded(mats: torch.Tensor, dtype=torch.bfloat16):
    """``[M, C, O] -> [M, pad_rows(O), pad_stride(C)]`` in ``dtype``,
    zero-padded: each matrix transposed (channels contiguous), the layout
    from which the kernels read their B fragments."""
    m, c, o = mats.shape
    out = torch.zeros((m, pad_rows(o), pad_stride(c)), dtype=dtype,
                      device=mats.device)
    out[:, :o, :c] = mats.transpose(1, 2).to(dtype)
    return out


def pack_skip_affines(a, b, skip: Optional[tuple] = None,
                      dtype=torch.bfloat16):
    """What the packs of K2 and K3 share: ``(skip, cs, ab)``, from ``skip =
    (skip_lin [Cs, O], a_s, b_s)`` the skip matrix laid out by
    :func:`transpose_padded` in ``dtype`` and its channels (None and 0
    without a skip), and ``ab [pad_rows(O), 4]`` f32: ``a, b, a_s, b_s``,
    the last two zero without a skip, the pad rows zero."""
    f32 = torch.float32
    o = a.shape[0]
    sk, cs = None, 0
    a_s = b_s = torch.zeros((o,), dtype=f32, device=a.device)
    if skip is not None:
        skip_lin, a_s, b_s = skip
        sk, cs = transpose_padded(skip_lin[None], dtype)[0], skip_lin.shape[0]
    ab = torch.zeros((pad_rows(o), 4), dtype=f32, device=a.device)
    ab[:o] = torch.stack([t.to(f32) for t in (a, b, a_s, b_s)], 1)
    return sk, cs, ab


def pack_shift_weights(tap_idx: torch.Tensor, weight, root, a, b,
                       skip: Optional[tuple] = None) -> ShiftWeights:
    """``weight [ks*ks, C, O]``, ``root [C, O]``, ``a``/``b [O]`` and
    ``skip = (_, skip_lin [Cs, O], a_s, b_s)`` as a :class:`ShiftWeights`:
    each matrix rounded to bf16 and laid out by :func:`transpose_padded`."""
    bf16 = torch.bfloat16
    w = transpose_padded(torch.cat([weight[tap_idx].to(bf16),
                                    root[None].to(bf16)]))
    sk, cs, ab = pack_skip_affines(a, b, None if skip is None else skip[1:])
    return ShiftWeights(w, sk, ab, root.shape[0], cs, root.shape[1])


def unpack_shift_weights(pack: ShiftWeights, prep: ShiftPrep):
    """``(weight [ks*ks, C, O], root, a, b, skip_lin or None, a_s, b_s)``
    back from a pack, bf16 weights and f32 affines; taps outside every
    slot's window, which the pack does not hold, are zero."""
    t, o = pack.w.shape[0] - 1, pack.o
    ks = prep.kernel_size
    mats = pack.w[:, :o, :pack.c].transpose(1, 2)       # [T + 1, C, O]
    weight = torch.zeros((ks * ks,) + tuple(mats.shape[1:]),
                         dtype=mats.dtype, device=mats.device)
    weight[prep.tap_idx] = mats[:t]
    skip_lin = None if pack.skip is None else pack.skip[:o, :pack.cs].t()
    ab = pack.ab[:o]
    return (weight, mats[t], ab[:, 0], ab[:, 1], skip_lin, ab[:, 2],
            ab[:, 3])


def shift_spline_conv_packed_plain(src, prep: ShiftPrep, pack: ShiftWeights,
                                   *, act: Optional[str], x_skip=None,
                                   kernel_rounding: bool = False):
    """The plain version computed from the packed operands: what the CUDA
    kernel is given, through :func:`shift_spline_conv_plain`."""
    weight, root, a, b, skip_lin, a_s, b_s = unpack_shift_weights(pack, prep)
    if (x_skip is None) != (skip_lin is None):
        raise ValueError("x_skip and the pack's skip weights go together")
    skip = None if x_skip is None else (x_skip, skip_lin, a_s, b_s)
    return shift_spline_conv_plain(src, prep, weight, root, a, b, act=act,
                                   skip=skip,
                                   kernel_rounding=kernel_rounding)


def shift_spline_conv_cuda(src, prep: ShiftPrep, weight, root, a, b, *,
                           act: Optional[str],
                           skip: Optional[tuple] = None,
                           pack: Optional[ShiftWeights] = None
                           ) -> torch.Tensor:
    """One launch of ``csrc/spline_shift.cu``.  ``pack``: the operands as
    :func:`pack_shift_weights` packs them for ``prep.tap_idx``, kept by the
    caller while they are unchanged; without it they are packed here, on
    every call.  Any ``O`` from 1 to :data:`MAX_OUT` (the pack pads it to
    a multiple of 8; above 128 the kernel walks column groups); any ``C``
    and ``Cs`` whose row tile of 16 fits in shared memory with a column
    group of 8 (else the launch raises)."""
    n, c = src.shape
    s_slots = len(prep.offsets)
    o = weight.shape[-1]
    if not 1 <= o <= MAX_OUT:
        raise ValueError(f"output channels must lie in [1, {MAX_OUT}], "
                         f"got {o}")
    require(src, "src", dtype=torch.bfloat16, shape=(n, c))
    require(prep.u, "prep.u", dtype=torch.float32, shape=(n, s_slots, 2))
    require(prep.mq, "prep.mq", dtype=torch.uint8, shape=(n, s_slots))
    require(prep.node_mask, "prep.node_mask", dtype=torch.bool, shape=(n,))
    ks = prep.kernel_size
    n_taps = prep.tap_idx.shape[0]
    if weight.shape != (ks * ks, c, o) or root.shape != (c, o):
        raise ValueError(f"weight, root: expected {(ks * ks, c, o)} and "
                         f"{(c, o)}, got {tuple(weight.shape)} and "
                         f"{tuple(root.shape)}")
    if n_taps > 64 or ks > 16 or s_slots > 32:
        raise ValueError(f"at most 64 used taps, a kernel size of 16 and 32 "
                         f"slots, got {n_taps}, {ks} and {s_slots}")
    xs = None
    if skip is not None:
        xs = skip[0]
        require(xs, "x_skip", dtype=torch.bfloat16,
                shape=(n, skip[1].shape[0]))
    if pack is None:
        pack = pack_shift_weights(prep.tap_idx, weight, root, a, b, skip)
    require(pack.w, "pack.w", dtype=torch.bfloat16,
            shape=(n_taps + 1, pad_rows(o), pad_stride(c)))
    if pack.o != o or pack.cs != (skip[1].shape[0] if skip is not None
                                  else 0):
        raise ValueError(f"pack with {pack.o} output and {pack.cs} skip "
                         f"channels does not belong to these operands")
    out = torch.empty((n, o), dtype=torch.bfloat16, device=src.device)
    if n:
        launch("eventad_shift_block", ptr(src), c, ptr(prep.u), ptr(prep.mq),
               ptr(prep.node_mask), ptr(prep.d_offs), s_slots, prep.halo,
               ptr(prep.tap_mxy), ptr(prep.tap_ptr), ptr(prep.tap_slots),
               n_taps, prep.tap_slots.shape[0], ptr(pack.w), ptr(pack.ab),
               ptr(xs), pack.cs, ptr(pack.skip), n, o, ks, ACT_CODES[act],
               ptr(out))
        shift_spline_conv_cuda.launches += 1
    return out


shift_spline_conv_cuda.launches = 0


def shift_tiles(n: int, c: int, cs: int, o: int, prep: ShiftPrep):
    """``(row tile, column group)`` that :func:`shift_spline_conv_cuda`'s
    launch picks for ``n`` rows of ``c`` channels, ``cs`` skip channels (0:
    none) and ``o`` outputs on ``prep``'s tables (no launch)."""
    plan = (ctypes.c_int * 2)()
    launch("eventad_shift_plan", n, c, cs, o, prep.halo, len(prep.offsets),
           prep.tap_slots.shape[0], prep.tap_idx.shape[0],
           prep.kernel_size, plan)
    return plan[0], plan[1]


def shift_spline_conv(src, prep: ShiftPrep, *args, **kw) -> torch.Tensor:
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if src.is_cuda:
        return shift_spline_conv_cuda(src, prep, *args, **kw)
    return shift_spline_conv_plain(src, prep, *args, **kw)
