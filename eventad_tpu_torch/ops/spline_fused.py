"""The fused spline convolutions over a neighbour table (counterpart of
``eventad_tpu/ops/spline_fused.py``).

K2, ``fused_two_block``: the whole level-0 layer — two spline-conv blocks
with root, eval-BN affines, activation, linear skip and skip-BN
(``fused_two_block_prepared`` there; kernel ``csrc/spline_fused.cu``,
launched once per block).

Computes, with the self edge folded into ``root1``/``root2`` and the taps
restricted to the static sub-rectangle ``ranges``, both by the pack
(:func:`pack_level0_block`, made once per layer by its owner, ``models/
backbone.whole_layer_operands``):

    z_m = sum_k coeff[n, k, m] * x[nbr[n, k]]          (rounded, see below)
    h   = bf16(act(a1 * (sum_m z_m @ W1[m] + src @ root1) + b1) * node_mask)
    out = bf16(act(a2 * (sum_m z_m @ W2[m] + h @ root2) + b2
                   + a_s * (src @ skip_lin) + b_s) * node_mask)

In the pack's type: with bf16 packs (the kernel's) each ``z_m`` is rounded
to bf16 before its product, as the TPU kernel rounds it, and ``h`` to bf16
before block 2 gathers it.  Sums run in f32 in both versions, in different
orders.

K5, ``fused_spline_conv``: one generic conv block, the neighbour
aggregation alone (``fused_spline_conv_prepared`` there; kernel
``csrc/spline_fused_single.cu``):

    z[n, m, :] = sum_k coeff[n, k, m] * src[nbr[n, k], :]
    out[n, o]  = sum_m bf16(z[n, m, :]) . bf16(W_sub[m])[:, o]

for any window of neighbours (before and after the destination) and any tap
sub-rectangle; ``src`` bf16, sums and output f32.  Root product, bias, BN,
activation, mask and skip stay with the caller.  The kernel multiplies from
a :class:`FusedWeights` pack (:func:`pack_fused_weights`), which the owner
of the weights keeps while they are unchanged (``models/backbone.
whole_layer_operands``), with the root (and centre tap) the caller
multiplies.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .kernels import launch, ptr, require
from .spline_basis import ACT_CODES, ACTS, axis_weights
from .spline_conv import center_index, sub_kernel_index
from .spline_shift import (MAX_OUT, pack_skip_affines, pad_rows, pad_stride,
                           transpose_padded)


class FusedPrep(NamedTuple):
    """Source-independent operands shared by the two blocks of a layer."""
    nbr: torch.Tensor    # [N, K] int32 absolute source rows, -1 = no edge
    u: torch.Tensor      # [N, K, 2] f32 spline coords clip(attr,0,1)*(ks-1)


def prepare_fused(nbr: torch.Tensor, nbr_mask: torch.Tensor,
                  u: torch.Tensor) -> FusedPrep:
    return FusedPrep(torch.where(nbr_mask, nbr, -1).to(torch.int32)
                     .contiguous(), u.to(torch.float32).contiguous())


def _tap_coeff(prep: FusedPrep, ks: int, ranges) -> torch.Tensor:
    """``coeff [N, K, M]``: each slot's spline weight on every tap of the
    sub-rectangle (x fastest), zero where the slot holds no edge."""
    (mx0, mx1), (my0, my1) = ranges
    nxs, nys = mx1 - mx0 + 1, my1 - my0 + 1
    cxs, cys = axis_weights(prep.u[..., 0], prep.u[..., 1], ks, mx0=mx0,
                            my0=my0, nxs=nxs, nys=nys)
    coeff = torch.stack([cys[my] * cxs[mx] for my in range(nys)
                         for mx in range(nxs)], -1)
    return coeff * (prep.nbr >= 0)[..., None]


def _masked_act(pre, node_mask, act):
    return torch.where(node_mask[:, None], ACTS[act](pre),
                       torch.zeros((), device=pre.device))


class Level0Weights(NamedTuple):
    """One conv block of the level-0 layer in the layout
    ``csrc/spline_fused.cu`` multiplies from (``OP = pad_rows(O)``: the rows
    beyond ``O`` zero)."""
    taps: torch.Tensor            # [M, OP, CS]: the sub-rectangle's taps
    root: torch.Tensor            # [OP, CS]: root (+ centre tap), transposed
    skip: Optional[torch.Tensor]  # [OP, CSS] or None
    ab: torch.Tensor              # [OP, 4] f32: a, b, a_s, b_s
    c: int
    cs: int                       # skip channels, 0 without skip
    kernel_size: int
    ranges: tuple
    o: int                        # output channels


def pack_level0_block(weight, root, a, b, *, kernel_size: int, ranges,
                      fold_center: bool,
                      skip: Optional[tuple] = None) -> Level0Weights:
    """``weight [ks*ks, C, O]``, ``root [C, O]``, ``a``/``b [O]`` and
    ``skip = (skip_lin [Cs, O], a_s, b_s)`` as a :class:`Level0Weights`, in
    ``weight``'s type: the taps of the sub-rectangle ``ranges`` (x fastest;
    a slice, no index tensor), the root with the centre tap added where
    ``fold_center`` (the self edge, in ``weight``'s type as the layer has
    always added it), each matrix laid out by :func:`spline_shift.
    transpose_padded`, skip and affines by :func:`spline_shift.
    pack_skip_affines`."""
    ks = kernel_size
    (mx0, mx1), (my0, my1) = ranges
    dt = weight.dtype
    c, o = root.shape
    taps = weight.reshape(ks, ks, c, o)[my0:my1 + 1, mx0:mx1 + 1] \
        .reshape(-1, c, o)
    r = root.to(dt) + weight[center_index(ks)] if fold_center else root.to(dt)
    sk, cs, ab = pack_skip_affines(a, b, skip, dt)
    return Level0Weights(transpose_padded(taps, dt),
                         transpose_padded(r[None], dt)[0], sk, ab, c, cs, ks,
                         tuple(map(tuple, ranges)), o)


def _level0_block_plain(x, prep: FusedPrep, pack: Level0Weights,
                        node_mask, act, x_skip=None):
    n, o = x.shape[0], pack.o
    xf = x.float()
    coeff = _tap_coeff(prep, pack.kernel_size, pack.ranges)     # [N, K, M]
    z = torch.einsum("nkm,nkc->nmc", coeff, xf[prep.nbr.clamp(min=0).long()])
    z = z.to(pack.taps.dtype).float()        # the kernel's rounding point
    taps = pack.taps[:, :o, :pack.c].float().transpose(1, 2)     # [M, C, O]
    acc = z.reshape(n, -1) @ taps.reshape(-1, o) \
        + xf @ pack.root[:o, :pack.c].float().t()
    ab = pack.ab[:o]
    pre = acc * ab[:, 0] + ab[:, 1]
    if x_skip is not None:
        pre = pre + (x_skip.float() @ pack.skip[:o, :pack.cs].float().t()) \
            * ab[:, 2] + ab[:, 3]
    return _masked_act(pre, node_mask, act).to(x.dtype)


def fused_two_block_plain(src, prep: FusedPrep, pack1: Level0Weights,
                          pack2: Level0Weights, node_mask, *,
                          act: str = "relu"):
    """Plain PyTorch version from the packs (``pack2`` with the skip).
    Sums in f32; ``h`` and the output are emitted in ``src.dtype`` (bf16 on
    the kernel's path).  Returns ``(out [N, O], h [N, C1])``."""
    h = _level0_block_plain(src, prep, pack1, node_mask, act)
    return _level0_block_plain(h, prep, pack2, node_mask, act,
                               x_skip=src), h


def fused_two_block_cuda(src, prep: FusedPrep, pack1: Level0Weights,
                         pack2: Level0Weights, node_mask, *,
                         act: str = "relu"):
    """Two launches of ``csrc/spline_fused.cu``: block 1 writes ``h``,
    block 2 gathers it and runs the skip epilogue.  Takes every operand as
    it is: the ``bool`` node mask as its bytes, the packs as packed, so the
    call launches the two kernels and nothing else.  Any ``O`` from 1 to
    :data:`MAX_OUT` (the pack pads it to a multiple of 8; the kernel walks
    64 columns at a time) and any ``C`` and ``Cs`` whose per-warp buffers
    fit in shared memory (the weights move to device memory where they do
    not fit beside them; beyond that the launch raises); at most 32 slots
    and 64 taps."""
    n, c = src.shape
    k = prep.nbr.shape[1]
    require(src, "src", dtype=torch.bfloat16, shape=(n, c))
    require(prep.nbr, "prep.nbr", dtype=torch.int32, shape=(n, k))
    require(prep.u, "prep.u", dtype=torch.float32, shape=(n, k, 2))
    require(node_mask, "node_mask", dtype=torch.bool, shape=(n,))
    c1, c2 = pack1.o, pack2.o
    for pk, cin, cs, name in ((pack1, c, 0, "pack1"), (pack2, c1, c, "pack2")):
        o, op = pk.o, pad_rows(pk.o)
        m = pk.taps.shape[0]
        if not 1 <= o <= MAX_OUT or m > 64 or k > 32:
            raise ValueError(f"{name}: output channels must lie in [1, "
                             f"{MAX_OUT}], with at most 64 taps and 32 "
                             f"slots, got {o}, {m} and {k}")
        if pk.c != cin or pk.cs != cs \
                or pk.kernel_size != pack1.kernel_size \
                or pk.ranges != pack1.ranges:
            raise ValueError(f"{name} does not belong to these operands")
        require(pk.taps, f"{name}.taps", dtype=torch.bfloat16,
                shape=(m, op, pad_stride(cin)))
        require(pk.root, f"{name}.root", dtype=torch.bfloat16,
                shape=(op, pad_stride(cin)))
        require(pk.ab, f"{name}.ab", dtype=torch.float32, shape=(op, 4))
    require(pack2.skip, "pack2.skip", dtype=torch.bfloat16,
            shape=(pad_rows(c2), pad_stride(c)))
    h = torch.empty((n, c1), dtype=torch.bfloat16, device=src.device)
    out = torch.empty((n, c2), dtype=torch.bfloat16, device=src.device)
    if n == 0:
        return out, h
    ks = pack1.kernel_size
    (mx0, mx1), (my0, my1) = pack1.ranges
    nxs, nys = mx1 - mx0 + 1, my1 - my0 + 1
    code = ACT_CODES[act]
    for x, pk, xs, y in ((src, pack1, None, h), (h, pack2, src, out)):
        launch("eventad_level0_block", ptr(x), x.shape[1], ptr(prep.nbr), k,
               ptr(prep.u), ptr(node_mask), ptr(pk.taps), ptr(pk.root),
               ptr(pk.ab), ptr(xs), pk.cs, ptr(pk.skip), n, pk.o, ks, mx0,
               nxs, my0, nys, code, ptr(y))
    fused_two_block_cuda.launches += 2
    return out, h


fused_two_block_cuda.launches = 0


def fused_two_block(src, prep: FusedPrep, *args, **kw):
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if src.is_cuda:
        return fused_two_block_cuda(src, prep, *args, **kw)
    return fused_two_block_plain(src, prep, *args, **kw)


class FusedWeights(NamedTuple):
    """One generic conv block's taps in the layout ``csrc/
    spline_fused_single.cu`` multiplies from (``OP = pad_rows(O)``: the rows
    beyond ``O`` zero), and the root its caller multiplies."""
    taps: torch.Tensor            # [M, OP, CS] bf16: the sub-rectangle's taps
    root: Optional[torch.Tensor]  # [C, O] root (+ centre tap), or None
    c: int
    o: int
    kernel_size: int
    ranges: tuple


def pack_fused_weights(weight, *, kernel_size: int, ranges,
                       root=None, fold_center: bool = False
                       ) -> FusedWeights:
    """``weight [ks*ks, C, O]`` as a :class:`FusedWeights`: the taps of the
    sub-rectangle ``ranges`` (x fastest; a slice, no index tensor) rounded
    to bf16 and laid out by :func:`spline_shift.transpose_padded`; ``root
    [C, O]`` kept in ``weight``'s type, with the centre tap added where
    ``fold_center`` (the self edge, as the layer has always added it)."""
    ks = kernel_size
    (mx0, mx1), (my0, my1) = ranges
    c, o = weight.shape[1:]
    taps = weight.reshape(ks, ks, c, o)[my0:my1 + 1, mx0:mx1 + 1] \
        .reshape(-1, c, o)
    r = None
    if root is not None:
        r = root.to(weight.dtype)
        if fold_center:
            r = r + weight[center_index(ks)]
    return FusedWeights(transpose_padded(taps), r, c, o, ks,
                        tuple(map(tuple, ranges)))


def unpack_fused_weights(pack: FusedWeights) -> torch.Tensor:
    """The sub-rectangle's taps ``[M, C, O]`` back from a pack, in bf16."""
    return pack.taps[:, :pack.o, :pack.c].transpose(1, 2)


def _check_pack(pack: FusedWeights, c, o, kernel_size, ranges):
    if (pack.c, pack.o, pack.kernel_size, pack.ranges) != \
            (c, o, kernel_size, tuple(map(tuple, ranges))):
        raise ValueError(f"a pack of C {pack.c}, O {pack.o}, kernel size "
                         f"{pack.kernel_size} and taps {pack.ranges} does "
                         f"not belong to C {c}, O {o}, kernel size "
                         f"{kernel_size} and taps {ranges}")


def fused_spline_conv_plain(src, prep: FusedPrep, weight, *,
                            kernel_size: int, ranges,
                            pack: Optional[FusedWeights] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of K5, rounding where the kernel rounds:
    ``src`` and the taps of ``weight [ks*ks, C, O]`` (or of ``pack``, which
    holds the same values) in bf16, ``z`` summed in f32 and rounded to bf16,
    the tap product summed in f32.  Returns ``[N, O]`` f32."""
    n, c = src.shape
    bf16, f32 = torch.bfloat16, torch.float32
    coeff = _tap_coeff(prep, kernel_size, ranges)
    rows = src.to(bf16).to(f32)[prep.nbr.clamp(min=0).long()]
    z = torch.einsum("nkm,nkc->nmc", coeff, rows).to(bf16).to(f32)
    if pack is not None:
        _check_pack(pack, c, weight.shape[-1], kernel_size, ranges)
        ws = unpack_fused_weights(pack).to(f32)
    else:
        sub = torch.as_tensor(sub_kernel_index(kernel_size, ranges),
                              device=src.device)
        ws = weight[sub].to(bf16).to(f32)
    return z.reshape(n, -1) @ ws.reshape(-1, ws.shape[-1])


def fused_spline_conv_cuda(src, prep: FusedPrep, weight, *,
                           kernel_size: int, ranges,
                           pack: FusedWeights) -> torch.Tensor:
    """One launch of ``csrc/spline_fused_single.cu``.  ``pack``: ``weight``
    as :func:`pack_fused_weights` packs it, kept by the caller while it is
    unchanged (``weight`` gives only the shape to check it against).  Any
    ``O`` (the pack pads it to a multiple of 8; the kernel walks column
    groups of up to 128) and any ``C`` whose 16-row tile fits in shared
    memory (up to about 2 200; else the launch raises); at most 32 slots and
    64 taps."""
    n, c = src.shape
    k = prep.nbr.shape[1]
    require(src, "src", dtype=torch.bfloat16, shape=(n, c))
    require(prep.nbr, "prep.nbr", dtype=torch.int32, shape=(n, k))
    require(prep.u, "prep.u", dtype=torch.float32, shape=(n, k, 2))
    (mx0, mx1), (my0, my1) = ranges
    nxs, nys = mx1 - mx0 + 1, my1 - my0 + 1
    o = weight.shape[-1]
    if tuple(weight.shape) != (kernel_size * kernel_size, c, o):
        raise ValueError(f"weight: expected {(kernel_size ** 2, c, o)}, got "
                         f"{tuple(weight.shape)}")
    if k > 32 or nxs * nys > 64:
        raise ValueError(f"at most 32 slots and 64 taps, got {k} and "
                         f"{nxs * nys}")
    _check_pack(pack, c, o, kernel_size, ranges)
    require(pack.taps, "pack.taps", dtype=torch.bfloat16,
            shape=(nxs * nys, pad_rows(o), pad_stride(c)))
    out = torch.empty((n, o), dtype=torch.float32, device=src.device)
    if n == 0:
        return out
    try:
        launch("eventad_fused_spline_conv", ptr(src), c, ptr(prep.nbr), k,
               ptr(prep.u), ptr(pack.taps), n, o, kernel_size, mx0, nxs,
               my0, nys, ptr(out))
    except RuntimeError as err:
        if fused_tiles(n, c, k, o, nxs * nys)[0] == 0:
            raise ValueError(f"fused_spline_conv: C {c} with {k} slots and "
                             f"{nxs * nys} taps does not fit in shared "
                             f"memory even at 16 rows and 8 columns a "
                             f"block") from err
        raise
    fused_spline_conv_cuda.launches += 1
    return out


fused_spline_conv_cuda.launches = 0


def fused_tiles(n: int, c: int, k: int, o: int, taps: int):
    """``(row tile, column group, staged rows, slab, blocks a tile)`` that
    :func:`fused_spline_conv_cuda`'s launch picks for ``n`` rows of ``c``
    channels, ``k`` slots, ``o`` outputs and ``taps`` taps (no launch; a
    row tile of 0: the shape does not fit; slab 1: the kernel whose warps
    each walk their own 16 rows' taps, 0: the one whose block walks its
    tile's taps in step, shared by a cluster of ``blocks a tile``)."""
    plan = (ctypes.c_int * 5)()
    launch("eventad_fused_plan", n, c, k, o, taps, plan)
    return tuple(plan)


def fused_spline_conv(src, prep: FusedPrep, weight, **kw) -> torch.Tensor:
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if src.is_cuda:
        return fused_spline_conv_cuda(src, prep, weight, **kw)
    return fused_spline_conv_plain(src, prep, weight, **kw)
