"""The fused spline convolutions over a neighbour table (counterpart of
``eventad_tpu/ops/spline_fused.py``).

K2, ``fused_two_block``: the whole level-0 layer — two spline-conv blocks
with root, eval-BN affines, activation, linear skip and skip-BN
(``fused_two_block_prepared`` there; kernel ``csrc/spline_fused.cu``,
launched once per block).

Computes, with the self edge folded into ``root1``/``root2`` by the caller
and the taps restricted to the static sub-rectangle ``ranges``:

    h   = bf16(act(a1 * (conv1(src) + src @ root1) + b1) * node_mask)
    out = bf16(act(a2 * (conv2(h) + h @ root2) + b2
                   + a_s * (src @ skip_lin) + b_s) * node_mask)

``h`` is rounded to bf16 before block 2 gathers it, as the TPU kernel
rounds it.  Sums run in f32 in both versions, in different orders.

K5, ``fused_spline_conv``: one generic conv block, the neighbour
aggregation alone (``fused_spline_conv_prepared`` there; kernel
``csrc/spline_fused_single.cu``):

    z[n, m, :] = sum_k coeff[n, k, m] * src[nbr[n, k], :]
    out[n, o]  = sum_m bf16(z[n, m, :]) . bf16(W_sub[m])[:, o]

for any window of neighbours (before and after the destination) and any tap
sub-rectangle; ``src`` bf16, sums and output f32.  Root product, bias, BN,
activation, mask and skip stay with the caller.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import launch, ptr, require
from .spline_basis import ACT_CODES, ACTS, axis_weights
from .spline_conv import sub_kernel_index


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


def fused_two_block_plain(src, prep: FusedPrep, w1, root1, a1, b1, w2, root2,
                          node_mask, *, kernel_size: int, ranges,
                          act: str = "relu", epilogue):
    """Plain PyTorch version.  ``epilogue = (skip_lin, a2, b2, a_s, b_s)``.
    Sums in f32; ``h`` and the output are emitted in ``src.dtype`` (bf16 on
    the kernel's path).  Returns ``(out [N, O], h [N, C1])``."""
    ks = kernel_size
    n = src.shape[0]
    sub = torch.as_tensor(sub_kernel_index(ks, ranges), device=src.device)
    coeff = _tap_coeff(prep, ks, ranges)                    # [N, K, M]
    idx = prep.nbr.clamp(min=0).long()

    def block(x, w, root):
        xf = x.float()
        z = torch.einsum("nkm,nkc->nmc", coeff, xf[idx])
        ws = w[sub].float()
        return z.reshape(n, -1) @ ws.reshape(-1, ws.shape[-1]) \
            + xf @ root.float()

    h = _masked_act(block(src, w1, root1) * a1.float() + b1.float(),
                    node_mask, act).to(src.dtype)
    skip_lin, a2, b2, a_s, b_s = (t.float() for t in epilogue)
    pre = block(h, w2, root2) * a2 + b2 + (src.float() @ skip_lin) * a_s + b_s
    return _masked_act(pre, node_mask, act).to(src.dtype), h


def fused_two_block_cuda(src, prep: FusedPrep, w1, root1, a1, b1, w2, root2,
                         node_mask, *, kernel_size: int, ranges,
                         act: str = "relu", epilogue):
    """Two launches of ``csrc/spline_fused.cu``: block 1 writes ``h``,
    block 2 gathers it and runs the skip epilogue."""
    n, c = src.shape
    k = prep.nbr.shape[1]
    require(src, "src", dtype=torch.bfloat16, shape=(n, c))
    require(prep.nbr, "prep.nbr", dtype=torch.int32, shape=(n, k))
    require(prep.u, "prep.u", dtype=torch.float32, shape=(n, k, 2))
    (mx0, mx1), (my0, my1) = ranges
    nxs, nys = mx1 - mx0 + 1, my1 - my0 + 1
    sub = torch.as_tensor(sub_kernel_index(kernel_size, ranges),
                          device=src.device)
    f32 = torch.float32

    def f(t):
        return t.to(f32).contiguous()

    skip_lin, a2, b2, a_s, b_s = epilogue
    c1, c2 = w1.shape[-1], w2.shape[-1]
    m_sub = nxs * nys
    zeros = torch.zeros(c1, dtype=f32, device=src.device)
    w1s, w2s = f(w1[sub]), f(w2[sub])
    r1, r2, skl = f(root1), f(root2), f(skip_lin)
    ab1 = f(torch.stack([a1.to(f32), b1.to(f32), zeros, zeros], 1))
    ab2 = f(torch.stack([a2, b2, a_s, b_s], 1))
    for t, name, shape in ((w1s, "w1", (m_sub, c, c1)),
                           (w2s, "w2", (m_sub, c1, c2)),
                           (r1, "root1", (c, c1)), (r2, "root2", (c1, c2)),
                           (skl, "skip_lin", (c, c2)),
                           (ab1, "a1/b1", (c1, 4)),
                           (ab2, "a2/b2/a_s/b_s", (c2, 4))):
        require(t, name, dtype=f32, shape=shape)
    mask_u8 = node_mask.to(torch.uint8).contiguous()
    require(mask_u8, "node_mask", dtype=torch.uint8, shape=(n,))
    h = torch.empty((n, c1), dtype=torch.bfloat16, device=src.device)
    out = torch.empty((n, c2), dtype=torch.bfloat16, device=src.device)
    if n == 0:
        return out, h
    code = ACT_CODES[act]
    launch("eventad_level0_block", ptr(src), c, ptr(prep.nbr), k,
           ptr(prep.u), ptr(w1s), ptr(r1), ptr(ab1), ptr(None), 0,
           ptr(None), ptr(mask_u8), n, c1, kernel_size, mx0, nxs, my0, nys,
           code, ptr(h))
    launch("eventad_level0_block", ptr(h), c1, ptr(prep.nbr), k,
           ptr(prep.u), ptr(w2s), ptr(r2), ptr(ab2), ptr(src), c, ptr(skl),
           ptr(mask_u8), n, c2, kernel_size, mx0, nxs, my0, nys, code,
           ptr(out))
    fused_two_block_cuda.launches += 2
    return out, h


fused_two_block_cuda.launches = 0


def fused_two_block(src, prep: FusedPrep, *args, **kw):
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if src.is_cuda:
        return fused_two_block_cuda(src, prep, *args, **kw)
    return fused_two_block_plain(src, prep, *args, **kw)


def fused_spline_conv_plain(src, prep: FusedPrep, weight, *,
                            kernel_size: int, ranges) -> torch.Tensor:
    """Plain PyTorch version of K5, rounding where the kernel rounds:
    ``src`` and the taps of ``weight [ks*ks, C, O]`` in bf16, ``z`` summed
    in f32 and rounded to bf16, the tap product summed in f32.  Returns
    ``[N, O]`` f32."""
    n = src.shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    sub = torch.as_tensor(sub_kernel_index(kernel_size, ranges),
                          device=src.device)
    coeff = _tap_coeff(prep, kernel_size, ranges)
    rows = src.to(bf16).to(f32)[prep.nbr.clamp(min=0).long()]
    z = torch.einsum("nkm,nkc->nmc", coeff, rows).to(bf16).to(f32)
    ws = weight[sub].to(bf16).to(f32)
    return z.reshape(n, -1) @ ws.reshape(-1, ws.shape[-1])


def fused_spline_conv_cuda(src, prep: FusedPrep, weight, *,
                           kernel_size: int, ranges) -> torch.Tensor:
    """One launch of ``csrc/spline_fused_single.cu``."""
    n, c = src.shape
    k = prep.nbr.shape[1]
    require(src, "src", dtype=torch.bfloat16, shape=(n, c))
    require(prep.nbr, "prep.nbr", dtype=torch.int32, shape=(n, k))
    require(prep.u, "prep.u", dtype=torch.float32, shape=(n, k, 2))
    (mx0, mx1), (my0, my1) = ranges
    nxs, nys = mx1 - mx0 + 1, my1 - my0 + 1
    o = weight.shape[-1]
    # the tap sub-rectangle as a slice: no index tensor crosses to the card
    w_sub = weight.reshape(kernel_size, kernel_size, c, o)[
        my0:my1 + 1, mx0:mx1 + 1].to(torch.bfloat16).reshape(
            nxs * nys, c, o).contiguous()
    require(w_sub, "weight", dtype=torch.bfloat16, shape=(nxs * nys, c, o))
    out = torch.empty((n, o), dtype=torch.float32, device=src.device)
    if n == 0:
        return out
    launch("eventad_fused_spline_conv", ptr(src), c, ptr(prep.nbr), k,
           ptr(prep.u), ptr(w_sub), n, o, kernel_size, mx0, nxs, my0, nys,
           ptr(out))
    fused_spline_conv_cuda.launches += 1
    return out


fused_spline_conv_cuda.launches = 0


def fused_spline_conv(src, prep: FusedPrep, weight, **kw) -> torch.Tensor:
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if src.is_cuda:
        return fused_spline_conv_cuda(src, prep, weight, **kw)
    return fused_spline_conv_plain(src, prep, weight, **kw)
