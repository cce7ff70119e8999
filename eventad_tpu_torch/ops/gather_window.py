"""K6a / K6b: the windowed neighbour-row gather of the level-0 layer and
its backward, the masked row scatter-add (counterpart of
``eventad_tpu/ops/gather_window.py``; kernels ``csrc/gather_window.cu``).

    gather : out[i, k] = src[nbr[i, k]] where nbr_mask[i, k], else 0
    scatter: out[s]    = sum of g[i, k] over unmasked (i, k) with
                         nbr[i, k] == s

Both rest on the event-graph contract ``i - lookback <= nbr[i, k] <= i`` for
every unmasked slot; masked slots may hold any index (``-1``, out of
window) and are never dereferenced.

The TPU kernels make both one-hot matmuls and rebuild f32 from bf16 hi/lo
``parts``.  On a GPU an indexed copy is exact for f32 and bf16 alike, so
``parts`` has no counterpart here: the gather kernel equals the plain
version bit for bit.  The scatter kernel uses ``lookback`` to bound the
destinations a tile of sources scans, and sums each row in ascending edge
order without atomics, so it is deterministic; the gather kernel takes
``lookback`` only to keep the reference's signature.
"""
from __future__ import annotations

import torch

from .kernels import launch, ptr, require

_DTYPES = (torch.float32, torch.bfloat16)


def gather_window_rows_plain(src: torch.Tensor, nbr: torch.Tensor,
                             nbr_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather: a masked indexed gather,
    differentiable in ``src`` by autograd.  ``src [N, C]``, ``nbr [M, K]``
    int32, ``nbr_mask [M, K]`` bool -> ``[M, K, C]`` in ``src.dtype``."""
    idx = torch.where(nbr_mask, nbr, 0).long()
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    return torch.where(nbr_mask[..., None], src[idx], zero)


def scatter_window_rows_plain(g: torch.Tensor, nbr: torch.Tensor,
                              nbr_mask: torch.Tensor, n_src: int, *,
                              out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the scatter: ``index_add_`` of the masked
    edge rows in f32.  ``g [M, K, C]`` -> ``[n_src, C]`` in ``out_dtype``
    (default ``g.dtype``)."""
    c = g.shape[-1]
    idx = torch.where(nbr_mask, nbr, 0).long().reshape(-1)
    gm = torch.where(nbr_mask[..., None], g.to(torch.float32), 0.0)
    out = torch.zeros((n_src, c), dtype=torch.float32, device=g.device)
    out.index_add_(0, idx, gm.reshape(-1, c))
    return out.to(out_dtype or g.dtype)


def _require_graph(nbr, nbr_mask):
    m, k = nbr.shape
    require(nbr, "nbr", dtype=torch.int32, shape=(m, k))
    require(nbr_mask, "nbr_mask", dtype=torch.bool, shape=(m, k))
    return m, k


def gather_window_rows_cuda(src: torch.Tensor, nbr: torch.Tensor,
                            nbr_mask: torch.Tensor, *,
                            lookback: int) -> torch.Tensor:
    """K6a: one launch of ``csrc/gather_window.cu``'s gather kernel.
    ``lookback`` is accepted for the reference's signature; the kernel
    checks nothing about the window."""
    if src.dtype not in _DTYPES or src.dim() != 2:
        raise ValueError(f"src: expected a 2-D float32 or bfloat16 tensor, "
                         f"got {src.dtype} {tuple(src.shape)}")
    require(src, "src", dtype=src.dtype)
    m, k = _require_graph(nbr, nbr_mask)
    c = src.shape[1]
    out = torch.empty((m, k, c), dtype=src.dtype, device=src.device)
    if out.numel():
        launch("eventad_gather_window_rows", ptr(src), ptr(nbr),
               ptr(nbr_mask), m, k, c, src.element_size(), ptr(out))
        gather_window_rows_cuda.launches += 1
    return out


gather_window_rows_cuda.launches = 0


def scatter_window_rows_cuda(g: torch.Tensor, nbr: torch.Tensor,
                             nbr_mask: torch.Tensor, n_src: int, *,
                             lookback: int, out_dtype=None) -> torch.Tensor:
    """K6b: one launch of ``csrc/gather_window.cu``'s scatter kernel.
    Every unmasked ``nbr[i, k]`` must lie in ``[i - lookback, i]``: an edge
    outside that window is not summed.  Accumulates in f32 and returns
    ``out_dtype`` (default ``g.dtype``)."""
    out_dtype = out_dtype or g.dtype
    if g.dtype not in _DTYPES or out_dtype not in _DTYPES or g.dim() != 3:
        raise ValueError(f"g: expected a 3-D float32 or bfloat16 tensor and "
                         f"such an out_dtype, got {g.dtype} "
                         f"{tuple(g.shape)} -> {out_dtype}")
    if out_dtype == torch.bfloat16 and g.dtype != torch.bfloat16:
        raise ValueError("a bfloat16 output needs a bfloat16 g")
    m, k = _require_graph(nbr, nbr_mask)
    c = g.shape[2]
    require(g, "g", dtype=g.dtype, shape=(m, k, c))
    if c > 128:
        raise ValueError(f"g: at most 128 channels, got {c}")
    if lookback < 0:
        raise ValueError(f"lookback must be >= 0, got {lookback}")
    out = torch.empty((n_src, c), dtype=out_dtype, device=g.device)
    if out.numel():
        launch("eventad_scatter_window_rows", ptr(g), ptr(nbr),
               ptr(nbr_mask), m, k, c, n_src, int(lookback),
               int(g.dtype == torch.bfloat16),
               int(out_dtype == torch.bfloat16), ptr(out))
        scatter_window_rows_cuda.launches += 1
    return out


scatter_window_rows_cuda.launches = 0


def gather_window_rows(src, nbr, nbr_mask, *, lookback: int):
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if src.is_cuda:
        return gather_window_rows_cuda(src, nbr, nbr_mask, lookback=lookback)
    return gather_window_rows_plain(src, nbr, nbr_mask)


def scatter_window_rows(g, nbr, nbr_mask, n_src: int, *, lookback: int,
                        out_dtype=None):
    """Dispatch by device, as :func:`gather_window_rows`."""
    if g.is_cuda:
        return scatter_window_rows_cuda(g, nbr, nbr_mask, n_src,
                                        lookback=lookback,
                                        out_dtype=out_dtype)
    return scatter_window_rows_plain(g, nbr, nbr_mask, n_src,
                                     out_dtype=out_dtype)


class GatherWindowRows(torch.autograd.Function):
    """The gather with the scatter as its backward (the reference's custom
    VJP ``_gather_window_diff``): gradient to ``src`` only, in ``src``'s
    dtype."""

    @staticmethod
    def forward(ctx, src, nbr, nbr_mask, lookback):
        ctx.save_for_backward(nbr, nbr_mask)
        ctx.lookback = lookback
        ctx.n_src, ctx.src_dtype = src.shape[0], src.dtype
        return gather_window_rows(src, nbr, nbr_mask, lookback=lookback)

    @staticmethod
    def backward(ctx, g):
        nbr, nbr_mask = ctx.saved_tensors
        d_src = scatter_window_rows(g.contiguous(), nbr, nbr_mask, ctx.n_src,
                                    lookback=ctx.lookback,
                                    out_dtype=ctx.src_dtype)
        return d_src, None, None, None


def gather_rows_auto(src: torch.Tensor, nbr: torch.Tensor,
                     nbr_mask: torch.Tensor, *, lookback: int) -> torch.Tensor:
    """``where(nbr_mask, src[nbr], 0)`` for window-local ``nbr``,
    differentiable in ``src``.  A CUDA tensor goes through the kernels
    (K6a forward, K6b backward) or raises; a CPU tensor through the plain
    versions."""
    return GatherWindowRows.apply(src.contiguous(), nbr.contiguous(),
                                  nbr_mask.contiguous(), lookback)
