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
version bit for bit; it writes 16 bytes a thread and finds each word's
first edge by a multiply with :func:`div_magic`.  The scatter is two
launches: one pass over the mask lists the unmasked edges in edge order,
per block of :data:`LIST_EDGES`; then a block per tile of
:func:`scatter_tile` source rows reads the lists of the destinations
``lookback`` bounds, buckets the edges that point into it by row, stably,
and sums each row's bucket in ascending edge order without atomics, so it
is deterministic and equals a sequential ``index_add_``.  The gather kernel
takes ``lookback`` only to keep the reference's signature.
"""
from __future__ import annotations

import torch

from .kernels import launch, ptr, require

_DTYPES = (torch.float32, torch.bfloat16)
# as csrc/gather_window.cu: threads of a scatter block, and the edges each
# block of the listing pass reads (16 mask bytes a thread)
SCATTER_THREADS = 256
LIST_EDGES = 16 * SCATTER_THREADS


def scatter_tile(c: int) -> int:
    """Source rows a block of the scatter's second launch owns: its f32
    accumulators, ``tile x c``, take at most 32 KB of shared memory."""
    return 256 if c <= 32 else (128 if c <= 64 else 64)


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


def div_magic(c: int):
    """``(m, s)`` with ``idx // c == (idx * m) >> s`` for every
    ``0 <= idx < 2**31``: ``s = 31 + ceil(log2 c)``, ``m = ceil(2**s / c)``,
    which is below ``2**32``.  With ``e = m c - 2**s < c <= 2**(s - 31)``
    the product overshoots ``idx / c`` by ``idx e / (c 2**s) < 1 / c``, too
    little to reach the next integer.  The gather kernel divides its flat
    index by ``C`` so (an output of ``2**31`` elements or more divides in
    64 bits)."""
    if c < 1:
        raise ValueError(f"c must be >= 1, got {c}")
    s = 31 + (c - 1).bit_length()
    return -(-(1 << s) // c), s


def _require_graph(nbr, nbr_mask):
    m, k = nbr.shape
    require(nbr, "nbr", dtype=torch.int32, shape=(m, k))
    require(nbr_mask, "nbr_mask", dtype=torch.bool, shape=(m, k))
    return m, k


def gather_window_rows_cuda(src: torch.Tensor, nbr: torch.Tensor,
                            nbr_mask: torch.Tensor, *,
                            lookback: int) -> torch.Tensor:
    """K6a: one launch of ``csrc/gather_window.cu``'s gather kernel, 16
    bytes of the output a thread.  ``lookback`` is accepted for the
    reference's signature; the kernel checks nothing about the window."""
    if src.dtype not in _DTYPES or src.dim() != 2:
        raise ValueError(f"src: expected a 2-D float32 or bfloat16 tensor, "
                         f"got {src.dtype} {tuple(src.shape)}")
    require(src, "src", dtype=src.dtype)
    m, k = _require_graph(nbr, nbr_mask)
    c = src.shape[1]
    out = torch.empty((m, k, c), dtype=src.dtype, device=src.device)
    if out.numel():
        launch("eventad_gather_window_rows", ptr(src), ptr(nbr),
               ptr(nbr_mask), m, k, c, src.element_size(), *div_magic(c),
               ptr(out))
        gather_window_rows_cuda.launches += 1
    return out


gather_window_rows_cuda.launches = 0


def scatter_window_rows_cuda(g: torch.Tensor, nbr: torch.Tensor,
                             nbr_mask: torch.Tensor, n_src: int, *,
                             lookback: int, out_dtype=None) -> torch.Tensor:
    """K6b: ``csrc/gather_window.cu``'s scatter, two launches (one where
    ``g`` holds no edge slot): the listing of the unmasked edges, then the
    bucketed sums.  Every unmasked ``nbr[i, k]`` must lie in ``[i -
    lookback, i]``: an edge outside that window may be left out.
    Accumulates in f32 and returns ``out_dtype`` (default ``g.dtype``)."""
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
    if m * k >= 2 ** 31 - LIST_EDGES:
        raise ValueError(f"at most 2^31 - {LIST_EDGES} edge slots, got "
                         f"{m * k}")
    out = torch.empty((n_src, c), dtype=out_dtype, device=g.device)
    if out.numel():
        n_lists = -(-m * k // LIST_EDGES)
        edges = torch.empty((n_lists * LIST_EDGES, 2), dtype=torch.int32,
                            device=g.device)
        counts = torch.empty((n_lists,), dtype=torch.int32, device=g.device)
        launch("eventad_scatter_window_rows", ptr(g), ptr(nbr),
               ptr(nbr_mask), m, k, c, n_src, int(lookback),
               int(g.dtype == torch.bfloat16),
               int(out_dtype == torch.bfloat16), scatter_tile(c), ptr(edges),
               ptr(counts), ptr(out))
        scatter_window_rows_cuda.launches += 2 if n_lists else 1
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
