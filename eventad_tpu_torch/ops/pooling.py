"""Voxel-grid graph pooling with static cell tables (counterpart of
``eventad_tpu/ops/pooling.py``).

The pooled node set is the full ``batch_size * nx * ny`` cell table with an
``active`` mask (reference pooling.py:34 sizes its cluster space the same
way).  Pooled edges form a ``(2*span+1)**2`` offset bitmap per destination
cell, so the neighbour table is arithmetic and deduplication is free.

:func:`pool_graph` takes K8 (:func:`pool_graph_cuda`, ``csrc/
pool_graph.cu``: one fill and two launches in place of the plain
formulation's ~115 operations) on the card, and the plain formulation
(:func:`pool_graph_plain`) on the CPU and where :func:`needs_plain` says
so: for training, which needs ``scatter_reduce``'s gradient, and where
PyTorch is asked for deterministic algorithms.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.graph import Graph, neighbor_rows
from .kernels import launch, ptr

_DTYPES = (torch.float32, torch.bfloat16)
# as csrc/pool_graph.cu: 32-bit words of a cell's record in the workspace
# (position sums, count, offset bitmap, temporal max), and the largest span
# whose (2 span + 1)^2 offsets fit one word
CELL_WORDS = 8
MAX_SPAN = 2


def _round_to_pixel(p: torch.Tensor, size: int) -> torch.Tensor:
    """reference pooling.py:47-49: floor((pos + 1e-5) * size) / size."""
    return torch.floor((p + 1e-5) * size) / size


def _cells(pos: torch.Tensor, batch: torch.Tensor, grid: tuple):
    """``(ix, iy, cell)`` of every node: its column, row and flat cell
    ``(b, iy, ix)`` in ``grid = (nx, ny)``."""
    nx, ny = grid
    pc = torch.clamp(pos, 0.0, 0.9999999)
    ix = torch.floor(pc[:, 0] * nx).long()
    iy = torch.floor(pc[:, 1] * ny).long()
    return ix, iy, batch.long() * (nx * ny) + iy * nx + ix


def max_pool_margin(x: torch.Tensor, pos: torch.Tensor,
                    node_mask: torch.Tensor, batch: torch.Tensor, *,
                    grid: tuple, batch_size: int) -> float:
    """The smallest gap, relative to the larger, between the largest entry
    of a channel in a cell (where positive) and the largest entry below it,
    over every cell and channel of the max pooling of ``x [N, C]`` into
    ``grid``.  The pooling's gradient goes to the largest entry; where this
    gap lies within the rounding of ``x``, which entry that is depends on
    the rounding (two implementations of the same forward may route the
    cotangent differently).  ``inf`` where no cell has two entries."""
    _, _, cell = _cells(pos, batch, grid)
    m_total = batch_size * grid[0] * grid[1]
    xs = x.detach().to(torch.float32)[node_mask]
    idx = cell[node_mask][:, None].expand(-1, x.shape[1])

    def cell_max(v):
        acc = torch.full((m_total, x.shape[1]), -torch.inf,
                         device=x.device)
        return acc.scatter_reduce_(0, idx, v, "amax")
    top = cell_max(xs)
    below = torch.where(xs < top.gather(0, idx), xs, -torch.inf)
    second = cell_max(below)
    ok = (top > 0) & torch.isfinite(second)
    if not bool(ok.any()):
        return float("inf")
    return float(((top - second) / top)[ok].min())


def pool_graph(x: torch.Tensor, pos: torch.Tensor, nbr: torch.Tensor,
               nbr_mask: torch.Tensor, node_mask: torch.Tensor,
               batch: torch.Tensor, **kw):
    """:func:`pool_graph_plain`'s pooling, by K8 (:func:`pool_graph_cuda`)
    for a CUDA ``x``, else, and where :func:`needs_plain`, by the plain
    formulation."""
    fn = pool_graph_cuda if x.is_cuda and not needs_plain(x) \
        else pool_graph_plain
    return fn(x, pos, nbr, nbr_mask, node_mask, batch, **kw)


def needs_plain(x: torch.Tensor) -> bool:
    """Whether the plain formulation has to pool ``x`` wherever it lies:
    autograd records an operation on it (K8 has no backward), or PyTorch is
    asked for deterministic algorithms (K8 sums in f32 atomics, in no fixed
    order; the plain ``index_add_`` then takes its deterministic version,
    as each of PyTorch's own operations does)."""
    return (torch.is_grad_enabled() and x.requires_grad) \
        or torch.are_deterministic_algorithms_enabled()


def pool_graph_plain(x: torch.Tensor, pos: torch.Tensor, nbr: torch.Tensor,
                     nbr_mask: torch.Tensor, node_mask: torch.Tensor,
                     batch: torch.Tensor, *, grid: tuple, batch_size: int,
                     width: int, height: int, aggr: str = "max",
                     span: int = 2, keep_temporal_ordering: bool = False,
                     pos_src: torch.Tensor = None,
                     return_pos_nbr: bool = False):
    """Pools ``x [N, C]`` at normalized ``pos [N, 3]`` into the cell grid
    ``grid = (nx, ny)``.

    ``pos_src``: neighbour positions ``[N, K, 2]`` (the conv already derived
    them) that give each edge's source cell; without it the source cell is
    read through ``nbr``.  ``aggr``: 'max' or 'mean' over the cell's nodes.
    Returns the pooled :class:`Graph` (with ``return_pos_nbr`` also the
    pooled table's per-slot neighbour positions ``[M, S, 2]``, equal to
    ``neighbor_rows(pooled_pos[:, :2])``)."""
    if aggr not in ("max", "mean"):
        raise ValueError(aggr)
    nx, ny = grid
    ncells = nx * ny
    m_total = batch_size * ncells
    side = 2 * span + 1
    n_off = side * side
    dev = x.device
    f32 = torch.float32

    ix, iy, cell = _cells(pos, batch, grid)
    cell_safe = torch.where(node_mask, cell, m_total)

    # ---- per-node adjacency bitmap over the cell offsets ----
    if pos_src is not None:
        ps = torch.clamp(pos_src, 0.0, 0.9999999)
        rel_x = torch.floor(ps[..., 0] * nx).long() - ix[:, None]
        rel_y = torch.floor(ps[..., 1] * ny).long() - iy[:, None]
        e_ok = nbr_mask & node_mask[:, None]
        not_self = (rel_x != 0) | (rel_y != 0)
    else:
        src_cell = cell_safe[nbr.long()]
        dst_cell = cell_safe[:, None]
        e_ok = (nbr_mask & node_mask[:, None] & (src_cell < m_total)
                & (dst_cell < m_total)
                & (src_cell // ncells == dst_cell // ncells))
        rel_x = src_cell % nx - dst_cell % nx
        rel_y = (src_cell // nx) % ny - (dst_cell // nx) % ny
        not_self = src_cell != dst_cell
    e_ok = e_ok & (rel_x.abs() <= span) & (rel_y.abs() <= span) & not_self
    rel_idx = ((rel_y + span) * side + (rel_x + span)).clamp(0, n_off - 1)
    offs = torch.arange(n_off, device=dev)
    node_onehot = ((rel_idx[..., None] == offs) & e_ok[..., None]).any(1)

    # ---- cell sums (f32, in node order) ----
    def cell_sum(rows):
        acc = torch.zeros((m_total + 1, rows.shape[1]), dtype=f32,
                          device=dev)
        return acc.index_add_(0, cell_safe, rows.to(f32))[:m_total]

    nm = node_mask[:, None]
    psum = cell_sum(torch.where(nm, pos, 0.0))
    pcnt = cell_sum(node_mask[:, None].to(f32))[:, 0]
    exist = cell_sum(node_onehot.to(f32)) > 0
    pooled_pos = (psum / pcnt.clamp(min=1.0)[:, None]).to(pos.dtype)
    pooled_pos = torch.stack([_round_to_pixel(pooled_pos[:, 0], width),
                              _round_to_pixel(pooled_pos[:, 1], height),
                              pooled_pos[:, 2]], 1)
    active = pcnt > 0

    if aggr == "mean":
        fsum = cell_sum(torch.where(nm, x.to(f32), 0.0))
        pooled_x = (fsum / pcnt.clamp(min=1.0)[:, None]).to(x.dtype)
    else:
        c = x.shape[1]
        accm = torch.full((m_total + 1, c), -torch.inf, dtype=f32,
                          device=dev)
        src = torch.where(nm, x.to(f32), -torch.inf)
        accm.scatter_reduce_(0, cell_safe[:, None].expand(-1, c), src,
                             "amax")
        pooled_x = accm[:m_total]
        pooled_x = torch.where(torch.isfinite(pooled_x), pooled_x, 0.0) \
            .to(x.dtype)

    # ---- neighbour table: arithmetic cell offsets ----
    cells = torch.arange(m_total, device=dev)
    cx, cy, cb = cells % nx, (cells // nx) % ny, cells // ncells
    ox = offs % side - span
    oy = offs // side - span
    nxs = cx[:, None] + ox[None, :]
    nys = cy[:, None] + oy[None, :]
    in_fov = (nxs >= 0) & (nxs < nx) & (nys >= 0) & (nys < ny)
    nbr_out = (cb[:, None] * ncells + nys.clamp(0, ny - 1) * nx
               + nxs.clamp(0, nx - 1))
    mask_out = exist & in_fov & active[:, None]
    # source-cell activity (+ temporal max, + positions) by 2-D shifts
    cols = [active[:, None].to(f32)]
    if keep_temporal_ordering:                      # pooling.py:69-72
        tmax = torch.full((m_total + 1,), -torch.inf, dtype=f32, device=dev)
        tmax.scatter_reduce_(0, cell_safe, torch.where(
            node_mask, pos[:, 2].to(f32), -torch.inf), "amax")
        tmax = tmax[:m_total]
        cols.append(tmax[:, None])
    if return_pos_nbr:
        cols.append(pooled_pos[:, :2].to(f32))
    shifts = neighbor_rows(torch.cat(cols, 1), grid, batch_size, span)
    mask_out = mask_out & (shifts[..., 0] > 0)
    col = 1
    if keep_temporal_ordering:
        mask_out = mask_out & (tmax[:, None] > shifts[..., 1])
        col = 2
    g = Graph(torch.where(active[:, None], pooled_x,
                          torch.zeros((), dtype=x.dtype, device=dev)),
              pooled_pos, torch.where(mask_out, nbr_out, 0).to(torch.int32),
              mask_out, active, cb.to(torch.int32))
    if return_pos_nbr:
        return g, shifts[..., col:col + 2]
    return g


def _check_layout(name, t, dtype, shape, unit_last=False):
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if unit_last:
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: expected a unit stride in the last "
                             f"dimension, got strides {t.stride()}")
        if any(s >= 2 ** 31 for s in t.stride()):
            raise ValueError(f"{name}: strides {t.stride()} above 32 bits")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def pool_layout(x, pos, nbr, nbr_mask, node_mask, batch, *, grid,
                batch_size, aggr="max", span=2, pos_src=None):
    """K8's argument check, the device aside: raises ``ValueError`` on what
    the kernel does not take.  ``x`` (f32 or bf16), ``pos``, ``node_mask``
    and ``batch`` contiguous; ``nbr``, ``nbr_mask`` and ``pos_src`` may be
    column slices of wider tables (each row's slots, and a slot's two
    coordinates, side by side).  Returns ``(n, c, k, m)``."""
    if aggr not in ("max", "mean"):
        raise ValueError(aggr)
    if x.dtype not in _DTYPES or x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x: expected a 2-D float32 or bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not 0 <= span <= MAX_SPAN:
        raise ValueError(f"span: at most {MAX_SPAN}, got {span}")
    n, c = x.shape
    k = nbr.shape[1] if nbr.dim() == 2 else -1
    _check_layout("x", x, x.dtype, (n, c))
    _check_layout("pos", pos, torch.float32, (n, 3))
    _check_layout("node_mask", node_mask, torch.bool, (n,))
    _check_layout("batch", batch, torch.int32, (n,))
    _check_layout("nbr", nbr, torch.int32, (n, k), unit_last=True)
    _check_layout("nbr_mask", nbr_mask, torch.bool, (n, k), unit_last=True)
    if pos_src is not None:
        _check_layout("pos_src", pos_src, torch.float32, (n, k, 2),
                      unit_last=True)
    m = batch_size * grid[0] * grid[1]
    if not 1 <= m < 2 ** 31:
        raise ValueError(f"{m} cells: out of range")
    return n, c, k, m


def pool_graph_cuda(x: torch.Tensor, pos: torch.Tensor, nbr: torch.Tensor,
                    nbr_mask: torch.Tensor, node_mask: torch.Tensor,
                    batch: torch.Tensor, *, grid: tuple, batch_size: int,
                    width: int, height: int, aggr: str = "max",
                    span: int = 2, keep_temporal_ordering: bool = False,
                    pos_src: torch.Tensor = None,
                    return_pos_nbr: bool = False):
    """K8: :func:`pool_graph_plain` by ``csrc/pool_graph.cu``, one fill of
    the workspace and two launches (the nodes, then the cells) on the
    current stream, nothing synchronised.  Takes the layouts
    :func:`pool_layout` states, on one CUDA device; raises ``ValueError``
    on anything else.  ``nbr`` is read only without ``pos_src``."""
    n, c, k, m = pool_layout(x, pos, nbr, nbr_mask, node_mask, batch,
                             grid=grid, batch_size=batch_size, aggr=aggr,
                             span=span, pos_src=pos_src)
    dev = x.device
    for name, t in (("x", x), ("pos", pos), ("nbr", nbr),
                    ("nbr_mask", nbr_mask), ("node_mask", node_mask),
                    ("batch", batch), ("pos_src", pos_src)):
        if t is not None and (not t.is_cuda or t.device != dev):
            raise ValueError(f"{name}: expected a CUDA tensor on {dev}, got "
                             f"{t.device}")
    nx, ny = grid
    s = (2 * span + 1) ** 2
    work = torch.empty((m * (CELL_WORDS + c),), dtype=torch.int32,
                       device=dev)
    out_x = torch.empty((m, c), dtype=x.dtype, device=dev)
    out_pos = torch.empty((m, 3), dtype=torch.float32, device=dev)
    out_nbr = torch.empty((m, s), dtype=torch.int32, device=dev)
    out_mask = torch.empty((m, s), dtype=torch.bool, device=dev)
    active = torch.empty((m,), dtype=torch.bool, device=dev)
    out_batch = torch.empty((m,), dtype=torch.int32, device=dev)
    pos_nbr = (torch.empty((m, s, 2), dtype=torch.float32, device=dev)
               if return_pos_nbr else None)
    ps = pos_src.stride()[:2] if pos_src is not None else (0, 0)
    dims = (ctypes.c_int * 16)(
        n, c, k, nbr.stride(0), nbr_mask.stride(0), *ps, nx, ny, batch_size,
        width, height, int(aggr == "mean"), int(keep_temporal_ordering),
        span, int(x.dtype == torch.bfloat16))
    launch("eventad_pool_graph", ptr(x), ptr(pos), ptr(nbr), ptr(nbr_mask),
           ptr(node_mask), ptr(batch), ptr(pos_src), dims, ptr(work),
           ptr(out_x), ptr(out_pos), ptr(out_nbr), ptr(out_mask),
           ptr(active), ptr(out_batch), ptr(pos_nbr))
    pool_graph_cuda.launches += 2 if n else 1
    g = Graph(out_x, out_pos, out_nbr, out_mask, active, out_batch)
    return (g, pos_nbr) if return_pos_nbr else g


pool_graph_cuda.launches = 0
