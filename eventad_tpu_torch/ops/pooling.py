"""Voxel-grid graph pooling with static cell tables (counterpart of
``eventad_tpu/ops/pooling.py``).

The pooled node set is the full ``batch_size * nx * ny`` cell table with an
``active`` mask (reference pooling.py:34 sizes its cluster space the same
way).  Pooled edges form a ``(2*span+1)**2`` offset bitmap per destination
cell, so the neighbour table is arithmetic and deduplication is free.
"""
from __future__ import annotations

import torch

from ..models.graph import Graph, neighbor_rows


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
               batch: torch.Tensor, *, grid: tuple, batch_size: int,
               width: int, height: int, aggr: str = "max", span: int = 2,
               keep_temporal_ordering: bool = False,
               pos_src: torch.Tensor = None, return_pos_nbr: bool = False):
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
