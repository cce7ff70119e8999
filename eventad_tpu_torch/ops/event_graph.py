"""Event-graph construction: the level-0 neighbour search.

Counterpart of ``eventad_tpu/ops/event_graph.py`` (spiral enumeration,
per-pixel queue ranks, the XLA formulation ``build_graph``) and of the
Pallas kernel ``eventad_tpu/ops/event_graph_pallas.py`` (K1, here the CUDA
kernel ``csrc/event_graph_search.cu``).

Contract (reference ev_graph.cu:15-80): for every valid destination ``i``,
the neighbours are the older events ``j = i - d``, ``d = 1..lookback``, that
are valid, lie within the Chebyshev square ``|dx|, |dy| <= radius``, satisfy
``t_i - t_j <= delta_t_us`` and have queue rank ``< Q``; the ``K - 1``
smallest keys ``spiral_index(dx, dy) * Q + rank_j`` are kept, the smaller
``d`` first at equal key.  Slot 0 is the self edge.  Outputs ``nbr``,
``nbr_mask`` and ``doff`` (``dst - src`` pixel offsets).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .kernels import launch, ptr, require

_INVALID_KEY = np.int32(2**31 - 1)


# ---------------------------------------------------------------------------
# spiral enumeration (reference src/dagr/graph/spiral.h)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def spiral_index_table(radius: int) -> np.ndarray:
    """``table[dy + r, dx + r]`` = visit order of offset (dx, dy) in the
    square spiral of the reference kernel."""
    side = 2 * radius + 1
    table = np.full((side, side), _INVALID_KEY, dtype=np.int32)
    x = y = 0
    layer, leg = 1, 0
    for order in range(side * side):
        if abs(x) <= radius and abs(y) <= radius:
            table[y + radius, x + radius] = order
        if leg == 0:
            x += 1
            if x == layer:
                leg = 1
        elif leg == 1:
            y += 1
            if y == layer:
                leg = 2
        elif leg == 2:
            x -= 1
            if -x == layer:
                leg = 3
        else:
            y -= 1
            if -y == layer:
                leg = 0
                layer += 1
    return table


def spiral_index(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Closed-form spiral visit order of offset (dx, dy) (rotated
    coordinates u = dx+dy, s = dy-dx; ring r = (|u|+|s|)/2)."""
    u = dx + dy
    s = dy - dx
    r = (u.abs() + s.abs()) >> 1
    v = s - 2 * r
    upper = (u > 0) | ((u == 0) & (s > 0))
    return 4 * r * r + torch.where(upper, v, -v)


def spiral_offset(s: torch.Tensor):
    """Inverse of :func:`spiral_index`: visit order -> (dx, dy)."""
    sf = s.to(torch.float32)
    r = torch.floor((torch.sqrt(sf.clamp(min=0.0)) + 1.0) * 0.5) \
        .to(s.dtype)
    r = torch.where((2 * r - 1) ** 2 > s, r - 1, r)
    r = torch.where((2 * r + 1) ** 2 <= s, r + 1, r)
    p = s - (2 * r - 1) ** 2
    leg = torch.clamp(torch.div(p, (2 * r).clamp(min=1),
                                rounding_mode="floor"), 0, 3)
    dx = torch.where(leg == 0, r, torch.where(
        leg == 1, 3 * r - 1 - p, torch.where(leg == 2, -r, p - 7 * r + 1)))
    dy = torch.where(leg == 0, p - r + 1, torch.where(
        leg == 1, r, torch.where(leg == 2, 5 * r - 1 - p, -r)))
    zero = s <= 0
    return torch.where(zero, 0, dx), torch.where(zero, 0, dy)


# ---------------------------------------------------------------------------
# per-pixel queue rank
# ---------------------------------------------------------------------------
def queue_rank(pix: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """For every event of one item, the number of later valid events at its
    pixel; invalid events get ``n + 1``."""
    n = pix.shape[0]
    pixv = torch.where(valid, pix.to(torch.int64), 2**40)
    order = torch.sort(pixv, stable=True).indices
    sp = pixv[order]
    pos = torch.arange(n, device=pix.device)
    is_last = torch.cat([sp[1:] != sp[:-1],
                         torch.ones(1, dtype=torch.bool, device=pix.device)])
    last_pos = torch.where(is_last, pos, n)
    last_pos = torch.flip(torch.cummin(torch.flip(last_pos, [0]), 0).values,
                          [0])
    ranks = torch.empty(n, dtype=torch.int32, device=pix.device)
    ranks[order] = (last_pos - pos).to(torch.int32)
    return torch.where(valid, ranks, n + 1)


def _ranks_or_default(pos, valid, ranks):
    b, n, _ = pos.shape
    if ranks is None:
        pix = pos[..., 1].to(torch.int64) * 2**15 + pos[..., 0]
        return torch.stack([queue_rank(pix[i], valid[i]) for i in range(b)])
    return torch.where(valid, ranks.to(torch.int32), n + 1)


# ---------------------------------------------------------------------------
# plain PyTorch version (the XLA formulation)
# ---------------------------------------------------------------------------
def build_graph(pos: torch.Tensor, valid: torch.Tensor, ranks=None, *,
                radius: int, delta_t_us: int, max_neighbors: int = 16,
                max_queue_size: int = 128, lookback: int = 1024,
                chunk: int = 512):
    """Batched neighbour search, ``pos [B, N, 3]`` int32, ``valid [B, N]``.

    Returns ``nbr [B, N, K]`` int32 (indices within the item), ``nbr_mask
    [B, N, K]`` bool and ``doff [B, N, K, 2]`` int32.  Candidates are
    materialized per destination chunk as a ``[B, chunk, lookback]`` key
    table; a stable sort keeps the smaller ``d`` first at equal key."""
    b, n, _ = pos.shape
    dev = pos.device
    k_other = max_neighbors - 1
    lookback = min(lookback, n)
    ranks = _ranks_or_default(pos, valid, ranks)
    x, y, t = (pos[..., i].to(torch.int64) for i in range(3))
    d = torch.arange(1, lookback + 1, device=dev)
    big = torch.iinfo(torch.int64).max
    nbrs, masks, offs = [], [], []
    for i0 in range(0, n, chunk):
        ii = torch.arange(i0, min(i0 + chunk, n), device=dev)
        jj = ii[:, None] - d[None, :]                      # [C, L]
        in_range = jj >= 0
        jc = jj.clamp(min=0)
        dx = x[:, jc] - x[:, ii, None]                      # src - dst
        dy = y[:, jc] - y[:, ii, None]
        dt = t[:, ii, None] - t[:, jc]
        rk = ranks[:, jc]
        ok = (in_range & valid[:, jc] & valid[:, ii, None]
              & (dx.abs() <= radius) & (dy.abs() <= radius)
              & (dt <= delta_t_us) & (rk < max_queue_size))
        key = torch.where(ok, spiral_index(dx, dy) * max_queue_size + rk,
                          big)
        top = torch.sort(key, dim=-1, stable=True)
        sel = top.indices[..., :k_other]                    # lane = d - 1
        found = top.values[..., :k_other] < big
        nbrs.append(torch.where(found, ii[:, None] - (sel + 1), 0))
        masks.append(found)
        offs.append(torch.where(found[..., None], -torch.stack(
            [dx.gather(-1, sel), dy.gather(-1, sel)], -1), 0))
    self_idx = torch.arange(n, device=dev).expand(b, n)[..., None]
    nbr = torch.cat([self_idx, torch.cat(nbrs, 1)], -1)
    mask = torch.cat([valid[..., None], torch.cat(masks, 1)], -1)
    doff = torch.cat([torch.zeros(b, n, 1, 2, dtype=torch.int64, device=dev),
                      torch.cat(offs, 1)], 2)
    return (torch.where(mask, nbr, 0).to(torch.int32), mask,
            doff.to(torch.int32))


# ---------------------------------------------------------------------------
# K1: the CUDA kernel
# ---------------------------------------------------------------------------
def search_key_bits(radius: int, max_queue_size: int, lookback: int):
    """``(dbits, bits)`` of the kernel's packed key ``(spiral_index * Q +
    rank) << dbits | d``: ``dbits`` holds any ``d <= lookback``, ``bits``
    any key; 32-bit keys where ``bits <= 32``, else 64-bit."""
    side = 2 * radius + 1
    dbits = max(int(lookback).bit_length(), 1)
    return dbits, ((side * side * max_queue_size) << dbits).bit_length()


def build_graph_cuda(pos: torch.Tensor, valid: torch.Tensor, ranks=None, *,
                     radius: int, delta_t_us: int, max_neighbors: int = 16,
                     max_queue_size: int = 128, lookback: int = 1024):
    """Same contract as :func:`build_graph`, one launch of
    ``csrc/event_graph_search.cu``.  ``valid`` (``torch.bool``) is read as
    its bytes, ``ranks`` (int32, the queue ranks) as given and the mask is
    written as a ``torch.bool`` tensor, so with ``ranks`` given the call
    launches the kernel and nothing else; without, the ranks are computed
    first by :func:`queue_rank`."""
    b, n, _ = pos.shape
    k_other = max_neighbors - 1
    if not 1 <= k_other <= 16:
        raise ValueError(f"max_neighbors must be in [2, 17], got "
                         f"{max_neighbors}")
    if ranks is None:
        ranks = _ranks_or_default(pos, valid, None)
    require(pos, "pos", dtype=torch.int32, shape=(b, n, 3))
    require(valid, "valid", dtype=torch.bool, shape=(b, n))
    require(ranks, "ranks", dtype=torch.int32, shape=(b, n))
    lookback = int(min(lookback, n))
    dbits, bits = search_key_bits(radius, max_queue_size, lookback)
    if bits > 64 or not -2**31 <= delta_t_us < 2**31:
        raise ValueError(f"radius {radius}, max_queue_size {max_queue_size}"
                         f" and lookback {lookback} need {bits}-bit keys, or"
                         f" delta_t_us {delta_t_us} is not a 32-bit int")
    k = k_other + 1
    nbr = torch.empty((b, n, k), dtype=torch.int32, device=pos.device)
    mask = torch.empty((b, n, k), dtype=torch.bool, device=pos.device)
    doff = torch.empty((b, n, k, 2), dtype=torch.int32, device=pos.device)
    if b * n:
        launch("eventad_event_graph_search", ptr(pos), ptr(valid),
               ptr(ranks), b, n, int(radius), int(delta_t_us), k_other,
               int(max_queue_size), lookback, dbits, int(bits > 32),
               ptr(nbr), ptr(mask), ptr(doff))
        build_graph_cuda.launches += 1
    return nbr, mask, doff


build_graph_cuda.launches = 0


def build_graph_auto(pos, valid, ranks=None, *, grid_wh=None, **kw):
    """Dispatch by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``grid_wh`` (the sensor's width and height,
    which the TPU kernel packs into its keys) is accepted on both devices
    and used by neither.  ``chunk`` and ``starts``, the TPU kernel's tiling
    knobs, are dropped on the card; the plain version takes its own
    ``chunk``."""
    del grid_wh
    if pos.is_cuda:
        kw.pop("chunk", None)
        kw.pop("starts", None)
        return build_graph_cuda(pos, valid, ranks, **kw)
    return build_graph(pos, valid, ranks, **kw)
