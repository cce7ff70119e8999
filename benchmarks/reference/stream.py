"""The plain reference of the incremental stream (the asynchronous
runtime's semantics, as the program's ``streaming/incremental`` states
them): a ring of events with cached level-0 activations, each chunk
appended with a neighbour search over the ring's tail (ranks over that
tail) and the level-0 layer computed for the chunk's rows alone, reading
its neighbours' rows from the caches; a read pools the whole ring from the
caches and runs levels 1-4 and one step of the recurrent head.

Weights come from the reference-format state dict; nothing of the
program's state is read but the head's track state before a step (the
caller's choice, see ``loops/stream``).  A ring whose last ``ring +
2 * lookback`` rows were appended here from an empty ring equals the
program's after the same appends: a row's caches reach two lookbacks
back."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .geometry import Geometry
from .model import (Graph, Q, _layer_params, batch_norm, box_features, f32,
                    gnn, head_step, neighbours, spline_conv, upsampled_rows)


class Ring(NamedTuple):
    pos: torch.Tensor      # [N, 3] int32, absolute t, newest at the end
    pol: torch.Tensor      # [N]
    valid: torch.Tensor    # [N] bool
    x_in: torch.Tensor     # [N, C0] level-0 inputs
    h_b1: torch.Tensor     # [N, C1] level-0 block-1 outputs
    h1: torch.Tensor       # [N, C1] level-0 outputs
    img1: torch.Tensor     # [N, Ci1] image map 1 rows
    nbr0: torch.Tensor     # [N, K] int32
    nbrm0: torch.Tensor    # [N, K] bool
    off0: torch.Tensor     # [N, K, 2] int32 (dst - src)
    t_now: int


def queue_rank(pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """For every event the number of later valid events at its pixel;
    invalid events ``n + 1``."""
    n = pos.shape[0]
    pix = pos[:, 1].to(torch.int64) * 2 ** 15 + pos[:, 0]
    pixv = torch.where(valid, pix, 2 ** 40)
    order = torch.sort(pixv, stable=True).indices
    sp = pixv[order]
    idx = torch.arange(n, device=pos.device)
    is_last = torch.cat([sp[1:] != sp[:-1],
                         torch.ones(1, dtype=torch.bool, device=pos.device)])
    last = torch.where(is_last, idx, n)
    last = torch.flip(torch.cummin(torch.flip(last, [0]), 0).values, [0])
    ranks = torch.empty(n, dtype=torch.int32, device=pos.device)
    ranks[order] = (last - idx).to(torch.int32)
    return torch.where(valid, ranks, n + 1)


def _rows(feat, posn, valid, geo: Geometry):
    zeros = torch.zeros(posn.shape[0], dtype=torch.int32,
                        device=posn.device)
    r = upsampled_rows(feat, posn, zeros, geo.model_width, geo.model_height)
    return torch.where(valid[:, None], r, 0.0)


def _norm_pos(pos, t_now: int, geo: Geometry):
    t_rel = pos[:, 2] - t_now + geo.time_window_us
    p = torch.cat([pos[:, :2].to(torch.float32),
                   t_rel[:, None].to(torch.float32)], 1)
    return p / torch.tensor((geo.model_width, geo.model_height,
                             geo.time_window_us), dtype=torch.float32,
                            device=pos.device)


def input_rows(feats, posn, pol, valid, geo: Geometry):
    """The level-0 inputs (polarity, map-0 row, rel-xy) and the map-1 rows
    of the given events."""
    cols = [torch.where(valid[:, None], pol[:, None], 0.0)]
    img1 = torch.zeros((posn.shape[0], 1), device=posn.device)
    if geo.use_image:
        cols.append(_rows(feats[0], posn, valid, geo))
        img1 = _rows(feats[1], posn, valid, geo)
    cols.append(torch.where(valid[:, None], posn[:, :2], 0.0))
    return torch.cat(cols, 1), img1


def _attr(off, mask, geo: Geometry):
    cart = geo.cart_max()[0]
    s = torch.tensor((1.0 / (2.0 * cart * geo.model_width),
                      1.0 / (2.0 * cart * geo.model_height)),
                     device=off.device)
    return torch.where(mask[..., None], torch.clamp(
        off.to(torch.float32) * s + 0.5, 0.0, 1.0), 0.5)


def _level0_rows(sd, geo, x_src, h_b1_keep, nbr, nbrm, attr, x_dst, dmask,
                 q: Q):
    """The level-0 layer for the newest rows, their neighbours read from
    ``x_src`` and the block-1 cache (older rows ``h_b1_keep``, then the
    new rows); returns ``(h_b1 rows, h1 rows, the whole h_b1 cache)``."""
    (w1, r1, bn1), (w2, r2, bn2) = _layer_params(sd, 0)[0]
    skip_w, skip_b, skip_bn = _layer_params(sd, 0)[1]
    act = torch.relu
    cart = geo.cart_max()[0]
    sx = geo.radius_px / geo.model_width / (2.0 * cart)
    sy = geo.radius_px / geo.model_height / (2.0 * cart)
    kw = dict(ks=geo.kernel_size, aggr=geo.aggr, node_mask=dmask,
              attr_range=((0.5 - sx, 0.5 + sx), (0.5 - sy, 0.5 + sy)),
              fold_center=True, q=q)
    nbr, nbrm, attr = nbr[:, 1:], nbrm[:, 1:], attr[:, 1:]
    idx = nbr.long()
    x_src, x_dst = q(x_src), q(x_dst)
    h = q(batch_norm(spline_conv(x_dst, x_src[idx], nbrm, attr, w1, r1,
                                 **kw), dmask, bn1))
    h_rows = q(torch.where(dmask[:, None], act(h), 0.0))
    h_full = torch.cat([h_b1_keep, h_rows])
    h2 = q(batch_norm(spline_conv(h_rows, h_full[idx], nbrm, attr, w2, r2,
                                  **kw), dmask, bn2))
    skip = q(batch_norm(q(x_dst @ q(skip_w) + skip_b), dmask, skip_bn))
    return h_rows, q(torch.where(dmask[:, None], act(h2 + skip), 0.0)), \
        h_full


def empty_ring(n: int, geo: Geometry, dev) -> Ring:
    c0, c1 = geo.layer_in_out()[0]
    ci1 = geo.channels()[2] if geo.use_image else 1
    k = geo.max_neighbors

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return Ring(z(n, 3, dtype=torch.int32), z(n), z(n, dtype=torch.bool),
                z(n, c0), z(n, c1), z(n, c1), z(n, ci1),
                z(n, k, dtype=torch.int32), z(n, k, dtype=torch.bool),
                z(n, k, 2, dtype=torch.int32), 0)


def _push(a, rows):
    return torch.cat([a[rows.shape[0]:], rows.to(a.dtype)])


def append(sd, geo: Geometry, feats, ring: Ring, pos, pol,
           q: Q = f32) -> Ring:
    """A full chunk ``pos [k, 3]``, ``pol [k]`` into the ring."""
    k, n = pos.shape[0], ring.pos.shape[0]
    lookback = min(geo.graph_lookback, n - k)
    ok = torch.ones(k, dtype=torch.bool, device=pos.device)
    rpos, rpol, valid = (_push(ring.pos, pos), _push(ring.pol, pol),
                         _push(ring.valid, ok))
    t_now = max(ring.t_now, int(pos[:, 2].max()))
    nbr_keep = ring.nbr0[k:] - k
    nbrm_keep = ring.nbrm0[k:] & (nbr_keep >= 0)
    nbr_keep = torch.where(nbrm_keep, nbr_keep, 0)
    off_keep = torch.where(nbrm_keep[..., None], ring.off0[k:], 0)
    posn = _norm_pos(rpos, t_now, geo)
    x_rows, img1_rows = input_rows(feats, posn[-k:], rpol[-k:], valid[-k:],
                                   geo)
    x_in = _push(ring.x_in, x_rows)
    w0 = n - (lookback + k)
    tail_pos, tail_valid = rpos[w0:], valid[w0:]
    nbr_t, nbrm_t, doff_t = (t[0, -k:] for t in neighbours(
        tail_pos[None], tail_valid[None],
        queue_rank(tail_pos, tail_valid)[None], radius=geo.radius_px,
        delta_t_us=geo.delta_t_us, max_neighbors=geo.max_neighbors,
        max_queue_size=geo.max_queue_size, lookback=lookback))
    nbr_c = torch.where(nbrm_t, nbr_t + w0, 0)
    _, h1_rows, h_b1 = _level0_rows(sd, geo, x_in, ring.h_b1[k:], nbr_c,
                                    nbrm_t, _attr(doff_t, nbrm_t, geo),
                                    x_rows, valid[-k:], q)
    return Ring(rpos, rpol, valid, x_in, h_b1, _push(ring.h1, h1_rows),
                _push(ring.img1, img1_rows),
                torch.cat([nbr_keep, nbr_c]), torch.cat([nbrm_keep, nbrm_t]),
                torch.cat([off_keep, doff_t]), t_now)


def read(sd, geo: Geometry, feats, ring: Ring, boxes, present, state,
         q: Q = f32):
    """Levels 1-4 over the ring and one head step from ``state``: the
    logits ``[S, 2]`` (zero outside the slots that produced outputs), the
    new state and the slots that produced outputs.  ``feats``: the frame's
    five maps (``model.cnn_features`` at batch 1)."""
    g1 = dataclasses.replace(geo, batch_size=1)
    n = ring.pos.shape[0]
    posn = _norm_pos(ring.pos, ring.t_now, geo)
    x1 = torch.cat([ring.h1, ring.img1], 1) if geo.use_image else ring.h1
    g = Graph(x1, posn, ring.nbr0, ring.nbrm0, ring.valid,
              torch.zeros((n,), dtype=torch.int32, device=x1.device))
    wh = torch.tensor((geo.model_width, geo.model_height),
                      dtype=torch.float32, device=x1.device)
    pos_src0 = (ring.pos[:, None, :2] - ring.off0).to(torch.float32) / wh
    _, out4 = gnn(sd, g, feats, g1, q, start_level=1, pos_src0=pos_src0)
    feat = box_features(out4, boxes[None, None], present[None, None],
                        g1)[0, 0]
    coord = boxes / torch.tensor((geo.model_width, geo.model_height,
                                  geo.model_width, geo.model_height),
                                 dtype=torch.float32, device=boxes.device)
    slot = torch.arange(boxes.shape[0], device=boxes.device)
    valid = (present & (feat.abs().sum(-1) > 0) & (slot >= 1)
             & (slot <= geo.max_boxes))
    logits, state = head_step(sd, geo, feat, coord, valid, state)
    return torch.where(valid[:, None], logits, 0.0), state, valid

