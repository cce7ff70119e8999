"""Incremental (delta) streaming with cached level-0 activations
(counterpart of ``eventad_tpu/streaming/incremental.py``; reference
asynchronous runtime, src/dagr/asynchronous/): recompute only what a new
event chunk can change.

Edges always point from older to newer events (ev_graph.cu:62-64), so an
event's receptive field never grows after it arrives, and with eval-mode
batch norm the level-0 layer outputs of buffered events never change.  A
chunk step (``append``) therefore only:

1. advances the ring caches and computes the new rows' input features
   (polarity, cached CNN rows, rel-xy; net.py:107-123 order);
2. runs the neighbour search with the chunk as destinations over the buffer
   tail (kernel K1 on the card);
3. runs the level-0 layer for the new rows only, reading neighbour rows
   from the caches (``spline_conv(x_dst=...)``), and writes them back.

``read_scores`` re-pools the whole buffer from the caches and runs the
pooled levels (K3 on the card in bf16) and the recurrent head as the batch
path does (``backbone_forward(start_level=1)``).  A new frame invalidates
the cached CNN rows: ``refresh`` rebuilds every cache once per frame.  The
stream equals the batch path (``tests/test_torch_streaming.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.backbone import (BackboneConfig, backbone_forward,
                               layer_in_out_channels, level0_attr_range)
from ..models.dagr import resolve_device
from ..models.eventad import EventADConfig
from ..models.graph import (Graph, lookup_pixel_features,
                            upsample_align_corners)
from ..models.resnet import cnn_branch_forward
from ..ops.event_graph import build_graph_auto
from ..ops.norm import batch_norm
from ..ops.spline_basis import ACTS
from ..ops.spline_conv import offset_attr, spline_conv
from ..utils.spans import count, span
from ..utils.tensors import constant
from .runner import head_step, insert_events, push_rows


class IncrementalState(NamedTuple):
    pos: torch.Tensor        # [N_buf, 3] int32 absolute t (newest at end)
    polarity: torch.Tensor   # [N_buf]
    valid: torch.Tensor      # [N_buf] bool
    x_in: torch.Tensor       # [N_buf, Cin0] level-0 layer inputs
    h_b1: torch.Tensor       # [N_buf, C1] level-0 block-1 outputs
    h1: torch.Tensor         # [N_buf, C1] level-0 layer outputs
    img1: torch.Tensor       # [N_buf, Cimg1] image_feats[1] rows
    nbr0: torch.Tensor       # [N_buf, K] int32 level-0 neighbour table
    nbrm0: torch.Tensor      # [N_buf, K] bool
    off0: torch.Tensor       # [N_buf, K, 2] int32 pixel offsets (dst - src)
    image_feats: Optional[tuple]
    h_event: torch.Tensor
    h_coord: torch.Tensor
    seen: torch.Tensor
    t_now: torch.Tensor
    # detector streaming only: the CNN head's logit maps of the current
    # frame (``detect.update_image_detector``), added on each read
    cnn_maps: Optional[dict] = None


def init_incremental_state(n_buf: int, bc: BackboneConfig,
                           mc: EventADConfig, max_neighbors: int = 16,
                           device=None) -> IncrementalState:
    """Empty caches for a ring of ``n_buf`` events on ``device`` (the CUDA
    card unless the caller names the CPU).  ``max_neighbors`` is the graph
    configuration's neighbour cap (``cfg.max_neighbors``)."""
    dev = resolve_device(device)
    c_in0, c1 = layer_in_out_channels(bc)[0]
    c_img1 = bc.image_channels[1] if bc.use_image else 1
    s1 = mc.max_boxes + 1
    k = max_neighbors

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return IncrementalState(
        pos=zeros(n_buf, 3, dtype=torch.int32), polarity=zeros(n_buf),
        valid=zeros(n_buf, dtype=torch.bool), x_in=zeros(n_buf, c_in0),
        h_b1=zeros(n_buf, c1), h1=zeros(n_buf, c1),
        img1=zeros(n_buf, c_img1),
        nbr0=zeros(n_buf, k, dtype=torch.int32),
        nbrm0=zeros(n_buf, k, dtype=torch.bool),
        off0=zeros(n_buf, k, 2, dtype=torch.int32),
        image_feats=None,
        h_event=zeros(s1, mc.event_layers, mc.h_dim),
        h_coord=zeros(s1, mc.coord_layers, mc.coord_dim),
        seen=zeros(s1, dtype=torch.bool),
        t_now=zeros(dtype=torch.int32))


def norm_pos(pos, t_now, gsc):
    """Normalized positions of the ring, the window ending at ``t_now``."""
    (_r, _d, _k, _q, _l, width, height, time_window) = gsc
    t_rel = pos[:, 2] - t_now + time_window
    p = torch.cat([pos[:, :2].to(torch.float32),
                   t_rel[:, None].to(torch.float32)], 1)
    return p / constant((width, height, time_window), torch.float32,
                        pos.device)


def input_rows(image_feats, posn_rows, pol_rows, valid_rows, bc):
    """The level-0 layer's input rows (polarity, image_feats[0] row, rel-xy)
    and the image_feats[1] rows (one zero column without an image) of the
    given events."""
    n = posn_rows.shape[0]
    dev = posn_rows.device
    feats = [torch.where(valid_rows[:, None], pol_rows[:, None], 0.0)]
    img1 = torch.zeros((n, 1), device=dev)
    if bc.use_image:
        # image_feats[0] and [1] are kept upsampled to full resolution
        # (update_image): a row lookup equals the batch path's
        # upsample + lookup
        zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
        feats.append(lookup_pixel_features(
            image_feats[0], posn_rows, zeros, valid_rows, bc.width,
            bc.height))
        img1 = lookup_pixel_features(image_feats[1], posn_rows, zeros,
                                     valid_rows, bc.width, bc.height)
    feats.append(torch.where(valid_rows[:, None], posn_rows[:, :2], 0.0))
    return torch.cat(feats, 1), img1


def _layer1_rows(layer, bc, x_in_full, h_b1_keep, nbr, nbrm, attr,
                 x_dst_in, dmask):
    """The level-0 layer (two conv blocks + skip, eval BN) for the newest
    rows of the ring, their neighbours read from the caches.  ``h_b1_keep``
    are the block-1 outputs of the older rows; returns ``(h_b1 rows, h1
    rows, the whole h_b1 cache)``.  The same self-edge fold (slot 0 dropped,
    the centre tap folded into the root) and static tap range as the batch
    path's level-0 layer."""
    act = ACTS[bc.activation]
    fold = bc.aggr == "sum"
    s0 = 1 if fold else 0
    kw = dict(kernel_size=bc.kernel_size, aggr=bc.aggr,
              attr_range=level0_attr_range(bc), add_center_to_root=fold)
    nbr, nbrm, attr = nbr[:, s0:], nbrm[:, s0:], attr[:, s0:]
    h = spline_conv(x_in_full, nbr, nbrm, attr, layer.block1.conv,
                    x_dst=x_dst_in, **kw)
    h = batch_norm(h, dmask, layer.block1.bn)
    h_b1_rows = torch.where(dmask[:, None], act(h), 0.0)
    # block 2 reads block-1 outputs of neighbours, some in this chunk: the
    # cache takes the new rows first
    h_b1_full = torch.cat([h_b1_keep, h_b1_rows])
    h2 = spline_conv(h_b1_full, nbr, nbrm, attr, layer.block2.conv,
                     x_dst=h_b1_rows, **kw)
    h2 = batch_norm(h2, dmask, layer.block2.bn)
    skip = x_dst_in @ layer.skip_lin + layer.skip_lin_bias
    skip = batch_norm(skip, dmask, layer.skip_bn)
    h1_rows = torch.where(dmask[:, None], act(h2 + skip), 0.0)
    return h_b1_rows, h1_rows, h_b1_full


def pooled_backbone_outs(model, bc, state: IncrementalState, posn, gsc):
    """Pools the cached level-0 outputs and runs levels 1-4; returns the
    ``(out3, out4)`` graphs (shared by the anomaly and detection reads)."""
    (_r, _d, _k, _q, _l, width, height, _tw) = gsc
    x1 = state.h1
    if bc.use_image:
        x1 = torch.cat([x1, state.img1], 1)
    n_buf = x1.shape[0]
    count("stream/ring_rows", n_buf)
    g = Graph(x1, posn, state.nbr0, state.nbrm0, state.valid,
              torch.zeros((n_buf,), dtype=torch.int32, device=x1.device))
    # the first pooling's source cells from the cached integer offsets
    # (x_src = x_dst - off, normalized by the batch path's division)
    wh = constant((width, height), torch.float32, x1.device)
    pos_src0 = (state.pos[:, None, :2] - state.off0).to(torch.float32) / wh
    return backbone_forward(model.dagr.backbone, g, state.image_feats, bc,
                            start_level=1, pos_src0=pos_src0)


def _upper_levels_and_head(model, bc, mc, state, posn, boxes, box_present,
                           gsc):
    """Levels 1-4 from the caches, then the recurrent head."""
    (_r, _d, _k, _q, _l, width, height, _tw) = gsc
    with span("stream/levels"):
        _, out4 = pooled_backbone_outs(model, bc, state, posn, gsc)
    with span("stream/head"):
        return head_step(model, mc, state, out4, boxes, box_present, width,
                         height)


def make_incremental_step(model, bc: BackboneConfig,
                          mc: Optional[EventADConfig], gsc: tuple, *,
                          n_chunk: int, n_buf: int):
    """Returns ``(refresh, step)`` for one stream (``bc.batch_size`` 1).

    ``refresh(state)`` rebuilds every cache from the raw ring (after
    ``update_image`` on each new frame, and once at the start).
    ``step(state, new_pos [n_chunk, 3], new_pol [n_chunk], n_new, boxes
    [S+1, 4], box_present [S+1])`` appends a chunk and returns ``(state,
    logits [S+1, 2])``.  Besides, ``step.append(state, new_pos, new_pol,
    n_new)`` ingests a chunk into the level-0 caches only (the event-rate
    path), ``step.read_scores(state, boxes, box_present)`` runs the pooled
    levels and the head on demand, and ``step.append_many`` / ``step.many``
    take ``M`` chunks (``[M, n_chunk, ...]``, boxes ``[M, S+1, ...]``) in
    one call, equal to ``M`` single calls (a loop over them).

    ``mc=None`` builds the level-0 machinery without an anomaly head (the
    streaming detector's mode, ``detect.py``): ``refresh`` and ``append``
    work, the head's entry points raise.

    Spans (``utils/spans``): ``stream/step`` around ``stream/append``
    (``stream/search``, the tail search; ``stream/layer0``) and
    ``stream/read_scores`` (``stream/levels``, ``stream/head``);
    ``stream/refresh`` and ``stream/update_image`` on their own.  Counters,
    from shapes alone (no device value is read): ``stream/search_rows``,
    the tail rows an append searches (``lookback + n_chunk``), and
    ``stream/ring_rows``, the ring rows a read pools (``n_buf``)."""
    if bc.batch_size != 1:
        raise ValueError("streaming runs one stream (batch_size=1)")
    (radius_px, delta_t_us, max_nb, max_q, lookback, width, height,
     _tw) = gsc
    # the batch path's lookback (exact consistency); the chunk's window
    # also needs lookback <= n_buf - n_chunk
    lb_exact = min(lookback, n_buf)
    lookback = min(lookback, n_buf - n_chunk)
    search = dict(radius=radius_px, delta_t_us=delta_t_us,
                  max_neighbors=max_nb, max_queue_size=max_q,
                  grid_wh=(width, height))
    layer0 = model.dagr.backbone.layers[0]

    @torch.no_grad()
    def refresh(state: IncrementalState) -> IncrementalState:
        with span("stream/refresh"):
            posn = norm_pos(state.pos, state.t_now, gsc)
            x_in, img1 = input_rows(state.image_feats, posn, state.polarity,
                                    state.valid, bc)
            nbr, nbrm, doff = (t[0] for t in build_graph_auto(
                state.pos[None], state.valid[None], lookback=lb_exact,
                **search))
            attr = offset_attr(doff, nbrm, bc.cart_max[0], width, height)
            h_b1, h1, _ = _layer1_rows(layer0, bc, x_in, state.h_b1[:0],
                                       nbr, nbrm, attr, x_in, state.valid)
            return state._replace(x_in=x_in, img1=img1, nbr0=nbr,
                                  nbrm0=nbrm, off0=doff, h_b1=h_b1, h1=h1)

    @torch.no_grad()
    def append(state: IncrementalState, new_pos, new_pol,
               n_new) -> IncrementalState:
        k = n_chunk
        if new_pos.shape[0] != k:
            raise ValueError(f"a chunk holds {k} event slots, got "
                             f"{new_pos.shape[0]}")
        with span("stream/append"):
            # 1. advance the ring caches; neighbour indices shift with the
            # ring, evicted sources mask out
            ring = insert_events(state, new_pos, new_pol, n_new)
            pos, pol, valid = ring.pos, ring.polarity, ring.valid
            nbr_keep = state.nbr0[k:] - k
            nbrm_keep = state.nbrm0[k:] & (nbr_keep >= 0)
            nbr_keep = torch.where(nbrm_keep, nbr_keep, 0)
            off_keep = torch.where(nbrm_keep[..., None], state.off0[k:], 0)

            # 2. the new rows' input features
            posn = norm_pos(pos, ring.t_now, gsc)
            x_rows, img1_rows = input_rows(state.image_feats, posn[-k:],
                                           pol[-k:], valid[-k:], bc)
            x_in = push_rows(state.x_in, x_rows)

            # 3. neighbour search: the chunk's rows as destinations over
            # the buffer tail, every destination reaching back exactly
            # `lookback` events
            w0 = n_buf - (lookback + k)
            with span("stream/search"):
                count("stream/search_rows", lookback + k)
                nbr_t, nbrm_t, doff_t = (t[0, -k:] for t in build_graph_auto(
                    pos[None, w0:], valid[None, w0:], lookback=lookback,
                    **search))
                nbr_c = torch.where(nbrm_t, nbr_t + w0, 0)

            # 4. the level-0 layer for the chunk's rows only
            with span("stream/layer0"):
                attr = offset_attr(doff_t, nbrm_t, bc.cart_max[0], width,
                                   height)
                _, h1_rows, h_b1 = _layer1_rows(
                    layer0, bc, x_in, state.h_b1[k:], nbr_c, nbrm_t, attr,
                    x_rows, valid[-k:])
            return ring._replace(
                x_in=x_in, img1=push_rows(state.img1, img1_rows),
                nbr0=torch.cat([nbr_keep, nbr_c]),
                nbrm0=torch.cat([nbrm_keep, nbrm_t]),
                off0=torch.cat([off_keep, doff_t]), h_b1=h_b1,
                h1=push_rows(state.h1, h1_rows))

    def _require_head():
        if mc is None:
            raise RuntimeError(
                "this incremental step was built without an anomaly-head "
                "config (mc=None, the streaming-detector mode): "
                "step/read_scores/step_many are unavailable; use "
                "append/read_detections")

    @torch.no_grad()
    def read_scores(state: IncrementalState, boxes, box_present):
        _require_head()
        with span("stream/read_scores"):
            posn = norm_pos(state.pos, state.t_now, gsc)
            return _upper_levels_and_head(model, bc, mc, state, posn, boxes,
                                          box_present, gsc)

    def step(state: IncrementalState, new_pos, new_pol, n_new, boxes,
             box_present):
        _require_head()
        with span("stream/step"):
            return read_scores(append(state, new_pos, new_pol, n_new),
                               boxes, box_present)

    def append_many(state: IncrementalState, pos_chunks, pol_chunks,
                    n_chunks) -> IncrementalState:
        """``M`` appends, one after the other (``pos_chunks [M, n_chunk,
        3]``, ``pol_chunks [M, n_chunk]``, ``n_chunks [M]``)."""
        for p, q, n in zip(pos_chunks, pol_chunks, n_chunks):
            state = append(state, p, q, n)
        return state

    def step_many(state: IncrementalState, pos_chunks, pol_chunks, n_chunks,
                  boxes_frames, present_frames):
        """``M`` steps, one after the other; returns ``(state, logits [M,
        S+1, 2])``."""
        _require_head()
        logits = []
        for p, q, n, bx, bp in zip(pos_chunks, pol_chunks, n_chunks,
                                   boxes_frames, present_frames):
            state, lg = step(state, p, q, n, bx, bp)
            logits.append(lg)
        return state, torch.stack(logits)

    step.append = append
    step.append_many = append_many
    step.read_scores = read_scores
    step.many = step_many
    return refresh, step


# fills the raw ring without computing caches (before the first ``refresh``)
insert_raw = insert_events


def upsampled_pyramid(feats, width: int, height: int) -> tuple:
    """The CNN pyramid as the incremental path keeps it: maps 0 and 1, read
    at event positions on every chunk, upsampled to full resolution so
    that the read is a row lookup."""
    feats = list(feats)
    feats[0] = upsample_align_corners(feats[0], width, height)
    feats[1] = upsample_align_corners(feats[1], width, height)
    return tuple(feats)


@torch.no_grad()
def update_image(model, state: IncrementalState, image: torch.Tensor,
                 width: int = None, height: int = None) -> IncrementalState:
    """Refreshes the cached CNN pyramid (f32) from a new frame ``image [H,
    W, 3]``; call ``refresh`` after it."""
    w = width if width is not None else image.shape[1]
    h = height if height is not None else image.shape[0]
    with span("stream/update_image"):
        feats = cnn_branch_forward(model.dagr.cnn, image[None])
        return state._replace(image_feats=upsampled_pyramid(feats, w, h))
