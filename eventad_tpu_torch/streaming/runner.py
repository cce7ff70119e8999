"""Dense streaming step: ``(state, new_events) -> (state, scores)``
(counterpart of ``eventad_tpu/streaming/runner.py``; reference asynchronous
runtime driver, src/dagr/asynchronous/evaluate_flops.py:82-165).

The sliding window advances by appending the newest events to a ring buffer
and dropping the oldest (``SlidingWindowGraph.delete_nodes`` semantics by
slot shifting); the temporal-radius cutoff makes old events unreachable to
the neighbour search before they are evicted, so the scores equal the batch
path's whenever the buffer covers the time window
(``evaluate.consistency_check``).  Every step rebuilds the level-0 graph
and runs the whole backbone on the buffer; the CNN pyramid is cached
between frames and the GRU hidden state persists across steps.
"""
from __future__ import annotations

import torch

from ..models.backbone import BackboneConfig, backbone_forward
from ..models.dagr import EventADModel, build_level0_graph
from ..models.eventad import EventADConfig, fusion_forward, spatial_attention
from ..models.feature_extract import extract_box_features
from ..models.gru import gru_input, gru_step
from ..models.resnet import cnn_branch_forward
from ..utils.tensors import constant
from .state import StreamingState


def push_rows(a: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The ring ``a`` advanced by ``k = len(rows)`` slots: the oldest ``k``
    rows dropped, ``rows`` written at the end (``roll(a, -k)`` with its last
    ``k`` rows replaced, as the JAX package writes it)."""
    return torch.cat([a[rows.shape[0]:], rows.to(a.dtype)])


def insert_events(state, new_pos: torch.Tensor, new_pol: torch.Tensor,
                  n_new):
    """Appends ``len(new_pos)`` event slots (the first ``n_new`` valid) to
    the ring of ``state`` (any state with ``pos``, ``polarity``, ``valid``
    and ``t_now``: a ``StreamingState`` or an incremental one), evicting
    the oldest.  The buffer stays chronologically sorted."""
    k = new_pos.shape[0]
    slot_ok = torch.arange(k, device=new_pos.device) < n_new
    t_new = torch.where(slot_ok, new_pos[:, 2], 0).max()
    return state._replace(
        pos=push_rows(state.pos, torch.where(slot_ok[:, None], new_pos, 0)),
        polarity=push_rows(state.polarity,
                           torch.where(slot_ok, new_pol, 0.0)),
        valid=push_rows(state.valid, slot_ok),
        t_now=torch.maximum(state.t_now, t_new))


def head_step(model: EventADModel, mc: EventADConfig, state, out4, boxes,
              box_present, width: int, height: int):
    """Box features of the current frame's slots from ``out4``, one step of
    the recurrent head and the spatial attention (EventAD.py:229-300 on one
    frame); returns ``(state with the new hidden states, logits [S+1,
    2])``, the logits zero outside the slots that produced outputs."""
    head = model.head
    feats = extract_box_features(out4, boxes[None, None],
                                 box_present[None, None], 1, width,
                                 height)[0, 0]
    coords = boxes / constant((width, height, width, height), torch.float32,
                              boxes.device)
    feat_ok = feats.abs().sum(-1) > 0
    slot_ids = torch.arange(boxes.shape[0], device=boxes.device)
    v = box_present & feat_ok & (slot_ids >= 1) & (slot_ids <= mc.max_boxes)
    h_in_e = torch.where(state.seen[:, None, None], state.h_event, 0.0)
    h_in_c = torch.where(state.seen[:, None, None], state.h_coord, 0.0)
    out_e, h_out_e = gru_step(head.gru_event,
                              gru_input(head.gru_event, feats), h_in_e)
    out_c, h_out_c = gru_step(head.gru_coord,
                              gru_input(head.gru_coord, coords), h_in_c)
    logits = fusion_forward(head.fusion, out_e, out_c)
    att_e = spatial_attention(h_out_e, head.att_event_w, v)
    att_c = spatial_attention(h_out_c, head.att_coord_w, v)
    state = state._replace(
        h_event=torch.where(v[:, None, None], att_e, state.h_event),
        h_coord=torch.where(v[:, None, None], att_c, state.h_coord),
        seen=state.seen | v)
    return state, torch.where(v[:, None], logits, 0.0)


def make_stream_step(model: EventADModel, bc: BackboneConfig,
                     mc: EventADConfig, gsc: tuple, *, n_chunk: int):
    """The dense streaming step of one stream (``bc.batch_size`` 1):
    ``step(state, new_pos [n_chunk, 3] int32 absolute t, new_pol
    [n_chunk], n_new, boxes [S+1, 4] pixels, box_present [S+1])`` appends
    the chunk and returns ``(state, logits [S+1, 2])``."""
    if bc.batch_size != 1:
        raise ValueError("streaming runs one stream (batch_size=1)")
    (_r, _d, _k, _q, _l, width, height, time_window) = gsc

    @torch.no_grad()
    def step(state: StreamingState, new_pos, new_pol, n_new, boxes,
             box_present):
        if new_pos.shape[0] != n_chunk:
            raise ValueError(f"a chunk holds {n_chunk} event slots, got "
                             f"{new_pos.shape[0]}")
        state = insert_events(state, new_pos, new_pol, n_new)
        # rebase timestamps so the window ends at time_window (the
        # preprocessing contract, dsec_data.py:124-130)
        t_rel = state.pos[:, 2] - state.t_now + time_window
        in_window = state.valid & (t_rel >= 0)
        pos_rel = torch.cat([state.pos[:, :2],
                             torch.where(in_window, t_rel, 0)[:, None]], 1)
        g0 = build_level0_graph(pos_rel[None], state.polarity[None],
                                in_window[None], gsc)
        _, out4 = backbone_forward(model.dagr.backbone, g0,
                                   state.image_feats, bc)
        return head_step(model, mc, state, out4, boxes, box_present, width,
                         height)

    return step


@torch.no_grad()
def update_image(model: EventADModel, state: StreamingState,
                 image: torch.Tensor) -> StreamingState:
    """Refreshes the cached CNN pyramid (f32) from a new frame ``image [H,
    W, 3]``."""
    return state._replace(
        image_feats=tuple(cnn_branch_forward(model.dagr.cnn, image[None])))
