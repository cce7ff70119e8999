"""EventAD anomaly head (counterpart of
``eventad_tpu/models/eventad.py``; reference models/EventAD.py:141-499).

Track state is a dense tensor over ``max_boxes + 1`` slots, and batch items
are consecutive frames of a video: the hidden state flows from one item to
the next (EventAD.py:202-206), so the JAX ``lax.scan`` over items is a loop
here.  Reference semantics kept: a slot is processed iff its current-frame
feature is non-zero and a box with that track id exists; the score is raw
logit channel 1; the loss is the sum of per-box cross entropies.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .gru import GRU, dropout_mask, gru_step


class EventADConfig(NamedTuple):
    x_dim: int = 64
    h_dim: int = 256
    coord_dim: int = 32
    max_boxes: int = 30
    event_layers: int = 2
    coord_layers: int = 1
    dropout: float = 0.3


def _linear(cin, cout, generator):
    s = 1.0 / cin ** 0.5
    return (nn.Parameter(torch.empty(cin, cout).uniform_(-s, s,
                                                         generator=generator)),
            nn.Parameter(torch.empty(cout).uniform_(-s, s,
                                                    generator=generator)))


class Fusion(nn.Module):
    def __init__(self, h_dim: int, coord_dim: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.event_proj_w, self.event_proj_b = _linear(h_dim, 256, generator)
        self.coord_proj_w, self.coord_proj_b = _linear(coord_dim, 256,
                                                       generator)
        self.fuse1_w, self.fuse1_b = _linear(512, 256, generator)
        self.fuse2_w, self.fuse2_b = _linear(256, 2, generator)


class EventADHead(nn.Module):
    def __init__(self, mc: EventADConfig, generator: torch.Generator = None):
        super().__init__()
        self.fusion = Fusion(mc.h_dim, mc.coord_dim, generator)
        # SpatialAttention: kaiming_normal_(a=sqrt(5)) on [h, 1]
        self.att_event_w = nn.Parameter(torch.randn(
            mc.h_dim, 1, generator=generator) * (2.0 / 6 / mc.h_dim) ** 0.5)
        self.att_coord_w = nn.Parameter(torch.randn(
            mc.coord_dim, 1, generator=generator)
            * (2.0 / 6 / mc.coord_dim) ** 0.5)
        self.gru_event = GRU(mc.x_dim, mc.h_dim, mc.event_layers, generator)
        self.gru_coord = GRU(4, mc.coord_dim, mc.coord_layers, generator)


def spatial_attention(h: torch.Tensor, w: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Masked softmax attention over track slots, per layer
    (EventAD.py:100-138): ``h [S, L, H]``, ``w [H, 1]``, ``valid [S]``."""
    score = (torch.tanh(h) @ w).squeeze(-1)                  # [S, L]
    score = torch.where(valid[:, None], score, -torch.inf)
    alpha = torch.softmax(score, dim=0)
    alpha = torch.where(valid[:, None], alpha, 0.0)
    return h * alpha[..., None]


def fusion_forward(p: Fusion, ev: torch.Tensor, co: torch.Tensor, *,
                   dropout: float = 0.0,
                   generator: torch.Generator = None) -> torch.Tensor:
    e = ev @ p.event_proj_w + p.event_proj_b
    c = co @ p.coord_proj_w + p.coord_proj_b
    h = torch.relu(torch.cat([e, c], dim=-1) @ p.fuse1_w + p.fuse1_b)
    if dropout > 0.0 and generator is not None:
        h = dropout_mask(h, dropout, generator)
    return h @ p.fuse2_w + p.fuse2_b


class EventADOutputs(NamedTuple):
    logits: torch.Tensor   # [B, S, 2]
    valid: torch.Tensor    # [B, S] slots that produced outputs
    labels: torch.Tensor   # [B, S]
    loss: torch.Tensor     # scalar, summed CE over valid boxes
    n_valid: torch.Tensor  # scalar count


def eventad_forward(head: EventADHead, mc: EventADConfig,
                    features: torch.Tensor, coords: torch.Tensor,
                    bbox_present: torch.Tensor,
                    labels: torch.Tensor, *, training: bool = False,
                    generator: torch.Generator = None) -> EventADOutputs:
    """``features [B, 2, S, x_dim]``, ``coords [B, S, 4]`` normalized xywh,
    ``bbox_present [B, S]``, ``labels [B, S]``.  Dropout (``mc.dropout``,
    between the event GRU's layers and before the last fusion layer) is
    active only when ``training`` and a ``generator`` on the features'
    device is given."""
    b, _, s1, _ = features.shape
    dev = features.device
    curr_feat = features[:, 1]
    feat_nonzero = curr_feat.abs().sum(-1) > 0               # EventAD.py:229
    slot_ids = torch.arange(s1, device=dev)
    in_range = (slot_ids >= 1) & (slot_ids <= mc.max_boxes)
    valid = bbox_present & feat_nonzero & in_range[None, :]

    h_event = torch.zeros((s1, mc.event_layers, mc.h_dim), device=dev)
    h_coord = torch.zeros((s1, mc.coord_layers, mc.coord_dim), device=dev)
    seen = torch.zeros((s1,), dtype=torch.bool, device=dev)
    drop = mc.dropout if (training and generator is not None) else 0.0
    all_logits, losses = [], []
    for i in range(b):
        v = valid[i]
        # unseen tracks start from a zero hidden state (EventAD.py:292-296)
        h_in_e = torch.where(seen[:, None, None], h_event, 0.0)
        h_in_c = torch.where(seen[:, None, None], h_coord, 0.0)
        out_e, h_out_e = gru_step(head.gru_event, curr_feat[i], h_in_e,
                                  dropout=drop, generator=generator)
        out_c, h_out_c = gru_step(head.gru_coord, coords[i], h_in_c)
        logits = fusion_forward(head.fusion, out_e, out_c, dropout=drop,
                                generator=generator)
        ce = -F.log_softmax(logits, dim=-1).gather(
            1, labels[i][:, None].long())[:, 0]
        losses.append(torch.where(v, ce, 0.0).sum())
        att_e = spatial_attention(h_out_e, head.att_event_w, v)
        att_c = spatial_attention(h_out_c, head.att_coord_w, v)
        h_event = torch.where(v[:, None, None], att_e, h_event)
        h_coord = torch.where(v[:, None, None], att_c, h_coord)
        seen = seen | v
        all_logits.append(logits)
    return EventADOutputs(torch.stack(all_logits), valid, labels,
                          torch.stack(losses).sum(),
                          valid.sum().to(torch.int32))
