"""DAGR feature path + the EventAD anomaly head: the batched scoring forward
(counterpart of ``eventad_tpu/models/dagr.py``; reference dagr.py:14-130,
EventAD.py:141).

``model_forward`` runs graph construction, the CNN pyramid, the GNN
pyramid, box-feature pooling and the recurrent head on one batch.  DAGR is
frozen and always runs in eval mode without gradients (EventAD.py:149-150,
357-360); only the head trains.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import Config
from ..data.batching import EventBatch
from ..ops.event_graph import build_graph_auto
from ..utils.spans import span
from ..utils.tensors import constant
from .backbone import (Backbone, BackboneConfig, backbone_forward,
                       make_backbone_config)
from .eventad import (EventADConfig, EventADHead, EventADOutputs,
                      eventad_forward)
from .feature_extract import extract_box_features
from .graph import Graph
from .resnet import CNNBranch, cnn_branch_forward


class DAGR(nn.Module):
    """Backbone and CNN branch.  ``output_channels``: widths of the CNN
    branch's two output maps, which only the detector's head reads."""

    def __init__(self, cfg: Config, bc: BackboneConfig,
                 generator: torch.Generator = None, output_channels=()):
        super().__init__()
        self.backbone = Backbone(bc, generator)
        self.cnn = (CNNBranch(cfg.img_net, list(cfg.channels()[1:]),
                              generator, output_channels=output_channels)
                    if cfg.use_image else None)
        self.img_net = cfg.img_net


class EventADModel(nn.Module):
    def __init__(self, dagr: DAGR, head: EventADHead):
        super().__init__()
        self.dagr = dagr
        self.head = head


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another (``"cpu"``).  Never a silent choice: without a card,
    ``device=None`` raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")


def init_model(cfg: Config, generator: torch.Generator = None,
               device=None) -> Tuple[EventADModel, BackboneConfig,
                                     EventADConfig]:
    """Randomly initialised model at ``cfg``'s widths (initialised on the
    CPU from ``generator``, then moved to ``device``: the CUDA card unless
    the caller names the CPU), in eval mode."""
    device = resolve_device(device)
    bc = make_backbone_config(cfg)
    mc = EventADConfig(x_dim=cfg.x_dim, h_dim=cfg.h_dim,
                       max_boxes=cfg.max_boxes)
    model = EventADModel(DAGR(cfg, bc, generator),
                         EventADHead(mc, generator))
    model.dagr.requires_grad_(False)
    return model.to(device).eval(), bc, mc


def graph_static_config(cfg: Config) -> tuple:
    return (cfg.radius_px, cfg.delta_t_us, cfg.max_neighbors,
            cfg.max_queue_size, cfg.graph_lookback, cfg.model_width,
            cfg.model_height, cfg.time_window_us)


def build_level0_graph(pos: torch.Tensor, polarity: torch.Tensor,
                       valid: torch.Tensor, gsc: tuple,
                       ranks: torch.Tensor = None) -> Graph:
    """Level-0 event graph over the flattened ``B * N`` event table.
    ``gsc`` = (radius_px, delta_t_us, max_neighbors, max_queue_size,
    lookback, width, height, time_window)."""
    (radius_px, delta_t_us, max_nb, max_q, lookback, width, height,
     time_window) = gsc
    b, n, _ = pos.shape
    nbr, nbrm, doff = build_graph_auto(
        pos, valid, ranks, radius=radius_px, delta_t_us=delta_t_us,
        max_neighbors=max_nb, max_queue_size=max_q,
        lookback=min(lookback, n))
    dev = pos.device
    off = (torch.arange(b, dtype=torch.int32, device=dev) * n)[:, None, None]
    nbr_f = (nbr + off).reshape(b * n, -1)
    denom = constant((width, height, time_window), torch.float32, dev)
    posn = (pos.to(torch.float32) / denom).reshape(b * n, 3)
    vm = valid.reshape(b * n)
    pol = torch.where(vm[:, None], polarity.reshape(b * n, 1), 0.0)
    batch_ids = torch.arange(b, dtype=torch.int32,
                             device=dev).repeat_interleave(n)
    return Graph(pol, posn, nbr_f, nbrm.reshape(b * n, -1), vm, batch_ids,
                 doff.reshape(b * n, -1, 2))


def dagr_extract_features(dagr: DAGR, pos, polarity, valid, image,
                          bc: BackboneConfig, gsc: tuple, *, ranks=None):
    """Frozen-DAGR feature path (reference dagr.py:108-130): returns the
    (out3, out4) graphs."""
    with span("model/graph"):
        g0 = build_level0_graph(pos, polarity, valid, gsc, ranks)
    feats = None
    if bc.use_image:
        with span("model/cnn"):
            feats = cnn_branch_forward(dagr.cnn, image, bc.compute_dtype)
    with span("model/backbone"):
        return backbone_forward(dagr.backbone, g0, feats, bc)


def box_inputs(dagr: DAGR, batch: EventBatch, bc: BackboneConfig,
               gsc: tuple):
    """The head's inputs from the frozen feature path, without gradients:
    ``(feats [B, 2, S, C] f32, coords [B, S, 4])``, the box features of
    both frames and the current frame's boxes normalised by the image
    size."""
    with torch.no_grad():
        _, out4 = dagr_extract_features(
            dagr, batch.pos, batch.polarity, batch.valid, batch.image, bc,
            gsc, ranks=batch.rank)
        with span("model/box_features"):
            feats = extract_box_features(out4, batch.boxes,
                                         batch.box_present, bc.batch_size,
                                         bc.width, bc.height)
        denom = constant((bc.width, bc.height, bc.width, bc.height),
                         torch.float32, feats.device)
        return feats.to(torch.float32), batch.boxes[:, 1] / denom


def model_forward(model: EventADModel, batch: EventBatch, bc: BackboneConfig,
                  mc: EventADConfig, gsc: tuple, *, training: bool = False,
                  generator: torch.Generator = None) -> EventADOutputs:
    """One batch through the whole pipeline.  The DAGR feature path never
    records gradients; the recurrent head always runs f32 (bf16 is only the
    frozen feature path's compute dtype) and records them when
    ``training``.  ``generator`` seeds the head's dropout (off without
    one).  Spans (``utils/spans``): ``model/forward``, around ``model/graph``,
    ``model/cnn``, ``model/backbone`` (its levels inside),
    ``model/box_features`` and ``model/head``."""
    with span("model/forward"):
        feats, coords = box_inputs(model.dagr, batch, bc, gsc)
        with torch.set_grad_enabled(training), span("model/head"):
            return eventad_forward(model.head, mc, feats, coords,
                                   batch.box_present[:, 1],
                                   batch.box_labels, training=training,
                                   generator=generator)
