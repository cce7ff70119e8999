"""The DAGR detector: backbone + GNN/CNN hybrid head + decode + NMS
(counterpart of ``eventad_tpu/models/detector.py``; reference
``DAGR.forward``, dagr.py:73-106, with ``postprocess_network_output`` and
the hybrid fusion of dagr.py:247-262).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import Config
from ..ops.spline_conv import cartesian_attr
from ..utils.spans import span
from .backbone import BackboneConfig, backbone_forward, make_backbone_config
from .dagr import (DAGR, build_level0_graph, graph_static_config,
                   resolve_device)
from .resnet import cnn_branch_forward
from .yolox_head import (GNNHead, cnn_head_forward, decode_outputs,
                         gnn_head_scale_forward, postprocess)

CNN_OUTPUT_CHANNELS = (256, 256)   # the two maps that feed the CNN head
NUM_CLASSES = 2


class Detector(nn.Module):
    def __init__(self, cfg: Config, bc: BackboneConfig,
                 generator: torch.Generator = None):
        super().__init__()
        self.dagr = DAGR(cfg, bc, generator,
                         output_channels=CNN_OUTPUT_CHANNELS)
        self.head = GNNHead(bc, num_classes=NUM_CLASSES,
                            num_scales=cfg.num_scales,
                            cnn_in_channels=CNN_OUTPUT_CHANNELS,
                            yolo_stem_width=cfg.yolo_stem_width,
                            use_image=cfg.use_image, generator=generator)


def init_detector(cfg: Config, generator: torch.Generator = None,
                  device=None) -> Tuple[Detector, BackboneConfig]:
    """Randomly initialised detector at ``cfg``'s widths (initialised on the
    CPU from ``generator``, then moved to ``device``: the CUDA card unless
    the caller names the CPU), in eval mode."""
    device = resolve_device(device)
    bc = make_backbone_config(cfg)
    return Detector(cfg, bc, generator).to(device).eval(), bc


def head_geometry(bc: BackboneConfig):
    """The head's two scales: grids ``(nx, ny)``, sizes ``(ny, nx)`` and
    strides in pixels."""
    grids = (bc.grids[2], bc.grids[3])
    out_sizes = [(g[1], g[0]) for g in grids]
    strides = [int(round(bc.height / g[1])) for g in grids]
    return grids, out_sizes, strides


def gnn_head_maps(detector: Detector, outs, cnn_maps, bc: BackboneConfig, *,
                  training: bool = False, no_events: bool = False):
    """The GNN head on the backbone's output graphs ``outs``, per scale
    ``(reg [B, 4, ny, nx], obj [B, 1, ny, nx], cls [B, C, ny, nx])``
    logits, plus the CNN head's maps ``cnn_maps`` (unless None), the hybrid
    fusion of dagr.py:247-262; with ``no_events`` those stand alone."""
    grids, _, _ = head_geometry(bc)
    maps = []
    for i, (g, head) in enumerate(zip(outs, detector.head.scales)):
        cart_max = bc.cart_max[3 + i]
        attr = cartesian_attr(g.pos, g.nbr, g.nbr_mask, cart_max, clamp=True)
        cls_o, reg_o, obj_o = gnn_head_scale_forward(
            head, g, attr, grids[i], bc, training, cart_max=cart_max)
        if cnn_maps is not None:
            cnn = [cnn_maps[k][i]
                   for k in ("cls_output", "reg_output", "obj_output")]
            if no_events:
                cls_o, reg_o, obj_o = cnn
            else:
                cls_o, reg_o, obj_o = (cls_o + cnn[0], reg_o + cnn[1],
                                       obj_o + cnn[2])
        maps.append((reg_o, obj_o, cls_o))
    return maps


def detector_maps(detector: Detector, batch, cfg: Config,
                  bc: BackboneConfig, *, training: bool = False,
                  no_events: bool = False):
    """The head's maps before decoding (see :func:`gnn_head_maps`) and the
    strides for one batch: level-0 graph, CNN branch, backbone, CNN head,
    GNN head."""
    g0 = build_level0_graph(batch.pos, batch.polarity, batch.valid,
                            graph_static_config(cfg), batch.rank)
    _, out_sizes, strides = head_geometry(bc)
    image_feats = cnn_maps = None
    if bc.use_image:
        # the ResNet always runs on its running statistics; the CNN head's
        # logits enter the sum detached
        image_feats, image_outs = cnn_branch_forward(
            detector.dagr.cnn, batch.image, bc.compute_dtype, outputs=True)
        cnn_maps = {k: [m.detach() for m in v] for k, v in cnn_head_forward(
            detector.head.cnn, image_outs, out_sizes,
            training=training).items()}
    outs = backbone_forward(detector.dagr.backbone, g0, image_feats, bc,
                            training=training)
    return gnn_head_maps(detector, outs, cnn_maps, bc, training=training,
                         no_events=no_events), strides


def decode_maps(maps, strides) -> torch.Tensor:
    """``decoded [B, A, 5 + C]`` f32 of the head's maps: sigmoid on
    objectness and classes, boxes decoded to pixels."""
    return decode_outputs(
        [torch.cat([reg_o, torch.sigmoid(obj_o), torch.sigmoid(cls_o)],
                   dim=1) for reg_o, obj_o, cls_o in maps], strides)


def decode_detections(maps, strides, bc: BackboneConfig):
    """``(detections, decoded)`` of the head's maps: :func:`decode_maps`,
    then class-offset NMS (spans ``detect/decode``, ``detect/nms``)."""
    with span("detect/decode"):
        decoded = decode_maps(maps, strides)
    with span("detect/nms"):
        detections = postprocess(decoded, num_classes=NUM_CLASSES,
                                 conf_threshold=0.001, nms_threshold=0.65,
                                 width=bc.width, height=bc.height)
    return detections, decoded


def detector_forward(detector: Detector, batch, cfg: Config,
                     bc: BackboneConfig, *, training: bool = False,
                     no_events: bool = False):
    """The detection forward.  Returns ``(detections, decoded)``: a dict of
    fixed-shape tensors (``boxes [B, 64, 4]`` xyxy pixels, ``scores``,
    ``labels``, ``mask``) and the raw decoded outputs ``[B, A, 5 + C]``.
    ``training`` normalises by batch statistics in the backbone's layers
    and both heads (running statistics updated in place) and keeps the
    eval-path decode; a training step takes :func:`detector_decoded`,
    which runs no NMS."""
    with torch.set_grad_enabled(training and torch.is_grad_enabled()):
        maps, strides = detector_maps(detector, batch, cfg, bc,
                                      training=training, no_events=no_events)
        return decode_detections(maps, strides, bc)


def detector_decoded(detector: Detector, batch, cfg: Config,
                     bc: BackboneConfig, *, training: bool = True,
                     no_events: bool = False) -> torch.Tensor:
    """The decoded outputs ``[B, A, 5 + C]`` of one batch without the
    detections: what a training step reads (the JAX package's step computes
    the detections and drops them unused).  With ``training`` (the default)
    the BN running statistics move once and the graph records gradients
    into every parameter: the ResNet's too, whose BN stays in eval mode;
    the CNN head's maps enter detached (the hybrid fusion), so its
    parameters and the ResNet's two output remaps get none."""
    with torch.set_grad_enabled(training and torch.is_grad_enabled()):
        maps, strides = detector_maps(detector, batch, cfg, bc,
                                      training=training, no_events=no_events)
        return decode_maps(maps, strides)
