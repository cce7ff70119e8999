"""Streaming detection read-out from the incremental level-0 caches
(counterpart of ``eventad_tpu/streaming/detect.py``; the reference's
asynchronous runtime wraps every layer of the detector, its GNN head
included, asynchronous/__init__.py:41-110).

The event-rate ``append`` is the anomaly model's (the same frozen backbone,
level-0 outputs cached per event); ``read_detections`` re-pools the buffer,
runs the pooled levels, the GNN head, the hybrid CNN fusion, the decode and
the NMS; the detection step is one ``append`` and one ``read_detections``.
With bf16 features on the card (eval, ``fused_shift`` on:
``models/backbone.frozen_route``) the GNN head runs as ten K3 launches a
read, five a scale, beside the pooled levels' eight.
The per-frame CNN work (ResNet pyramid and the CNN head's logit maps, which
depend on the image only) runs once per frame in ``update_image_detector``
and is cached in the state.

Spans (``utils/spans``): ``stream/step`` around ``stream/append`` and
``stream/read_detections`` (``stream/levels``, ``detect/gnn_head``, then
``detect/decode`` and ``detect/nms`` from ``models/detector``);
``stream/update_image_detector`` on its own.
"""
from __future__ import annotations

import torch

from ..models.backbone import BackboneConfig
from ..models.detector import (Detector, decode_detections, gnn_head_maps,
                               head_geometry)
from ..models.resnet import cnn_branch_forward
from ..models.yolox_head import cnn_head_forward
from ..utils.spans import span
from .incremental import (IncrementalState, make_incremental_step, norm_pos,
                          pooled_backbone_outs, upsampled_pyramid)


@torch.no_grad()
def update_image_detector(detector: Detector, state: IncrementalState,
                          image: torch.Tensor,
                          bc: BackboneConfig) -> IncrementalState:
    """New frame ``image [H, W, 3]``: the cached CNN pyramid (f32, for the
    backbone's lookups at node positions) and the CNN head's logit maps
    (hybrid fusion); call ``refresh`` after it."""
    with span("stream/update_image_detector"):
        feats, image_outs = cnn_branch_forward(detector.dagr.cnn,
                                               image[None], outputs=True)
        _, out_sizes, _ = head_geometry(bc)
        cnn_maps = cnn_head_forward(detector.head.cnn, image_outs,
                                    out_sizes)
        return state._replace(
            image_feats=upsampled_pyramid(feats, bc.width, bc.height),
            cnn_maps=cnn_maps)


def make_incremental_detector(detector: Detector, bc: BackboneConfig,
                              gsc: tuple, *, n_chunk: int, n_buf: int):
    """Returns ``(refresh, step)`` for one stream (``bc.batch_size`` 1).
    ``refresh`` is the incremental level-0 machinery's, without an anomaly
    head.  ``step(state, new_pos [n_chunk, 3], new_pol [n_chunk], n_new)``
    appends a chunk and reads the detections: ``(state, (detections,
    decoded))``.  Besides, ``step.append(state, new_pos, new_pol, n_new)``
    ingests a chunk only, and ``step.read_detections(state)`` gives
    ``(detections, decoded)`` as the batch ``detector_forward`` does on the
    same event window."""
    refresh, inc_step = make_incremental_step(detector, bc, None, gsc,
                                              n_chunk=n_chunk, n_buf=n_buf)
    append = inc_step.append
    _, _, strides = head_geometry(bc)

    @torch.no_grad()
    def read_detections(state: IncrementalState):
        with span("stream/read_detections"):
            posn = norm_pos(state.pos, state.t_now, gsc)
            with span("stream/levels"):
                outs = pooled_backbone_outs(detector, bc, state, posn, gsc)
            with span("detect/gnn_head"):
                maps = gnn_head_maps(detector, outs, state.cnn_maps, bc)
            return decode_detections(maps, strides, bc)

    def step(state: IncrementalState, new_pos, new_pol, n_new):
        with span("stream/step"):
            state = append(state, new_pos, new_pol, n_new)
            return state, read_detections(state)

    step.append = append
    step.read_detections = read_detections
    return refresh, step
