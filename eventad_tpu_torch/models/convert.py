"""The weight bridge: fills the port's modules from reference-format state
dicts of numpy arrays — the dicts ``eventad_tpu/models/convert.py`` writes
(``export_backbone``, ``export_cnn_branch``, ``export_eventad_head``) and
the reference's torch checkpoints hold, so one checkpoint format serves both
packages.

Layouts: torch conv weights OIHW (kept as they are); torch Linear ``[O, I]``
-> ``[I, O]``; GRU ``[3H, In]`` -> ``[In, 3H]``; spline kernels
``[K^2, Cin, Cout]`` copied verbatim.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..ops.norm import BatchNorm
from .dagr import EventADModel
from .gru import GRU

_LAYER_NAMES = ("conv_block1", "layer2", "layer3", "layer4", "layer5")


def _copy(dst: torch.Tensor, src, name: str, transpose: bool = False):
    a = np.asarray(src)
    if transpose:
        a = a.T
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {a.shape} != {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.tensor(a))


def _load_bn(bn: BatchNorm, sd: Mapping, prefix: str):
    # torch_geometric BatchNorm nests a torch BatchNorm1d at .module
    key = prefix if f"{prefix}.weight" in sd else f"{prefix}.module"
    _copy(bn.scale, sd[f"{key}.weight"], key)
    _copy(bn.offset, sd[f"{key}.bias"], key)
    _copy(bn.mean, sd[f"{key}.running_mean"], key)
    _copy(bn.var, sd[f"{key}.running_var"], key)


def _load_backbone(backbone, sd: Mapping, prefix: str = "backbone."):
    for nm, layer in zip(_LAYER_NAMES, backbone.layers):
        base = f"{prefix}{nm}"
        for bi, blk in ((1, layer.block1), (2, layer.block2)):
            cb = f"{base}.conv_block{bi}"
            _copy(blk.conv.weight, sd[f"{cb}.conv.weight"], cb)
            _copy(blk.conv.root, sd[f"{cb}.conv.lin.weight"], cb,
                  transpose=True)
            _load_bn(blk.bn, sd, f"{cb}.norm")
        _copy(layer.skip_lin, sd[f"{base}.conv_block2.lin.mlp.weight"], nm,
              transpose=True)
        _copy(layer.skip_lin_bias, sd.get(
            f"{base}.conv_block2.lin.mlp.bias",
            np.zeros(layer.skip_lin.shape[1], np.float32)), nm)
        _load_bn(layer.skip_bn, sd, f"{base}.conv_block2.norm_skip")


def _load_cnn(cnn, sd: Mapping, prefix: str = "backbone.net."):
    r = prefix + "module."
    _copy(cnn.conv1, sd[r + "conv1.weight"], "conv1")
    _load_bn(cnn.bn1, sd, r + "bn1")
    for li, layer in enumerate(cnn.layers, start=1):
        for bi, blk in enumerate(layer):
            base = f"{r}layer{li}.{bi}"
            for ci, (w, bn) in enumerate(zip(blk.convs, blk.bns), start=1):
                _copy(w, sd[f"{base}.conv{ci}.weight"], base)
                _load_bn(bn, sd, f"{base}.bn{ci}")
            if blk.down is not None:
                _copy(blk.down, sd[f"{base}.downsample.0.weight"], base)
                _load_bn(blk.down_bn, sd, f"{base}.downsample.1")
    for i, (w, b) in enumerate(zip(cnn.feature_w, cnn.feature_b)):
        _copy(w, sd[f"{prefix}feature_dconv.{i}.weight"], "feature_dconv")
        _copy(b, sd[f"{prefix}feature_dconv.{i}.bias"], "feature_dconv")


def _load_gru(gru: GRU, sd: Mapping, prefix: str):
    for i, p in enumerate(gru.layers):
        _copy(p.w_ih, sd[f"{prefix}.weight_ih_l{i}"], prefix, transpose=True)
        _copy(p.w_hh, sd[f"{prefix}.weight_hh_l{i}"], prefix, transpose=True)
        _copy(p.b_ih, sd[f"{prefix}.bias_ih_l{i}"], prefix)
        _copy(p.b_hh, sd[f"{prefix}.bias_hh_l{i}"], prefix)


def _load_head(head, sd: Mapping):
    f = head.fusion
    for attr, key in (("event_proj", "event_proj"),
                      ("coord_proj", "coord_proj"),
                      ("fuse1", "fusion.0"), ("fuse2", "fusion.3")):
        _copy(getattr(f, attr + "_w"), sd[f"fusion_module.{key}.weight"],
              key, transpose=True)
        _copy(getattr(f, attr + "_b"), sd[f"fusion_module.{key}.bias"], key)
    _copy(head.att_event_w, sd["soft_attention.weight"], "soft_attention")
    _copy(head.att_coord_w, sd["soft_attention_cor.weight"],
          "soft_attention_cor")
    _load_gru(head.gru_event, sd, "gru_net_event.gru")
    _load_gru(head.gru_coord, sd, "gru_net_cor.gru")


def load_reference_state(model: EventADModel,
                         dagr_sd: Dict[str, np.ndarray],
                         head_sd: Dict[str, np.ndarray] = None
                         ) -> EventADModel:
    """Fills ``model`` in place from a DAGR state dict (backbone, and the
    CNN branch when the model has one) and, if given, an EventAD head
    state dict.  Returns the model."""
    _load_backbone(model.dagr.backbone, dagr_sd)
    if model.dagr.cnn is not None:
        _load_cnn(model.dagr.cnn, dagr_sd)
    if head_sd is not None:
        _load_head(model.head, head_sd)
    return model
