"""The weight bridge: fills the port's modules from reference-format state
dicts of numpy arrays (or tensors) — the dicts ``eventad_tpu/models/
convert.py`` writes (``export_backbone``, ``export_cnn_branch``,
``export_eventad_head``) and the reference's torch checkpoints hold — and
writes them back (``export_reference_state``), so one checkpoint format
serves both packages.  ``load_detector_state`` fills the port's detector
from the reference package's detector parameters and state, handed over as
nested containers of numpy arrays, and ``export_detector_state`` /
``export_detector_grads`` give the detector's parameters, running
statistics and gradients back in that layout.  ``load_torch_state_dict``,
``convert_full_model`` and ``export_torch_checkpoints`` read and write the
reference's ``.pth`` files (``parity``).

Layouts: torch conv weights OIHW (kept as they are); torch Linear ``[O, I]``
-> ``[I, O]``; GRU ``[3H, In]`` -> ``[In, 3H]``; spline kernels
``[K^2, Cin, Cout]`` copied verbatim.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Mapping

import numpy as np
import torch

from ..ops.norm import BatchNorm
from .dagr import EventADModel, init_model
from .gru import GRU

_LAYER_NAMES = ("conv_block1", "layer2", "layer3", "layer4", "layer5")


def _copy(dst: torch.Tensor, src, name: str, transpose: bool = False):
    a = src if isinstance(src, torch.Tensor) else torch.tensor(
        np.asarray(src))
    if transpose:
        a = a.T
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(a)


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
    for key, ws, bs in (("feature_dconv", cnn.feature_w, cnn.feature_b),
                        ("output_dconv", cnn.output_w, cnn.output_b)):
        for i, (w, b) in enumerate(zip(ws, bs)):
            _copy(w, sd[f"{prefix}{key}.{i}.weight"], key)
            _copy(b, sd[f"{prefix}{key}.{i}.bias"], key)


def _load_gru(gru: GRU, sd: Mapping, prefix: str):
    for i, p in enumerate(gru.layers):
        _copy(p.w_ih, sd[f"{prefix}.weight_ih_l{i}"], prefix, transpose=True)
        _copy(p.w_hh, sd[f"{prefix}.weight_hh_l{i}"], prefix, transpose=True)
        _copy(p.b_ih, sd[f"{prefix}.bias_ih_l{i}"], prefix)
        _copy(p.b_hh, sd[f"{prefix}.bias_hh_l{i}"], prefix)


_FUSION_KEYS = (("event_proj", "event_proj"), ("coord_proj", "coord_proj"),
                ("fuse1", "fusion.0"), ("fuse2", "fusion.3"))


def _load_head(head, sd: Mapping):
    f = head.fusion
    for attr, key in _FUSION_KEYS:
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


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict as numpy arrays, unwrapped as the
    JAX package unwraps it: ``["ema"]``, then ``["model"]``, then
    ``.state_dict()`` (reference utils/model.py:31-32)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "ema" in obj:
        obj = obj["ema"]
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def convert_full_model(cfg, dagr_path: str, eventad_path: str = None,
                       device=None):
    """``(model, bc, mc)`` from the reference's torch checkpoints:
    ``dagr_s_50.pth`` (backbone, and the CNN branch when ``cfg.use_image``)
    and optionally ``best_rol.pth`` (the trained EventAD head, reference
    utils/model.py:80-90; its ``module.`` prefixes stripped and its
    ``dagr_model.`` keys dropped).  Without ``eventad_path`` the head stays
    randomly initialised (from seed 0).  On ``device`` (the CUDA card
    unless the caller names the CPU)."""
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), device)
    head_sd = None
    if eventad_path:
        head_sd = {k.removeprefix("module."): v for k, v in
                   load_torch_state_dict(eventad_path).items()
                   if not k.startswith(("dagr_model.",
                                        "module.dagr_model."))}
    load_reference_state(model, load_torch_state_dict(dagr_path), head_sd)
    return model, bc, mc


# ---------------------------------------------------------------------------
# the inverse: the port's modules -> reference-format state dicts
# ---------------------------------------------------------------------------
def _np(t: torch.Tensor, transpose: bool = False) -> np.ndarray:
    # a copy: a CPU tensor's numpy() shares its storage
    a = t.detach().cpu().numpy()
    return np.array(a.T if transpose else a, order="C", copy=True)


def _export_bn(out: dict, bn: BatchNorm, key: str):
    out[f"{key}.weight"] = _np(bn.scale)
    out[f"{key}.bias"] = _np(bn.offset)
    out[f"{key}.running_mean"] = _np(bn.mean)
    out[f"{key}.running_var"] = _np(bn.var)


def _export_backbone(out: dict, backbone, prefix: str = "backbone."):
    for nm, layer in zip(_LAYER_NAMES, backbone.layers):
        base = f"{prefix}{nm}"
        for bi, blk in ((1, layer.block1), (2, layer.block2)):
            cb = f"{base}.conv_block{bi}"
            out[f"{cb}.conv.weight"] = _np(blk.conv.weight)
            out[f"{cb}.conv.lin.weight"] = _np(blk.conv.root, True)
            _export_bn(out, blk.bn, f"{cb}.norm.module")
        out[f"{base}.conv_block2.lin.mlp.weight"] = _np(layer.skip_lin, True)
        out[f"{base}.conv_block2.lin.mlp.bias"] = _np(layer.skip_lin_bias)
        _export_bn(out, layer.skip_bn, f"{base}.conv_block2.norm_skip.module")


def _export_cnn(out: dict, cnn, prefix: str = "backbone.net."):
    r = prefix + "module."
    out[r + "conv1.weight"] = _np(cnn.conv1)
    _export_bn(out, cnn.bn1, r + "bn1")
    for li, layer in enumerate(cnn.layers, start=1):
        for bi, blk in enumerate(layer):
            base = f"{r}layer{li}.{bi}"
            for ci, (w, bn) in enumerate(zip(blk.convs, blk.bns), start=1):
                out[f"{base}.conv{ci}.weight"] = _np(w)
                _export_bn(out, bn, f"{base}.bn{ci}")
            if blk.down is not None:
                out[f"{base}.downsample.0.weight"] = _np(blk.down)
                _export_bn(out, blk.down_bn, f"{base}.downsample.1")
    for i, (w, b) in enumerate(zip(cnn.feature_w, cnn.feature_b)):
        out[f"{prefix}feature_dconv.{i}.weight"] = _np(w)
        out[f"{prefix}feature_dconv.{i}.bias"] = _np(b)


def _export_head(out: dict, head):
    f = head.fusion
    for attr, key in _FUSION_KEYS:
        out[f"fusion_module.{key}.weight"] = _np(getattr(f, attr + "_w"),
                                                 True)
        out[f"fusion_module.{key}.bias"] = _np(getattr(f, attr + "_b"))
    out["soft_attention.weight"] = _np(head.att_event_w)
    out["soft_attention_cor.weight"] = _np(head.att_coord_w)
    for gru, prefix in ((head.gru_event, "gru_net_event.gru"),
                        (head.gru_coord, "gru_net_cor.gru")):
        for i, p in enumerate(gru.layers):
            out[f"{prefix}.weight_ih_l{i}"] = _np(p.w_ih, True)
            out[f"{prefix}.weight_hh_l{i}"] = _np(p.w_hh, True)
            out[f"{prefix}.bias_ih_l{i}"] = _np(p.b_ih)
            out[f"{prefix}.bias_hh_l{i}"] = _np(p.b_hh)


DAGR_PREFIX = "dagr_model."


def export_reference_state(model: EventADModel) -> Dict[str, np.ndarray]:
    """The inverse of :func:`load_reference_state`: one dict of numpy arrays
    in the key layout of the reference's ``EventADModel`` state dict — the
    head's keys flat, the frozen DAGR's under ``dagr_model.``.
    :func:`split_reference_state` gives the two dicts back."""
    dagr: Dict[str, np.ndarray] = {}
    _export_backbone(dagr, model.dagr.backbone)
    if model.dagr.cnn is not None:
        _export_cnn(dagr, model.dagr.cnn)
    out = {DAGR_PREFIX + k: v for k, v in dagr.items()}
    _export_head(out, model.head)
    return out


def export_torch_checkpoints(model: EventADModel, dagr_path: str,
                             eventad_path: str):
    """Writes reference-format torch files from ``model``: the DAGR state
    under ``["ema"]``, the EventAD head's under ``["model"]`` (the files
    ``convert_full_model`` reads back)."""
    dagr, head = split_reference_state(export_reference_state(model))

    def tensors(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}
    torch.save({"ema": tensors(dagr)}, dagr_path)
    torch.save({"model": tensors(head)}, eventad_path)


def split_reference_state(sd: Mapping):
    """``(dagr_sd, head_sd)`` of an :func:`export_reference_state` dict."""
    n = len(DAGR_PREFIX)
    dagr = {k[n:]: v for k, v in sd.items() if k.startswith(DAGR_PREFIX)}
    head = {k: v for k, v in sd.items() if not k.startswith(DAGR_PREFIX)}
    return dagr, head


# ---------------------------------------------------------------------------
# the detector: nested containers of numpy arrays -> the port's modules
# ---------------------------------------------------------------------------
def _field(obj, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _fill_bn(bn: BatchNorm, p, s, name: str):
    _copy(bn.scale, _field(p, "scale"), name)
    _copy(bn.offset, _field(p, "offset"), name)
    _copy(bn.mean, _field(s, "mean"), name)
    _copy(bn.var, _field(s, "var"), name)


def _fill_spline(conv, p, name: str):
    _copy(conv.weight, p.weight, name)
    _copy(conv.root, p.root, name)
    if (conv.bias is None) != (p.bias is None):
        raise ValueError(f"{name}: bias on one side only")
    if conv.bias is not None:
        _copy(conv.bias, p.bias, name)


def _fill_conv_block(blk, p, s, name: str):
    _fill_spline(blk.conv, p.conv, name)
    _fill_bn(blk.bn, p.bn, s.bn, name)


def _oihw(w) -> np.ndarray:
    """A conv kernel in HWIO layout as the port's OIHW."""
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _dagr_reference_state(params, state) -> Dict[str, np.ndarray]:
    """The DAGR part (``DAGRParams`` / ``DAGRState`` as nested containers
    of numpy arrays) as a reference-format state dict, the keys
    :func:`_load_backbone` and :func:`_load_cnn` read."""
    sd: Dict[str, np.ndarray] = {}

    def bn(key, p, s):
        sd[f"{key}.weight"] = _field(p, "scale")
        sd[f"{key}.bias"] = _field(p, "offset")
        sd[f"{key}.running_mean"] = _field(s, "mean")
        sd[f"{key}.running_var"] = _field(s, "var")

    for nm, lp, ls in zip(_LAYER_NAMES, params.backbone.layers,
                          state.backbone.layers):
        base = f"backbone.{nm}"
        for bi, bp, bs in ((1, lp.block1, ls.block1),
                           (2, lp.block2, ls.block2)):
            cb = f"{base}.conv_block{bi}"
            sd[f"{cb}.conv.weight"] = bp.conv.weight
            sd[f"{cb}.conv.lin.weight"] = np.asarray(bp.conv.root).T
            bn(f"{cb}.norm.module", bp.bn, bs.bn)
        sd[f"{base}.conv_block2.lin.mlp.weight"] = np.asarray(lp.skip_lin).T
        sd[f"{base}.conv_block2.lin.mlp.bias"] = lp.skip_lin_bias
        bn(f"{base}.conv_block2.norm_skip.module", lp.skip_bn, ls.skip_bn)
    if params.cnn is None:
        return sd
    net = "backbone.net."
    r = net + "module."
    rp, rs = params.cnn["resnet"], state.cnn
    sd[r + "conv1.weight"] = _oihw(rp["conv1"])
    bn(r + "bn1", rp["bn1"], rs["bn1"])
    for li in range(1, 5):
        for bi, (bp, bs) in enumerate(zip(rp[f"layer{li}"],
                                          rs[f"layer{li}"])):
            base = f"{r}layer{li}.{bi}"
            for ci in (1, 2, 3):
                if f"c{ci}" in bp:
                    sd[f"{base}.conv{ci}.weight"] = _oihw(bp[f"c{ci}"])
                    bn(f"{base}.bn{ci}", bp[f"b{ci}"], bs[f"b{ci}"])
            if "down" in bp:
                sd[f"{base}.downsample.0.weight"] = _oihw(bp["down"])
                bn(f"{base}.downsample.1", bp["down_bn"], bs["down_bn"])
    for key in ("feature_dconv", "output_dconv"):
        for i, d in enumerate(params.cnn[key]):
            sd[f"{net}{key}.{i}.weight"] = _oihw(d["w"])
            sd[f"{net}{key}.{i}.bias"] = d["b"]
    return sd


def load_detector_state(detector, params, state):
    """Fills the port's ``Detector`` in place from the reference package's
    ``DetectorParams`` / ``DetectorState``, given as the same nested
    containers (named tuples, dicts, lists) with numpy arrays as leaves, so
    that both compute the same function.  The DAGR part goes through the
    reference-format key map that :func:`load_reference_state` reads; the
    head, which has no such map yet, is filled directly.  Returns the
    detector."""
    sd = _dagr_reference_state(params.dagr, state.dagr)
    _load_backbone(detector.dagr.backbone, sd)
    if detector.dagr.cnn is not None:
        _load_cnn(detector.dagr.cnn, sd)
    head = detector.head
    for i, (sc, sp, ss) in enumerate(zip(head.scales, params.head.scales,
                                         state.head.scales)):
        name = f"head.scales[{i}]"
        for blk in ("stem", "cls_conv", "reg_conv"):
            _fill_conv_block(getattr(sc, blk), getattr(sp, blk),
                             getattr(ss, blk), name)
        for conv in ("cls_pred", "reg_pred", "obj_pred"):
            _fill_spline(getattr(sc, conv), getattr(sp, conv), name)
    if head.cnn is not None:
        for i, (sc, sp, ss) in enumerate(zip(
                head.cnn.scales, params.head.cnn["scales"],
                state.head.cnn["scales"])):
            name = f"head.cnn.scales[{i}]"
            for blk in ("stem", "cls1", "cls2", "reg1", "reg2"):
                m = getattr(sc, blk)
                _copy(m.weight, _oihw(sp[blk]["w"]), name)
                _fill_bn(m.bn, sp[blk]["bn"], ss[blk]["bn"], name)
            for conv in ("cls_pred", "reg_pred", "obj_pred"):
                m = getattr(sc, conv)
                _copy(m.weight, _oihw(sp[conv]["w"]), name)
                _copy(m.bias, sp[conv]["b"], name)
    return detector


# ---------------------------------------------------------------------------
# the inverse for the detector: the port's modules -> the reference
# package's DetectorParams / DetectorState layout
# ---------------------------------------------------------------------------
def _hwio(w: np.ndarray) -> np.ndarray:
    """A conv kernel in the port's OIHW layout as HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _detector_tree(detector, param, buffer):
    """``(params, state)`` of ``detector`` in the reference package's
    layout: its named tuples as ``SimpleNamespace``s (the same field
    names), its dicts as dicts, its tuples and lists as lists; the leaves
    ``param(p)`` of every parameter, ``buffer(b)`` of every running
    statistic.  Conv kernels of the image branch and the CNN head go from
    OIHW to HWIO; spline kernels, roots and linear maps are verbatim."""
    ns = SimpleNamespace

    def bn_p(bn):
        return ns(scale=param(bn.scale), offset=param(bn.offset))

    def bn_s(bn):
        return ns(mean=buffer(bn.mean), var=buffer(bn.var))

    def bn_pd(bn):
        return {"scale": param(bn.scale), "offset": param(bn.offset)}

    def bn_sd(bn):
        return {"mean": buffer(bn.mean), "var": buffer(bn.var)}

    def spline(conv):
        return ns(weight=param(conv.weight), root=param(conv.root),
                  bias=None if conv.bias is None else param(conv.bias))

    def conv_w(w):
        return _hwio(param(w))

    layers_p, layers_s = [], []
    for layer in detector.dagr.backbone.layers:
        b1, b2 = layer.block1, layer.block2
        layers_p.append(ns(
            block1=ns(conv=spline(b1.conv), bn=bn_p(b1.bn)),
            block2=ns(conv=spline(b2.conv), bn=bn_p(b2.bn)),
            skip_lin=param(layer.skip_lin),
            skip_lin_bias=param(layer.skip_lin_bias),
            skip_bn=bn_p(layer.skip_bn)))
        layers_s.append(ns(block1=ns(bn=bn_s(b1.bn)),
                           block2=ns(bn=bn_s(b2.bn)),
                           skip_bn=bn_s(layer.skip_bn)))
    cnn_p = cnn_s = None
    cnn = detector.dagr.cnn
    if cnn is not None:
        resnet = {"conv1": conv_w(cnn.conv1), "bn1": bn_pd(cnn.bn1)}
        cnn_s = {"bn1": bn_sd(cnn.bn1)}
        for li, layer in enumerate(cnn.layers, start=1):
            blocks_p, blocks_s = [], []
            for blk in layer:
                bp, bs = {}, {}
                for ci, (w, bn) in enumerate(zip(blk.convs, blk.bns),
                                             start=1):
                    bp[f"c{ci}"] = conv_w(w)
                    bp[f"b{ci}"] = bn_pd(bn)
                    bs[f"b{ci}"] = bn_sd(bn)
                if blk.down is not None:
                    bp["down"] = conv_w(blk.down)
                    bp["down_bn"] = bn_pd(blk.down_bn)
                    bs["down_bn"] = bn_sd(blk.down_bn)
                blocks_p.append(bp)
                blocks_s.append(bs)
            resnet[f"layer{li}"] = blocks_p
            cnn_s[f"layer{li}"] = blocks_s
        cnn_p = {"resnet": resnet}
        for key, ws, bs in (("feature_dconv", cnn.feature_w, cnn.feature_b),
                            ("output_dconv", cnn.output_w, cnn.output_b)):
            cnn_p[key] = [{"w": conv_w(w), "b": param(b)}
                          for w, b in zip(ws, bs)]

    head = detector.head
    scales_p, scales_s = [], []
    for sc in head.scales:
        blocks = ("stem", "cls_conv", "reg_conv")
        scales_p.append(ns(
            **{k: ns(conv=spline(getattr(sc, k).conv),
                     bn=bn_p(getattr(sc, k).bn)) for k in blocks},
            **{k: spline(getattr(sc, k))
               for k in ("cls_pred", "reg_pred", "obj_pred")}))
        scales_s.append(ns(**{k: ns(bn=bn_s(getattr(sc, k).bn))
                              for k in blocks}))
    hcnn_p = hcnn_s = None
    if head.cnn is not None:
        hcnn_p, hcnn_s = {"scales": []}, {"scales": []}
        for sc in head.cnn.scales:
            blocks = ("stem", "cls1", "cls2", "reg1", "reg2")
            hcnn_p["scales"].append({
                **{k: {"w": conv_w(getattr(sc, k).weight),
                       "bn": bn_pd(getattr(sc, k).bn)} for k in blocks},
                **{k: {"w": conv_w(getattr(sc, k).weight),
                       "b": param(getattr(sc, k).bias)}
                   for k in ("cls_pred", "reg_pred", "obj_pred")}})
            hcnn_s["scales"].append({k: {"bn": bn_sd(getattr(sc, k).bn)}
                                     for k in blocks})
    params = ns(dagr=ns(backbone=ns(layers=layers_p), cnn=cnn_p),
                head=ns(scales=scales_p, cnn=hcnn_p))
    state = ns(dagr=ns(backbone=ns(layers=layers_s), cnn=cnn_s),
               head=ns(scales=scales_s, cnn=hcnn_s))
    return params, state


def export_detector_state(detector):
    """The inverse of :func:`load_detector_state`: ``(params, state)`` of
    the port's ``Detector`` as the reference package's
    ``DetectorParams`` / ``DetectorState`` (named tuples as
    ``SimpleNamespace``s with the same fields, dicts as dicts, sequences as
    lists, numpy arrays as leaves), which :func:`load_detector_state` reads
    back."""
    return _detector_tree(detector, _np, _np)


def export_detector_grads(detector):
    """The gradients in ``p.grad`` (zeros where a parameter has none) in
    the layout of :func:`export_detector_state`'s ``params``."""
    def grad(p):
        return _np(p.grad) if p.grad is not None else np.zeros(
            tuple(p.shape), np.float32)
    return _detector_tree(detector, grad, lambda b: None)[0]
