"""Random weights of what the DAGR detector holds beyond EventAD's frozen
backbone, made on a device from a seed: the ResNet's two output remaps
(``output_dconv``, the maps of ``layer3`` and ``layer4`` that feed the CNN
head), the GNN head's scales and the CNN head's scales.  The shared
backbone keeps ``weights.make_state``'s reference-format dict.

The head's keys follow the layout of the reference package's
``DetectorParams`` / ``DetectorState`` that the program's
``models/convert.load_detector_state`` reads (DAGR's own checkpoint key
names for the head are not in the repository), flattened with dots; conv
kernels are OIHW here, as ``F.conv2d`` takes them.  :func:`detector_tree`
turns ``(state dict, head dict)`` into that layout's nested containers of
numpy arrays (conv kernels HWIO), for the program.

Scales as in ``weights``: uniform ``1/sqrt(fan_in)`` for spline kernels,
roots, 1x1 remaps and prediction convs (biases too, so that a dropped bias
shows), He-normal for the CNN head's ``BaseConv`` kernels, batch norms near
the identity.  YOLOX's box prediction is ``log(w / stride)``: the w and h
biases of the CNN head's box prediction, which every anchor reads (the
GNN head's maps are zero in cells without events), start at ``log 4``
(boxes about four strides wide, 96 px at stride 24, a near car at
360x240), so that the boxes of neighbouring anchors overlap as a trained
head's do and NMS has boxes to suppress.  The random ResNet's output remaps are tens to hundreds in
magnitude, so the CNN head's logits on near-identity statistics run to
50-90: saturated probabilities and boxes ``exp(50)`` strides wide, which
no comparison could read.  :func:`fit_cnn_statistics` gives the CNN head's
batch norms the statistics of the frame they run on, as a trained
detector's running statistics follow its data."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .detect import Head, cnn_head
from .geometry import Geometry
from .model import DAGR, _LAYER_NAMES
from .weights import Spec, _bn

OUTPUT_CHANNELS = (256, 256)          # the remaps of layer3 and layer4
WH_LOG_STRIDES = float(np.log(4.0))   # the box predictions' w, h bias
GNN_BLOCKS = ("stem", "cls_conv", "reg_conv")
CNN_BLOCKS = ("stem", "cls1", "cls2", "reg1", "reg2")
PREDS = ("cls_pred", "reg_pred", "obj_pred")
# the reference-format BN keys ``weights._bn`` writes -> the layout's
_BN_FIELDS = (("weight", "p", "scale"), ("bias", "p", "offset"),
              ("running_mean", "s", "mean"), ("running_var", "s", "var"))


def head_widths(geo: Geometry, head: Head):
    """``(inputs of the GNN head's scales, their width, the CNN head's
    width, prediction outputs)``: DAGR's ``GNNHead`` at ``geo``'s
    widths."""
    ch = geo.channels()
    cin = (ch[-2], ch[-1])[:head.num_scales]
    return cin, max(cin), int(256 * head.yolo_stem_width), \
        {"cls_pred": head.num_classes, "reg_pred": 4, "obj_pred": 1}


def specs(geo: Geometry, head: Head) -> List[Spec]:
    """Every tensor of the head dict at ``geo``'s widths."""
    out: List[Spec] = []
    ks2 = geo.kernel_size ** 2
    taps = geo.tap_channels()
    for i, (ci, co) in enumerate(zip(taps[3:], OUTPUT_CHANNELS)):
        out += [(f"output_dconv.{i}.w", (co, ci, 1, 1), "uniform",
                 ci ** -0.5),
                (f"output_dconv.{i}.b", (co,), "uniform", ci ** -0.5)]
    cins, width, hidden, pred_out = head_widths(geo, head)
    for s, cin in enumerate(cins):
        base = f"head.scales.{s}"
        for blk in GNN_BLOCKS:
            c = cin if blk == "stem" else width
            out += [(f"{base}.{blk}.conv.weight", (ks2, c, width), "uniform",
                     (c * ks2) ** -0.5),
                    (f"{base}.{blk}.conv.root", (c, width), "uniform",
                     c ** -0.5)]
            _bn(out, f"{base}.{blk}.bn", width)
        for p in PREDS:
            o = pred_out[p]
            out += [(f"{base}.{p}.weight", (ks2, width, o), "uniform",
                     (width * ks2) ** -0.5),
                    (f"{base}.{p}.root", (width, o), "uniform",
                     width ** -0.5),
                    (f"{base}.{p}.bias", (o,), "uniform", width ** -0.5)]
    for s, cin in enumerate(OUTPUT_CHANNELS):
        base = f"head.cnn.scales.{s}"
        for blk in CNN_BLOCKS:
            c, k = (cin, 1) if blk == "stem" else (hidden, 3)
            out.append((f"{base}.{blk}.w", (hidden, c, k, k), "normal",
                        (2.0 / (c * k * k)) ** 0.5))
            _bn(out, f"{base}.{blk}.bn", hidden)
        for p in PREDS:
            o = pred_out[p]
            out += [(f"{base}.{p}.w", (o, hidden, 1, 1), "uniform",
                     hidden ** -0.5),
                    (f"{base}.{p}.b", (o,), "uniform", hidden ** -0.5)]
    return out


def make_head(geo: Geometry, head: Head, seed: int,
              device) -> Dict[str, torch.Tensor]:
    """The head dict, f32 on ``device``, from ``seed`` (a stream of its
    own, apart from ``weights.make_state``'s): every tensor a slice of one
    normal and one uniform draw."""
    sp = specs(geo, head)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in sp]
    own = int(np.random.SeedSequence([seed, 17]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(own)
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for (key, shape, kind, s), n in zip(sp, sizes):
        nrm = normal[off:off + n].view(shape)
        uni = uniform[off:off + n].view(shape)
        off += n
        if kind == "normal":
            t = nrm * s
        elif kind == "uniform":
            t = uni * s
        elif kind == "one":
            t = 1.0 + nrm * s
        else:                                   # a variance
            t = 1.0 + (nrm * s).abs()
        if key.startswith("head.cnn.scales.") and key.endswith(
                "reg_pred.b"):
            t = t + torch.tensor([0.0, 0.0, WH_LOG_STRIDES, WH_LOG_STRIDES],
                                 device=device)
        out[key] = t.contiguous()
    return out


def fit_cnn_statistics(sd, hd, image, geo: Geometry):
    """A copy of ``hd`` whose CNN head batch norms hold the statistics of
    their conv outputs on ``image [B, H, W, 3]`` (per channel over the
    batch and the map), the drawn near-identity statistics kept as a
    perturbation: running mean ``m + drawn mean * s``, running variance
    ``s^2 * drawn variance``.  f32, TF32 off (call ``model.strict_f32``
    first on the card)."""
    out = dict(hd)

    def fit(key, h):
        m = h.mean(dim=(0, 2, 3))
        v = h.var(dim=(0, 2, 3), unbiased=False)
        out[f"{key}.running_mean"] = m + hd[f"{key}.running_mean"] \
            * torch.sqrt(v)
        out[f"{key}.running_var"] = v * hd[f"{key}.running_var"]
    with torch.no_grad():
        cnn_head(sd, out, image, geo, fit=fit)
    return out


# ---------------------------------------------------------------------------
# the program's layout: DetectorParams / DetectorState as nested containers
# ---------------------------------------------------------------------------
def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _hwio(w: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 1, 0)))


def _bn_pair(d, key: str, dict_form: bool):
    """``(params, state)`` of the BN under ``key`` (``.module`` nested or
    not) of a flat dict."""
    k = key if f"{key}.weight" in d else f"{key}.module"
    p = {f: _np(d[f"{k}.{r}"]) for r, side, f in _BN_FIELDS if side == "p"}
    s = {f: _np(d[f"{k}.{r}"]) for r, side, f in _BN_FIELDS if side == "s"}
    if dict_form:
        return p, s
    return SimpleNamespace(**p), SimpleNamespace(**s)


def _spline(d, key: str, root_key: str, transpose_root: bool,
            bias_key: str = None):
    root = _np(d[root_key])
    return SimpleNamespace(
        weight=_np(d[key]), root=root.T.copy() if transpose_root else root,
        bias=None if bias_key is None else _np(d[bias_key]))


def detector_tree(sd: Dict[str, torch.Tensor], hd: Dict[str, torch.Tensor],
                  geo: Geometry):
    """``(params, state)`` of the whole detector for the program's
    ``load_detector_state``: the backbone and ResNet from the
    reference-format ``sd``, the output remaps and both heads from
    ``hd``."""
    ns = SimpleNamespace
    layers_p, layers_s = [], []
    for nm in _LAYER_NAMES:
        base = f"{DAGR}backbone.{nm}"
        bp, bs = {}, {}
        for bi in (1, 2):
            cb = f"{base}.conv_block{bi}"
            p, s = _bn_pair(sd, f"{cb}.norm", False)
            bp[bi] = ns(conv=_spline(sd, f"{cb}.conv.weight",
                                     f"{cb}.conv.lin.weight", True), bn=p)
            bs[bi] = ns(bn=s)
        sp, ss = _bn_pair(sd, f"{base}.conv_block2.norm_skip", False)
        layers_p.append(ns(
            block1=bp[1], block2=bp[2],
            skip_lin=_np(sd[f"{base}.conv_block2.lin.mlp.weight"]).T.copy(),
            skip_lin_bias=_np(sd[f"{base}.conv_block2.lin.mlp.bias"]),
            skip_bn=sp))
        layers_s.append(ns(block1=bs[1], block2=bs[2], skip_bn=ss))
    cnn_p = cnn_s = None
    if geo.use_image:
        r = f"{DAGR}backbone.net.module."
        p, s = _bn_pair(sd, r + "bn1", True)
        resnet, cnn_s = {"conv1": _hwio(sd[r + "conv1.weight"]),
                         "bn1": p}, {"bn1": s}
        for li in range(1, 5):
            blocks_p, blocks_s = [], []
            bi = 0
            while f"{r}layer{li}.{bi}.conv1.weight" in sd:
                base = f"{r}layer{li}.{bi}"
                bp, bs = {}, {}
                ci = 1
                while f"{base}.conv{ci}.weight" in sd:
                    bp[f"c{ci}"] = _hwio(sd[f"{base}.conv{ci}.weight"])
                    bp[f"b{ci}"], bs[f"b{ci}"] = _bn_pair(
                        sd, f"{base}.bn{ci}", True)
                    ci += 1
                if f"{base}.downsample.0.weight" in sd:
                    bp["down"] = _hwio(sd[f"{base}.downsample.0.weight"])
                    bp["down_bn"], bs["down_bn"] = _bn_pair(
                        sd, f"{base}.downsample.1", True)
                blocks_p.append(bp)
                blocks_s.append(bs)
                bi += 1
            resnet[f"layer{li}"] = blocks_p
            cnn_s[f"layer{li}"] = blocks_s
        f = f"{DAGR}backbone.net.feature_dconv"
        cnn_p = {"resnet": resnet,
                 "feature_dconv": [
                     {"w": _hwio(sd[f"{f}.{i}.weight"]),
                      "b": _np(sd[f"{f}.{i}.bias"])} for i in range(5)],
                 "output_dconv": [
                     {"w": _hwio(hd[f"output_dconv.{i}.w"]),
                      "b": _np(hd[f"output_dconv.{i}.b"])}
                     for i in range(len(OUTPUT_CHANNELS))]}
    scales_p, scales_s = [], []
    s = 0
    while f"head.scales.{s}.stem.conv.weight" in hd:
        base = f"head.scales.{s}"
        p_blocks, s_blocks = {}, {}
        for blk in GNN_BLOCKS:
            p, st = _bn_pair(hd, f"{base}.{blk}.bn", False)
            p_blocks[blk] = ns(conv=_spline(hd, f"{base}.{blk}.conv.weight",
                                            f"{base}.{blk}.conv.root",
                                            False), bn=p)
            s_blocks[blk] = ns(bn=st)
        for pr in PREDS:
            p_blocks[pr] = _spline(hd, f"{base}.{pr}.weight",
                                   f"{base}.{pr}.root", False,
                                   f"{base}.{pr}.bias")
        scales_p.append(ns(**p_blocks))
        scales_s.append(ns(**s_blocks))
        s += 1
    hcnn_p = hcnn_s = None
    if geo.use_image:
        hcnn_p, hcnn_s = {"scales": []}, {"scales": []}
        for s in range(len(OUTPUT_CHANNELS)):
            base = f"head.cnn.scales.{s}"
            p_sc, s_sc = {}, {}
            for blk in CNN_BLOCKS:
                p, st = _bn_pair(hd, f"{base}.{blk}.bn", True)
                p_sc[blk] = {"w": _hwio(hd[f"{base}.{blk}.w"]), "bn": p}
                s_sc[blk] = {"bn": st}
            for pr in PREDS:
                p_sc[pr] = {"w": _hwio(hd[f"{base}.{pr}.w"]),
                            "b": _np(hd[f"{base}.{pr}.b"])}
            hcnn_p["scales"].append(p_sc)
            hcnn_s["scales"].append(s_sc)
    params = ns(dagr=ns(backbone=ns(layers=layers_p), cnn=cnn_p),
                head=ns(scales=scales_p, cnn=hcnn_p))
    state = ns(dagr=ns(backbone=ns(layers=layers_s), cnn=cnn_s),
               head=ns(scales=scales_s, cnn=hcnn_s))
    return params, state
