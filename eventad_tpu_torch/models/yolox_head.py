"""YOLOX-style detection heads on graph and CNN features, decode and
class-offset NMS (counterpart of ``eventad_tpu/models/yolox_head.py``;
reference dagr.py:132-320, spline_conv.py:80-118, model/utils.py:25-110).

The pooled node tables are dense grids (cell = (b, iy, ix)), so the
reference's scatter into a dense map is a reshape.  Per scale
(dagr.py:174-187):

    stem (ConvBlock) -> cls_conv -> cls_pred (to dense, C = num_classes)
                     `-> reg_conv -> reg_pred (4) + obj_pred (1)

Where the pooled layers take K3 (``models/backbone.frozen_route``: bf16
features on the card in eval mode) each scale runs as five launches of it
(``ops/spline_shift``), each conv's tail in the kernel's epilogue and
``reg_pred`` with ``obj_pred`` as one launch; otherwise as six plain spline
convs (``ops/spline_conv``) with BN, activation and mask around them.

The CNN head (YOLOX ``BaseConv`` stacks) runs on the ResNet output maps and
its logits are added to the GNN maps (hybrid fusion, dagr.py:247-262).
Decode and NMS keep the JAX package's fixed output shapes; on the card the
post-process and NMS run as one launch of K9 (``ops/nms``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import postprocess_cuda
from ..ops.norm import MOMENTUM, BatchNorm, batch_norm, channel_statistics
from ..ops.spline_basis import ACTS
from ..ops.spline_conv import SplineConv, spline_conv
from ..ops.spline_shift import (pack_shift_weights, prepare_shift,
                                shift_spline_conv)
from ..utils.spans import count
from ..utils.tensors import kept_on
from .backbone import (BackboneConfig, ConvBlock, fold_bn_affine,
                       frozen_route)
from .graph import Graph, neighbor_rows


class ScaleHead(nn.Module):
    def __init__(self, cin: int, width: int, num_classes: int,
                 kernel_size: int, generator: torch.Generator = None):
        super().__init__()
        self.stem = ConvBlock(cin, width, kernel_size, generator)
        self.cls_conv = ConvBlock(width, width, kernel_size, generator)
        self.reg_conv = ConvBlock(width, width, kernel_size, generator)
        self.cls_pred = SplineConv(width, num_classes, kernel_size,
                                   generator, bias=True)
        self.reg_pred = SplineConv(width, 4, kernel_size, generator,
                                   bias=True)
        self.obj_pred = SplineConv(width, 1, kernel_size, generator,
                                   bias=True)


class BaseConv(nn.Module):
    """YOLOX ``BaseConv``: conv (OIHW, no bias) -> BN -> SiLU."""

    def __init__(self, cin: int, cout: int, ks: int,
                 generator: torch.Generator = None):
        super().__init__()
        std = (2.0 / (ks * ks * cin)) ** 0.5
        self.weight = nn.Parameter(
            torch.randn(cout, cin, ks, ks, generator=generator) * std)
        self.bn = BatchNorm(cout)


class Pred(nn.Module):
    """A 1x1 prediction conv with bias."""

    def __init__(self, cin: int, cout: int,
                 generator: torch.Generator = None):
        super().__init__()
        s = 1.0 / cin ** 0.5
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1).uniform_(
            -s, s, generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout))


class CNNScaleHead(nn.Module):
    def __init__(self, cin: int, hidden: int, num_classes: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.stem = BaseConv(cin, hidden, 1, generator)
        self.cls1 = BaseConv(hidden, hidden, 3, generator)
        self.cls2 = BaseConv(hidden, hidden, 3, generator)
        self.reg1 = BaseConv(hidden, hidden, 3, generator)
        self.reg2 = BaseConv(hidden, hidden, 3, generator)
        self.cls_pred = Pred(hidden, num_classes, generator)
        self.reg_pred = Pred(hidden, 4, generator)
        self.obj_pred = Pred(hidden, 1, generator)


class CNNHead(nn.Module):
    """YOLOX decoupled head on image features (dagr.py:132-148)."""

    def __init__(self, num_classes: int, in_channels=(256, 256),
                 width: float = 0.5, generator: torch.Generator = None):
        super().__init__()
        hidden = int(256 * width)
        self.scales = nn.ModuleList(
            [CNNScaleHead(cin, hidden, num_classes, generator)
             for cin in in_channels])


class GNNHead(nn.Module):
    def __init__(self, bc: BackboneConfig, num_classes: int = 2,
                 num_scales: int = 2, cnn_in_channels=(256, 256),
                 yolo_stem_width: float = 0.5, use_image: bool = True,
                 generator: torch.Generator = None):
        super().__init__()
        in_ch = [bc.channels[-2], bc.channels[-1]]
        n_reg = max(in_ch)
        self.scales = nn.ModuleList(
            [ScaleHead(in_ch[i], n_reg, num_classes, bc.kernel_size,
                       generator) for i in range(num_scales)])
        self.cnn = (CNNHead(num_classes, cnn_in_channels, yolo_stem_width,
                            generator) if use_image else None)


def _to_dense(x: torch.Tensor, grid: Tuple[int, int], batch_size: int,
              node_mask: torch.Tensor = None) -> torch.Tensor:
    """``[B*ny*nx, C]`` cell table -> ``[B, C, ny, nx]`` dense map; the cell
    order (b, iy, ix) is the pooling's cluster order, the reference's voxel
    scatter (spline_conv.py:99-105).  Rows outside ``node_mask`` are zeroed
    (None: ``x`` is masked already)."""
    nx, ny = grid
    if node_mask is not None:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x = torch.where(node_mask[:, None], x, zero)
    return x.reshape(batch_size, ny, nx, x.shape[1]).permute(0, 3, 1, 2)


def head_shift_operands(head: ScaleHead, dt, tap_idx) -> tuple:
    """K3's operands of the head's five launches, ``(weight, root, a, b,
    pack)`` each: the stem, ``cls_conv`` and ``reg_conv`` with their eval BN
    folded into ``(a, b)`` as the backbone folds a layer's, ``cls_pred``
    with ``a = 1`` and ``b`` its bias, and ``reg_pred`` and ``obj_pred`` as
    one conv of 5 outputs (their weights, roots and biases concatenated).
    The weights are cast to ``dt`` and packed for the used taps
    ``tap_idx``.  Kept on the head (``utils/tensors.kept_on``), so a read
    with unchanged weights casts, folds and packs nothing."""
    blocks = (head.stem, head.cls_conv, head.reg_conv)
    preds = ((head.cls_pred,), (head.reg_pred, head.obj_pred))
    sources = [tap_idx]
    for blk in blocks:
        sources += [blk.conv.weight, blk.conv.root, blk.bn.scale,
                    blk.bn.offset, blk.bn.mean, blk.bn.var]
    for convs in preds:
        for conv in convs:
            sources += [conv.weight, conv.root, conv.bias]

    def make():
        ops = [(blk.conv.weight.to(dt), blk.conv.root.to(dt),
                *fold_bn_affine(blk.bn, None, dt)) for blk in blocks]
        for convs in preds:
            b = torch.cat([c.bias for c in convs]).to(dt).float()
            ops.append((torch.cat([c.weight for c in convs], -1).to(dt),
                        torch.cat([c.root for c in convs], -1).to(dt),
                        torch.ones_like(b), b))
        return tuple(tuple(t.detach() for t in o)
                     + (pack_shift_weights(tap_idx, *o),) for o in ops)
    return kept_on(head, "head_shift_operands", sources, make, key=(dt,))


def gnn_head_scale_shift(head: ScaleHead, g: Graph, attr, grid,
                         bc: BackboneConfig, *, cart_max: float):
    """One scale of the GNN head as five K3 launches
    (``ops/spline_shift.shift_spline_conv``; its plain version on the CPU):
    stem, ``cls_conv`` and ``reg_conv`` each with its eval BN, activation
    and node mask in the kernel's epilogue, ``cls_pred``, and ``reg_pred``
    with ``obj_pred`` as one launch of 5 outputs.  The static tap tables
    are the pooled layer's of the same grid (``static_tables``' cache)."""
    ks = bc.kernel_size
    u = torch.clamp(attr, 0.0, 1.0) * (ks - 1)
    prep = prepare_shift(u, g.nbr_mask, g.node_mask, grid=grid, span=2,
                         cart_max=cart_max, width=bc.width,
                         height=bc.height, kernel_size=ks)
    stem, cls_conv, reg_conv, cls_pred, box_pred = head_shift_operands(
        head, g.x.dtype, prep.tap_idx)

    def conv(x, operands, act):
        *args, pack = operands
        return shift_spline_conv(x, prep, *args, act=act, pack=pack)
    h = conv(g.x, stem, bc.activation)
    hc = conv(h, cls_conv, bc.activation)
    hr = conv(h, reg_conv, bc.activation)
    cls_o = _to_dense(conv(hc, cls_pred, None), grid, bc.batch_size)
    box = _to_dense(conv(hr, box_pred, None), grid, bc.batch_size)
    return cls_o, box[:, :4], box[:, 4:]


def gnn_head_scale_plain(head: ScaleHead, g: Graph, attr, grid,
                         bc: BackboneConfig, training: bool = False):
    """One scale of the GNN head as six plain spline convs
    (``ops/spline_conv``), each block's BN, activation and mask in PyTorch
    ops; ``training`` normalises by batch statistics."""
    def conv(c: SplineConv, x):
        return spline_conv(x, g.nbr, g.nbr_mask, attr.to(x.dtype), c,
                           kernel_size=bc.kernel_size, aggr=bc.aggr,
                           node_mask=g.node_mask,
                           x_j=neighbor_rows(x, grid, bc.batch_size, span=2))

    def block(blk: ConvBlock, x):
        h = ACTS[bc.activation](batch_norm(conv(blk.conv, x), g.node_mask,
                                           blk.bn, training=training))
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        return torch.where(g.node_mask[:, None], h, zero)

    def pred(c: SplineConv, x):
        return _to_dense(conv(c, x), grid, bc.batch_size, g.node_mask)
    h = block(head.stem, g.x)
    hc, hr = block(head.cls_conv, h), block(head.reg_conv, h)
    return pred(head.cls_pred, hc), pred(head.reg_pred, hr), \
        pred(head.obj_pred, hr)


def gnn_head_scale_forward(head: ScaleHead, g: Graph, attr, grid,
                           bc: BackboneConfig, training: bool = False, *,
                           cart_max: float):
    """One scale of the GNN head on graph ``g`` (a pooled level's output,
    ``attr`` its clamped Cartesian edge attributes at ``cart_max``):
    ``(cls, reg, obj)`` dense maps ``[B, C, ny, nx]`` in ``g.x.dtype``.
    :func:`gnn_head_scale_shift` where the pooled layers take K3
    (``models/backbone.frozen_route``), else :func:`gnn_head_scale_plain`."""
    if frozen_route(bc, g.x.dtype, g.x.device, training).pooled == "K3":
        return gnn_head_scale_shift(head, g, attr, grid, bc,
                                    cart_max=cart_max)
    return gnn_head_scale_plain(head, g, attr, grid, bc, training)


def _base_conv(x: torch.Tensor, m: BaseConv, training: bool,
               eps: float = 1e-5) -> torch.Tensor:
    """NCHW.  Eval: the BN affine folded in f32 from parameters and running
    statistics rounded to ``x.dtype``, applied in ``x.dtype``; training: the
    map's own statistics, running statistics updated in place."""
    dt = x.dtype
    h = F.conv2d(x, m.weight.to(dt), padding=(m.weight.shape[2] - 1) // 2)
    bn = m.bn
    if training:
        mean, var, cnt = channel_statistics(h)
        denom = (max(cnt - 1, 1) if isinstance(cnt, int)
                 else (cnt - 1).clamp(min=1))
        with torch.no_grad():
            bn.mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
            bn.var.mul_(1 - MOMENTUM).add_(MOMENTUM * var * cnt / denom)
        y = ((h - mean[:, None, None])
             * torch.rsqrt(var + eps)[:, None, None]
             * bn.scale[:, None, None] + bn.offset[:, None, None])
    else:
        a = bn.scale.to(dt).float() * torch.rsqrt(bn.var.to(dt).float()
                                                  + eps)
        b = bn.offset.to(dt).float() - bn.mean.to(dt).float() * a
        y = h * a.to(dt)[:, None, None] + b.to(dt)[:, None, None]
    return F.silu(y)


def _nearest(f: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Nearest resize of NCHW ``f`` at the half-pixel source index
    ``floor((i + 0.5) * src / dst)``, as ``jax.image.resize`` picks it."""
    _, _, h, w = f.shape

    def index(dst, src):
        i = torch.arange(dst, dtype=torch.float32, device=f.device)
        return ((i + 0.5) * src / dst).floor().long()
    return f[:, :, index(ny, h)][:, :, :, index(nx, w)]


def cnn_head_forward(head: CNNHead, feats: Sequence[torch.Tensor],
                     out_sizes, training: bool = False):
    """``feats``: NHWC maps, resized to ``out_sizes`` (ny, nx) as
    dagr.py:233 does.  Returns a dict of lists (cls / reg / obj) in NCHW.
    Eval runs in the maps' dtype (parameters and statistics cast to it);
    training always in f32."""
    outs = {"cls_output": [], "reg_output": [], "obj_output": []}
    for f, size, sc in zip(feats, out_sizes, head.scales):
        f = _nearest(f.permute(0, 3, 1, 2), *size)
        if training:
            f = f.to(torch.float32)
        dt = f.dtype
        h = _base_conv(f, sc.stem, training)
        c = _base_conv(_base_conv(h, sc.cls1, training), sc.cls2, training)
        r = _base_conv(_base_conv(h, sc.reg1, training), sc.reg2, training)

        def pred(x, p):
            return F.conv2d(x, p.weight.to(dt)) + p.bias.to(dt)[:, None, None]
        outs["cls_output"].append(pred(c, sc.cls_pred))
        outs["reg_output"].append(pred(r, sc.reg_pred))
        outs["obj_output"].append(pred(r, sc.obj_pred))
    return outs


# ---------------------------------------------------------------------------
# decode + NMS (model/utils.py:63-132 equivalents, fixed shapes)
# ---------------------------------------------------------------------------
def decode_outputs(maps: List[torch.Tensor], strides) -> torch.Tensor:
    """``maps``: per scale ``[B, 5+C, ny, nx]`` (reg 4, obj, cls...), obj and
    cls already sigmoided.  Returns ``[B, A, 5+C]`` f32 with xy in pixels
    and wh decoded through exp (dagr.py:314-320).  Counts the anchors of
    every image (``detect/anchors``)."""
    count("detect/anchors", sum(m.shape[0] * m.shape[2] * m.shape[3]
                                for m in maps))
    outs = []
    for m, stride in zip(maps, strides):
        m = m.to(torch.float32)          # decode and NMS geometry stay f32
        b, c, ny, nx = m.shape
        flat = m.reshape(b, c, ny * nx).permute(0, 2, 1)
        gx = torch.arange(nx, device=m.device).repeat(ny).to(flat.dtype)
        gy = torch.arange(ny, device=m.device).repeat_interleave(nx) \
            .to(flat.dtype)
        xy = (flat[..., :2] + torch.stack([gx, gy], -1)[None]) * stride
        wh = torch.exp(flat[..., 2:4]) * stride
        outs.append(torch.cat([xy, wh, flat[..., 4:]], dim=-1))
    return torch.cat(outs, dim=1)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """``boxes [..., N, 4]`` xyxy -> ``[..., N, N]`` IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)

    def overlap(lo, hi):
        return (torch.minimum(hi[..., :, None], hi[..., None, :])
                - torch.maximum(lo[..., :, None], lo[..., None, :])) \
            .clamp(min=0)
    inter = overlap(x1, x2) * overlap(y1, y2)
    return inter / (area[..., :, None] + area[..., None, :] - inter) \
        .clamp(min=1e-9)


def nms_fixed(boxes, scores, class_ids, *, iou_threshold: float = 0.65,
              score_threshold: float = 0.001, max_out: int = 64,
              width: int = 640, height: int = 640):
    """Class-offset NMS with a fixed output size (the reference's
    ``batched_nms_coordinate_trick``, model/utils.py:25-33) of ``boxes
    [..., N, 4]`` xyxy, ``scores`` and ``class_ids [..., N]``; leading
    dimensions are independent images.  Returns ``(keep_idx, keep_mask)``,
    both ``[..., min(N, max_out)]``.  Both sorts are stable, so tied scores
    keep their anchor order.  The greedy suppression is N sequential steps
    on all images at once, on the tensors' own device (counted as
    ``detect/nms_steps``)."""
    n = boxes.shape[-2]
    count("detect/nms_steps", n)
    offset = class_ids.to(boxes.dtype) * (max(width, height) + 1)
    shifted = boxes + offset[..., None]
    neg_inf = torch.full((), -torch.inf, dtype=scores.dtype,
                         device=scores.device)
    s = torch.where(scores >= score_threshold, scores, neg_inf)
    order = torch.argsort(-s, dim=-1, stable=True)
    s_sorted = torch.gather(s, -1, order)
    shifted = torch.gather(shifted, -2, order[..., None].expand(
        *order.shape, 4))
    rank = torch.arange(n, device=boxes.device)
    # sup[..., i, j]: box i, if kept, suppresses the later box j
    sup = (_iou_matrix(shifted) > iou_threshold) & (rank > rank[:, None])
    alive = torch.isfinite(s_sorted)
    keep = alive.clone()
    for i in range(n):
        keep &= ~(sup[..., i, :] & keep[..., i:i + 1])
    kidx = torch.argsort(-torch.where(keep, s_sorted, neg_inf), dim=-1,
                         stable=True)[..., :max_out]
    kmask = torch.gather(keep & alive, -1, kidx)
    return torch.gather(order, -1, kidx), kmask


def postprocess(outputs: torch.Tensor, num_classes: int, **kw):
    """:func:`postprocess_plain`'s detections, by K9 (``ops/nms.
    postprocess_cuda``, one launch) for a CUDA ``outputs``, else by the
    plain version.  Counts ``detect/nms_steps`` (the anchors of an image)
    on both paths."""
    if outputs.is_cuda:
        out = postprocess_cuda(outputs, num_classes, **kw)
        count("detect/nms_steps", outputs.shape[-2])
        return out
    return postprocess_plain(outputs, num_classes, **kw)


def postprocess_plain(outputs: torch.Tensor, num_classes: int, *,
                      conf_threshold: float = 0.001,
                      nms_threshold: float = 0.65, width: int = 640,
                      height: int = 640, max_out: int = 64):
    """reference ``postprocess_network_output`` (model/utils.py:63-110) with
    fixed shapes: ``outputs [B, A, 5+C]`` -> a dict of per-image tensors of
    size ``max_out`` (boxes xyxy, scores, labels) with a mask."""
    xy = outputs[..., :2] - outputs[..., 2:4] / 2
    boxes = torch.cat([xy, xy + outputs[..., 2:4]], dim=-1)
    class_conf, class_pred = outputs[..., 5:5 + num_classes].max(-1)
    score = outputs[..., 4] * class_conf
    idx, mask = nms_fixed(boxes, score, class_pred,
                          iou_threshold=nms_threshold,
                          score_threshold=conf_threshold, max_out=max_out,
                          width=width, height=height)
    return {"boxes": torch.gather(boxes, 1, idx[..., None].expand(
                *idx.shape, 4)),
            "scores": torch.gather(score, 1, idx),
            "labels": torch.gather(class_pred, 1, idx), "mask": mask}
