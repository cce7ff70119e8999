"""The plain reference of DAGR-S's detection read-out (Gehrig &
Scaramuzza, Nature 629, 2024; ``GNNHead`` and ``postprocess_network_output``
of uzh-rpg/dagr): the GNN head on the backbone's level-3 and level-4
graphs, the CNN head on the ResNet's two output remaps, their sum, the
YOLOX decode and greedy class-offset NMS, in float32 plain PyTorch.

Weights: the backbone's from ``weights.make_state``'s reference-format
dict, the rest from ``detect_weights.make_head``'s dict.  Built on
``model`` (the pyramid, spline conv, BN, grid rows, the ResNet) and
``stream`` (the ring); nothing of the program is imported.  ``q`` rounds
what enters a product, as in ``model``.

Per head scale (DAGR's ``process_feature``): stem, then a classification
and a regression conv block (spline conv, masked BN, the configuration's
activation), then the class, box and objectness spline predictions (with
bias), scattered into the dense ``[B, C, ny, nx]`` map of the level's
cells.  The CNN head: per scale a ``BaseConv`` stem (1x1) and two 3x3
``BaseConv`` stacks (conv, BN, SiLU), then 1x1 predictions, on the output
remap resized to the head's grid; its logits are added to the GNN's.
Decode: sigmoid on objectness and classes, xy = (offset + cell) * stride,
wh = exp(offset) * stride.  NMS: score = objectness x best class
probability, kept at ``conf_threshold`` and above; boxes shifted by their
class times ``max(W, H) + 1`` so that classes never overlap; greedy in
score order (ties in anchor order), a box dropped where its IoU with a kept
box exceeds ``nms_threshold``; the first ``max_detections`` kept.

Departures from DAGR's description, each the port's: the head's random
weights use the reference package's key layout (DAGR's key names are not
in the repository); the CNN head's resize picks the source cell at
half-pixel centres, ``floor((i + 0.5) src / dst)``, as ``jax.image.resize``
does; NMS keeps a fixed count of 64 slots per image (masked), where DAGR's
returns a list of any length.  On the card call ``model.strict_f32``
first."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import stream as rstream
from .geometry import Geometry
from .model import (Graph, Q, _bn, _bn2d, _edge_attr, batch_norm,
                    cnn_features, f32, gnn, grid_rows, level0_graph,
                    spline_conv)

DAGR_NET = "dagr_model.backbone.net."
_ACTS = {"relu": torch.relu, "elu": F.elu, "silu": F.silu,
         "hardtanh": lambda v: torch.clamp(v, -1.0, 1.0)}


@dataclass(frozen=True)
class Head:
    """The detector's settings a configuration file states: ``fields``'
    ``yolo_stem_width`` and ``num_scales``, and its ``detector`` key."""
    num_classes: int = 2
    yolo_stem_width: float = 0.5
    num_scales: int = 2
    conf_threshold: float = 0.001
    nms_threshold: float = 0.65
    max_detections: int = 64

    @classmethod
    def of(cls, config: dict) -> "Head":
        f, d = config["fields"], config.get("detector", {})
        kw = {k: f[k] for k in ("yolo_stem_width", "num_scales") if k in f}
        kw.update({k: d[k] for k in ("num_classes", "conf_threshold",
                                     "nms_threshold", "max_detections")
                   if k in d})
        return cls(**kw)


def head_geometry(geo: Geometry):
    """``(grids (nx, ny), strides)`` of the two head scales: the grids of
    levels 3 and 4."""
    grids = geo.grid_dims()[2:4]
    return grids, [int(round(geo.model_height / ny)) for _, ny in grids]


# ---------------------------------------------------------------------------
# the GNN head
# ---------------------------------------------------------------------------
def gnn_head_scale(hd, s: int, g: Graph, geo: Geometry, q: Q = f32):
    """Head scale ``s`` on the level-``3 + s`` graph ``g``: ``(reg, obj,
    cls)`` logit maps ``[B, C, ny, nx]``."""
    grid = geo.grid_dims()[2 + s]
    nx, ny = grid
    base = f"head.scales.{s}"
    act = _ACTS[geo.activation]
    mask, nbrm = g.node_mask, g.nbr_mask

    def rows(src):
        return grid_rows(src, grid, geo.batch_size)
    attr = _edge_attr(g.pos, rows(g.pos[:, :2]), nbrm,
                      geo.cart_max()[3 + s])

    def conv(x, key, bias=None):
        x = q(x)
        out = spline_conv(x, rows(x), nbrm, attr, hd[f"{key}.weight"],
                          hd[f"{key}.root"], ks=geo.kernel_size,
                          aggr=geo.aggr, node_mask=mask, q=q)
        if bias is not None:
            out = q(torch.where(mask[:, None], out + bias, 0.0))
        return out

    def block(x, name):
        h = conv(x, f"{base}.{name}.conv")
        h = act(q(batch_norm(h, mask, _bn(hd, f"{base}.{name}.bn"))))
        return q(torch.where(mask[:, None], h, 0.0))

    def dense(x):
        return x.reshape(geo.batch_size, ny, nx, x.shape[1]) \
            .permute(0, 3, 1, 2)
    stem = block(g.x, "stem")
    xc, xr = block(stem, "cls_conv"), block(stem, "reg_conv")
    return tuple(dense(conv(x, f"{base}.{p}", hd[f"{base}.{p}.bias"]))
                 for x, p in ((xr, "reg_pred"), (xr, "obj_pred"),
                              (xc, "cls_pred")))


# ---------------------------------------------------------------------------
# the CNN head
# ---------------------------------------------------------------------------
def output_maps(sd, hd, image, geo: Geometry, q: Q = f32):
    """The ResNet's output remaps of ``layer3`` and ``layer4``, NHWC: the
    pyramid's remaps of those taps with the output weights in place of the
    feature weights."""
    sd2 = dict(sd)
    for i in range(2):
        sd2[f"{DAGR_NET}feature_dconv.{3 + i}.weight"] = \
            hd[f"output_dconv.{i}.w"]
        sd2[f"{DAGR_NET}feature_dconv.{3 + i}.bias"] = \
            hd[f"output_dconv.{i}.b"]
    return cnn_features(sd2, image, geo, q)[3:5]


def _resize_nearest(f, ny: int, nx: int):
    """NCHW ``f`` at source cells ``floor((i + 0.5) src / dst)``."""
    _, _, h, w = f.shape
    iy = [((2 * i + 1) * h) // (2 * ny) for i in range(ny)]
    ix = [((2 * i + 1) * w) // (2 * nx) for i in range(nx)]
    return f[:, :, iy][:, :, :, ix]


def cnn_head(sd, hd, image, geo: Geometry, q: Q = f32, fit=None):
    """Per scale the CNN head's ``(reg, obj, cls)`` logit maps on the
    image ``[B, H, W, 3]``.  ``fit(key, h)``, where given, is called with
    each ``BaseConv``'s BN key and its conv output before the BN reads
    ``hd`` (``detect_weights.fit_cnn_statistics``)."""
    grids, _ = head_geometry(geo)
    out = []
    for s, (f, (nx, ny)) in enumerate(zip(output_maps(sd, hd, image, geo, q),
                                          grids)):
        base = f"head.cnn.scales.{s}"
        x = _resize_nearest(f.permute(0, 3, 1, 2), ny, nx)

        def base_conv(x, name):
            w = hd[f"{base}.{name}.w"]
            h = q(F.conv2d(q(x), q(w), padding=(w.shape[2] - 1) // 2))
            if fit is not None:
                fit(f"{base}.{name}.bn", h)
            return q(F.silu(_bn2d(h, _bn(hd, f"{base}.{name}.bn"))))
        h = base_conv(x, "stem")
        c = base_conv(base_conv(h, "cls1"), "cls2")
        r = base_conv(base_conv(h, "reg1"), "reg2")

        def pred(x, name):
            return q(F.conv2d(q(x), q(hd[f"{base}.{name}.w"]))
                     + hd[f"{base}.{name}.b"][:, None, None])
        out.append((pred(r, "reg_pred"), pred(r, "obj_pred"),
                    pred(c, "cls_pred")))
    return out


# ---------------------------------------------------------------------------
# decode and NMS
# ---------------------------------------------------------------------------
def decode(maps, strides) -> torch.Tensor:
    """``[B, A, 5 + C]``: per anchor (scale by scale, cells row by row)
    x, y, w, h in pixels, objectness and class probabilities."""
    out = []
    for (reg, obj, cls), stride in zip(maps, strides):
        b, _, ny, nx = reg.shape
        gy, gx = torch.meshgrid(torch.arange(ny, device=reg.device),
                                torch.arange(nx, device=reg.device),
                                indexing="ij")
        cell = torch.stack([gx, gy]).to(torch.float32)
        xy = (reg[:, :2] + cell) * stride
        wh = torch.exp(reg[:, 2:4]) * stride
        m = torch.cat([xy, wh, torch.sigmoid(obj), torch.sigmoid(cls)], 1)
        out.append(m.reshape(b, m.shape[1], ny * nx).permute(0, 2, 1))
    return torch.cat(out, 1)


def _iou(box, boxes):
    """IoU of one xyxy ``box [4]`` with each of ``boxes [M, 4]``."""
    def area(b):
        return (b[..., 2] - b[..., 0]).clamp(min=0) * \
            (b[..., 3] - b[..., 1]).clamp(min=0)
    ow = (torch.minimum(box[2], boxes[:, 2])
          - torch.maximum(box[0], boxes[:, 0])).clamp(min=0)
    oh = (torch.minimum(box[3], boxes[:, 3])
          - torch.maximum(box[1], boxes[:, 1])).clamp(min=0)
    inter = ow * oh
    return inter / (area(box) + area(boxes) - inter).clamp(min=1e-9)


def nms(decoded, head: Head, width: int, height: int) -> List[List[int]]:
    """Per image the anchors kept, in the order kept (at most
    ``head.max_detections``), from ``decoded [B, A, 5 + C]``; computed on
    the host."""
    d = decoded.detach().to("cpu", torch.float32)
    xy = d[..., :2] - d[..., 2:4] / 2
    boxes = torch.cat([xy, xy + d[..., 2:4]], -1)
    conf, label = d[..., 5:5 + head.num_classes].max(-1)
    score = d[..., 4] * conf
    shifted = boxes + (label.to(torch.float32)
                       * (max(width, height) + 1))[..., None]
    out = []
    for b in range(d.shape[0]):
        alive = score[b] >= head.conf_threshold
        order = torch.argsort(-torch.where(alive, score[b], -torch.inf),
                              stable=True)
        kept: List[int] = []
        for i in order.tolist():
            if not bool(alive[i]) or len(kept) == head.max_detections:
                break
            if kept and bool((_iou(shifted[b, i], shifted[b, kept])
                              > head.nms_threshold).any()):
                continue
            kept.append(i)
        out.append(kept)
    return out


def kept_of(detections: Dict[str, torch.Tensor], decoded,
            head: Head) -> List[List[int]]:
    """Per image the anchors behind a fixed-size detections dict
    (``boxes`` xyxy, ``scores``, ``labels``, ``mask``): each kept slot
    matched, bit for bit in box, score and label, to an anchor of
    ``decoded``; -1 where none matches."""
    d = decoded.detach().to("cpu", torch.float32)
    xy = d[..., :2] - d[..., 2:4] / 2
    boxes = torch.cat([xy, xy + d[..., 2:4]], -1)
    conf, label = d[..., 5:5 + head.num_classes].max(-1)
    score = d[..., 4] * conf
    det = {k: v.detach().cpu() for k, v in detections.items()}
    out = []
    for b in range(d.shape[0]):
        kept = []
        for j in torch.nonzero(det["mask"][b]).flatten().tolist():
            hit = ((boxes[b] == det["boxes"][b, j].to(torch.float32))
                   .all(-1) & (score[b] == det["scores"][b, j])
                   & (label[b] == det["labels"][b, j]))
            idx = torch.nonzero(hit).flatten()
            kept.append(int(idx[0]) if len(idx) else -1)
        out.append(kept)
    return out


def mismatches(got: List[List[int]], want: List[List[int]]) -> int:
    """Slots, image by image, where two kept lists differ (index or
    order), a missing slot counting as a difference."""
    return sum(sum(1 for j in range(max(len(a), len(b)))
                   if j >= len(a) or j >= len(b) or a[j] != b[j])
               for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the batch forward and the stream's read
# ---------------------------------------------------------------------------
def head_maps(sd, hd, outs, image, geo: Geometry, q: Q = f32, cnn=None):
    """Per scale the ``(reg, obj, cls)`` logits of the output graphs
    ``outs`` (levels 3 and 4): the GNN head's, with the CNN head's added
    (the hybrid sum; ``cnn``, else computed from ``image``) where the
    model has an image."""
    g_maps = [gnn_head_scale(hd, s, g, geo, q) for s, g in enumerate(outs)]
    if not geo.use_image:
        return g_maps
    if cnn is None:
        cnn = cnn_head(sd, hd, image, geo, q)
    return [tuple(a + b for a, b in zip(g, c)) for g, c in zip(g_maps, cnn)]


def forward(sd, hd, batch: dict, geo: Geometry, q: Q = f32):
    """The batch detector: ``(maps, decoded)`` of a collated batch
    (``pos``, ``polarity``, ``valid``, ``rank``, ``image``; tensors on the
    weights' device)."""
    with torch.no_grad():
        g0 = level0_graph(batch, geo)
        feats = (cnn_features(sd, batch["image"], geo, q)
                 if geo.use_image else None)
        outs = gnn(sd, g0, feats, geo, q)
        maps = head_maps(sd, hd, outs, batch.get("image"), geo, q)
        return maps, decode(maps, head_geometry(geo)[1])


def read(sd, hd, geo: Geometry, feats, cnn, ring: rstream.Ring,
         q: Q = f32):
    """The stream's read-out of a ring (``stream.append``'s): levels 1-4
    from its caches, both heads' sum and the decode; ``feats`` the frame's
    five maps and ``cnn`` its :func:`cnn_head` maps (batch 1).  Returns
    ``decoded [1, A, 5 + C]``."""
    g1 = dataclasses.replace(geo, batch_size=1)
    n = ring.pos.shape[0]
    posn = rstream._norm_pos(ring.pos, ring.t_now, geo)
    x1 = torch.cat([ring.h1, ring.img1], 1) if geo.use_image else ring.h1
    g = Graph(x1, posn, ring.nbr0, ring.nbrm0, ring.valid,
              torch.zeros((n,), dtype=torch.int32, device=x1.device))
    wh = torch.tensor((geo.model_width, geo.model_height),
                      dtype=torch.float32, device=x1.device)
    pos_src0 = (ring.pos[:, None, :2] - ring.off0).to(torch.float32) / wh
    with torch.no_grad():
        outs = gnn(sd, g, feats, g1, q, start_level=1, pos_src0=pos_src0)
        maps = head_maps(sd, hd, outs, None, g1, q, cnn)
        return decode(maps, head_geometry(geo)[1])
