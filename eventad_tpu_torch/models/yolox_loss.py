"""YOLOX detection loss with static simOTA assignment (counterpart of
``eventad_tpu/models/yolox_loss.py``; reference: the vendored YOLOX head's
``get_losses``, dagr.py:281-290, targets from ``convert_to_training_format``,
model/utils.py:46-61).

Per image a ``[D, A]`` cost matrix over (target, anchor) pairs; candidate
anchors lie in the target box or its 2.5-stride centre region; each target
takes its ``dyn_k`` cheapest candidates (``dyn_k`` the sum of its top-10
candidate IoUs, truncated, at least 1); an anchor claimed twice goes to the
cheaper target.  Losses: IoU on matched boxes, BCE on objectness (every
anchor), BCE on classes (matched), L1 optional, all over the number of
matches.  The images of a batch are one batched computation (the JAX
package maps a per-image function over them).

The discrete choices follow the JAX package's tie for tie: the sort is
stable, ``argmin`` / ``argmax`` take the first index, ``dyn_k`` truncates.
The assignment carries no gradient (it only selects); the losses' clips use
``torch.maximum`` / ``torch.minimum``, which share the gradient at a tie as
``jnp.maximum`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from ..ops.group_sum import stats_group


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _bbox_iou_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of ``a [..., 4]`` and ``b [..., 4]``, both (cx, cy, w, h)."""
    ax1, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax2, ay2 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx1, by1 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx2, by2 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    zero = _zero(ax1)
    iw = torch.maximum(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                       zero)
    ih = torch.maximum(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                       zero)
    inter = iw * ih
    area = (torch.maximum(ax2 - ax1, zero) * torch.maximum(ay2 - ay1, zero)
            + torch.maximum(bx2 - bx1, zero)
            * torch.maximum(by2 - by1, zero) - inter)
    return inter / torch.maximum(area, torch.full((), 1e-9,
                                                  dtype=area.dtype,
                                                  device=area.device))


def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (torch.maximum(logits, _zero(logits)) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


class AnchorGeometry(NamedTuple):
    centers: torch.Tensor   # [A, 2] pixel centres
    strides: torch.Tensor   # [A]


def make_anchor_geometry(grids: Sequence, strides: Sequence[int],
                         device=None) -> AnchorGeometry:
    """Anchor centres and strides of the output scales, ``grids`` as
    ``(nx, ny)``, in the decode's anchor order (row-major per scale)."""
    cs, ss = [], []
    for (nx, ny), stride in zip(grids, strides):
        gx = torch.arange(nx).repeat(ny).to(torch.float32)
        gy = torch.arange(ny).repeat_interleave(nx).to(torch.float32)
        cs.append(torch.stack([(gx + 0.5) * stride, (gy + 0.5) * stride],
                              -1))
        ss.append(torch.full((nx * ny,), float(stride)))
    return AnchorGeometry(torch.cat(cs).to(device), torch.cat(ss).to(device))


def simota_assign(outputs: torch.Tensor, targets: torch.Tensor,
                  target_mask: torch.Tensor, geom: AnchorGeometry,
                  num_classes: int = 2, center_radius: float = 2.5,
                  topk_candidates: int = 10):
    """The static simOTA assignment of ``outputs [B, A, 5 + C]`` (boxes in
    pixels, logits) to ``targets [B, D, 5]`` (class, cx, cy, w, h) under
    ``target_mask [B, D]``.  Returns ``(matched [B, D, A], m_any [B, A],
    m_gt [B, A])``: the (target, anchor) matches, whether an anchor is
    matched, and the target it is matched to (0 where none)."""
    with torch.no_grad():
        out = outputs.detach()
        boxes = out[..., :4]
        obj_logit = out[..., 4]
        cls_logit = out[..., 5:5 + num_classes]
        a = boxes.shape[1]
        d = targets.shape[1]
        gt_box = targets[..., 1:5]
        gt_cls = targets[..., 0].to(torch.int32)

        cx, cy = geom.centers[:, 0], geom.centers[:, 1]
        gx1 = gt_box[..., 0] - gt_box[..., 2] / 2
        gx2 = gt_box[..., 0] + gt_box[..., 2] / 2
        gy1 = gt_box[..., 1] - gt_box[..., 3] / 2
        gy2 = gt_box[..., 1] + gt_box[..., 3] / 2
        in_box = ((cx >= gx1[..., None]) & (cx <= gx2[..., None])
                  & (cy >= gy1[..., None]) & (cy <= gy2[..., None]))
        r = center_radius * geom.strides
        in_ctr = ((cx >= gt_box[..., 0:1] - r) & (cx <= gt_box[..., 0:1] + r)
                  & (cy >= gt_box[..., 1:2] - r)
                  & (cy <= gt_box[..., 1:2] + r))
        fg_cand = (in_box | in_ctr) & target_mask[..., None]    # [B, D, A]

        iou = _bbox_iou_xywh(gt_box[:, :, None, :], boxes[:, None, :, :])
        iou_loss_mat = -torch.log(iou + 1e-8)
        classes = torch.arange(num_classes, device=out.device)
        onehot = (gt_cls[..., None] == classes).to(torch.float32)[:, :, None]
        # YOLOX's cost: sigmoid(cls) * sigmoid(obj) against the one-hot
        p = torch.sigmoid(cls_logit) * torch.sigmoid(obj_logit)[..., None]
        p = torch.sqrt(torch.clamp(p, 1e-8, 1.0))[:, None]
        cls_cost = -(onehot * torch.log(p)
                     + (1 - onehot) * torch.log(1 - p + 1e-8)).sum(-1)
        cost = cls_cost + 3.0 * iou_loss_mat \
            + 1e5 * (~fg_cand).to(torch.float32)

        # dynamic k per target: the sum of its top-10 candidate IoUs, >= 1
        iou_cand = torch.where(fg_cand, iou, 0.0)
        topk_iou = torch.topk(iou_cand, min(topk_candidates, a), dim=-1)[0]
        dyn_k = torch.clamp(topk_iou.sum(-1).to(torch.int32), 1, a)

        # each target's rank of every anchor by cost; selected below dyn_k
        order = torch.argsort(cost, dim=-1, stable=True)
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(a, device=out.device).expand_as(order))
        selected = (rank < dyn_k[..., None]) & fg_cand

        # an anchor claimed twice goes to the cheapest target
        sel_cost = torch.where(selected, cost, torch.inf)
        best_gt = torch.argmin(sel_cost, dim=1)                  # [B, A]
        fg = selected.any(dim=1)
        claims = (best_gt[:, None, :] == torch.arange(
            d, device=out.device)[:, None]) & selected
        matched = claims & fg[:, None]
        m_any = matched.any(dim=1)
        m_gt = torch.argmax(matched.to(torch.int32), dim=1)
    return matched, m_any, m_gt


def yolox_loss(outputs: torch.Tensor, targets: torch.Tensor,
               target_mask: torch.Tensor, geom: AnchorGeometry,
               num_classes: int = 2, center_radius: float = 2.5,
               topk_candidates: int = 10, l1_weight=0.0) -> dict:
    """``outputs [B, A, 5 + C]`` decoded (boxes in pixels, objectness and
    class logits), ``targets [B, D, 5]`` (class, cx, cy, w, h),
    ``target_mask [B, D]``.  Returns ``dict(total, iou, obj, cls, l1,
    num_fg)`` of 0-dim tensors.

    ``l1_weight`` gates YOLOX's L1 branch (on in the final no-augmentation
    epochs).  The L1 is taken on the decoded boxes: the decode is
    invertible, so ``|raw - l1_target|`` is ``|d_centre| / stride`` and
    ``|log(w_pred / w_gt)|`` exactly.

    Inside ``ops.group_sum.batch_stats_group`` the losses are this rank's
    parts: its sums over the foreground count of every rank of the group
    (``num_fg`` stays this rank's count)."""
    matched, m_any, m_gt = simota_assign(
        outputs, targets, target_mask, geom, num_classes, center_radius,
        topk_candidates)
    boxes = outputs[..., :4]
    obj_logit = outputs[..., 4]
    cls_logit = outputs[..., 5:5 + num_classes]
    b, a = boxes.shape[:2]
    gt_box = targets[..., 1:5]
    classes = torch.arange(num_classes, device=outputs.device)
    onehot = (targets[..., 0].to(torch.int32)[..., None] == classes) \
        .to(torch.float32)

    num_fg = torch.clamp(matched.sum(dim=(1, 2)), min=1).to(torch.float32)
    mb = torch.gather(gt_box, 1, m_gt[..., None].expand(b, a, 4))
    iou_l = torch.where(m_any, 1.0 - _bbox_iou_xywh(mb, boxes), 0.0).sum(-1)
    obj_l = _bce(obj_logit, m_any.to(torch.float32)).sum(-1)
    cls_t = torch.gather(onehot, 1, m_gt[..., None].expand(
        b, a, num_classes)) * torch.where(m_any[..., None], 1.0, 0.0)
    cls_l = torch.where(m_any[..., None], _bce(cls_logit, cls_t),
                        0.0).sum(dim=(1, 2))
    # raw-space L1 on matched anchors (YOLOX get_l1_target semantics)
    tiny = torch.full((), 1e-9, dtype=boxes.dtype, device=boxes.device)
    l1 = (torch.abs(boxes[..., 0] - mb[..., 0]) / geom.strides
          + torch.abs(boxes[..., 1] - mb[..., 1]) / geom.strides
          + torch.abs(torch.log(torch.maximum(boxes[..., 2], tiny)
                                / torch.maximum(mb[..., 2], tiny)))
          + torch.abs(torch.log(torch.maximum(boxes[..., 3], tiny)
                                / torch.maximum(mb[..., 3], tiny))))
    l1_l = torch.where(m_any, l1, 0.0).sum(-1)
    total_fg = num_fg.sum()
    group = stats_group()
    if group is not None:
        # each rank's loss is its part of the global loss: the divisor is
        # the foreground count of the whole batch
        total_fg = total_fg.clone()
        dist.all_reduce(total_fg, group=group)
    nfg = torch.clamp(total_fg, min=1.0)
    iou_total = 5.0 * iou_l.sum() / nfg
    obj_total = obj_l.sum() / nfg
    cls_total = cls_l.sum() / nfg
    l1_total = l1_weight * l1_l.sum() / nfg
    return {"total": iou_total + obj_total + cls_total + l1_total,
            "iou": iou_total, "obj": obj_total, "cls": cls_total,
            "l1": l1_total, "num_fg": num_fg.sum()}


def convert_to_training_format(bbox: torch.Tensor, bbox_mask: torch.Tensor):
    """``[B, D, 6]`` (x, y, w, h, class, track), corner xywh, to ``[B, D,
    5]`` (class, cx, cy, w, h) and the mask (reference
    model/utils.py:46-61)."""
    cx = bbox[..., 0] + bbox[..., 2] * 0.5
    cy = bbox[..., 1] + bbox[..., 3] * 0.5
    tgt = torch.stack([bbox[..., 4], cx, cy, bbox[..., 2], bbox[..., 3]], -1)
    return tgt, bbox_mask


def logits_of_decoded(decoded: torch.Tensor) -> torch.Tensor:
    """The decoded outputs with the sigmoided objectness and class columns
    turned back into logits, through a clip to ``[1e-6, 1 - 1e-6]`` (the
    JAX package's ``train_detector`` loss; ``jnp.clip``'s gradient at a
    bound is shared as ``torch.maximum`` / ``torch.minimum`` share it)."""
    p = decoded[..., 4:]
    lo, hi = (torch.full((), v, dtype=p.dtype, device=p.device)
              for v in (1e-6, 1 - 1e-6))
    p = torch.minimum(torch.maximum(p, lo), hi)
    return torch.cat([decoded[..., :4], torch.log(p) - torch.log1p(-p)],
                     dim=-1)
